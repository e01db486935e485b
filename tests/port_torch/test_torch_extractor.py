"""The port's ``DataExtractor`` (``data/extractor.py``) and
``utils/io.collect_video_files_by_view`` against the JAX package's, on the
same synthetic labeled set and file names."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest


def _data_module(package: str, data_dir: Path):
    """``BaseDataModule`` over a 128 px ``HeatmapDataset`` of ``package``
    (``lightning_pose_tpu`` or the port), 60/20/20 splits from seed 7."""
    import importlib

    datasets = importlib.import_module(f"{package}.data.datasets")
    datamodules = importlib.import_module(f"{package}.data.datamodules")
    dataset = datasets.HeatmapDataset(
        root_directory=str(data_dir), csv_path="CollectedData.csv", image_resize_height=128,
        image_resize_width=128, imgaug_pipeline="default",
    )
    return datamodules.BaseDataModule(dataset=dataset, train_batch_size=4, val_batch_size=4, test_batch_size=4,
                                      train_probability=0.6, val_probability=0.2, torch_seed=7)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    return write_labeled_dataset(tmp_path_factory.mktemp("extract") / "data", 30, 100, 120, ["a", "b", "c"], seed=4)


@pytest.mark.parametrize("cond", ["train", "val", "test"])
def test_data_extractor_matches_jax(data_dir, cond):
    from lightning_pose_tpu.data.extractor import DataExtractor as JaxDataExtractor
    from lightning_pose_tpu_torch.data.extractor import DataExtractor

    port = DataExtractor(_data_module("lightning_pose_tpu_torch", data_dir), cond=cond, extract_images=True)
    ref = JaxDataExtractor(_data_module("lightning_pose_tpu", data_dir), cond=cond, extract_images=True)
    keypoints, images = port()
    ref_keypoints, ref_images = ref()
    assert port.dataset_length == ref.dataset_length == len(keypoints) > 0
    assert keypoints.shape == (len(keypoints), 6) and keypoints.dtype == np.float32
    np.testing.assert_array_equal(keypoints, ref_keypoints)
    np.testing.assert_array_equal(images, np.asarray(ref_images))
    assert images.shape == (len(keypoints), 128, 128, 3)


def test_data_extractor_rejects_a_bad_split():
    from lightning_pose_tpu_torch.data.extractor import DataExtractor

    with pytest.raises(ValueError, match="cond must be"):
        DataExtractor(None, cond="holdout")


@pytest.mark.parametrize(
    "files, views, error",
    [
        (["s1_top.mp4", "s1_bot.mp4"], ["top", "bot"], None),
        (["mouse-bot-3.mp4", "mouse-top-3.mp4"], ["top", "bot"], None),
        (["s1_top.mp4", "s1_topbot.mp4"], ["top", "bot"], "File not found for view: bot"),
        (["s1_top.mp4", "s2_top.mp4"], ["top", "bot"], "File matches multiple views"),
    ],
)
def test_collect_video_files_by_view_matches_jax(files, views, error):
    from lightning_pose_tpu.utils.io import collect_video_files_by_view as jax_collect
    from lightning_pose_tpu_torch.utils.io import collect_video_files_by_view

    paths = [Path("videos") / f for f in files]
    if error is not None:
        for fn in (collect_video_files_by_view, jax_collect):
            with pytest.raises(ValueError, match=error):
                fn(paths, views)
        return
    matched = collect_video_files_by_view(paths, views)
    assert matched == jax_collect(paths, views)
    assert list(matched) == views and all(v in matched[v].stem for v in views)
