"""Slice 11, the data path of the heatmap models on multiview data against
the JAX package's: the data factory's dispatch (``heatmap`` and
``heatmap_mhcrnn`` with views to the multiview dataset, regression refused),
the context samples ``(V, 5, H, W, 3)`` of ``MultiviewHeatmapDataset``
bitwise, the calibrated context refusal, the synchronized unlabeled stream
and ``pca_multiview`` of a heatmap model's data module, the overlapping
multiview predict loader of a context model, and the context shift of a
multiview session's rows. Data from ``utils/synthetic.py`` in the split
layout: ``top.csv`` and ``bot.csv``, consecutive frame names, a
synchronized session in ``videos/``."""

from __future__ import annotations

from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

VIEWS = ["top", "bot"]
NAMES = ["nose", "ear", "tail"]
FRAMES = 20


@pytest.fixture(scope="module")
def split_root(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_multiview_dataset, write_multiview_videos

    root = write_multiview_dataset(tmp_path_factory.mktemp("port_mv_heatmap") / "data", FRAMES, 100, 120, NAMES,
                                   VIEWS, seed=11, csv_name="{view}.csv")
    write_multiview_videos(root, "sess", 18, 100, 120, VIEWS, seed=12)
    return root


def _cfg(root: Path, model_type: str, losses=(), context_mode: str = "adjacent"):
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(root)
    cfg.data.video_dir = str(root / "videos")
    cfg.data.csv_file = [f"{v}.csv" for v in VIEWS]
    cfg.data.view_names = list(VIEWS)
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.mirrored_column_matches = list(range(len(NAMES)))
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.model_type = model_type
    cfg.model.backbone = "resnet18"
    cfg.model.mhcrnn_context_mode = context_mode
    cfg.model.losses_to_use = list(losses)
    cfg.training.imgaug = "dlc"
    cfg.training.train_prob, cfg.training.val_prob = 0.8, 0.1
    cfg.dali.base.train.sequence_length = 6
    return cfg


@pytest.mark.parametrize("model_type", ["heatmap", "heatmap_mhcrnn", "regression"])
def test_data_factory_dispatch_matches_jax(split_root, model_type):
    """``heatmap`` and ``heatmap_mhcrnn`` with two views take the multiview
    dataset in both packages, the latter with context stacks; a regression
    model on multiview data raises the JAX package's NotImplementedError."""
    from lightning_pose_tpu.data.factory import get_dataset as jax_get_dataset
    from lightning_pose_tpu_torch.data.factory import get_dataset

    cfg = _cfg(split_root, model_type)
    if model_type == "regression":
        for fn in (get_dataset, jax_get_dataset):
            with pytest.raises(NotImplementedError, match="heatmap-based"):
                fn(cfg, str(split_root))
        return
    ds, ref = get_dataset(cfg, str(split_root)), jax_get_dataset(cfg, str(split_root))
    assert type(ds).__name__ == type(ref).__name__ == "MultiviewHeatmapDataset"
    assert ds.do_context == ref.do_context == (model_type == "heatmap_mhcrnn")
    assert (len(ds), ds.num_keypoints, ds.num_keypoints_per_view) == (FRAMES, 2 * len(NAMES), len(NAMES))
    assert not ds.is_calibrated and ds.image_names_by_view == ref.image_names_by_view


@pytest.mark.parametrize("context_mode", ["adjacent", "repeat_center"])
def test_context_samples_match_jax(split_root, context_mode):
    """``do_context`` samples: ``(V, 5, H, W, 3)`` stacks (the edges' stacks
    repeat their first and last frames; repeat_center repeats the labeled
    frame), view-major keypoints and visibility, bboxes ``(4V,)``, bitwise
    the JAX dataset's; the center frame is the sample without context
    (mirroring the JAX package's tests/data/test_datasets.py:307)."""
    from lightning_pose_tpu.data.datasets_multiview import MultiviewHeatmapDataset as JaxDataset
    from lightning_pose_tpu_torch.data.datasets_multiview import MultiviewHeatmapDataset

    cfg = _cfg(split_root, "heatmap_mhcrnn", context_mode=context_mode)
    ds = MultiviewHeatmapDataset(cfg, str(split_root), do_context=True)
    ref = JaxDataset(cfg, str(split_root), do_context=True)
    plain = MultiviewHeatmapDataset(cfg, str(split_root))
    for i in (0, 1, 10, FRAMES - 1):
        out, expected = ds[i], ref[i]
        assert out["images"].shape == (2, 5, 128, 128, 3)
        assert out["keypoints"].shape == (2 * len(NAMES), 2) and out["bbox"].shape == (8,)
        for key in ("images", "keypoints", "visibility", "bbox"):
            np.testing.assert_array_equal(out[key], expected[key], err_msg=f"{key} of sample {i}")
        np.testing.assert_array_equal(out["images"][:, 2], plain[i]["images"])
    if context_mode == "adjacent":
        np.testing.assert_array_equal(ds[10]["images"][:, 3], plain[11]["images"])
    else:
        assert all(np.array_equal(ds[10]["images"][:, t], plain[10]["images"]) for t in range(5))


@pytest.mark.parametrize("source", ["camera_params_file", "discovery"])
def test_calibrated_context_raises_the_jax_value_error(split_root, tmp_path, source):
    """A context dataset with a calibration, named by ``camera_params_file``
    (even a missing file) or found beside the frames, raises the JAX
    package's ValueError, word for word (mirroring its
    tests/data/test_datasets.py:333); the data factory raises it for
    ``heatmap_mhcrnn``. A heatmap model keeps the calibrated dataset."""
    import shutil

    from lightning_pose_tpu.data.datasets_multiview import MultiviewHeatmapDataset as JaxDataset
    from lightning_pose_tpu_torch.data.datasets_multiview import MultiviewHeatmapDataset
    from lightning_pose_tpu_torch.data.factory import get_dataset
    from lightning_pose_tpu_torch.utils.synthetic import synthetic_cameras, write_anipose_toml

    root = tmp_path / "data"
    shutil.copytree(split_root, root, ignore=shutil.ignore_patterns("videos"))
    cfg = _cfg(root, "heatmap_mhcrnn")
    if source == "camera_params_file":
        cfg.data.camera_params_file = str(tmp_path / "anything.toml")
    else:
        write_anipose_toml(root / "calibration.toml", synthetic_cameras(2, 100, 120), VIEWS, 100, 120)
    with pytest.raises(ValueError, match="not supported") as err:
        MultiviewHeatmapDataset(cfg, str(root), do_context=True)
    with pytest.raises(ValueError, match="not supported") as ref_err:
        JaxDataset(cfg, str(root), do_context=True)
    assert str(err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match="not supported"):
        get_dataset(cfg, str(root))
    if source == "discovery":
        cfg.model.model_type = "heatmap"
        assert get_dataset(cfg, str(root)).is_calibrated


@pytest.mark.parametrize("model_type", ["heatmap", "heatmap_mhcrnn"])
def test_unlabeled_stream_and_pca_multiview_match_jax(split_root, model_type):
    """A heatmap model's semi-supervised data module on multiview data: the
    synchronized ``(T, V, H, W, 3)`` windows bitwise the JAX package's, and
    ``pca_multiview`` with the flat per-view matches expanded one list a
    view: the same subspace within 1e-5 and the same loss on predictions
    within a relative 1e-5."""
    from lightning_pose_tpu.data.factory import get_data_module as jax_dm
    from lightning_pose_tpu.data.factory import get_dataset as jax_ds
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu_torch.data.factory import get_data_module, get_dataset
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories

    cfg = _cfg(split_root, model_type, ["pca_multiview"])
    cfg.losses.pca_multiview.log_weight = 0.0
    videos = str(split_root / "videos")
    ref_ds, ds = jax_ds(cfg, str(split_root)), get_dataset(cfg, str(split_root))
    ref_dm, dm = jax_dm(cfg, ref_ds, videos), get_data_module(cfg, ds, videos)
    try:
        for _ in range(2):
            out, ref = next(dm.unlabeled_loader), next(ref_dm.unlabeled_loader)
            assert out["frames"].shape == (6, 2, 128, 128, 3) and out["bbox"].shape == (6, 8)
            np.testing.assert_array_equal(out["frames"], ref["frames"])
            np.testing.assert_array_equal(out["bbox"], ref["bbox"])
        factory = get_loss_factories(cfg, dm)["unsupervised"]
        ref_factory = jax_factories(cfg, ref_dm)["unsupervised"]
        pca, ref_pca = (f.loss_instance_dict["pca_multiview"].pca for f in (factory, ref_factory))
        assert pca.mirrored_column_matches == ref_pca.mirrored_column_matches == [[0, 1, 2], [3, 4, 5]]
        for key in ("mean", "kept_eigenvectors", "discarded_eigenvectors"):
            np.testing.assert_allclose(pca.parameters[key], ref_pca.parameters[key], rtol=0, atol=1e-5, err_msg=key)
        preds = np.random.default_rng(13).uniform(0, 128, (4, 4 * len(NAMES))).astype(np.float32)
        value, _ = factory(stage="train", anneal_weight=1.0, keypoints_pred=torch.from_numpy(preds))
        ref_value, _ = ref_factory(stage="train", anneal_weight=1.0, keypoints_pred=jnp.asarray(preds))
        assert float(ref_value) > 0
        np.testing.assert_allclose(float(value), float(ref_value), rtol=1e-5)
    finally:
        dm.close()
        ref_dm.close()


def test_context_predict_loader_and_session_rows_match_jax(split_root):
    """A context model's multiview predict loader: 8-frame batches that
    overlap by 4 frames, ``(T, V, h, w, 3)``, bitwise the JAX loader's; the
    stacked per-window rows of a session shift by 2 frames in every view's
    columns, as the JAX ``PredictionHandler`` shifts them."""
    from lightning_pose_tpu.data.video import MultiviewPredictVideoLoader as JaxLoader
    from lightning_pose_tpu.utils.predictions import PredictionHandler as JaxHandler
    from lightning_pose_tpu_torch.data.video import MultiviewPredictVideoLoader
    from lightning_pose_tpu_torch.utils.predictions import PredictionHandler

    files = [str(split_root / "videos" / f"sess_{v}.mp4") for v in VIEWS]
    out = list(MultiviewPredictVideoLoader(files, 8, 128, 128, do_context=True))
    ref = list(JaxLoader(files, 8, 128, 128, do_context=True))
    assert len(out) == len(ref) == 4 and out[0].shape == (8, 2, 128, 128, 3)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(out[1][:4], out[0][4:])

    cfg = _cfg(split_root, "heatmap_mhcrnn")
    rng = np.random.default_rng(14)
    rows = [(rng.uniform(0, 100, (4, 12)), rng.uniform(0, 1, (4, 6))) for _ in range(4)]
    frames = PredictionHandler(cfg=cfg, video_file=files[0])(rows, is_multiview_video=True)
    expected = JaxHandler(cfg=cfg, data_module=None, video_file=files[0])(rows, is_multiview_video=True)
    for i, view in enumerate(VIEWS):
        pd.testing.assert_frame_equal(frames[view], expected[view])
        assert len(frames[view]) == 18
        np.testing.assert_array_equal(frames[view].to_numpy()[2, 0::3], rows[0][0][0, 6 * i:6 * i + 6:2])
