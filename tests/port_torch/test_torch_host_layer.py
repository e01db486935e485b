"""The port's copy of the host layer against the JAX package's: the same
config tree, the same uint8 video batches, the same native resize, the same
label parsing and checkpoint discovery, and the same prediction CSV."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

from lightning_pose_tpu import native as jax_native
from lightning_pose_tpu.config import load_config as jax_load_config
from lightning_pose_tpu.data.video import PredictVideoLoader as JaxLoader
from lightning_pose_tpu.utils import io as jax_io
from lightning_pose_tpu.utils.predictions import PredictionHandler as JaxHandler
from lightning_pose_tpu_torch import native
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.data.video import PredictVideoLoader, count_frames
from lightning_pose_tpu_torch.utils import io
from lightning_pose_tpu_torch.utils.predictions import PredictionHandler
from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset


@pytest.mark.parametrize("overrides", [None, ["training.train_batch_size=4", "data.video_dir=/x", "model.backbone=resnet18"]])
def test_load_config_gives_the_jax_tree(overrides):
    cfg, ref = load_config(overrides=overrides), jax_load_config(overrides=overrides)
    assert cfg.to_dict() == ref.to_dict()
    for section in ("data", "training", "model", "eval", "losses"):
        assert cfg[section].to_dict(resolve=True) == ref[section].to_dict(resolve=True)
    assert cfg.eval.test_videos_directory == cfg.data.video_dir


def test_config_round_trips_through_yaml(tmp_path):
    cfg = load_config(overrides=["data.num_keypoints=3"])
    cfg.save(str(tmp_path / "config.yaml"))
    again = load_config(str(tmp_path / "config.yaml"))
    assert again.to_dict() == cfg.to_dict()
    assert again.data.num_keypoints == 3


@pytest.mark.parametrize("decode_threads", [1, 2])
def test_predict_video_loader_gives_the_jax_batches(slice_video, decode_threads):
    args = (str(slice_video), 8, 64, 48)
    port = list(PredictVideoLoader(*args, decode_threads=decode_threads))
    ref = list(JaxLoader(*args, decode_threads=decode_threads))
    assert len(port) == len(ref) == 3  # 20 frames, the last batch filled
    for a, b in zip(port, ref):
        assert a.dtype == np.uint8 and a.shape == (8, 64, 48, 3)
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(port[-1][4:], np.repeat(port[-1][3:4], 4, axis=0))
    assert count_frames(str(slice_video)) == 20


def test_predict_video_loader_rejects_a_missing_file(tmp_path):
    with pytest.raises(FileNotFoundError):
        PredictVideoLoader(str(tmp_path / "missing.mp4"), 8, 64, 64)


def test_native_resize_matches_the_jax_package():
    """The same C++ source, built into the port's own build directory."""
    frames = np.random.default_rng(0).integers(0, 256, (5, 37, 53, 3), dtype=np.uint8)
    for swap_rb in (False, True):
        np.testing.assert_array_equal(
            native.batch_resize_rgb(frames, 32, 40, swap_rb=swap_rb),
            jax_native.batch_resize_rgb(frames, 32, 40, swap_rb=swap_rb),
        )
    if native.available():
        assert native._library_path().parent.name == "native"
        assert native._library_path().parent.parent.name == "build"


def test_prediction_handler_writes_the_jax_csv(slice_video, tmp_path):
    cfg = load_config()
    cfg.data.keypoint_names = ["a", "b", "c"]
    rng = np.random.default_rng(1)
    # three batches of 8 for the 20-frame video: the handler trims the fill
    preds = [
        (rng.uniform(0, 80, (8, 6)).astype(np.float32), rng.uniform(0, 1, (8, 3)).astype(np.float32))
        for _ in range(3)
    ]
    port = PredictionHandler(cfg=cfg, video_file=str(slice_video))(preds)
    ref = JaxHandler(cfg=cfg, video_file=str(slice_video))(preds)
    assert port.shape == (20, 9)
    port.to_csv(tmp_path / "port.csv")
    ref.to_csv(tmp_path / "ref.csv")
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "ref.csv").read_text()


def test_label_parsing_and_checkpoint_discovery_match(tmp_path):
    names = ["nose", "tail"]
    data = write_labeled_dataset(tmp_path / "data", 6, 40, 50, names, seed=2)
    csv = str(Path(data) / "CollectedData.csv")
    port, ref = io.parse_label_csv(csv), jax_io.parse_label_csv(csv)
    assert port.keypoint_names == ref.keypoint_names == names
    assert port.image_names == ref.image_names
    np.testing.assert_array_equal(port.keypoints, ref.keypoints)
    ckpts = tmp_path / "model" / "tb_logs" / "m" / "version_1" / "checkpoints"
    ckpts.mkdir(parents=True)
    for name in ("epoch=0-step=5.ckpt", "epoch=1-step=10-best.ckpt", "epoch=2-step=15-last.ckpt"):
        (ckpts / name).write_bytes(b"")
    found = io.ckpt_path_from_base_path(str(tmp_path / "model"), "m")
    assert found == jax_io.ckpt_path_from_base_path(str(tmp_path / "model"), "m")
    assert found.endswith("-best.ckpt")
    assert io.ckpt_path_from_base_path(str(tmp_path / "model"), "other") is None


def test_video_discovery_matches(tmp_path):
    for name in ("s1_top.mp4", "s1_side.mp4", "s2_top.mp4", "s2_side.mp4", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert sorted(io.get_videos_in_dir(str(tmp_path))) == sorted(jax_io.get_videos_in_dir(str(tmp_path)))
    views = ["top", "side"]
    assert io.get_videos_in_dir(str(tmp_path), views) == jax_io.get_videos_in_dir(str(tmp_path), views)
    port = io.find_video_files_for_views(str(tmp_path), views)
    ref = jax_io.find_video_files_for_views(str(tmp_path), views)
    assert sorted(map(tuple, port)) == sorted(map(tuple, ref)) and len(port) == 2
