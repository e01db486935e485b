"""Evaluation against the JAX package: ``predict_on_label_csv`` (with and
without a bbox file and the train/val/test column), ``predict_on_video_file``
with its defaults (metrics), a bbox file and a progress file, the labeled
video, and ``train()`` with its post-training evaluation, on a synthetic
labeled set and mp4 (resnet18, 128 px, fp32, 4 keypoints). Every model
directory's checkpoint is read by both packages through the flax bridge."""

from __future__ import annotations

import json
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest

from lightning_pose_tpu.api.model import Model as JaxModel
from lightning_pose_tpu_torch.api.model import Model

IMAGE = 128
NAMES = ["nose", "tail", "paw_left", "paw_right"]
N_FRAMES = 12
FRAME_H, FRAME_W = 140, 150
VIDEO_FRAMES = 20
# fp32 on the CPU in both packages: the convolutions sum in another order
# and the temperature-1000 decode magnifies it (2.3e-4 px measured on the
# video path); likelihoods are window sums of the same softmax
PX_TOL = 1e-3
CONF_TOL = 1e-4
# the random-init head's maps are near-uniform; this factor on its deconv
# kernels makes them peaked (conftest.py uses 300 at 64 px; at 128 px and
# 300 a map spread over many pixels moved 1.9e-3 px between the packages)
HEAD_SCALE = 1000.0


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    root = write_labeled_dataset(tmp_path_factory.mktemp("port_eval") / "data", N_FRAMES, FRAME_H, FRAME_W, NAMES,
                                 seed=0, nan_fraction=0.1)
    write_unlabeled_video(root, "test_vid", VIDEO_FRAMES, FRAME_H, FRAME_W)
    labels = pd.read_csv(root / "CollectedData.csv", header=[0, 1, 2], index_col=0)
    rng = np.random.default_rng(1)
    boxes = np.column_stack([rng.integers(0, 20, N_FRAMES), rng.integers(0, 20, N_FRAMES),
                             rng.integers(100, 130, N_FRAMES), rng.integers(100, 140, N_FRAMES)])
    pd.DataFrame(boxes, index=labels.index, columns=["x", "y", "h", "w"]).to_csv(root / "bbox.csv")
    boxes = np.column_stack([rng.integers(-5, 20, VIDEO_FRAMES), rng.integers(-5, 20, VIDEO_FRAMES),
                             rng.integers(100, 150, VIDEO_FRAMES), rng.integers(100, 160, VIDEO_FRAMES)])
    pd.DataFrame(boxes, columns=["x", "y", "h", "w"]).to_csv(root / "video_bbox.csv")
    return root


def _port_cfg(data_dir: Path, model_name: str = "porteval"):
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = IMAGE
    cfg.data.image_resize_dims.width = IMAGE
    cfg.data.columns_for_singleview_pca = [0, 1, 2, 3]
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = model_name
    cfg.dali.base.predict.sequence_length = 8
    cfg.training.train_batch_size = 4
    cfg.training.val_batch_size = 4
    cfg.training.test_batch_size = 4
    cfg.training.train_prob = 0.7
    cfg.training.val_prob = 0.3
    return cfg


@pytest.fixture(scope="module")
def model_dir(data_dir, tmp_path_factory) -> Path:
    """config.yaml and a peaked random-init checkpoint written by the JAX
    package."""
    import jax
    import jax.numpy as jnp

    from lightning_pose_tpu.models.factory import get_model
    from lightning_pose_tpu.train import checkpoints as ckpt_utils

    cfg = _port_cfg(data_dir)
    module, _ = get_model(cfg)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, IMAGE, IMAGE, 3)), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for name, layer in params["head"].items():
        if name.startswith("deconv"):
            layer["kernel"] = layer["kernel"] * HEAD_SCALE
    out = tmp_path_factory.mktemp("port_eval_model") / "model"
    ckpt_dir = Path(ckpt_utils.checkpoint_dir(ckpt_utils.next_version_dir(str(out), cfg.model.model_name)))
    ckpt_utils.save_checkpoint(str(ckpt_dir / "epoch=0-step=1-best.ckpt"), params=params, batch_stats=stats,
                               step=1, epoch=0)
    cfg.save(str(out / "config.yaml"))
    return out


@pytest.fixture(scope="module")
def port_model(model_dir) -> Model:
    return Model.from_dir(model_dir, precision="fp32", device="cpu")


@pytest.fixture(scope="module")
def jax_model(model_dir) -> JaxModel:
    return JaxModel.from_dir(model_dir, precision="fp32")


def _read(path: Path) -> pd.DataFrame:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _assert_same_predictions(out: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert out.index.equals(ref.index) and list(out.columns) == list(ref.columns)
    coords = out.columns.get_level_values("coords")
    xy, conf = np.isin(coords, ["x", "y"]), coords == "likelihood"
    np.testing.assert_allclose(out.loc[:, xy].to_numpy(float), ref.loc[:, xy].to_numpy(float), rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(out.loc[:, conf].to_numpy(float), ref.loc[:, conf].to_numpy(float),
                               rtol=0, atol=CONF_TOL)
    if out.columns[-1][0] == "set":
        assert (out.iloc[:, -1] == ref.iloc[:, -1]).all()


def _metric_files(directory: Path) -> list[str]:
    return sorted(p.name for p in directory.glob("*.csv"))


@pytest.mark.parametrize("bbox", [False, True])
@pytest.mark.parametrize("add_set", [False, True])
def test_predict_on_label_csv_matches_jax(port_model, jax_model, data_dir, tmp_path, bbox, add_set):
    kwargs = dict(add_train_val_test_set=add_set, bbox_file=str(data_dir / "bbox.csv") if bbox else None)
    ref = jax_model.predict_on_label_csv("CollectedData.csv", output_dir=tmp_path / "jax", **kwargs)
    out = port_model.predict_on_label_csv("CollectedData.csv", output_dir=tmp_path / "port", **kwargs)
    port_csv, ref_csv = _read(tmp_path / "port" / "predictions.csv"), _read(tmp_path / "jax" / "predictions.csv")
    assert len(port_csv) == N_FRAMES and port_csv.columns[-1][0] == "set"
    _assert_same_predictions(port_csv, ref_csv)
    assert "train" in set(port_csv.iloc[:, -1])
    assert out.metrics is not None and out.metrics.pixel_error_df is not None
    assert _metric_files(tmp_path / "port") == _metric_files(tmp_path / "jax") == [
        "predictions.csv", "predictions_pca_singleview_error.csv", "predictions_pixel_error.csv"]
    pd.testing.assert_frame_equal(out.predictions.iloc[:, :-1].astype(float), ref.predictions.iloc[:, :-1].astype(float),
                                  check_exact=False, rtol=0, atol=PX_TOL)


def test_predict_on_label_csv_default_dir(port_model):
    port_model.predict_on_label_csv("CollectedData.csv", compute_metrics=False)
    out_dir = port_model.model_dir / "image_preds" / "CollectedData.csv"
    assert _metric_files(out_dir) == ["predictions.csv"]


def test_predict_on_video_file_defaults_match_jax(port_model, jax_model, data_dir, tmp_path):
    video = data_dir / "videos" / "test_vid.mp4"
    ref = jax_model.predict_on_video_file(video, output_dir=tmp_path / "jax")
    out = port_model.predict_on_video_file(video, output_dir=tmp_path / "port")
    assert out.metrics is not None and out.metrics.temporal_norm_df is not None
    assert ref.metrics is not None
    assert _metric_files(tmp_path / "port") == _metric_files(tmp_path / "jax") == [
        "test_vid.csv", "test_vid_temporal_norm.csv"]
    _assert_same_predictions(_read(tmp_path / "port" / "test_vid.csv"), _read(tmp_path / "jax" / "test_vid.csv"))
    norm = pd.read_csv(tmp_path / "port" / "test_vid_temporal_norm.csv", index_col=0)
    ref_norm = pd.read_csv(tmp_path / "jax" / "test_vid_temporal_norm.csv", index_col=0)
    assert list(norm.columns) == list(ref_norm.columns) == NAMES and len(norm) == VIDEO_FRAMES
    np.testing.assert_allclose(norm.to_numpy(), ref_norm.to_numpy(), rtol=0, atol=PX_TOL)


def test_predict_on_video_file_with_bbox_file_matches_jax(port_model, jax_model, data_dir, tmp_path):
    video = data_dir / "videos" / "test_vid.mp4"
    kwargs = dict(bbox_file=data_dir / "video_bbox.csv", compute_metrics=False)
    jax_model.predict_on_video_file(video, output_dir=tmp_path / "jax", **kwargs)
    port_model.predict_on_video_file(video, output_dir=tmp_path / "port", **kwargs)
    port_csv, ref_csv = _read(tmp_path / "port" / "test_vid.csv"), _read(tmp_path / "jax" / "test_vid.csv")
    _assert_same_predictions(port_csv, ref_csv)
    plain = port_model.predict_on_video_file(video, output_dir=tmp_path / "plain", compute_metrics=False)
    assert np.abs(plain.predictions.to_numpy() - port_csv.to_numpy()).max() > 1.0  # the crops moved them
    with pytest.raises(ValueError):
        port_model.predict_on_video_file(video, bbox_file=data_dir / "video_bbox.csv",
                                         bbox_df=pd.read_csv(data_dir / "video_bbox.csv", index_col=0))


def test_progress_file_writes_the_jax_keys(port_model, jax_model, data_dir, tmp_path):
    video = data_dir / "videos" / "test_vid.mp4"
    for name, model in (("jax", jax_model), ("port", port_model)):
        model.predict_on_video_file(video, output_dir=tmp_path / name, compute_metrics=False,
                                    progress_file=tmp_path / name / "progress.json")
    ref = json.loads((tmp_path / "jax" / "progress.json").read_text())
    out = json.loads((tmp_path / "port" / "progress.json").read_text())
    assert sorted(out) == sorted(ref) == ["completed", "timestamp", "total"]
    assert out["completed"] == out["total"] == ref["total"] == -(-VIDEO_FRAMES // 8)


def _frames(path: Path) -> np.ndarray:
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def test_labeled_video_is_bitwise_the_jax_one(port_model, data_dir, tmp_path):
    from lightning_pose_tpu.utils.video_predictions import _create_labeled_video as jax_labeled_video
    from lightning_pose_tpu_torch.utils.video_predictions import _create_labeled_video

    video = data_dir / "videos" / "test_vid.mp4"
    result = port_model.predict_on_video_file(video, output_dir=tmp_path, generate_labeled_video=True,
                                              compute_metrics=False)
    mp4 = tmp_path / "labeled_videos" / "test_vid_labeled.mp4"
    assert mp4.is_file() and result.metrics is None
    preds = tmp_path / "test_vid.csv"
    for name, fn in (("jax", jax_labeled_video), ("port", _create_labeled_video)):
        fn(video_file=str(video), preds_df_file=str(preds), output_mp4=str(tmp_path / f"{name}.mp4"),
           confidence_thresh=0.0)
    out, ref = _frames(tmp_path / "port.mp4"), _frames(tmp_path / "jax.mp4")
    assert out.shape == ref.shape == (VIDEO_FRAMES, FRAME_H, FRAME_W, 3)
    np.testing.assert_array_equal(out, ref)
    assert not np.array_equal(out, _frames(video))  # the dots were drawn


@pytest.mark.parametrize("n", [1, 4, 17, 256, 300])
def test_cool_colormap_matches_matplotlib(n):
    import matplotlib.pyplot as plt

    from lightning_pose_tpu_torch.utils.video_predictions import _make_cmap

    ref = (plt.cm.ScalarMappable(cmap="cool").to_rgba(np.linspace(0, 1, n))[:, :3] * 255).astype(np.uint8)
    np.testing.assert_array_equal(_make_cmap(n, "cool"), ref)


# -- train() with its evaluation --------------------------------------------------------


def _train_settings(cfg, data_dir: Path) -> None:
    cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
    cfg.training.max_steps = cfg.training.min_steps = 2
    cfg.training.unfreezing_step = 1
    cfg.training.lr_scheduler_params.multisteplr.milestones = None
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
    cfg.training.check_val_every_n_epoch = 1
    cfg.eval.predict_vids_after_training = True
    cfg.eval.save_vids_after_training = True
    cfg.eval.test_videos_directory = str(data_dir / "videos")


@pytest.fixture(scope="module")
def trained_dirs(data_dir, tmp_path_factory) -> tuple[Path, Path]:
    """The port's train() on the CPU (its compute type set to fp32, so that
    its evaluation can be held to the JAX package's fp32 prediction) and the
    JAX package's train() on the same config, both with evaluation, a
    ``_new`` label file and the test videos."""
    import shutil

    import torch

    from lightning_pose_tpu.config import Config as JaxConfig
    from lightning_pose_tpu.train.trainer import train as jax_train
    from lightning_pose_tpu_torch.train import trainer

    shutil.copy(data_dir / "CollectedData.csv", data_dir / "CollectedData_new.csv")
    root = tmp_path_factory.mktemp("port_eval_train")
    cfg = _port_cfg(data_dir, "evaltrain")
    _train_settings(cfg, data_dir)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "COMPUTE_DTYPE", torch.float32)
        trainer.train(cfg, root / "port", device="cpu")
    jax_train(JaxConfig.from_yaml(str(root / "port" / "config.yaml")), root / "jax")
    return root / "port", root / "jax"


def _files(model_dir: Path) -> list[str]:
    return sorted(str(p.relative_to(model_dir)) for p in model_dir.rglob("*")
                  if p.is_file() and p.parts[len(model_dir.parts)] != "tb_logs")


def test_train_evaluates_into_the_jax_file_names(trained_dirs):
    port_dir, jax_dir = trained_dirs
    files = _files(port_dir)
    assert files == _files(jax_dir)
    for name in ("image_preds/CollectedData.csv/predictions.csv",
                 "image_preds/CollectedData.csv/predictions_pixel_error.csv",
                 "image_preds/CollectedData_new.csv/predictions.csv",
                 "predictions.csv", "predictions_new.csv", "predictions_pixel_error_new.csv",
                 "video_preds/test_vid.csv", "video_preds/test_vid_temporal_norm.csv",
                 "video_preds/labeled_videos/test_vid_labeled.mp4"):
        assert name in files, name
    assert json.loads((port_dir / "train_status.json").read_text())["status"] == "COMPLETED"


def test_jax_package_reproduces_the_port_train_predictions(trained_dirs, tmp_path):
    port_dir, _ = trained_dirs
    JaxModel.from_dir(port_dir, precision="fp32").predict_on_label_csv(
        "CollectedData.csv", output_dir=tmp_path, add_train_val_test_set=True, compute_metrics=False)
    _assert_same_predictions(_read(port_dir / "image_preds" / "CollectedData.csv" / "predictions.csv"),
                             _read(tmp_path / "predictions.csv"))
