"""Slice 9, a transformer trunk end to end across the packages: the port's
``train()`` of a DINOv3 heatmap model (2 epochs of 128 px, ``imgaug: none``,
fp32 in both packages) with ``eval.decode_method: dark``, whose evaluation
writes what ``Model.from_dir`` of either package predicts with DARK from
its directory; then its ``-last.ckpt`` (the optimizer state's new leaves:
LayerScale, register tokens, the DINOv3 projections) resumed to 4 epochs
by the JAX package and by the port, the end parameters held as
``test_torch_resume_cross.py`` holds the convnet's.

The DINOv3 is small (``VIT_CONFIGS["vits"]`` width 32, depth 1, 2 heads:
head dim 16, a multiple of 4 as RoPE needs), set in both packages."""

from __future__ import annotations

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lightning_pose_tpu.models.backbones import vit as jvit
from lightning_pose_tpu_torch.models.backbones import vit as pvit


IMAGE = 128
NAMES = ["nose", "tail", "paw_left", "paw_right"]
TINY_VIT = (32, 1, 2, 16)
# fp32 on the CPU in both packages, one checkpoint; frame pixels
PX_TOL = 5e-3
CONF_TOL = 2e-4
# the end parameters of the two resumes from one checkpoint (as in
# test_torch_resume_cross.py): the median and 90th percentile of the
# entries' absolute differences, and the largest
RESUME_MEDIAN_TOL = 1e-5
RESUME_Q90_TOL = 5e-5
RESUME_MAX_TOL = 1e-3


def _patch(mp) -> None:
    """The tiny DINOv3 in both packages, fp32 compute in both trainers."""
    from lightning_pose_tpu.train import trainer as jtrainer
    from lightning_pose_tpu_torch.train import trainer

    mp.setitem(jvit.VIT_CONFIGS, "vits", TINY_VIT)
    mp.setitem(pvit.VIT_CONFIGS, "vits", TINY_VIT)
    jax_get_model = jtrainer.get_model
    mp.setattr(jtrainer, "get_model", lambda cfg, **kw: jax_get_model(cfg, compute_dtype=jnp.float32, **kw))
    mp.setattr(trainer, "COMPUTE_DTYPE", torch.float32)


def _cfg(data_dir: Path, epochs: int, resume: bool = False):
    """vits_dinov3 at 128 px, batch 4 (2 steps an epoch), no augmentation,
    Adam 1e-3 with the backbone unfrozen from epoch 0, validation (and a
    -last.ckpt) every 2 epochs, DARK decoding."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.backbone = "vits_dinov3"
    cfg.model.model_name = "vitresume"
    cfg.eval.decode_method = "dark"
    cfg.eval.predict_vids_after_training = False
    t = cfg.training
    t.imgaug = "none"
    t.train_batch_size = t.val_batch_size = 4
    t.train_prob, t.val_prob = 0.8, 0.2
    t.max_epochs = t.min_epochs = epochs
    t.unfreezing_epoch = 0
    t.lr_scheduler_params.multisteplr.milestones = [epochs]
    t.check_val_every_n_epoch = 2
    t.scan_epochs = False
    t.resume = resume
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory) -> tuple[Path, Path]:
    """The data and the directory of the port's 2-epoch train() with its
    evaluation."""
    from lightning_pose_tpu_torch.train.trainer import train
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    root = tmp_path_factory.mktemp("vit_resume")
    data = write_labeled_dataset(root / "data", 10, 130, 140, NAMES, seed=3)
    with pytest.MonkeyPatch.context() as mp:
        _patch(mp)
        train(_cfg(data, 2), root / "model", device="cpu")
    return data, root / "model"


def _csv(path: Path) -> np.ndarray:
    """The x, y and likelihood columns of a predictions CSV."""
    return pd.read_csv(path, header=[0, 1, 2], index_col=0).to_numpy()[:, :3 * len(NAMES)].astype(np.float64)


def test_train_evaluation_decodes_with_dark_as_model_from_dir(trained, tmp_path, monkeypatch):
    """The evaluation's predictions.csv is what ``Model.from_dir`` predicts
    from the directory with DARK (the same numbers in the port, within fp32
    noise in the JAX package), and not what the soft-argmax gives."""
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    _patch(monkeypatch)
    data, model_dir = trained
    written = _csv(model_dir / "image_preds" / "CollectedData.csv" / "predictions.csv")
    assert written.shape == (10, 12) and np.isfinite(written).all()
    port = Model.from_dir(model_dir, precision="fp32", device="cpu")
    port.predict_on_label_csv(data / "CollectedData.csv", data_dir=data, compute_metrics=False,
                              output_dir=tmp_path / "port")
    ported = _csv(tmp_path / "port" / "predictions.csv")
    np.testing.assert_array_equal(ported, written)
    ref = JaxModel.from_dir(model_dir, precision="fp32")
    ref.predict_on_label_csv(data / "CollectedData.csv", data_dir=data, compute_metrics=False,
                             output_dir=tmp_path / "jax")
    expected = _csv(tmp_path / "jax" / "predictions.csv")
    xy = np.arange(12) % 3 != 2
    np.testing.assert_allclose(ported[:, xy], expected[:, xy], rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(ported[:, ~xy], expected[:, ~xy], rtol=0, atol=CONF_TOL)
    soft_dir = tmp_path / "soft"
    shutil.copytree(model_dir, soft_dir)
    cfg_file = soft_dir / "config.yaml"
    cfg_file.write_text(cfg_file.read_text().replace("decode_method: dark", "decode_method: softargmax"))
    soft = Model.from_dir(soft_dir, precision="fp32", device="cpu")
    soft.predict_on_label_csv(data / "CollectedData.csv", data_dir=data, compute_metrics=False,
                              output_dir=tmp_path / "softargmax")
    assert np.abs(_csv(tmp_path / "softargmax" / "predictions.csv")[:, xy] - written[:, xy]).max() > 1e-3


def _train(package: str, cfg, model_dir: Path, tmp_path: Path) -> None:
    if package == "jax":
        from lightning_pose_tpu.config import Config as JaxConfig
        from lightning_pose_tpu.train.trainer import train

        yaml_file = tmp_path / "jax_config.yaml"
        cfg.save(str(yaml_file))
        train(JaxConfig.from_yaml(str(yaml_file)), model_dir=model_dir, skip_evaluation=True)
    else:
        from lightning_pose_tpu_torch.train.trainer import train

        train(cfg, model_dir, skip_evaluation=True, device="cpu")


def _last_params(model_dir: Path) -> np.ndarray:
    from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint

    lasts = list((model_dir / "tb_logs" / "vitresume" / "version_0" / "checkpoints").glob("*-last.ckpt"))
    assert len(lasts) == 1 and "epoch=3" in lasts[0].name
    params = load_checkpoint(str(lasts[0]))["params"]
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(params)])


def test_the_port_last_ckpt_of_a_vit_resumes_in_the_jax_package(trained, tmp_path, monkeypatch):
    from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint

    _patch(monkeypatch)
    data, model_dir = trained
    own_dir, other_dir = tmp_path / "own", tmp_path / "other"
    shutil.copytree(model_dir, own_dir)
    shutil.copytree(model_dir, other_dir)
    (start_ckpt,) = (own_dir / "tb_logs" / "vitresume" / "version_0" / "checkpoints").glob("*-last.ckpt")
    start_tree = load_checkpoint(str(start_ckpt))
    moments = start_tree["opt_state"]["inner_states"]["backbone"]["inner_state"]["0"]["mu"]["backbone"]
    assert {"cls_token", "register_tokens"} <= set(moments) and "lambda" in moments["block0"]["ls1"]
    start = np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(start_tree["params"])])
    _train("port", _cfg(data, 4, resume=True), own_dir, tmp_path)
    _train("jax", _cfg(data, 4, resume=True), other_dir, tmp_path)

    own, cross = _last_params(own_dir), _last_params(other_dir)
    assert np.median(np.abs(own - start)) > 3 * RESUME_MEDIAN_TOL  # the resumed steps moved the weights
    diff = np.abs(cross - own)
    assert np.median(diff) <= RESUME_MEDIAN_TOL, np.median(diff)
    assert np.quantile(diff, 0.9) <= RESUME_Q90_TOL, np.quantile(diff, 0.9)
    assert diff.max() <= RESUME_MAX_TOL, diff.max()
