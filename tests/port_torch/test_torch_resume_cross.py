"""A ``-last.ckpt`` written by either package resumes in the other. From the
same checkpoint (2 epochs of resnet18 at 128 px, ``imgaug: none`` so that
no augmentation draws differ between the packages, fp32 compute in both),
each package resumes to 4 epochs, and the end parameters of the package
that did not write the checkpoint are held to those of the one that did.

The tolerance: the packages' fp32 train steps differ by the order of their
sums, and at a random init the JAX package's fp32 backbone gradients are
ill-conditioned (``test_torch_train.py``): Adam turns a gradient whose sign
differs into a step lr apart. So a few entries part by up to a few lr / 10
over the 4 resumed steps, while most stay within fp32 noise. The test holds
the median and the 90th percentile of the entries' differences (taken in
float64) and bounds the largest. A resume whose moments were lost (zeroed,
as a fresh optimizer) parts from the writer's own resume by a median of
8.3e-5 and a 90th percentile of 2.0e-4 in this setup; the two packages'
resumes of one checkpoint by 3.4e-6 and 1.6e-5, at most 3.2e-4 (the port's
checkpoint resumed by the JAX package)"""

from __future__ import annotations

import shutil
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

pytestmark = pytest.mark.usefixtures("few_torch_threads")

IMAGE = 128
NAMES = ["nose", "tail", "paw_left", "paw_right"]
# the end parameters of the two resumes from one checkpoint: the median and
# 90th percentile of the entries' absolute differences, and the largest
RESUME_MEDIAN_TOL = 1e-5
RESUME_Q90_TOL = 5e-5
RESUME_MAX_TOL = 1e-3


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    return write_labeled_dataset(tmp_path_factory.mktemp("cross_resume") / "data", 10, 130, 140, NAMES, seed=3)


def _cfg(data_dir: Path, epochs: int, resume: bool = False):
    """resnet18 at 128 px, batch 4 (2 steps an epoch), no augmentation, Adam
    1e-3 with the backbone unfrozen from epoch 0, validation (and a
    -last.ckpt) every 2 epochs."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = "crossresume"
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


@pytest.fixture()
def fp32(monkeypatch):
    """fp32 compute in both packages' train()."""
    from lightning_pose_tpu.train import trainer as jtrainer
    from lightning_pose_tpu_torch.train import trainer

    jax_get_model = jtrainer.get_model
    monkeypatch.setattr(jtrainer, "get_model", lambda cfg, **kw: jax_get_model(cfg, compute_dtype=jnp.float32, **kw))
    monkeypatch.setattr(trainer, "COMPUTE_DTYPE", torch.float32)


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


def _last_params(model_dir: Path) -> dict:
    from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint

    lasts = list((model_dir / "tb_logs" / "crossresume" / "version_0" / "checkpoints").glob("*-last.ckpt"))
    assert len(lasts) == 1 and "epoch=3" in lasts[0].name
    assert not (model_dir / "tb_logs" / "crossresume" / "version_1").exists()
    return load_checkpoint(str(lasts[0]))["params"]


@pytest.mark.parametrize("writer, reader", [("port", "jax"), ("jax", "port")])
def test_a_last_ckpt_of_one_package_resumes_in_the_other(writer, reader, data_dir, tmp_path, fp32):
    from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint

    own_dir, other_dir = tmp_path / "own", tmp_path / "other"
    _train(writer, _cfg(data_dir, 2), own_dir, tmp_path)
    shutil.copytree(own_dir, other_dir)
    (start_ckpt,) = (own_dir / "tb_logs" / "crossresume" / "version_0" / "checkpoints").glob("*-last.ckpt")
    start = _flat(load_checkpoint(str(start_ckpt))["params"])
    _train(writer, _cfg(data_dir, 4, resume=True), own_dir, tmp_path)
    _train(reader, _cfg(data_dir, 4, resume=True), other_dir, tmp_path)

    own, cross = _flat(_last_params(own_dir)), _flat(_last_params(other_dir))
    moved = np.abs(own - start)
    assert np.median(moved) > 3 * RESUME_MEDIAN_TOL  # the resumed steps moved the weights
    diff = np.abs(cross - own)
    assert np.median(diff) <= RESUME_MEDIAN_TOL, np.median(diff)
    assert np.quantile(diff, 0.9) <= RESUME_Q90_TOL, np.quantile(diff, 0.9)
    assert diff.max() <= RESUME_MAX_TOL, diff.max()


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x, np.float64).ravel() for x in jax.tree_util.tree_leaves(tree)])
