"""Fixtures for the PyTorch port's tests.

The port is held against the JAX package: inputs are made from a seed with
numpy and given to both. Model directories are written by the JAX package
(random init, head scaled so its maps are peaked) and read by both.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pytest

# factor on both deconv kernels of the random-init head: the reference's
# Xavier gain 0.01 gives near-uniform maps, whose decode lands at the
# centre whatever the backbone computed
HEAD_SCALE = 300.0

SLICE_KEYPOINTS = 4
SLICE_IMAGE = 64
SLICE_SEQ_LEN = 8


def _make_config(model_name: str = "porttest"):
    """A resnet18 heatmap config at 64 px, the JAX package's defaults
    otherwise."""
    from lightning_pose_tpu.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = SLICE_KEYPOINTS
    cfg.data.keypoint_names = [f"kp{i}" for i in range(SLICE_KEYPOINTS)]
    cfg.data.image_resize_dims.height = SLICE_IMAGE
    cfg.data.image_resize_dims.width = SLICE_IMAGE
    cfg.model.model_type = "heatmap"
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = model_name
    cfg.model.losses_to_use = []
    cfg.dali.base.predict.sequence_length = SLICE_SEQ_LEN
    return cfg


def _peaked_jax_variables(module, image: int, seed: int = 0) -> tuple[dict, dict]:
    """Random-init flax variables as numpy trees, with the head's deconv
    kernels scaled by HEAD_SCALE."""
    import jax
    import jax.numpy as jnp

    variables = module.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, image, image, 3)), train=False
    )
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    batch_stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    for name, layer in params["head"].items():
        if name.startswith("deconv"):
            layer["kernel"] = layer["kernel"] * HEAD_SCALE
    return params, batch_stats


@pytest.fixture()
def peaked_jax_variables():
    """``fn(flax module, image size, seed) -> (params, batch_stats)``:
    random-init numpy trees with a peaked head."""
    return _peaked_jax_variables


@pytest.fixture(scope="session")
def slice_model_dir(tmp_path_factory) -> Path:
    """A model directory as training writes it: config.yaml and a
    ``-best.ckpt`` written by the JAX package's save_checkpoint."""
    from lightning_pose_tpu.models.factory import get_model
    from lightning_pose_tpu.train import checkpoints as ckpt_utils

    cfg = _make_config()
    module, _ = get_model(cfg)
    params, batch_stats = _peaked_jax_variables(module, SLICE_IMAGE)
    model_dir = tmp_path_factory.mktemp("port_slice") / "model"
    version_dir = ckpt_utils.next_version_dir(str(model_dir), cfg.model.model_name)
    ckpt_dir = Path(ckpt_utils.checkpoint_dir(version_dir))
    ckpt_utils.save_checkpoint(
        str(ckpt_dir / "epoch=1-step=10-best.ckpt"),
        params=params, batch_stats=batch_stats, step=10, epoch=1,
    )
    cfg.save(str(model_dir / "config.yaml"))
    return model_dir


def _write_video(path: Path, n_frames: int, height: int, width: int, seed: int = 0) -> Path:
    """A seeded mp4 of smooth moving blobs (decodes stably under mp4v)."""
    import cv2

    rng = np.random.default_rng(seed)
    centers = rng.uniform(0.2, 0.8, (3, 2)) * (width, height)
    velocity = rng.uniform(-2.0, 2.0, (3, 2))
    yy, xx = np.mgrid[0:height, 0:width]
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (width, height))
    for t in range(n_frames):
        frame = np.zeros((height, width, 3), dtype=np.float64)
        for c, (cx, cy) in enumerate(centers + t * velocity):
            frame[..., c] = 255.0 * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 200.0)
        writer.write(frame.astype(np.uint8))
    writer.release()
    return path


@pytest.fixture(scope="session")
def slice_video(tmp_path_factory) -> Path:
    """20 frames of 60x80: three batches of 8, the last one padded."""
    return _write_video(tmp_path_factory.mktemp("port_video") / "blobs.mp4", 20, 60, 80)
