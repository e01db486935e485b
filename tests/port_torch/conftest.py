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
    from lightning_pose_tpu_torch.config import load_config

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


def _seeded_jax_variables(module, *inputs, seed: int = 0, **kwargs) -> dict:
    """Variables of a flax module made from a seed with numpy, without
    running its init (only its shapes are traced): kernels normal with std
    ``1/sqrt(fan_in)``, biases and running means normal(0, 0.1), scales and
    running variances uniform in [0.5, 1.5], other leaves normal(0, 0.02).
    ``inputs`` and ``kwargs`` go to ``module.init``."""
    import jax

    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *inputs, **kwargs))
    rng = np.random.default_rng(seed)

    def leaf(path, s):
        name = jax.tree_util.keystr(path[-1:]).strip("[]'")
        if name == "kernel":
            if len(s.shape) == 3:  # DenseGeneral: (D, H, Dh) in, (H, Dh, D) out
                fan_in = s.shape[0] * (s.shape[1] if "out" in jax.tree_util.keystr(path) else 1)
            else:
                fan_in = int(np.prod(s.shape[:-1]))
            value = rng.standard_normal(s.shape) / np.sqrt(max(fan_in, 1))
        elif name in ("bias", "mean"):
            value = 0.1 * rng.standard_normal(s.shape)
        elif name in ("scale", "var"):
            value = rng.uniform(0.5, 1.5, s.shape)
        else:
            value = 0.02 * rng.standard_normal(s.shape)
        return value.astype(np.float32)

    return jax.tree_util.tree_map_with_path(leaf, shapes)


@pytest.fixture(scope="module")
def few_torch_threads():
    """Two torch threads for a module's tests: the suite runs several
    workers on one machine, and a worker whose torch takes every core
    slows the others most in the heavy training tests."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(threads)


@pytest.fixture()
def seeded_jax_variables():
    """``fn(flax module, *init inputs, seed=0, **init kwargs) -> variables``:
    numpy trees made from a seed, without running the module's init."""
    return _seeded_jax_variables


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


def _jax_draws(engine, rng, b: int):
    """The draws the JAX engine's ``_augment`` makes from ``rng`` for ``b``
    images, the same ``jax.random`` calls on the same keys, as the port's
    ``Draws`` (CPU tensors)."""
    import jax
    import torch

    from lightning_pose_tpu_torch.ops.augment import Draws, _coarse_size

    spec, h, w = engine.spec, engine.h, engine.w
    keys = jax.random.split(rng, 28)

    def u(i, shape=(b,), lo=0.0, hi=1.0):
        return torch.from_numpy(np.array(jax.random.uniform(keys[i], shape, minval=lo, maxval=hi)))

    d = Draws()
    if spec["rot90"] is not None:
        d.rot90_u = u(27)
        n = len(spec["rot90"]["k"])
        d.rot90_choice = torch.from_numpy(np.array(jax.random.randint(keys[0], (b,), 0, n))).long()
    if spec["affine"] is not None:
        rot = spec["affine"]["rotate"]
        d.affine_u, d.affine_deg = u(1), u(2, lo=-rot, hi=rot)
    if spec["croppad"] is not None:
        pct = spec["croppad"]["percent"]
        d.croppad_u, d.croppad_percents = u(3), u(4, (b, 4), -pct, pct)
    if engine.hflip or spec["fliplr"] is not None:
        d.flip_u = u(5)
    if spec["elastic"] is not None:
        alo, ahi = spec["elastic"]["alpha"]
        d.elastic_u, d.elastic_alpha = u(6), u(7, lo=alo, hi=ahi)
        d.elastic_raw = u(8, (b, h, w, 2), -1.0, 1.0)
    if spec["motion_blur"] is not None:
        ang = spec["motion_blur"]["angle"]
        d.blur_u, d.blur_deg = u(9), u(10, lo=-ang, hi=ang)
    if spec["coarse_dropout"] is not None:
        lh, lw = _coarse_size(h, w, spec["coarse_dropout"]["size"])
        d.dropout_u, d.dropout_low, d.dropout_channel_u = u(11), u(12, (b, lh, lw, 1)), u(13)
        d.dropout_low_rgb = torch.stack([u(14 + i, (b, lh, lw, 1)) for i in range(3)])
    if spec["coarse_salt"] is not None:
        lh, lw = _coarse_size(h, w, spec["coarse_salt"]["size"])
        d.salt_u, d.salt_low = u(17), u(18, (b, lh, lw, 1))
    if spec["coarse_pepper"] is not None:
        lh, lw = _coarse_size(h, w, spec["coarse_pepper"]["size"])
        d.pepper_u, d.pepper_low = u(19), u(20, (b, lh, lw, 1))
    if spec["histeq"] is not None:
        d.histeq_u = u(21)
    if spec["clahe"] is not None:
        clo, chi = spec["clahe"]["clip"]
        d.clahe_u, d.clahe_clip = u(22), u(24, lo=clo, hi=chi)
    if spec["emboss"] is not None:
        em = spec["emboss"]
        d.emboss_u = u(23)
        d.emboss_alpha, d.emboss_strength = u(25, lo=em["alpha"][0], hi=em["alpha"][1]), u(
            26, lo=em["strength"][0], hi=em["strength"][1]
        )
    return d


@pytest.fixture()
def jax_draws():
    """``fn(jax engine, rng key, b) -> Draws``: the JAX engine's draws,
    replayable into the port's ``AugmentationEngine.apply``."""
    return _jax_draws


@pytest.fixture(scope="session")
def slice_video(tmp_path_factory) -> Path:
    """20 frames of 60x80: three batches of 8, the last one padded."""
    return _write_video(tmp_path_factory.mktemp("port_video") / "blobs.mp4", 20, 60, 80)
