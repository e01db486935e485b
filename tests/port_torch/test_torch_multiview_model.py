"""Slice 7, the multiview transformer's modules against the JAX package's:
the torch-exact bicubic resize, the ViT's block and whole encoder (with a
resized position embedding), the multiview tracker's maps and keypoints
(fp32, the same weights through the bridge), flax's init, the bridge both
ways, the per-view bbox remap, and the patch mask with its curriculum.

The ViTs are built small (width 64, 2 heads, depth 2, 64 px: a 4x4 token
grid a view) by setting ``VIT_CONFIGS["vits"]`` in both packages for the
test."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models.backbones import vit as jvit
from lightning_pose_tpu_torch.models.backbones import vit as pvit
from lightning_pose_tpu_torch.models.factory import build_model
from lightning_pose_tpu_torch.train.checkpoints import (
    load_flax_variables,
    state_dict_from_flax,
    state_dict_to_flax,
)

IMAGE = 64
KEYPOINTS = 3
VIEWS = 2
SMALL_VIT = (64, 2, 2, 16)
# fp32 on both sides, the same terms summed in another order
MAP_TOL = 1e-4
PX_TOL = 1e-3


@pytest.fixture(autouse=True)
def small_vits(monkeypatch):
    monkeypatch.setitem(jvit.VIT_CONFIGS, "vits", SMALL_VIT)
    monkeypatch.setitem(pvit.VIT_CONFIGS, "vits", SMALL_VIT)


def _tree(variables) -> dict:
    return jax.tree_util.tree_map(np.array, variables)


def _np(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _images(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


# -- resize, block, encoder ------------------------------------------------------------


@pytest.mark.parametrize("in_hw, out_hw", [((14, 14), (16, 16)), ((16, 16), (14, 14)), ((14, 14), (8, 12))])
def test_bicubic_resize_matches_jax(in_hw, out_hw):
    """``F.interpolate`` bicubic is the JAX package's torch-exact matrices
    (a = -0.75, clamped taps), up- and downsampling."""
    from lightning_pose_tpu.ops.interpolate import bicubic_resize_2d as jax_resize
    from lightning_pose_tpu_torch.ops.interpolate import bicubic_resize_2d

    x = _images((2, *in_hw, 5))
    ref = np.asarray(jax_resize(jnp.asarray(x), out_hw))
    out = bicubic_resize_2d(torch.from_numpy(x).permute(0, 3, 1, 2), out_hw).permute(0, 2, 3, 1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=1e-5)


def test_encoder_block_matches_flax():
    """One pre-LN block (LayerNorm eps 1e-6, attention in flax's
    DenseGeneral layout at scale Dh^-0.5, exact GELU) on 20 tokens."""
    block = jvit.EncoderBlock(num_heads=2)
    x = _images((3, 20, 64))
    params = _tree(block.init(jax.random.PRNGKey(1), jnp.asarray(x)))["params"]
    for leaf in ("ln1", "ln2"):  # non-trivial LayerNorm parameters
        params[leaf]["scale"] = 1.0 + 0.1 * _images((64,), seed=2)
        params[leaf]["bias"] = 0.1 * _images((64,), seed=3)
    ref = np.asarray(block.apply({"params": params}, jnp.asarray(x)))
    ported = pvit.EncoderBlock(64, 2)
    ported.load_state_dict(state_dict_from_flax(params, {}), strict=True)
    out = _np(ported(torch.from_numpy(x)))
    np.testing.assert_allclose(out, ref, rtol=0, atol=MAP_TOL * np.abs(ref).max())


@pytest.mark.parametrize("pretrained_grid", [4, 3])
def test_vit_encoder_matches_flax(pretrained_grid):
    """The whole ViT (patch embedding, CLS token, depth 2, final LayerNorm)
    to its token grid; with a 3x3 pretrained grid the position embeddings
    are resized bicubically to the 4x4 grid of a 64 px image."""
    module = jvit.ViT(embed_dim=64, depth=2, num_heads=2, patch_size=16, pretrained_grid=pretrained_grid)
    x = _images((2, IMAGE, IMAGE, 3), seed=4)
    params = _tree(module.init(jax.random.PRNGKey(5), jnp.asarray(x)))["params"]
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    ported = pvit.ViT(embed_dim=64, depth=2, num_heads=2, patch_size=16, pretrained_grid=pretrained_grid)
    load = {k.removeprefix("backbone."): v for k, v in state_dict_from_flax({"backbone": params}, {}).items()}
    ported.load_state_dict(load, strict=True)
    out = np.moveaxis(_np(ported(torch.from_numpy(x).permute(0, 3, 1, 2))), 1, -1)
    assert out.shape == ref.shape == (2, 4, 4, 64)
    np.testing.assert_allclose(out, ref, rtol=0, atol=MAP_TOL * np.abs(ref).max())


# -- the tracker -------------------------------------------------------------------------


@pytest.fixture(scope="module")
def tracker_pair():
    """The JAX tracker's fp32 variables (its head scaled 300x so the maps
    are peaked) and the ported tracker loaded from them."""
    from lightning_pose_tpu.models.heatmap_tracker_multiview import HeatmapTrackerMultiviewTransformer

    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(jvit.VIT_CONFIGS, "vits", SMALL_VIT)
        mp.setitem(pvit.VIT_CONFIGS, "vits", SMALL_VIT)
        module = HeatmapTrackerMultiviewTransformer(
            backbone_arch="vits_dino", num_keypoints=KEYPOINTS, num_views=VIEWS, image_size=IMAGE,
            dtype=jnp.float32,
        )
        x = _images((3, VIEWS, IMAGE, IMAGE, 3), seed=6)
        params = _tree(module.init(jax.random.PRNGKey(7), jnp.asarray(x)))["params"]
        params["head"]["deconv0"]["kernel"] = params["head"]["deconv0"]["kernel"] * 300.0
        ported = build_model("heatmap_multiview", "vits_dino", KEYPOINTS, num_views=VIEWS, image_size=IMAGE)
        load_flax_variables(ported, params, {})
    return module, params, ported.eval(), x


def test_multiview_tracker_matches_flax(tracker_pair):
    """View embeddings on view i % V, one sequence of V x 16 tokens, the
    shared head per view: maps view-major (channel v*K + k) within 1e-4,
    the decode of all V*K maps within 1e-3 px."""
    module, params, ported, x = tracker_pair
    ref = np.asarray(module.apply({"params": params}, jnp.asarray(x)))
    kp_ref, conf_ref = module.decode(jnp.asarray(ref))
    with torch.no_grad():
        heatmaps = ported(torch.from_numpy(x).permute(0, 1, 4, 2, 3))
        kp, conf = ported.decode(heatmaps)
    assert heatmaps.shape == (3, VIEWS * KEYPOINTS, 16, 16) and ref.shape == (3, 16, 16, VIEWS * KEYPOINTS)
    np.testing.assert_allclose(np.moveaxis(_np(heatmaps), 1, -1), ref, rtol=0, atol=MAP_TOL)
    assert float(conf.mean()) > 0.1  # peaked maps
    np.testing.assert_allclose(_np(kp), np.asarray(kp_ref), rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(_np(conf), np.asarray(conf_ref), rtol=0, atol=1e-4)


def test_views_are_not_interchangeable(tracker_pair):
    """Swapping the two views changes the maps by more than a swap: the
    view embeddings tell the views apart."""
    _, _, ported, x = tracker_pair
    with torch.no_grad():
        a = ported(torch.from_numpy(x).permute(0, 1, 4, 2, 3))
        b = ported(torch.from_numpy(x[:, ::-1].copy()).permute(0, 1, 4, 2, 3))
    swapped = torch.cat([b[:, KEYPOINTS:], b[:, :KEYPOINTS]], dim=1)
    assert float((a - swapped).abs().max()) > 1e-6


def test_bridge_round_trip_and_keys(tracker_pair):
    """Every flax leaf maps to one torch key and back bitwise; no BatchNorm
    statistics, and no num_batches_tracked for the LayerNorms."""
    _, params, ported, _ = tracker_pair
    state = ported.state_dict()
    assert not any(k.endswith("num_batches_tracked") for k in state)
    assert len(state) == len(jax.tree_util.tree_leaves(params))
    assert state["backbone.block0.attn.query.weight"].shape == (64, 2, 32)
    assert state["backbone.block1.mlp.fc1.weight"].shape == (256, 64)
    back, stats = state_dict_to_flax(state)
    assert stats == {}
    flat = jax.tree_util.tree_flatten_with_path(params)[0]
    back_flat = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert len(back_flat) == len(flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(back_flat[path], leaf, err_msg=jax.tree_util.keystr(path))


def test_init_matches_flax_per_layer_std(monkeypatch):
    """``init_like_flax``: lecun-normal kernels with flax's fan-in (D for
    query, key, value; H*Dh for out; in for fc1, fc2; 16*16*3 for the
    patch embedding), zero biases, LayerNorm 1 and 0, normal(0.02) tokens,
    position and view embeddings. Per-layer std within 15% of the JAX
    package's init of the same shapes at width 128 (more samples)."""
    from lightning_pose_tpu.models.heatmap_tracker_multiview import HeatmapTrackerMultiviewTransformer

    monkeypatch.setitem(jvit.VIT_CONFIGS, "vits", (128, 1, 4, 16))
    monkeypatch.setitem(pvit.VIT_CONFIGS, "vits", (128, 1, 4, 16))
    module = HeatmapTrackerMultiviewTransformer(backbone_arch="vits_dino", num_keypoints=4, num_views=VIEWS,
                                                image_size=128, dtype=jnp.float32)
    ref = _tree(module.init(jax.random.PRNGKey(0), jnp.zeros((1, VIEWS, 128, 128, 3))))["params"]
    torch.manual_seed(0)
    ported = build_model("heatmap_multiview", "vits_dino", 4, num_views=VIEWS, image_size=128)
    out, _ = state_dict_to_flax(ported.state_dict())
    ref_flat = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    out_flat = dict(jax.tree_util.tree_flatten_with_path(out)[0])
    assert set(ref_flat) == set(out_flat)
    for path, r in ref_flat.items():
        o = out_flat[path]
        name = jax.tree_util.keystr(path)
        assert o.shape == r.shape, name
        if r.std() == 0:
            np.testing.assert_array_equal(o, r, err_msg=name)
        else:
            assert abs(o.std() / r.std() - 1) < 0.15, name
            assert abs(o.mean()) < 0.2 * r.std() + 1e-3, name


def test_head_at_stride_16_is_one_deconv():
    """log2(16) - 2 - 1 = 1 transposed conv, over D / 4 channels after the
    PixelShuffle."""
    model = build_model("heatmap_multiview", "vits_dino", KEYPOINTS, num_views=VIEWS, image_size=IMAGE)
    assert model.head.n_layers == 1
    assert model.head.deconv0.weight.shape == (16, KEYPOINTS, 3, 3)


@pytest.mark.parametrize("backbone, error, match", [
    ("vitt_sam2", ValueError, "not supported for multiview"),
    ("vitb_sam", ValueError, "not supported for multiview"),
    ("resnet50", ValueError, "not supported for multiview"),
])
def test_unported_backbones_raise(backbone, error, match):
    with pytest.raises(error, match=match):
        build_model("heatmap_multiview", backbone, KEYPOINTS, num_views=VIEWS)


# -- bboxes and the patch mask ---------------------------------------------------------------


def test_model_to_frame_batch_per_view_matches_jax():
    """Each view's keypoints map through its own ``[4v, 4v + 4)`` bbox
    columns, bitwise."""
    from lightning_pose_tpu.data.bboxes import model_to_frame_batch as jax_m2f
    from lightning_pose_tpu_torch.data.bboxes import model_to_frame_batch

    rng = np.random.default_rng(8)
    kp = rng.uniform(0, 128, (5, 2 * 3 * KEYPOINTS)).astype(np.float32)
    bbox = np.concatenate([rng.uniform(0, 50, (5, 2)), rng.uniform(60, 300, (5, 2))] * 3, axis=1).astype(np.float32)
    ref = np.asarray(jax_m2f(jnp.asarray(kp), jnp.asarray(bbox), 128, 128, num_views=3))
    out = model_to_frame_batch(torch.from_numpy(kp), torch.from_numpy(bbox), 128, 128, num_views=3)
    np.testing.assert_array_equal(_np(out), ref)


def test_patch_mask_ratio_schedule_matches_jax():
    """0 before the start, then a float32 linear ramp: the same floats as the
    JAX package's at every step."""
    from lightning_pose_tpu.callbacks import patch_mask_ratio as jax_ratio
    from lightning_pose_tpu_torch.callbacks import patch_mask_ratio

    for args in ((0.1, 0.5, 0, 9), (0.0, 0.5, 3, 7), (0.2, 0.5, 4, 4)):
        for step in range(12):
            ref = np.float32(jax_ratio(jnp.asarray(step, jnp.int32), *args))
            assert np.float32(patch_mask_ratio(step, *args)) == ref, (args, step)


def test_patch_mask_schedule_from_config_matches_jax():
    """``training.patch_mask`` in epochs or steps, the older
    ``callbacks.patch_masking``, and ``final_ratio`` 0 (off)."""
    from lightning_pose_tpu.train.trainer import _patch_mask_schedule as jax_schedule
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.train.trainer import _patch_mask_schedule

    settings = [
        ("training", "patch_mask", {"init_epoch": 0.5, "final_epoch": 3, "init_ratio": 0.1, "final_ratio": 0.5}),
        ("training", "patch_mask", {"init_step": 2, "final_step": 9, "init_ratio": 0.0, "final_ratio": 0.4}),
        ("training", "patch_mask", {"final_ratio": 0.0}),
        ("callbacks", "patch_masking", {"start_epoch": 1, "end_epoch": 4, "final_ratio": 0.3}),
        (None, None, None),
    ]
    for section, key, value in settings:
        cfg = load_config()
        if section:
            cfg[section][key] = value
        assert _patch_mask_schedule(cfg, 7) == jax_schedule(cfg, 7), value


@pytest.mark.parametrize("ratio", [0.0, 0.1, 0.5, 0.97, 1.0])
def test_patch_mask_matches_jax_on_its_scores(ratio):
    """The JAX package's uniform scores replayed: the same
    ``floor(ratio * 16)`` patches of each 64 px image zeroed, bitwise."""
    from lightning_pose_tpu.callbacks import apply_patch_mask as jax_mask
    from lightning_pose_tpu_torch.callbacks import apply_patch_mask

    images = np.random.default_rng(9).uniform(0, 255, (4, IMAGE, IMAGE, 3)).astype(np.float32)
    key = jax.random.PRNGKey(10)
    ref = np.asarray(jax_mask(key, jnp.asarray(images), jnp.float32(ratio)))
    scores = torch.from_numpy(np.array(jax.random.uniform(key, (4, 16))))
    out = _np(apply_patch_mask(torch.from_numpy(images), ratio, scores))
    np.testing.assert_array_equal(out, ref)
    masked = (out.reshape(4, 4, 16, 4, 16, 3) == 0).all(axis=(2, 4, 5)).sum(axis=(1, 2))
    assert (masked == int(np.floor(np.float32(ratio) * 16))).all()
