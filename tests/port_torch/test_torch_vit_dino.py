"""Slice 9, DINOv2 and DINOv3 against the JAX package: the whole encoder's
token grid at fp32 (DINOv2 at its native position grid and at a resized
one; DINOv3 single-view and as the multiview model calls it, 2 views in one
sequence with the RoPE tables tiled), the RoPE tables, and the multiview
tracker's maps with a DINOv3 trunk. The same seeded flax variables go to
both packages through the checkpoint bridge.

The encoders are small: width 64, 2 heads (head_dim 32, a multiple of 4 as
RoPE needs), depth 2, 64 px (a 4x4 token grid)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models.backbones import vit as jvit
from lightning_pose_tpu.models.backbones import vit_dino as jdino
from lightning_pose_tpu_torch.models.backbones import vit as pvit
from lightning_pose_tpu_torch.models.backbones import vit_dino as pdino

IMAGE = 64
WIDTH, DEPTH, HEADS = 64, 2, 2
# fp32 on both sides, the same terms summed in another order: within this
# share of the largest output
REL_TOL = 1e-4


def _images(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def with_layer_scales(params: dict, seed: int = 9) -> dict:
    """``params`` with every LayerScale ``lambda`` drawn uniform in [0.5,
    1.5] (the seeded fill gives them normal(0, 0.02), which would all but
    switch the blocks off)."""
    rng = np.random.default_rng(seed)

    def fill(tree):
        return {k: (rng.uniform(0.5, 1.5, v.shape).astype(np.float32) if k == "lambda" else
                    fill(v) if isinstance(v, dict) else v) for k, v in tree.items()}

    return fill(params)


def _grid(out: torch.Tensor) -> np.ndarray:
    return np.moveaxis(out.detach().numpy(), 1, -1)


def _close(out: np.ndarray, ref: np.ndarray) -> None:
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())


@pytest.mark.parametrize("pretrained_grid", [4, 3])
def test_dinov2_matches_flax(seeded_jax_variables, load_flax_backbone, pretrained_grid):
    """The DINOv2 encoder (CLS token, LayerScale on both branches, eps 1e-6)
    to its token grid; at a 3x3 pretrained grid the position rows are
    resized bicubically to the 4x4 grid of a 64 px image."""
    x = _images((2, IMAGE, IMAGE, 3), seed=1)
    module = jdino.DinoV2ViT(embed_dim=WIDTH, depth=DEPTH, num_heads=HEADS, pretrained_grid=pretrained_grid)
    params = with_layer_scales(seeded_jax_variables(module, jnp.asarray(x), seed=2)["params"])
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    ported = load_flax_backbone(pdino.DinoV2ViT(WIDTH, DEPTH, HEADS, pretrained_grid=pretrained_grid), params)
    with torch.no_grad():
        out = _grid(ported(torch.from_numpy(x).permute(0, 3, 1, 2)))
    assert ref.shape == (2, 4, 4, WIDTH)
    _close(out, ref)


def test_rope_tables_match_jax():
    """float64 numpy in both, cast to float32: bitwise, also on a
    rectangular grid."""
    for grid, hd in (((4, 4), 32), ((16, 16), 64), ((3, 5), 16)):
        for ours, theirs in zip(pdino.rope_cos_sin(grid, hd, 100.0), jdino.rope_cos_sin(grid, hd, 100.0)):
            assert ours.dtype == np.float32 and np.array_equal(ours, theirs)


def test_dinov3_matches_flax(seeded_jax_variables, load_flax_backbone):
    """The DINOv3 encoder (CLS and 4 register tokens, RoPE on the patch
    tokens only, no key bias, eps 1e-5) to its token grid."""
    x = _images((2, IMAGE, IMAGE, 3), seed=3)
    module = jdino.DinoV3ViT(embed_dim=WIDTH, depth=DEPTH, num_heads=HEADS)
    params = with_layer_scales(seeded_jax_variables(module, jnp.asarray(x), seed=4)["params"])
    assert "bias" not in params["block0"]["k_proj"]
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    ported = load_flax_backbone(pdino.DinoV3ViT(WIDTH, DEPTH, HEADS), params)
    with torch.no_grad():
        out = _grid(ported(torch.from_numpy(x).permute(0, 3, 1, 2)))
    _close(out, ref)


@pytest.mark.parametrize("family", ["dinov2", "dinov3"])
def test_multiview_sequence_matches_flax(seeded_jax_variables, load_flax_backbone, family):
    """``embed`` of 2 views then ``encode_tokens`` over their joined
    sequence of 32 tokens (DINOv3: no prefix tokens, the RoPE tables tiled
    once a view), as the multiview model calls them."""
    b, views = 2, 2
    x = _images((b * views, IMAGE, IMAGE, 3), seed=5)
    if family == "dinov2":
        module = jdino.DinoV2ViT(WIDTH, DEPTH, HEADS, pretrained_grid=4)
        ported = pdino.DinoV2ViT(WIDTH, DEPTH, HEADS, pretrained_grid=4)
    else:
        module, ported = jdino.DinoV3ViT(WIDTH, DEPTH, HEADS), pdino.DinoV3ViT(WIDTH, DEPTH, HEADS)
    params = with_layer_scales(seeded_jax_variables(module, jnp.asarray(x), seed=6)["params"])

    def joint(m, images):
        tokens, grid = m.embed(images)
        n = tokens.shape[1]
        return m.encode_tokens(tokens.reshape(b, views * n, -1), grid=grid, num_views=views)

    ref = np.asarray(jax.jit(lambda p, images: module.apply({"params": p}, images, method=joint))(params, x))
    ported = load_flax_backbone(ported, params)
    with torch.no_grad():
        out = joint(ported, torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert ref.shape == (b, views * 16, WIDTH)
    _close(out, ref)


@pytest.fixture()
def small_vits(monkeypatch):
    monkeypatch.setitem(jvit.VIT_CONFIGS, "vits", (WIDTH, DEPTH, HEADS, 16))
    monkeypatch.setitem(pvit.VIT_CONFIGS, "vits", (WIDTH, DEPTH, HEADS, 16))


@pytest.mark.parametrize("backbone", ["vits_dinov2", "vits_dinov3"])
def test_multiview_tracker_matches_flax(seeded_jax_variables, small_vits, backbone):
    """The multiview tracker's view-major maps with a DINOv2 or DINOv3
    trunk: view embeddings, the joint sequence, the shared head."""
    from lightning_pose_tpu.models.heatmap_tracker_multiview import HeatmapTrackerMultiviewTransformer
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables

    x = _images((2, 2, IMAGE, IMAGE, 3), seed=7)
    module = HeatmapTrackerMultiviewTransformer(backbone_arch=backbone, num_keypoints=3, num_views=2,
                                                image_size=IMAGE, dtype=jnp.float32)
    params = with_layer_scales(seeded_jax_variables(module, jnp.asarray(x), seed=8)["params"])
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    model = build_model("heatmap_multiview", backbone, 3, num_views=2, image_size=IMAGE).eval()
    load_flax_variables(model, params, {})
    with torch.no_grad():
        out = _grid(model(torch.from_numpy(x).permute(0, 1, 4, 2, 3)))
    assert ref.shape == (2, 16, 16, 6)
    _close(out, ref)
