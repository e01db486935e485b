"""Slice 9, the SAM encoder against the JAX package at fp32: the window
partition and its inverse (with padding), and the whole encoder's token
grid with windows that the grid does not fill (a 4x4 or 8x8 grid under
14x14 windows, zero-padded after ``ln1``, the padded tokens attended with
no mask), a global-attention block, and a position table resized in the
forward. The same seeded flax variables go to both packages through the
checkpoint bridge.

The encoder is small: width 64, 2 heads, depth 3 (blocks 0 and 1
windowed, block 2 global as in SAM's (2, 5, 8, 11))."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models.backbones import vit_sam as jsam
from lightning_pose_tpu_torch.models.backbones import vit_sam as psam

# fp32 on both sides, the same terms summed in another order: within this
# share of the largest output
REL_TOL = 1e-4

WIDTH, DEPTH, HEADS = 64, 3, 2


def _images(shape, seed=0) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("hw, window", [((4, 4), 14), ((16, 16), 14), ((6, 9), 4)])
def test_window_partition_round_trip_matches_jax(hw, window):
    x = _images((2, *hw, 5), seed=1)
    ref, ref_hw = jsam.window_partition(jnp.asarray(x), window)
    out, out_hw = psam.window_partition(torch.from_numpy(x), window)
    assert out_hw == ref_hw and np.array_equal(out.numpy(), np.asarray(ref))
    back = psam.window_unpartition(out, window, out_hw, hw)
    assert np.array_equal(back.numpy(), x)


@pytest.mark.parametrize("image, pos_grid", [(64, 4), (128, 8), (64, 5)])
def test_sam_encoder_matches_flax(seeded_jax_variables, load_flax_backbone, image, pos_grid):
    """The encoder's stride-16 grid, no final LayerNorm; at a 5x5 table the
    position rows are resized to the 4x4 grid in the forward."""
    x = _images((2, image, image, 3), seed=2)
    module = jsam.SamViT(embed_dim=WIDTH, depth=DEPTH, num_heads=HEADS, pos_grid=pos_grid)
    params = seeded_jax_variables(module, jnp.asarray(x), seed=3)["params"]
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    ported = load_flax_backbone(psam.SamViT(WIDTH, DEPTH, HEADS, pos_grid=pos_grid), params)
    assert [getattr(ported, f"block{i}").window_size for i in range(DEPTH)] == [14, 14, 0]
    with torch.no_grad():
        out = np.moveaxis(ported(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(), 1, -1)
    assert out.shape == ref.shape == (2, image // 16, image // 16, WIDTH)
    np.testing.assert_allclose(out, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())
