"""Slice 9, the SAM2 Hiera trunks against the JAX package at fp32: each
variant's stage geometry (blocks per stage, the q-pool stage changes at
the previous stage's window, the global blocks by index, the stride-32
output of 8 x the width) and its token map, from the same seeded flax
variables through the checkpoint bridge.

The trunks keep their published depths and windows with the width cut to
16 (``HIERA_CONFIGS`` set in both packages for the test), at 128 px: a
32x32 grid after the patch embedding, 4x4 at the end; the stage-2 windows
of 14 pad the 8x8 grid."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models.backbones import hiera as jhiera
from lightning_pose_tpu_torch.models.backbones import hiera as phiera

# fp32 on both sides, the same terms summed in another order: within this
# share of the largest output
REL_TOL = 1e-4

IMAGE = 128
WIDTH = 16


@pytest.fixture(autouse=True)
def narrow_hiera(monkeypatch):
    for configs in (jhiera.HIERA_CONFIGS, phiera.HIERA_CONFIGS):
        for name, config in list(configs.items()):
            monkeypatch.setitem(configs, name, dict(config, embed_dim=WIDTH))


def _geometry(module: phiera.Hiera) -> list[tuple]:
    return [(b.dim, b.dim_out, b.attn.num_heads, b.window_size, b.q_pool)
            for b in (getattr(module, f"block{i}") for i in range(module.depth))]


@pytest.mark.parametrize("name", ["vitt_sam2", "vits_sam2", "vitb_sam2"])
def test_hiera_matches_flax(seeded_jax_variables, load_flax_backbone, name):
    from lightning_pose_tpu.models.backbones.factory import make_transformer_module as jax_make
    from lightning_pose_tpu_torch.models.backbones.factory import make_transformer_module

    x = np.random.default_rng(1).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    module, features = jax_make(name, IMAGE, jnp.float32)
    params = seeded_jax_variables(module, jnp.asarray(x), seed=2)["params"]
    ref = np.asarray(jax.jit(module.apply)({"params": params}, jnp.asarray(x)))
    ported, port_features = make_transformer_module(name, IMAGE)
    ported = load_flax_backbone(ported, params)
    config = jhiera.HIERA_CONFIGS[name]
    geometry = _geometry(ported)
    assert len(geometry) == sum(config["blocks_per_stage"]) and port_features == features == 8 * WIDTH
    firsts = np.cumsum(config["blocks_per_stage"])[:-1]
    assert [i for i, g in enumerate(geometry) if g[4]] == list(firsts)  # q-pool at each stage change
    assert [i for i, g in enumerate(geometry) if g[3] == 0] == list(config["global_attention_blocks"])
    for i in firsts:  # the previous stage's window, the width doubling
        assert geometry[i][1] == 2 * geometry[i][0]
    with torch.no_grad():
        out = np.moveaxis(ported(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy(), 1, -1)
    assert out.shape == ref.shape == (2, IMAGE // 32, IMAGE // 32, 8 * WIDTH)
    np.testing.assert_allclose(out, ref, rtol=0, atol=REL_TOL * np.abs(ref).max())
