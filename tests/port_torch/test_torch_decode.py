"""The port's decode (ops/decode_kernel.py, ops/softargmax.py,
data/heatmaps.py) against the JAX package's XLA decode and Pallas kernel."""

from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.data.heatmaps import (
    evaluate_heatmaps_at_location as jax_evaluate,
    generate_heatmaps,
)
from lightning_pose_tpu.ops.pallas_decode import (
    run_subpixelmaxima_pallas,
    upsample_matrix as jax_upsample_matrix,
)
from lightning_pose_tpu.ops.softargmax import run_subpixelmaxima as jax_decode
from lightning_pose_tpu_torch.data.heatmaps import evaluate_heatmaps_at_location
from lightning_pose_tpu_torch.ops import decode_kernel
from lightning_pose_tpu_torch.ops.softargmax import (
    run_subpixelmaxima,
    spatial_expectation2d,
    spatial_softmax2d,
)

# fp32 on both sides; the matmuls run in another order, and the softmax at
# temperature 1000 scales that rounding by 1000 in the logits
KP_TOL_PX = 1e-3
CONF_TOL = 1e-5


def _maps(b: int, k: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(B, h, w, K) targets of the JAX package's generate_heatmaps, at
    random keypoints of an image 4x the map size."""
    rng = np.random.default_rng(seed)
    kp = rng.uniform(0, 1, (b, k, 2)) * np.array([4 * w, 4 * h])
    return np.asarray(generate_heatmaps(jnp.asarray(kp, jnp.float32), 4 * h, 4 * w, (h, w)))


def _nchw(maps_nhwc: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(maps_nhwc.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("df", [1, 2, 3])
@pytest.mark.parametrize("size", [8, 12, 16])
def test_upsample_matrix_equals_jax(df, size):
    # numpy float64 vs jax.image.resize in float32, both rounded to float32
    np.testing.assert_allclose(
        decode_kernel.upsample_matrix(size, df), jax_upsample_matrix(size, df), rtol=0, atol=1e-6
    )


@pytest.mark.parametrize("df", [1, 2, 3])
@pytest.mark.parametrize("hw", [(16, 16), (12, 16)])
def test_plain_decode_matches_jax_decode(df, hw):
    maps = _maps(2, 3, *hw, seed=df)
    kp_ref, conf_ref = jax_decode(jnp.asarray(maps), downsample_factor=df)
    kp, conf = decode_kernel.decode_plain(_nchw(maps), df)
    assert kp.shape == (2, 6) and conf.shape == (2, 3)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_ref), rtol=0, atol=KP_TOL_PX)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_ref), rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("df", [1, 2, 3])
def test_plain_decode_matches_pallas_kernel(df):
    maps = _maps(2, 3, 16, 16, seed=10 + df)
    kp_ref, conf_ref = run_subpixelmaxima_pallas(jnp.asarray(maps), downsample_factor=df, interpret=True)
    kp, conf = decode_kernel.decode_plain(_nchw(maps), df)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_ref), rtol=0, atol=KP_TOL_PX)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_ref), rtol=0, atol=CONF_TOL)


def test_plain_decode_without_upsampling_matches_jax():
    maps = _maps(2, 3, 16, 16, seed=20)
    kp_ref, conf_ref = jax_decode(jnp.asarray(maps), downsample_factor=0)
    kp, conf = decode_kernel.decode_plain(_nchw(maps), 0)
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_ref), rtol=0, atol=KP_TOL_PX)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_ref), rtol=0, atol=CONF_TOL)


def test_fast_and_plain_paths_agree_on_cpu():
    """On a CPU tensor the fused wrapper runs the plain version, launching
    nothing."""
    hm = _nchw(_maps(2, 3, 16, 16, seed=30))
    before = decode_kernel.launches
    fast = run_subpixelmaxima(hm, 2, fast=True)
    plain = run_subpixelmaxima(hm, 2, fast=False)
    assert decode_kernel.launches == before
    for a, b in zip(fast, plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_decode_rejects_bad_input():
    with pytest.raises(ValueError):
        decode_kernel.decode(torch.zeros((2, 16, 16)), 2)
    with pytest.raises(ValueError):
        decode_kernel.decode(torch.zeros((1, 1, 16, 16)), 4)


def test_spatial_softmax_and_expectation_match_jax():
    from lightning_pose_tpu.ops.softargmax import (
        spatial_expectation2d as jax_expectation,
        spatial_softmax2d as jax_softmax,
    )

    x = np.random.default_rng(40).standard_normal((2, 6, 7, 3)).astype(np.float32)
    ref = np.asarray(jax_softmax(jnp.asarray(x), temperature=3.0))
    out = spatial_softmax2d(_nchw(x), temperature=3.0)
    np.testing.assert_allclose(out.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(
        spatial_expectation2d(out).numpy(), np.asarray(jax_expectation(jnp.asarray(ref))),
        rtol=0, atol=1e-5,
    )


def test_evaluate_heatmaps_at_location_matches_jax():
    """Including locations at and past the edges (clipped, zero outside)."""
    rng = np.random.default_rng(50)
    maps = rng.uniform(0, 1, (2, 10, 12, 4)).astype(np.float32)
    locs = np.array(
        [[[0.0, 0.0], [11.9, 9.9], [-3.2, 4.5], [5.7, 20.0]],
         [[1.5, 8.2], [6.0, 1.0], [11.0, 0.4], [14.0, -1.0]]],
        dtype=np.float32,
    )
    ref = np.asarray(jax_evaluate(jnp.asarray(maps), jnp.asarray(locs)))
    out = evaluate_heatmaps_at_location(_nchw(maps), torch.from_numpy(locs))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=1e-6)


@pytest.mark.parametrize("df", [0, 1, 2, 3])
@pytest.mark.parametrize("size", [12, 64])
def test_row_tile_bands_cover_every_nonzero(df, size):
    """The decode kernel sums over these bands only: outside them each tile
    of 4 rows must be exactly zero."""
    m = decode_kernel.upsample_matrix(size, df)
    bands = decode_kernel.row_tile_bands(m, 4)
    assert bands.shape == (-(-m.shape[0] // 4), 2)
    for t, (lo, hi) in enumerate(bands):
        tile = m[4 * t:4 * t + 4]
        assert 0 <= lo < hi <= size
        assert not tile[:, :lo].any() and not tile[:, hi:].any()
    if df == 2 and size == 64:
        assert int((bands[:, 1] - bands[:, 0]).max()) <= 9


def test_row_tile_bands_of_an_all_zero_tile_are_empty():
    m = np.zeros((6, 5), dtype=np.float32)
    m[1, 2] = 1.0
    np.testing.assert_array_equal(decode_kernel.row_tile_bands(m, 4), [[2, 3], [0, 0]])
