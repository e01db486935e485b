"""The port's augmentation against the JAX package's: the warp and CLAHE
kernels' plain versions, the engine's ops, and the whole engine with the JAX
engine's draws replayed into it. Inputs are made from numpy seeds."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.ops import augment as jaug
from lightning_pose_tpu.ops.pallas_clahe import clahe_apply_pallas
from lightning_pose_tpu.ops.pallas_warp import warp_bilinear_pallas
from lightning_pose_tpu_torch.ops import augment as paug
from lightning_pose_tpu_torch.ops import clahe_kernel, warp_kernel

# fp32 against fp32: the same four taps and weights, summed in another order
WARP_TOL = 1e-3
# the TPU warp rounds the image and the weights to bf16 (tests/ops/test_pallas_warp.py)
WARP_PALLAS_TOL = 1.5
# the tile histograms are exact counts; the LUTs then differ by fp32 rounding
LUT_TOL = 1e-4
# the Pallas blend's HIGHEST-precision dots against direct gathers, fp32
CLAHE_PALLAS_TOL = 1e-2
# the JAX package's XLA CLAHE and histogram equalization round their LUTs to
# bf16 (tests/ops/test_pallas_clahe.py); the port keeps them in fp32
BF16_LUT_TOL = 1.0
OPS_TOL = 1e-5
# whole engine: keypoints within 1e-3 px; images within 1 gray level but
# for a small share of pixels, where a value within rounding of an integer
# truncates into the neighbouring histogram bin in histeq or CLAHE
KP_TOL = 1e-3
IMG_TOL = 1.0
IMG_OFF_SHARE = 2e-3


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _images(rng, shape) -> np.ndarray:
    """Smooth 0-255 images with noise, so histograms are not flat."""
    b, h, w, c = shape
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    base = 127.5 + 100 * np.sin(6 * xx + rng.uniform(0, 6, (b, 1, 1)))[..., None] * np.cos(4 * yy)[..., None]
    return np.clip(base + rng.normal(0, 20, (b, h, w, c)), 0, 255).astype(np.float32)


def _coords(rng, b, h, w, theta=0.4, jitter=8.0) -> np.ndarray:
    """Rotated pixel grid plus noise: taps fall outside the frame too."""
    ys, xs = np.meshgrid(np.arange(h, dtype=np.float32), np.arange(w, dtype=np.float32), indexing="ij")
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    px = np.cos(theta) * (xs - cx) - np.sin(theta) * (ys - cy) + cx
    py = np.sin(theta) * (xs - cx) + np.cos(theta) * (ys - cy) + cy
    coords = np.stack([np.stack([px, py], -1)] * b)
    return (coords + rng.uniform(-jitter, jitter, coords.shape)).astype(np.float32)


# -- warp -------------------------------------------------------------------------


@pytest.mark.parametrize("shape", [(2, 128, 128, 3), (2, 128, 256, 3), (3, 40, 56, 3)])
def test_warp_plain_matches_jax_gather(shape):
    rng = np.random.default_rng(shape[1] + shape[2])
    b, h, w, _ = shape
    img, coords = _images(rng, shape), _coords(rng, b, h, w)
    ref = np.asarray(jaug.grid_sample_bilinear(img, coords))
    out = warp_kernel.warp(torch.from_numpy(img), torch.from_numpy(coords))
    assert (ref == 0).any()  # taps outside the frame are exercised
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=WARP_TOL)


def test_warp_plain_matches_tpu_kernel_in_interpret_mode():
    rng = np.random.default_rng(1)
    img, coords = _images(rng, (2, 128, 128, 3)), _coords(rng, 2, 128, 128, theta=0.2)
    ref = np.asarray(warp_bilinear_pallas(img, coords, interpret=True))
    out = warp_kernel.warp_plain(torch.from_numpy(img), torch.from_numpy(coords))
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=WARP_PALLAS_TOL)


@pytest.mark.parametrize(
    "images, coords, error",
    [
        (torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 8, 3), ValueError),
        (torch.zeros(2, 8, 8, 3), torch.zeros(2, 8, 9, 2), ValueError),
        (torch.zeros(2, 8, 8, 3, dtype=torch.float64), torch.zeros(2, 8, 8, 2), TypeError),
        (torch.zeros(8, 8, 3), torch.zeros(8, 8, 2), ValueError),
    ],
)
def test_warp_rejects_what_it_does_not_take(images, coords, error):
    with pytest.raises(error):
        warp_kernel.warp(images, coords)


# -- CLAHE ---------------------------------------------------------------------------


@pytest.mark.parametrize("h, w, g", [(128, 128, 16), (128, 128, 8), (256, 128, 16)])
def test_clahe_lut_grid_matches_jax(h, w, g):
    rng = np.random.default_rng(g + h)
    x = _images(rng, (2, h, w, 3)).astype(np.int32).transpose(0, 3, 1, 2)
    clip = rng.uniform(1.0, 8.0, 2).astype(np.float32)
    ref = np.asarray(jaug._clahe_lut_grid(jnp.asarray(x), jnp.asarray(clip), g))
    out = paug._clahe_lut_grid(torch.from_numpy(x).long(), torch.from_numpy(clip), g)
    assert out.shape == (2, 3, g, g, 256)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=LUT_TOL)


@pytest.mark.parametrize("n, h, w, g", [(3, 128, 128, 8), (2, 256, 128, 16)])
def test_clahe_blend_matches_tpu_kernel_in_interpret_mode(n, h, w, g):
    rng = np.random.default_rng(n * g)
    x = rng.uniform(-2, 257, (n, h, w)).astype(np.float32)
    lut = np.sort(rng.uniform(0, 255, (n, g, g, 256)), axis=-1).astype(np.float32)
    ref = np.asarray(clahe_apply_pallas(jnp.asarray(x), jnp.asarray(lut), g, interpret=True))
    out = clahe_kernel.clahe_apply(torch.from_numpy(x), torch.from_numpy(lut), g)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=CLAHE_PALLAS_TOL)


@pytest.mark.parametrize("h, w, grid", [(128, 128, 16), (128, 256, 8), (96, 96, 16)])
def test_equalize_clahe_tiled_matches_jax(h, w, grid):
    """Tiled CLAHE end to end against the JAX package's XLA path (bf16
    LUTs); 96 px does not split into 16x16 half-blocks and takes the global
    clip-limited equalization in both."""
    rng = np.random.default_rng(h + grid)
    img = _images(rng, (2, h, w, 3))
    clip = rng.uniform(1.0, 8.0, 2).astype(np.float32)
    ref = np.asarray(jaug._equalize_clahe_tiled(jnp.asarray(img), jnp.asarray(clip), grid))
    out = paug._equalize_clahe_tiled(torch.from_numpy(img), torch.from_numpy(clip), grid)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=BF16_LUT_TOL)


@pytest.mark.parametrize(
    "x_shape, lut_shape, g, dtype, error",
    [
        ((2, 60, 64), (2, 16, 16, 256), 16, torch.float32, ValueError),  # no half-blocks
        ((2, 64, 64), (2, 1, 1, 256), 1, torch.float32, ValueError),  # no grid
        ((2, 64, 64), (2, 8, 8, 255), 8, torch.float32, ValueError),  # LUTs of another size
        ((2, 64, 64), (2, 4, 4, 256), 4, torch.float64, TypeError),
    ],
)
def test_clahe_apply_rejects_what_it_does_not_take(x_shape, lut_shape, g, dtype, error):
    with pytest.raises(error):
        clahe_kernel.clahe_apply(torch.zeros(x_shape, dtype=dtype), torch.zeros(lut_shape, dtype=dtype), g)


# -- other ops -----------------------------------------------------------------------


@pytest.mark.parametrize("clip", [False, True])
def test_equalize_hist_matches_jax(clip):
    rng = np.random.default_rng(int(clip))
    img = _images(rng, (3, 64, 96, 3))
    limit = rng.uniform(1.0, 8.0, 3).astype(np.float32) if clip else None
    ref = np.asarray(jaug._equalize_hist(jnp.asarray(img), None if limit is None else jnp.asarray(limit)))
    out = paug._equalize_hist(torch.from_numpy(img), None if limit is None else torch.from_numpy(limit))
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=BF16_LUT_TOL)


@pytest.mark.parametrize("h, w, drop, size", [(128, 128, 0.02, 0.3), (128, 128, 0.5, 0.075),
                                              (256, 256, 0.02, 0.3), (256, 192, 0.5, 0.075)])
def test_coarse_mask_equals_jax(h, w, drop, size):
    """``nearest-exact`` upsampling is ``jax.image.resize``'s nearest."""
    key = jax.random.PRNGKey(h + w)
    ref = np.asarray(jaug._coarse_mask(key, 3, h, w, drop, size))
    lh, lw = paug._coarse_size(h, w, size)
    low = torch.from_numpy(np.array(jax.random.uniform(key, (3, lh, lw, 1))))
    out = paug._coarse_mask(low, h, w, drop)
    np.testing.assert_array_equal(_np(out), ref)


def test_emboss_matches_jax():
    rng = np.random.default_rng(3)
    img = _images(rng, (3, 64, 80, 3))
    alpha = rng.uniform(0, 0.5, 3).astype(np.float32)
    strength = rng.uniform(0.5, 1.5, 3).astype(np.float32)
    ref = np.asarray(jaug._emboss(jnp.asarray(img), jnp.asarray(alpha), jnp.asarray(strength)))
    out = paug._emboss(*(torch.from_numpy(a) for a in (img, alpha, strength)))
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=OPS_TOL * 255)


@pytest.mark.parametrize("n, sigma", [(128, 5.0), (40, 2.0)])
def test_blur_band_and_separable_blur_match_jax(n, sigma):
    np.testing.assert_array_equal(paug._blur_band_matrix(n, sigma), jaug._blur_band_matrix(n, sigma))
    field = np.random.default_rng(n).uniform(-1, 1, (2, n, n + 8, 2)).astype(np.float32)
    ref = np.asarray(jaug._separable_gaussian_blur(jnp.asarray(field), sigma))
    out = paug._separable_gaussian_blur(torch.from_numpy(field), sigma)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=OPS_TOL)


def test_affine_matrices_match_jax():
    rng = np.random.default_rng(4)
    h, w = 128, 96
    theta = rng.uniform(-0.5, 0.5, 5).astype(np.float32)
    k = np.array([0, 1, 2, 3, 1])
    pct = rng.uniform(-0.15, 0.15, (5, 4)).astype(np.float32)
    flip = np.array([True, False, True, False, False])
    pairs = [
        (jaug._rotation_about_center(jnp.asarray(theta), h, w), paug._rotation_about_center(torch.from_numpy(theta), h, w)),
        (jaug._rot90_matrix(jnp.asarray(k), h, w), paug._rot90_matrix(torch.from_numpy(k), h, w)),
        (jaug._croppad_matrix(jnp.asarray(pct), h, w), paug._croppad_matrix(torch.from_numpy(pct), h, w)),
        (jaug._hflip_matrix(jnp.asarray(flip), h, w), paug._hflip_matrix(torch.from_numpy(flip), h, w)),
    ]
    for ref, out in pairs:
        np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=OPS_TOL * max(h, w))


def test_motion_blur_kernels_are_normalised_lines():
    kern = paug._motion_blur_kernels(torch.tensor([1.0, 0.0, 0.6]), torch.tensor([0.0, 1.0, 0.8]), 5)
    torch.testing.assert_close(kern.sum(dim=(1, 2)), torch.ones(3))
    torch.testing.assert_close(kern[0, 2], torch.full((5,), 0.2))  # a horizontal line
    torch.testing.assert_close(kern[1, :, 2], torch.full((5,), 0.2))  # a vertical line


# -- the whole engine ------------------------------------------------------------------

ENGINE_B, ENGINE_H, ENGINE_W, ENGINE_K = 8, 128, 128, 6
SWAP = np.array([1, 0, 2, 4, 3, 5])


def _firing_seed(jax_engine, jax_draws) -> int:
    """The first seed whose draws fire histeq, CLAHE and emboss at least
    once, and never histeq and CLAHE on one image: after the JAX package's
    histeq, whose LUT is rounded to bf16, CLAHE truncates other values into
    its bins (``test_histeq_then_clahe_differs_by_the_bf16_histeq_lut``)."""
    for seed in range(400):
        d = jax_draws(jax_engine, jax.random.PRNGKey(seed), ENGINE_B)
        he, cl, em = (d.histeq_u < 0.1), (d.clahe_u < 0.1), (d.emboss_u < 0.1)
        if he.any() and cl.any() and em.any() and not (he & cl).any():
            return seed
    raise AssertionError("no seed fires histeq, CLAHE and emboss apart")


@pytest.mark.parametrize("pipeline, hflip", [("dlc", False), ("dlc-lr", False),
                                             ("dlc-top-down", False), ("dlc", True)])
def test_engine_matches_jax_with_replayed_draws(pipeline, hflip, jax_draws):
    rng = np.random.default_rng(7)
    images = _images(rng, (ENGINE_B, ENGINE_H, ENGINE_W, 3)).round().astype(np.uint8)
    keypoints = rng.uniform(-4, 132, (ENGINE_B, ENGINE_K, 2)).astype(np.float32)
    keypoints[0, 1] = np.nan
    visibility = rng.integers(0, 3, (ENGINE_B, ENGINE_K)).astype(np.int32)
    swap = SWAP if hflip else None
    jax_engine = jaug.AugmentationEngine(pipeline, ENGINE_H, ENGINE_W, hflip=hflip, hflip_swap_indices=swap)
    port_engine = paug.AugmentationEngine(pipeline, ENGINE_H, ENGINE_W, hflip=hflip, hflip_swap_indices=swap)
    key = jax.random.PRNGKey(_firing_seed(jax_engine, jax_draws))
    ref_img, ref_kp, ref_vis = (
        np.asarray(a) for a in jax_engine(key, jnp.asarray(images), jnp.asarray(keypoints), jnp.asarray(visibility))
    )
    out_img, out_kp, out_vis = port_engine.apply(
        torch.from_numpy(images), torch.from_numpy(keypoints), torch.from_numpy(visibility),
        jax_draws(jax_engine, key, ENGINE_B),
    )
    out_img, out_kp, out_vis = _np(out_img), _np(out_kp), _np(out_vis)
    np.testing.assert_array_equal(np.isnan(out_kp), np.isnan(ref_kp))
    assert np.isnan(ref_kp).any() and not np.isnan(ref_kp).all()
    np.testing.assert_allclose(out_kp[~np.isnan(out_kp)], ref_kp[~np.isnan(ref_kp)], rtol=0, atol=KP_TOL)
    np.testing.assert_array_equal(out_vis, ref_vis)
    diff = np.abs(out_img - ref_img)
    off = float((diff > IMG_TOL).mean())
    assert off <= IMG_OFF_SHARE, f"{off:.2e} of pixels differ by more than {IMG_TOL} (largest {diff.max():.2f})"


def test_histeq_then_clahe_differs_by_the_bf16_histeq_lut():
    """Where histeq and CLAHE fire on one image, the JAX package's histeq
    output carries its bf16 LUT, and CLAHE truncates those values into other
    bins than the port's fp32 ones. Fed the same bf16-rounded histeq output,
    the two CLAHEs agree within the bf16 LUT tolerance."""
    rng = np.random.default_rng(9)
    img = _images(rng, (2, 128, 128, 3))
    clip = rng.uniform(1.0, 8.0, 2).astype(np.float32)
    ref = np.asarray(jaug._equalize_clahe_tiled(jaug._equalize_hist(jnp.asarray(img)), jnp.asarray(clip), 16))
    eq = paug._equalize_hist(torch.from_numpy(img)).to(torch.bfloat16).to(torch.float32)
    out = paug._equalize_clahe_tiled(eq, torch.from_numpy(clip), 16)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=BF16_LUT_TOL)


def test_sample_gives_every_draw_of_the_spec():
    engine = paug.AugmentationEngine("dlc-top-down", 64, 96, hflip=True, hflip_swap_indices=np.arange(3))
    d1 = engine.sample(torch.Generator().manual_seed(3), 5)
    d2 = engine.sample(torch.Generator().manual_seed(3), 5)
    for name, value in vars(d1).items():
        assert value is not None, name
        torch.testing.assert_close(value, getattr(d2, name), rtol=0, atol=0)
    assert d1.elastic_raw.shape == (5, 64, 96, 2) and d1.croppad_percents.shape == (5, 4)
    assert d1.dropout_low_rgb.shape == (3, 5, 19, 28, 1)
    assert float(d1.elastic_raw.min()) >= -1.0 and float(d1.elastic_raw.max()) < 1.0
    assert float(d1.affine_deg.abs().max()) <= 25.0
    assert set(d1.rot90_choice.tolist()) <= {0, 1, 2, 3}


def test_engine_identity_and_contract():
    images = torch.zeros(2, 64, 64, 3, dtype=torch.uint8)
    keypoints = torch.ones(2, 3, 2)
    out, kp = paug.AugmentationEngine("none", 64, 64).apply(images, keypoints)
    assert out.dtype == torch.float32 and kp is keypoints
    engine = paug.AugmentationEngine("dlc", 64, 64)
    with pytest.raises(ValueError, match="draws"):
        engine.apply(images, keypoints)
    with pytest.raises(ValueError, match="stacks"):
        engine.apply(torch.zeros(2, 2, 5, 64, 64, 3), keypoints)
    with pytest.raises(NotImplementedError):
        paug.build_spec({"Sharpen": {"p": 0.5}})


def test_build_spec_matches_jax():
    pipelines = ["dlc", "dlc-lr", "dlc-top-down", "dlc-mv", "none",
                 {"Rot90": {"p": 0.5, "kwargs": {"k": [[0, 2]]}},
                  "Affine": {"p": 0.3, "kwargs": {"rotate": [-10, 10]}},
                  "AllChannelsCLAHE": {"p": 0.2, "kwargs": {"clip_limit": [2, 4], "tiles": 8}},
                  "CoarseDropout": {"p": 0.5, "kwargs": {"p": 0.1, "size_percent": [0.1, 0.3]}},
                  "Resize": {"p": 1.0}}]
    for pipeline in pipelines:
        assert paug.build_spec(pipeline) == jaug.build_spec(pipeline)
