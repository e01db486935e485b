"""Slice 10, the 3D augmentation against the JAX package
(``lightning_pose_tpu/ops/augment3d.py``): the similarity fit with its
degenerate cases, and ``apply`` with the JAX draws replayed (threefry keys
cannot be replayed by ``torch.Generator``), fp32 in both packages, the JAX
warp through its CPU path: keypoints within 1e-4 model px (without a
frame-to-model crop they stay in the 320 px frame, and the bound scales by
320 / 48 to the same relative precision), each warp's sampling
coordinates within 5e-4 px of the JAX package's, the port's warp at the JAX
package's coordinates within 1e-3 gray of its images, and the port's images
within 1e-3 gray plus what the coordinates' difference can move them (the
image's largest gradient times 5e-4 px). The skip cases of the JAX
package's tests (``tests/data/test_cameras.py``) are mirrored: all labels
NaN, fewer than 3 triangulated keypoints, views whose valid keypoints do not
overlap.

The coordinates differ by the fp32 rounding of the similarity fits' sums
(two reduction orders): 1.4e-4 px measured with the fit in frame pixels,
2.7e-5 px in model pixels; the keypoints by the fp32 triangulation (two
LAPACK builds): 1.4e-4 frame px, 3.1e-5 model px (CPU, this file's
inputs)."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.ops import augment3d as jaug
from lightning_pose_tpu_torch.ops import augment3d as paug

GRAY_TOL = 1e-3
PX_TOL = 1e-4
COORD_TOL = 5e-4
H = W = 48
FRAME_H, FRAME_W = 240, 320


def _rig(n_views: int, b: int, seed: int = 0) -> tuple[np.ndarray, ...]:
    """``synthetic_cameras`` of ``n_views`` views for ``b`` samples, float32."""
    from lightning_pose_tpu_torch.data.anipose import rodrigues
    from lightning_pose_tpu_torch.utils.synthetic import synthetic_cameras

    cams = synthetic_cameras(n_views, FRAME_H, FRAME_W, span_degrees=90.0 * (n_views - 1), seed=seed)
    extr = np.stack([np.concatenate([rodrigues(r), t[:, None]], axis=1)
                     for r, t in zip(cams["rotations"], cams["translations"])])
    return tuple(np.broadcast_to(a.astype(np.float32), (b, *a.shape)).copy()
                 for a in (cams["intrinsics"], extr, cams["distortions"])) + (cams,)


def _labels(cams: dict, n_views: int, b: int, k: int, seed: int) -> np.ndarray:
    """``(B, V*K, 2)`` view-major frame pixels of seeded 3D points."""
    from lightning_pose_tpu_torch.utils.synthetic import project_points

    points = np.random.default_rng(seed).uniform(-0.5, 0.5, (b, k, 3))
    return np.concatenate([project_points(points, cams, v) for v in range(n_views)], axis=1).astype(np.float32)


def _smooth_images(shape, seed: int) -> np.ndarray:
    """``(B, V, H, W, 3)`` 0-255 images: blobs on slow gradients."""
    rng = np.random.default_rng(seed)
    b, v, h, w, _ = shape
    yy, xx = np.mgrid[0:h, 0:w] / max(h, w)
    out = np.zeros(shape)
    for i in np.ndindex(b, v):
        img = 40 + 40 * np.sin(2 * np.pi * (rng.uniform(0.5, 1.5) * xx + rng.uniform(0.5, 1.5) * yy))[..., None]
        for _ in range(4):
            cx, cy, s = rng.uniform(0.1, 0.9), rng.uniform(0.1, 0.9), rng.uniform(0.05, 0.15)
            img = img + rng.uniform(50, 150, 3) * np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / (2 * s**2))[..., None]
        out[i] = img
    return np.clip(out, 0, 255).astype(np.float32)


def _frame_to_model(b: int, n_views: int) -> np.ndarray:
    """Per-view crops of the frame resized to the model's 48 px, as the
    train step builds them from the bboxes."""
    rng = np.random.default_rng(1)
    f2m = np.zeros((b, n_views, 3, 3), np.float32)
    x0, y0 = rng.uniform(0, 20, (b, n_views)), rng.uniform(0, 15, (b, n_views))
    f2m[..., 0, 0], f2m[..., 1, 1] = W / (FRAME_W - 30), H / (FRAME_H - 20)
    f2m[..., 0, 2], f2m[..., 1, 2] = -x0 * f2m[..., 0, 0], -y0 * f2m[..., 1, 1]
    f2m[..., 2, 2] = 1.0
    return f2m


def _jax_draws(key, b: int, scale_range=(0.8, 1.2)) -> paug.Draws3D:
    """The JAX function's draws from ``key`` (its split and uniform calls)."""
    key_s, key_t, key_p = jax.random.split(key, 3)
    u = jax.random.uniform(key_p, (b,))
    scale = jax.random.uniform(key_s, (b, 1, 1), minval=scale_range[0], maxval=scale_range[1])
    translate = jax.random.uniform(key_t, (b, 1, 3), minval=-1.0, maxval=1.0)
    return paug.Draws3D(apply_u=torch.from_numpy(np.array(u)), scale=torch.from_numpy(np.array(scale)).reshape(b),
                        translate=torch.from_numpy(np.array(translate)).reshape(b, 3))


@pytest.fixture(autouse=True)
def warp_coords(monkeypatch) -> dict:
    """The coordinates each package's apply hands its warp, recorded."""
    recorded = {}
    jax_warp, port_warp = jaug.warp_bilinear, paug.warp

    def jax_recorder(images, coords):
        recorded["jax"] = np.asarray(coords)
        return jax_warp(images, coords)

    def port_recorder(images, coords):
        recorded["port"] = coords.numpy().copy()
        return port_warp(images, coords)

    monkeypatch.setattr(jaug, "warp_bilinear", jax_recorder)
    monkeypatch.setattr(paug, "warp", port_recorder)
    return recorded


def _both(images, kp, cams, key, f2m=None, **kwargs):
    """The JAX function and the port's apply on the same inputs and draws."""
    intr, extr, dist = cams[:3]
    ref_images, ref_kp = jaug.apply_3d_transforms(
        key, *(jnp.asarray(a) for a in (images, kp, intr, extr, dist)),
        frame_to_model=None if f2m is None else jnp.asarray(f2m), **kwargs)
    draws = _jax_draws(key, images.shape[0], kwargs.get("scale_range", (0.8, 1.2)))
    out_images, out_kp = paug.apply(
        *(torch.from_numpy(a) for a in (images, kp, intr, extr, dist)), draws,
        frame_to_model=None if f2m is None else torch.from_numpy(f2m),
        translate_range=kwargs.get("translate_range", 0.1), apply_prob=kwargs.get("apply_prob", 0.5))
    return (out_images.numpy(), out_kp.numpy()), (np.asarray(ref_images), np.asarray(ref_kp)), draws


def _assert_same(out, ref, coords: dict, draws, inputs, apply_prob: float, px_tol: float = PX_TOL) -> None:
    """Keypoints; the warp's coordinates; the port's warp at the JAX
    package's coordinates; the images within what the coordinates' rounding
    can move them."""
    from lightning_pose_tpu_torch.ops.warp_kernel import warp_plain

    (images, kp), (ref_images, ref_kp) = out, ref
    np.testing.assert_array_equal(np.isnan(kp), np.isnan(ref_kp))
    np.testing.assert_allclose(np.nan_to_num(kp), np.nan_to_num(ref_kp), rtol=0, atol=px_tol)
    jax_coords = coords["jax"].reshape(coords["port"].shape)
    np.testing.assert_allclose(coords["port"], jax_coords, rtol=0, atol=COORD_TOL)
    applied = (draws.apply_u.numpy() < apply_prob)[:, None, None, None, None]
    flat = torch.from_numpy(inputs.reshape(-1, *inputs.shape[2:]))
    at_jax = warp_plain(flat, torch.from_numpy(jax_coords.copy())).numpy().reshape(inputs.shape)
    np.testing.assert_allclose(np.where(applied, at_jax, inputs), ref_images, rtol=0, atol=GRAY_TOL)
    gradient = max(np.abs(np.diff(inputs, axis=2)).max(), np.abs(np.diff(inputs, axis=3)).max())
    np.testing.assert_allclose(images, ref_images, rtol=0, atol=GRAY_TOL + gradient * COORD_TOL)


def test_fit_similarity_transform_matches_jax(rng):
    """Batched fits of random similarities with NaN pairs (the JAX function
    one by one), and the degenerate fits: no or one valid pair, coincident
    points -> the identity."""
    src = rng.uniform(0, 100, (2, 3, 8, 2)).astype(np.float32)
    theta, scale = rng.uniform(-0.5, 0.5, (2, 3)), rng.uniform(0.8, 1.2, (2, 3))
    rot = scale[..., None, None] * np.stack([np.stack([np.cos(theta), -np.sin(theta)], -1),
                                             np.stack([np.sin(theta), np.cos(theta)], -1)], -2)
    dst = (np.einsum("bvij,bvkj->bvki", rot, src) + rng.uniform(-5, 5, (2, 3, 1, 2))).astype(np.float32)
    dst += rng.normal(0, 0.3, dst.shape).astype(np.float32)
    src[0, 1, :3] = np.nan
    dst[1, 2, 5] = np.nan
    src[1, 0, :7] = np.nan  # one valid pair
    src[0, 2] = 7.0  # coincident
    src[1, 1, :, 0] = np.nan  # none valid
    out = paug.fit_similarity_transform(torch.from_numpy(src), torch.from_numpy(dst)).numpy()
    ref = np.stack([np.stack([np.asarray(jaug.fit_similarity_transform(jnp.asarray(src[b, v]), jnp.asarray(dst[b, v])))
                              for v in range(3)]) for b in range(2)])
    np.testing.assert_allclose(out, ref, rtol=1e-5, atol=1e-4)
    for b, v in ((1, 0), (0, 2), (1, 1)):
        np.testing.assert_array_equal(out[b, v], np.eye(3, dtype=np.float32))
    assert not np.allclose(out[0, 0], np.eye(3), atol=1e-3)


@pytest.mark.parametrize("n_views,with_crop", [(2, True), (3, True), (2, False)])
def test_apply_matches_jax_with_replayed_draws(n_views, with_crop, warp_coords):
    """8 samples (some labels NaN, the apply flag drawn at p = 0.7), the
    frame-to-model crops or the identity: the warped images, the moved
    keypoints in model pixels and the untouched samples as the JAX
    function gives them."""
    b, k = 8, 6
    cams = _rig(n_views, b, seed=n_views)
    kp = _labels(cams[3], n_views, b, k, seed=n_views)
    kp[1, :2] = np.nan
    kp[2, k + 3] = np.nan
    f2m = _frame_to_model(b, n_views) if with_crop else None
    images = _smooth_images((b, n_views, H, W, 3), seed=n_views)
    key = jax.random.PRNGKey(10 + n_views)
    out, ref, draws = _both(images, kp, cams, key, f2m, apply_prob=0.7)
    applied = draws.apply_u.numpy() < 0.7
    assert 0 < applied.sum() < b
    _assert_same(out, ref, warp_coords, draws, images, 0.7, PX_TOL if with_crop else PX_TOL * FRAME_W / W)
    assert np.abs(out[0][applied] - images[applied]).max() > 10  # warped
    np.testing.assert_array_equal(out[0][~applied], images[~applied])


@pytest.mark.parametrize("case", ["all_nan", "under_3_valid", "mismatched_views"])
def test_skip_cases_match_jax(case, warp_coords):
    """Samples the JAX package leaves unaugmented (the apply flag forced
    off): the images as they came, the keypoints unmoved and NaN where the
    labels are NaN, in both packages."""
    n_views, b, k = 2, 1, 6
    cams = _rig(n_views, b)
    kp = _labels(cams[3], n_views, b, k, seed=3)
    if case == "all_nan":
        kp[:] = np.nan
    elif case == "under_3_valid":
        kp[:, 2:k] = np.nan
        kp[:, k + 2:] = np.nan
    else:  # view 0 labels keypoints 0-2, view 1 keypoints 3-5
        kp[:, 3:k] = np.nan
        kp[:, k:k + 3] = np.nan
    images = _smooth_images((b, n_views, H, W, 3), seed=4)
    out, ref, draws = _both(images, kp, cams, jax.random.PRNGKey(11), scale_range=(0.5, 0.5), translate_range=0.5,
                            apply_prob=1.0)
    assert float(draws.apply_u[0]) < 1.0  # drawn to apply, forced off
    (images_out, kp_out), (ref_images, ref_kp) = out, ref
    np.testing.assert_array_equal(ref_images, images)
    np.testing.assert_array_equal(np.isnan(kp_out), np.isnan(ref_kp))
    np.testing.assert_allclose(np.nan_to_num(kp_out), np.nan_to_num(ref_kp), rtol=0, atol=PX_TOL)
    np.testing.assert_array_equal(out[0], images)
    valid = ~np.isnan(kp)
    np.testing.assert_allclose(out[1][valid], kp[valid], atol=1e-3)


def test_identity_draws_keep_the_keypoints():
    """Scale 1 and no translation reproject the labels onto themselves
    (their triangulation is exact), mapped to model pixels by the crop."""
    n_views, b, k = 2, 2, 5
    cams = _rig(n_views, b)
    kp = _labels(cams[3], n_views, b, k, seed=5)
    f2m = _frame_to_model(b, n_views)
    draws = paug.Draws3D(apply_u=torch.zeros(b), scale=torch.ones(b), translate=torch.zeros(b, 3))
    images = _smooth_images((b, n_views, H, W, 3), seed=6)
    out_images, out_kp = paug.apply(*(torch.from_numpy(a) for a in (images, kp, *cams[:3])), draws,
                                    frame_to_model=torch.from_numpy(f2m))
    expected = np.einsum("bvij,bvkj->bvki", f2m, np.concatenate(
        [kp.reshape(b, n_views, k, 2), np.ones((b, n_views, k, 1), np.float32)], -1))[..., :2]
    np.testing.assert_allclose(out_kp.numpy().reshape(b, n_views, k, 2), expected, atol=1e-2)
    np.testing.assert_allclose(out_images.numpy(), images, atol=0.5)


def test_sample_draws():
    """One generator call order: the apply uniforms, the scales in the
    range, the translations in [-1, 1); the same seed gives the same
    draws."""
    d1 = paug.sample(torch.Generator().manual_seed(0), 64, (0.8, 1.2))
    d2 = paug.sample(torch.Generator().manual_seed(0), 64, (0.8, 1.2))
    for name in ("apply_u", "scale", "translate"):
        torch.testing.assert_close(getattr(d1, name), getattr(d2, name), rtol=0, atol=0)
    assert d1.apply_u.shape == (64,) and d1.scale.shape == (64,) and d1.translate.shape == (64, 3)
    assert 0 <= float(d1.apply_u.min()) and float(d1.apply_u.max()) < 1
    assert 0.8 <= float(d1.scale.min()) and float(d1.scale.max()) < 1.2
    assert -1 <= float(d1.translate.min()) and float(d1.translate.max()) < 1
