"""Slice 10, the camera geometry against the JAX package
(``lightning_pose_tpu/data/cameras.py``), in float64: distortion and its
inverse, each camera pair's triangulation, the projection, the host
``triangulate_fast`` and ``CameraGroup``, at 2, 3 and 4 views with NaN
keypoints, within 1e-9 of each output's largest entry; the ``nanmedian``
with ``jnp.nanmedian``'s even counts; and the gradients of the supervised 3D
losses with respect to the predicted keypoints against ``jax.grad``, within
1e-6 of the largest entry. The JAX package's own geometry tests
(``tests/data/test_cameras.py``) are mirrored on the port."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.data import cameras as jc
from lightning_pose_tpu_torch.data import cameras as pc

F64_REL_TOL = 1e-9
# CameraGroup holds float32 cameras, and both packages multiply K [R|t] in
# float32: two summation orders differ in the last bit of a few entries,
# which a pair 45 degrees apart turns into a few 1e-6 of the scene
GROUP_REL_TOL = 1e-5
GRAD_REL_TOL = 1e-6
# the reprojection loss sums float32 Gaussian maps (float32 in both
# packages): its value agrees to float32 summation order
MAPS_LOSS_REL_TOL = 1e-5
BATCH, KEYPOINTS, H, W = 3, 5, 240, 320


def _rig(n_views: int, seed: int = 0) -> dict:
    """Cameras around a unit scene (``utils/synthetic.synthetic_cameras``),
    as ``(V, 3, 3)``, ``(V, 3, 4)``, ``(V, 5)`` float64."""
    from lightning_pose_tpu_torch.data.anipose import rodrigues
    from lightning_pose_tpu_torch.utils.synthetic import synthetic_cameras

    cams = synthetic_cameras(n_views, H, W, span_degrees=90.0 * (n_views - 1), seed=seed)
    extrinsics = np.stack([np.concatenate([rodrigues(r), t[:, None]], axis=1)
                           for r, t in zip(cams["rotations"], cams["translations"])])
    return {"cams": cams, "intrinsics": cams["intrinsics"], "extrinsics": extrinsics,
            "distortions": cams["distortions"]}


def _batched(rig: dict, b: int = BATCH) -> list[np.ndarray]:
    return [np.ascontiguousarray(np.broadcast_to(rig[k], (b, *rig[k].shape)))
            for k in ("intrinsics", "extrinsics", "distortions")]


def _labels(rig: dict, seed: int) -> np.ndarray:
    """``(B, V, K, 2)`` projections of seeded points plus 0.5 px noise, with
    NaNs: one view of a keypoint, a keypoint in all views, one coordinate."""
    from lightning_pose_tpu_torch.utils.synthetic import project_points

    rng = np.random.default_rng(seed)
    points = rng.uniform(-0.5, 0.5, (BATCH, KEYPOINTS, 3))
    n_views = rig["intrinsics"].shape[0]
    pts = np.stack([project_points(points, rig["cams"], v) for v in range(n_views)], axis=1)
    pts = pts + rng.normal(0.0, 0.5, pts.shape)
    pts[0, 1, 2] = np.nan
    pts[1, :, 3] = np.nan
    pts[2, 0, 0, 1] = np.nan
    return pts


def _assert_close(out, ref, tol: float = F64_REL_TOL, name: str = "") -> None:
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, name
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref), err_msg=name)
    scale = np.nanmax(np.abs(ref))
    assert scale > 0, name
    np.testing.assert_allclose(np.nan_to_num(out), np.nan_to_num(ref), rtol=0, atol=tol * scale, err_msg=name)


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


@pytest.fixture()
def jitted_reference(monkeypatch):
    """The JAX package's batched geometry jitted (its host functions and
    CameraGroup call them): the same computation, compiled once instead of
    dispatched op by op."""
    monkeypatch.setattr(jc, "project_camera_pairs_to_3d", jax.jit(jc.project_camera_pairs_to_3d))
    monkeypatch.setattr(jc, "project_3d_to_2d", jax.jit(jc.project_3d_to_2d))


@pytest.mark.parametrize("n_views", [2, 3, 4])
def test_geometry_matches_jax_in_float64(n_views, jitted_reference):
    """Every function of ``cameras.py`` on the same float64 inputs: NaN
    where the JAX package gives NaN, the rest within 1e-9 of the largest
    entry. ``triangulate_fast`` takes the median over 1, 3 or 6 pairs."""
    rig = _rig(n_views, seed=n_views)
    pts = _labels(rig, seed=10 + n_views)
    cams = _batched(rig)
    with jax.enable_x64(True):
        j = [jnp.asarray(a) for a in cams]
        ref_pairs = np.asarray(jc.project_camera_pairs_to_3d(jnp.asarray(pts), *j))
        ref_fast = jc.triangulate_fast(pts, rig["intrinsics"], rig["extrinsics"], rig["distortions"])
        points_3d = np.nan_to_num(ref_fast, nan=0.1)
        ref_proj = np.asarray(jc.project_3d_to_2d(jnp.asarray(points_3d), *j))
        k0, d0 = rig["intrinsics"][0], rig["distortions"][0]
        ref_dist = np.asarray(jc.distort_points(jnp.asarray(pts[:, 0]), jnp.asarray(k0), jnp.asarray(d0)))
        ref_undist = np.asarray(jc.undistort_points(jnp.asarray(pts[:, 0]), jnp.asarray(k0), jnp.asarray(d0)))
        proj = np.asarray(jnp.asarray(rig["intrinsics"]) @ jnp.asarray(rig["extrinsics"]))
        ref_pair = np.asarray(jc.triangulate_pair(jnp.asarray(proj[0]), jnp.asarray(proj[-1]),
                                                  jnp.asarray(pts[:, 0]), jnp.asarray(pts[:, -1])))
        group = jc.CameraGroup(rig["intrinsics"], rig["extrinsics"], rig["distortions"])
        ref_group = (group.triangulate_fast(pts), np.asarray(group.triangulate_pairs(jnp.asarray(pts))),
                     np.asarray(group.project(jnp.asarray(points_3d))))

    pairs = pc.project_camera_pairs_to_3d(_t(pts), *map(_t, cams))
    assert pairs.shape == (BATCH, n_views * (n_views - 1) // 2, KEYPOINTS, 3) and pairs.dtype == torch.float64
    _assert_close(pairs, ref_pairs, name="pairs")
    _assert_close(pc.triangulate_fast(pts, rig["intrinsics"], rig["extrinsics"], rig["distortions"]), ref_fast,
                  name="triangulate_fast")
    _assert_close(pc.project_3d_to_2d(_t(points_3d), *map(_t, cams)), ref_proj, name="project")
    _assert_close(pc.distort_points(_t(pts[:, 0]), _t(k0), _t(d0)), ref_dist, name="distort")
    _assert_close(pc.undistort_points(_t(pts[:, 0]), _t(k0), _t(d0)), ref_undist, name="undistort")
    _assert_close(pc.triangulate_pair(_t(proj[0]), _t(proj[-1]), _t(pts[:, 0]), _t(pts[:, -1])), ref_pair,
                  name="triangulate_pair")
    # the port's CameraGroup holds float32 cameras, as the JAX package's
    out_group = pc.CameraGroup(rig["intrinsics"], rig["extrinsics"], rig["distortions"])
    assert out_group.num_views == n_views
    _assert_close(out_group.triangulate_fast(pts), ref_group[0], GROUP_REL_TOL, "group.triangulate_fast")
    _assert_close(out_group.triangulate_pairs(_t(pts)), ref_group[1], GROUP_REL_TOL, "group.triangulate_pairs")
    _assert_close(out_group.project(_t(points_3d)), ref_group[2], GROUP_REL_TOL, "group.project")
    # and exactly the port's functions on the float32 cameras
    cams32 = [_t(np.broadcast_to(a.astype(np.float32), (BATCH, *a.shape)))
              for a in (rig["intrinsics"], rig["extrinsics"], rig["distortions"])]
    np.testing.assert_array_equal(out_group.triangulate_pairs(_t(pts)).numpy(),
                                  pc.project_camera_pairs_to_3d(_t(pts), *cams32).numpy())


def test_nanmedian_averages_the_middle_two_as_jnp():
    """``torch.nanmedian`` gives 2.0 on ``[1, 2, 3, 4, nan]``, the port's
    helper 2.5 as ``jnp.nanmedian``; on every axis of a random array with
    NaNs (even and odd counts, an all-NaN slice) bit for bit."""
    from lightning_pose_tpu_torch.data.cameras import nanmedian

    x = torch.tensor([1.0, 2.0, 3.0, 4.0, float("nan")])
    assert float(torch.nanmedian(x)) == 2.0 and float(nanmedian(x, dim=0)) == 2.5
    rng = np.random.default_rng(0)
    a = rng.standard_normal((6, 7, 4))
    a[rng.uniform(size=a.shape) < 0.4] = np.nan
    a[0, :, 1] = np.nan
    counts = (~np.isnan(a)).sum(axis=1)
    assert (counts % 2 == 0).any() and (counts % 2 == 1).any() and (counts == 0).any()
    with jax.enable_x64(True):
        for dim in range(3):
            np.testing.assert_array_equal(nanmedian(_t(a), dim).numpy(), np.asarray(jnp.nanmedian(a, axis=dim)))


def _jax_losses(cams, heatmaps_nhwc, kp_targ_frame, bbox, nv):
    """The JAX step's 3D terms as a function of the predicted keypoints in
    model pixels (``train/trainer.py:278-307``)."""
    from lightning_pose_tpu.data import bboxes as jb
    from lightning_pose_tpu.losses.losses import PairwiseProjectionsLoss, ReprojectionHeatmapLoss

    pairwise = PairwiseProjectionsLoss(log_weight=0.0)
    reprojection = ReprojectionHeatmapLoss(128, 128, 32, 32, log_weight=0.0)

    def fn(preds):
        b = preds.shape[0]
        views = jb.model_to_frame_batch(preds, bbox, 128, 128, num_views=nv).reshape(b, nv, -1, 2)
        pred_3d = jc.project_camera_pairs_to_3d(views, *cams)
        targ_3d = jnp.nanmedian(jc.project_camera_pairs_to_3d(kp_targ_frame, *cams), axis=1)
        reproj = jc.project_3d_to_2d(jnp.mean(pred_3d, axis=1), *cams)
        reproj = jb.frame_to_model_batch(reproj.reshape(b, nv, -1, 2), bbox, 128, 128).reshape(b, -1, 2)
        lp, _ = pairwise(keypoints_targ_3d=targ_3d, keypoints_pred_3d=pred_3d)
        lr, _ = reprojection(heatmaps_targ=heatmaps_nhwc, keypoints_pred_2d_reprojected=reproj)
        return lp, lr

    return fn


@pytest.mark.parametrize("n_views", [2, 4])
def test_3d_loss_gradients_match_jax(n_views):
    """The pairwise-projection and reprojection-heatmap losses on predicted
    keypoints (model pixels of a 128 px crop of each view, mapped to the
    frame by the bboxes) against NaN-holed labels: values and gradients
    with respect to the predictions against ``jax.grad`` of the JAX step's
    composition, float64 (the reprojection's Gaussian maps are float32 in
    both packages: the reprojection loss's value within 1e-5), within 1e-6
    of the largest entry."""
    from lightning_pose_tpu_torch.data import bboxes as pb
    from lightning_pose_tpu_torch.data.heatmaps import generate_heatmaps
    from lightning_pose_tpu_torch.losses.losses import PairwiseProjectionsLoss, ReprojectionHeatmapLoss

    rig = _rig(n_views, seed=20 + n_views)
    labels = _labels(rig, seed=30 + n_views)  # (B, V, K, 2) frame pixels
    cams = _batched(rig)
    bbox = np.tile(np.array([10.0, 5.0, H - 20.0, W - 30.0]), (BATCH, n_views))
    scale = np.array([128.0 / (W - 30.0), 128.0 / (H - 20.0)])
    kp_model = (labels - np.array([10.0, 5.0])) * scale  # (B, V, K, 2)
    rng = np.random.default_rng(n_views)
    preds = np.nan_to_num(kp_model, nan=64.0) + rng.normal(0.0, 1.5, kp_model.shape)
    preds = preds.reshape(BATCH, -1)
    heatmaps = generate_heatmaps(_t(kp_model.reshape(BATCH, -1, 2)), 128, 128, (32, 32))  # (B, VK, h, w)

    with jax.enable_x64(True):
        fn = _jax_losses([jnp.asarray(c) for c in cams], jnp.asarray(heatmaps.permute(0, 2, 3, 1).numpy()),
                         jnp.asarray(labels), jnp.asarray(bbox), n_views)
        def both(p):
            values, vjp = jax.vjp(fn, p)
            ones = [jnp.ones_like(v) for v in values]
            zeros = [jnp.zeros_like(v) for v in values]
            return [(values[0], vjp((ones[0], zeros[1]))[0]), (values[1], vjp((zeros[0], ones[1]))[0])]

        ref = [(float(v), np.asarray(g)) for v, g in jax.jit(both)(jnp.asarray(preds))]

    pairwise = PairwiseProjectionsLoss(log_weight=0.0)
    reprojection = ReprojectionHeatmapLoss(128, 128, 32, 32, log_weight=0.0)
    out = []
    for i in range(2):
        x = _t(preds).requires_grad_()
        t_cams = list(map(_t, cams))
        views = pb.model_to_frame_batch(x, _t(bbox), 128, 128, num_views=n_views).reshape(BATCH, n_views, -1, 2)
        pred_3d = pc.project_camera_pairs_to_3d(views, *t_cams)
        targ_3d = pc.nanmedian(pc.project_camera_pairs_to_3d(_t(labels), *t_cams), dim=1)
        reproj = pc.project_3d_to_2d(pred_3d.mean(dim=1), *t_cams)
        reproj = pb.frame_to_model_batch(reproj, _t(bbox), 128, 128).reshape(BATCH, -1, 2)
        value = (pairwise(keypoints_targ_3d=targ_3d, keypoints_pred_3d=pred_3d)[0] if i == 0
                 else reprojection(heatmaps_targ=heatmaps, keypoints_pred_2d_reprojected=reproj)[0])
        value.backward()
        out.append((float(value.detach()), x.grad.numpy()))
    for (value, grad), (ref_value, ref_grad), name, tol in zip(out, ref, ("pairwise", "reprojection"),
                                                               (GRAD_REL_TOL, MAPS_LOSS_REL_TOL)):
        assert ref_value > 0 and np.abs(ref_grad).max() > 0, name
        np.testing.assert_allclose(value, ref_value, rtol=tol, err_msg=name)
        np.testing.assert_allclose(grad, ref_grad, rtol=0, atol=GRAD_REL_TOL * np.abs(ref_grad).max(), err_msg=name)


def test_3d_losses_raise_without_calibration():
    """Both losses raise the JAX package's ValueError when the step has no
    calibration to give them."""
    from lightning_pose_tpu_torch.losses.losses import PairwiseProjectionsLoss, ReprojectionHeatmapLoss

    with pytest.raises(ValueError, match="supervised_pairwise_projections"):
        PairwiseProjectionsLoss()(keypoints_targ_3d=None, keypoints_pred_3d=None, stage="train")
    with pytest.raises(ValueError, match="supervised_reprojection_heatmap"):
        ReprojectionHeatmapLoss(128, 128, 32, 32)(heatmaps_targ=torch.zeros(1, 2, 32, 32),
                                                  keypoints_pred_2d_reprojected=None, stage="val")


# -- the JAX package's geometry tests, on the port ---------------------------------------


def _circle_rig(n_views: int = 3):
    """``tests/data/test_cameras.py``'s rig: cameras on a circle looking at
    the origin, no distortion, float32."""
    intr, extr = [], []
    for i in range(n_views):
        angle = 2 * np.pi * i / n_views * 0.2
        k = np.array([[500.0, 0, 200], [0, 500.0, 200], [0, 0, 1]], np.float32)
        c, s = np.cos(angle), np.sin(angle)
        r = np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], np.float32)
        t = np.array([0.1 * i, 0.0, 5.0], np.float32)
        intr.append(k)
        extr.append(np.concatenate([r, t[:, None]], axis=1).astype(np.float32))
    return np.stack(intr), np.stack(extr), np.zeros((n_views, 5), np.float32)


def _project(pts3d, intr, extr):
    homog = np.concatenate([pts3d, np.ones_like(pts3d[:, :1])], axis=1)
    cam = homog @ extr.T
    xy = cam[:, :2] / cam[:, 2:3]
    return xy * [intr[0, 0], intr[1, 1]] + [intr[0, 2], intr[1, 2]]


def test_triangulation_roundtrip_and_fast(rng):
    """Exact projections triangulate back to their points in every pair
    (fp32, within 1e-2), and ``triangulate_fast`` of 2 frames too."""
    intr, extr, dist = _circle_rig(3)
    pts3d = rng.uniform(-0.5, 0.5, size=(6, 3)).astype(np.float32)
    pts2d = np.stack([_project(pts3d, intr[v], extr[v]) for v in range(3)]).astype(np.float32)
    out = pc.project_camera_pairs_to_3d(*(_t(a[None]) for a in (pts2d, intr, extr, dist))).numpy()
    assert out.shape == (1, 3, 6, 3) and out.dtype == np.float32
    for p in range(3):
        np.testing.assert_allclose(out[0, p], pts3d, atol=1e-2)
    fast = pc.triangulate_fast(np.tile(pts2d[None], (2, 1, 1, 1)), intr, extr, dist)
    assert fast.shape == (2, 6, 3)
    np.testing.assert_allclose(fast[1], pts3d, atol=1e-2)
    proj = pc.project_3d_to_2d(*(_t(a[None]) for a in (pts3d, intr, extr, dist))).numpy()[0]
    for v in range(3):
        np.testing.assert_allclose(proj[v], pts2d[v], atol=1e-2)


def test_distort_undistort_roundtrip(rng):
    intr = np.array([[500.0, 0, 200], [0, 500.0, 200], [0, 0, 1]], np.float32)
    dist = np.array([0.1, -0.05, 0.001, 0.002, 0.01], np.float32)
    pts = rng.uniform(100, 300, size=(10, 2)).astype(np.float32)
    recovered = pc.undistort_points(pc.distort_points(_t(pts), _t(intr), _t(dist)), _t(intr), _t(dist))
    np.testing.assert_allclose(recovered.numpy(), pts, atol=0.05)
