"""Slice 10, the anipose calibration format against the JAX package: the
port's own copy of ``rodrigues`` and ``load_anipose_toml`` bit for bit
(short and long distortion lists, ``cam_N`` sections out of order), and the
synthetic calibration that ``utils/synthetic.py`` writes read back as the
cameras it was made from."""

from __future__ import annotations

import numpy as np
import pytest

# the JAX package's test calibration (tests/data/test_anipose.py): a short
# distortion list in the second camera
_TOML = """
[cam_0]
name = "top"
size = [ 396, 168,]
matrix = [ [ 400.0, 0.0, 198.0,], [ 0.0, 400.0, 84.0,], [ 0.0, 0.0, 1.0,],]
distortions = [ -0.05, 0.01, 0.0, 0.0, 0.0,]
rotation = [ 0.01, -0.02, 0.005,]
translation = [ 0.5, -0.2, 10.0,]

[cam_1]
name = "bot"
size = [ 396, 238,]
matrix = [ [ 410.0, 0.0, 198.0,], [ 0.0, 410.0, 119.0,], [ 0.0, 0.0, 1.0,],]
distortions = [ -0.04,]
rotation = [ 1.2, 0.1, -0.3,]
translation = [ -0.4, 0.3, 9.5,]

[metadata]
adjusted = true
error = 0.31
"""

# sections out of order (cam_10 after cam_2 numerically, written first), a
# distortion list longer than 5, a camera without distortions or name
_TOML_UNORDERED = """
[metadata]
error = 0.5

[cam_10]
name = "c"
matrix = [ [ 500.0, 0.0, 160.0,], [ 0.0, 505.0, 120.0,], [ 0.0, 0.0, 1.0,],]
distortions = [ 0.1, -0.02, 0.001, 0.002, 0.003, 0.5, 0.6,]
rotation = [ 0.0, 0.0, 0.0,]
translation = [ 0.0, 0.0, 5.0,]

[cam_2]
name = "b"
matrix = [ [ 450.0, 0.0, 150.0,], [ 0.0, 450.0, 110.0,], [ 0.0, 0.0, 1.0,],]
rotation = [ 0.3, 2.9, -0.1,]
translation = [ 1.0, -0.5, 6.0,]

[cam_0]
matrix = [ [ 480.0, 0.0, 155.0,], [ 0.0, 470.0, 115.0,], [ 0.0, 0.0, 1.0,],]
distortions = [ -0.03, 0.004,]
rotation = [ -0.2, 0.7, 0.05,]
translation = [ -1.0, 0.25, 5.5,]
"""


def test_rodrigues_matches_jax_and_cv2(rng):
    """Bit for bit the JAX package's, and cv2's within 1e-10; the zero
    vector gives the identity."""
    import cv2

    from lightning_pose_tpu.data.anipose import rodrigues as jax_rodrigues
    from lightning_pose_tpu_torch.data.anipose import rodrigues

    for rvec in list(rng.normal(size=(6, 3))) + [np.zeros(3), np.array([1e-13, 0.0, 0.0]), np.array([0, np.pi, 0])]:
        np.testing.assert_array_equal(rodrigues(rvec), jax_rodrigues(rvec))
        np.testing.assert_allclose(rodrigues(rvec), cv2.Rodrigues(np.asarray(rvec, np.float64))[0], atol=1e-10)


@pytest.mark.parametrize("text", [_TOML, _TOML_UNORDERED], ids=["jax-template", "unordered"])
def test_load_anipose_toml_matches_jax(tmp_path, text):
    """Names in numeric ``cam_N`` order, distortions padded or truncated to
    5, extrinsics ``[R | t]``: the same float32 arrays as the JAX
    package's."""
    from lightning_pose_tpu.data.anipose import load_anipose_toml as jax_load
    from lightning_pose_tpu_torch.data.anipose import load_anipose_toml

    path = tmp_path / "calibration.toml"
    path.write_text(text)
    out, ref = load_anipose_toml(str(path)), jax_load(str(path))
    assert out["names"] == ref["names"]
    for key in ("intrinsics", "extrinsics", "distortions"):
        assert out[key].dtype == np.float32
        np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
    if text is _TOML_UNORDERED:
        assert out["names"] == ["cam_0", "b", "c"]
        np.testing.assert_array_equal(out["distortions"][0], np.float32([-0.03, 0.004, 0, 0, 0]))
        np.testing.assert_array_equal(out["distortions"][1], np.zeros(5, np.float32))
        np.testing.assert_array_equal(out["distortions"][2], np.float32([0.1, -0.02, 0.001, 0.002, 0.003]))
    else:
        np.testing.assert_array_equal(out["distortions"][1], np.float32([-0.04, 0, 0, 0, 0]))


def test_load_anipose_toml_without_cameras_raises(tmp_path):
    from lightning_pose_tpu_torch.data.anipose import load_anipose_toml

    path = tmp_path / "empty.toml"
    path.write_text("[metadata]\nerror = 0.1\n")
    with pytest.raises(ValueError, match="cam_N"):
        load_anipose_toml(str(path))


@pytest.mark.parametrize("n_views", [2, 4])
def test_synthetic_calibration_reads_back(tmp_path, n_views):
    """``write_anipose_toml`` of ``synthetic_cameras`` reads back (in both
    packages) as those cameras in float32, and ``project_points`` is the
    port's ``project_3d_to_2d`` on them within 1e-9 px (float64)."""
    import torch

    from lightning_pose_tpu.data.anipose import load_anipose_toml as jax_load
    from lightning_pose_tpu_torch.data.anipose import load_anipose_toml, rodrigues
    from lightning_pose_tpu_torch.data.cameras import project_3d_to_2d
    from lightning_pose_tpu_torch.utils.synthetic import project_points, synthetic_cameras, write_anipose_toml

    cams = synthetic_cameras(n_views, 240, 320, span_degrees=270.0, seed=n_views)
    names = [f"view{v}" for v in range(n_views)]
    path = write_anipose_toml(tmp_path / "calibrations" / "s.toml", cams, names, 240, 320)
    out, ref = load_anipose_toml(str(path)), jax_load(str(path))
    extrinsics = np.stack([np.concatenate([rodrigues(r), t[:, None]], axis=1)
                           for r, t in zip(cams["rotations"], cams["translations"])])
    assert out["names"] == ref["names"] == names
    np.testing.assert_array_equal(out["intrinsics"], cams["intrinsics"].astype(np.float32))
    np.testing.assert_array_equal(out["extrinsics"], extrinsics.astype(np.float32))
    np.testing.assert_array_equal(out["distortions"], cams["distortions"].astype(np.float32))
    for key in ("intrinsics", "extrinsics", "distortions"):
        np.testing.assert_array_equal(out[key], ref[key])

    points = np.random.default_rng(0).uniform(-0.5, 0.5, (3, 5, 3))
    expected = np.stack([project_points(points, cams, v) for v in range(n_views)], axis=1)
    cameras = [torch.from_numpy(np.broadcast_to(a, (3, *a.shape)).copy())
               for a in (cams["intrinsics"], extrinsics, cams["distortions"])]
    projected = project_3d_to_2d(torch.from_numpy(points), *cameras).numpy()
    np.testing.assert_allclose(projected, expected, rtol=0, atol=1e-9)
    assert (expected > 0).all() and (expected[..., 0] < 320).all() and (expected[..., 1] < 240).all()
