"""``scripts/torch_triangulate_predictions.py`` (the port's cameras)
against ``scripts/triangulate_predictions.py`` (the JAX package's) on the
same calibration and per-view CSVs of known 3D points."""

from __future__ import annotations

import importlib.util
import subprocess
import sys
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

SCRIPTS = Path(__file__).resolve().parents[2] / "scripts"
VIEWS = ["Cam-A", "Cam-B", "Cam-C"]


def _script(name: str):
    spec = importlib.util.spec_from_file_location(name, SCRIPTS / f"{name}.py")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _rig(tmp_path: Path, n_frames: int = 6, n_kp: int = 3) -> tuple[Path, list[Path], np.ndarray]:
    """A 3-camera anipose TOML (distorted cameras 90 degrees apart) and one
    DLC CSV a camera of seeded 3D points' projections, the first camera's
    keypoint 0 at likelihood 0.5."""
    from lightning_pose_tpu_torch.utils.synthetic import project_points, synthetic_cameras, write_anipose_toml

    cameras = synthetic_cameras(3, 240, 320, seed=1)
    calib = write_anipose_toml(tmp_path / "calibration.toml", cameras, VIEWS, 240, 320)
    points = np.random.default_rng(0).uniform(-0.4, 0.4, (n_frames, n_kp, 3))
    cols = pd.MultiIndex.from_product([["m"], [f"kp{i}" for i in range(n_kp)], ["x", "y", "likelihood"]],
                                      names=["scorer", "bodyparts", "coords"])
    csvs = []
    for v, name in enumerate(VIEWS):
        likelihood = np.ones((n_frames, n_kp, 1))
        if v == 0:
            likelihood[:, 0] = 0.5
        values = np.concatenate([project_points(points, cameras, v), likelihood], axis=-1)
        csvs.append(tmp_path / f"preds_{name}.csv")
        pd.DataFrame(values.reshape(n_frames, -1), columns=cols).to_csv(csvs[-1])
    return calib, csvs, points


@pytest.mark.parametrize("thresh", [0.0, 0.9])
def test_triangulation_matches_the_jax_script(tmp_path, thresh):
    calib, csvs, points = _rig(tmp_path)
    port = _script("torch_triangulate_predictions").triangulate_csvs(calib, csvs[::-1], confidence_thresh=thresh)
    ref = _script("triangulate_predictions").triangulate_csvs(calib, csvs[::-1], confidence_thresh=thresh)
    assert list(port.columns) == list(ref.columns) and port.shape == (6, 12)
    np.testing.assert_allclose(port.to_numpy(), ref.to_numpy(), rtol=0, atol=1e-4)
    xyz = port.to_numpy().reshape(6, 3, 4)
    np.testing.assert_allclose(xyz[..., :3], points, rtol=0, atol=1e-3)
    np.testing.assert_array_equal(xyz[:, 0, 3], 2 if thresh else 3)


def test_script_runs_without_jax(tmp_path):
    """The script's command line, with JAX and the JAX package blocked."""
    calib, csvs, _ = _rig(tmp_path)
    block = ("import sys\nclass B:\n    def find_spec(self, name, path=None, target=None):\n"
             "        if name.split('.')[0] in ('jax', 'jaxlib', 'flax', 'lightning_pose_tpu'):\n"
             "            raise ImportError(name)\nsys.meta_path.insert(0, B())\n"
             f"sys.argv = ['x', {str(calib)!r}, *{[str(c) for c in csvs]!r}, '--output', {str(tmp_path / 'out.csv')!r}]\n"
             f"exec(open({str(SCRIPTS / 'torch_triangulate_predictions.py')!r}).read(), {{'__name__': '__main__'}})\n")
    out = subprocess.run([sys.executable, "-c", block], capture_output=True, text=True, timeout=120,
                         cwd=SCRIPTS.parent)
    assert out.returncode == 0, out.stderr[-2000:]
    assert pd.read_csv(tmp_path / "out.csv", header=[0, 1, 2], index_col=0).shape == (6, 12)
