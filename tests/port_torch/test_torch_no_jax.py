"""The port imports no JAX: its whole package and its predict path run in a
subprocess where importing jax, jaxlib or flax raises."""

from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]

_BLOCK_JAX = """
import sys

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError(f"{name} is blocked in this test")

sys.meta_path.insert(0, BlockJax())
"""


def _run(code: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX + code],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def test_every_port_module_imports_without_jax():
    out = _run("""
import importlib, pkgutil, sys
import lightning_pose_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
print(len(names), "jax" in sys.modules)
""")
    count, has_jax = out.split()
    assert int(count) >= 15 and has_jax == "False"


def test_predict_path_runs_without_jax(slice_model_dir, slice_video, tmp_path):
    out = _run(f"""
import json, sys
import numpy as np
from lightning_pose_tpu_torch.api.model import Model
model = Model.from_dir({str(slice_model_dir)!r}, precision="fp32", device="cpu")
result = model.predict_on_video_file({str(slice_video)!r}, output_dir={str(tmp_path)!r})
frame = model.predict_frame(np.zeros((60, 80, 3), dtype=np.uint8))
print(json.dumps({{
    "shape": list(result.predictions.shape),
    "finite": bool(np.isfinite(result.predictions.to_numpy()).all()),
    "frame": list(frame["keypoints"].shape),
    "jax": [m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax")],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"shape": [20, 12], "finite": True, "frame": [4, 2], "jax": []}
    assert (tmp_path / "blobs.csv").is_file()
