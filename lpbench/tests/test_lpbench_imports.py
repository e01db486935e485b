"""What the benchmark may import: nothing of JAX or of the JAX package
anywhere (top-level names compared whole, since ``lightning_pose_tpu_torch``
begins with ``lightning_pose_tpu``), and nothing of the program in the
reference."""

from __future__ import annotations

import ast
import subprocess
import sys
from pathlib import Path

import pytest

from lpbench import harness

LPBENCH = harness.LPBENCH
SOURCES = sorted(p for p in LPBENCH.rglob("*.py") if ".cache" not in p.parts)


def _imported_top_names(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(LPBENCH)))
def test_no_source_imports_jax_or_the_jax_package(path):
    assert not _imported_top_names(path) & set(harness.FORBIDDEN)


@pytest.mark.parametrize("path", sorted((LPBENCH / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_program(path):
    names = _imported_top_names(path)
    assert "lightning_pose_tpu_torch" not in names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("lpbench"):
            assert node.module.startswith("lpbench.reference")


def test_whole_names_are_compared(monkeypatch):
    monkeypatch.setitem(sys.modules, "lightning_pose_tpu_torch_fake", object())
    assert "lightning_pose_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "lightning_pose_tpu.fake", object())
    assert "lightning_pose_tpu.fake" in harness.forbidden_modules()


def test_loading_every_module_loads_no_jax():
    """In a fresh process: every module of the benchmark, every driver and
    metric by name, and the program's modules that the drivers call."""
    code = f"""
import sys
sys.path.insert(0, {str(harness.ROOT)!r})
import importlib, pkgutil
from pathlib import Path
from lpbench import harness
import lpbench
for m in pkgutil.walk_packages(lpbench.__path__, "lpbench."):
    if ".tests" not in m.name:
        importlib.import_module(m.name)
for kind in ("drivers", "metrics"):
    for p in (harness.LPBENCH / kind).glob("*.py"):
        harness.load_module(kind, p.stem)
import lightning_pose_tpu_torch.api.model, lightning_pose_tpu_torch.train.checkpoints
print(harness.forbidden_modules())
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"


def test_reference_alone_loads_nothing_of_the_program():
    code = f"""
import sys
sys.path.insert(0, {str(harness.ROOT)!r})
import lpbench.reference.model, lpbench.reference.video
print(sorted(m for m in sys.modules if m.split(".")[0] in ("lightning_pose_tpu_torch", "jax", "flax")))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
