"""What every cell shares: finding a cell's files by the names in
``BENCHMARK.json``, and the check on what the process has imported.

A cell names a configuration (``lpbench/configs/<config>.json``) and a
traffic mix (``lpbench/mixes/<traffic>.json``); the mix names its driver
(``lpbench/drivers/<driver>.py``), the code that sets the cell up, runs its
window and checks its outputs; each per-layer metric is a reader of its own
(``lpbench/metrics/<metric>.py``); each cell's limits on what it compares
are ``lpbench/limits/<workload>.json``. A new configuration, mix, driver,
metric or cell is a new file, found by its name.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
from dataclasses import dataclass
from pathlib import Path
from types import ModuleType

__all__ = [
    "FORBIDDEN",
    "LPBENCH",
    "ROOT",
    "Cell",
    "Run",
    "card_line",
    "forbidden_modules",
    "load_cell",
    "load_module",
]

LPBENCH = Path(__file__).resolve().parent
ROOT = LPBENCH.parent
# top-level module names that may not be loaded: JAX and the JAX package
FORBIDDEN = ("jax", "jaxlib", "flax", "lightning_pose_tpu")


@dataclass
class Cell:
    """One entry of ``workloads`` with its files and metrics."""

    name: str
    chips: int
    config: dict
    mix: dict
    limits: dict
    end_to_end: list[dict]
    per_layer: list[dict]


@dataclass
class Run:
    """What a driver hands back from its window: the end-to-end metrics it
    measures (by name), counts for the per-layer readers, the attempted
    operations, and the trace of its traced stretch."""

    metrics: dict[str, float]
    counts: dict
    attempted: int
    trace: object = None


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(kind: str, name: str) -> ModuleType:
    """``lpbench/<kind>/<name>.py`` as a module (names may hold dots)."""
    path = LPBENCH / kind / f"{name}.py"
    if not path.is_file():
        raise FileNotFoundError(f"no {kind[:-1]} {name!r}: {path} is missing")
    spec = importlib.util.spec_from_file_location(f"lpbench_{kind}_{name.replace('.', '_')}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def load_cell(workload: str, benchmark_file: Path = ROOT / "BENCHMARK.json") -> Cell:
    """The cell ``workload`` of ``benchmark_file`` with its configuration,
    mix, limits and the metrics it reports."""
    bench = load_json(benchmark_file)
    entry = next((w for w in bench["workloads"] if w["name"] == workload), None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in {benchmark_file}")

    def reports(metric: dict) -> bool:
        return "workloads" not in metric or workload in metric["workloads"]

    limits_file = LPBENCH / "limits" / f"{workload}.json"
    return Cell(
        name=workload,
        chips=int(entry["chips"]),
        config=load_json(LPBENCH / "configs" / f"{entry['config']}.json"),
        mix=load_json(LPBENCH / "mixes" / f"{entry['traffic']}.json"),
        limits=load_json(limits_file) if limits_file.is_file() else {},
        end_to_end=[m for m in bench["end_to_end"] if reports(m)],
        per_layer=[m for m in bench["per_layer"] if reports(m)],
    )


def forbidden_modules() -> list[str]:
    """The loaded modules whose top-level name is one of :data:`FORBIDDEN`,
    compared as whole names (``lightning_pose_tpu_torch`` is not
    ``lightning_pose_tpu``)."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def card_line() -> str:
    """``name, power limit`` of the first card by ``nvidia-smi``."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0] if out.returncode == 0 and out.stdout.strip() else "unknown"
    except (OSError, subprocess.SubprocessError):
        return "unknown"
