"""Build the package's CUDA sources into shared libraries with a plain C
interface, loaded with ``ctypes``.

Each source under ``csrc/`` is compiled by ``nvcc`` for ``sm_90a`` at its
first use, into ``build/kernels/<stem>-<hash>.so`` at the root of the
checkout. The hash covers the source text and the compiler flags, so an
edited source is rebuilt and an unchanged one is loaded as it is. The build
needs the CUDA toolkit (``$CUDA_HOME/bin/nvcc``, else ``nvcc`` on the
``PATH``) and raises if it fails: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "build", "load_library"]

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_loaded: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    candidate = Path(cuda_home) / "bin" / "nvcc"
    if candidate.is_file():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked in $CUDA_HOME/bin and on PATH); the CUDA "
            "kernels are built from source at first use"
        )
    return found


def _output(source_name: str) -> Path:
    src = CSRC_DIR / source_name
    key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"


def _build(source_names: tuple[str, ...]) -> dict[str, float]:
    t0 = time.perf_counter()
    seconds = {name: 0.0 for name in source_names}
    procs = {}
    for name in source_names:
        out = _output(name)
        if out.is_file():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC_DIR / name)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs[name] = (proc, tmp, out)
    failures = []
    for name, (proc, tmp, out) in procs.items():
        log = proc.communicate()[0]
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed on {CSRC_DIR / name} (exit {proc.returncode}):\n{log}")
        else:
            os.replace(tmp, out)
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build(*source_names: str) -> dict[str, float]:
    """Build those of ``csrc/<source_names>`` that are not built yet, one
    ``nvcc`` each, all started together. Returns, for each source, the
    seconds until its build was collected (0 if it was built already)."""
    with _lock:
        return _build(source_names)


def load_library(source_name: str) -> ctypes.CDLL:
    """Build ``csrc/<source_name>`` if needed and load it (cached per process)."""
    with _lock:
        if source_name not in _loaded:
            _build((source_name,))
            _loaded[source_name] = ctypes.CDLL(str(_output(source_name)))
        return _loaded[source_name]
