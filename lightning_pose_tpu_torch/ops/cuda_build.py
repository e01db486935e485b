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
from pathlib import Path

__all__ = ["BUILD_DIR", "CSRC_DIR", "NVCC_FLAGS", "load_library"]

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


def load_library(source_name: str) -> ctypes.CDLL:
    """Build ``csrc/<source_name>`` if needed and load it (cached per process)."""
    with _lock:
        if source_name in _loaded:
            return _loaded[source_name]
        src = CSRC_DIR / source_name
        key = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
        out = BUILD_DIR / f"{src.stem}-{key.hexdigest()[:16]}.so"
        if not out.is_file():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            proc = subprocess.run(cmd, capture_output=True, text=True)
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed on {src} (exit {proc.returncode}):\n"
                    f"{proc.stdout}{proc.stderr}"
                )
            os.replace(tmp, out)
        lib = ctypes.CDLL(str(out))
        _loaded[source_name] = lib
        return lib
