"""The benchmark of ``lightning_pose_tpu_torch`` on NVIDIA GPUs.

``python3 lpbench/run.py --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` once; ``lpbench/README.md`` says
how the pieces are found by name.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path

# Triton's cache and Python's bytecode: fixed directories inside the
# checkout (the port's CUDA kernels build into its own build/kernels/, its
# g++ frame ops into build/native/)
CACHE = Path(__file__).resolve().parent / ".cache"


def use_checkout_caches() -> None:
    """Compile Python's bytecode and Triton's kernels into :data:`CACHE`, so
    that every run after a checkout's first imports torch and the port and
    launches the kernels without compiling them again (even where the
    environment turns bytecode writing off). Call it before importing torch."""
    sys.pycache_prefix = str(CACHE / "pycache")
    sys.dont_write_bytecode = False
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
