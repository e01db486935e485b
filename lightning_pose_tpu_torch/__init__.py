"""lightning_pose_tpu_torch: the PyTorch/CUDA port of the JAX package
``lightning_pose_tpu``.

The JAX package is the reference; this package mirrors its module paths and
is held against it by tests that feed both the same inputs and weights. It
imports nothing of the JAX package: the host layer it needs (config, IO,
datasets, video decode, CSV writing, the native frame ops) is its own copy.
Its hand-written Hopper kernels (``csrc/`` and ``ops/*_kernel.py``) each sit
beside a plain PyTorch version, which runs on CPU tensors.
"""

import os

# the distribution's version (the two packages ship in one); the pyproject
# value for a checkout that is not installed
try:
    from importlib.metadata import version as _pkg_version

    __version__ = _pkg_version("lightning-pose-tpu")
except Exception:  # not installed
    __version__ = "0.2.0"

# Absolute path to the repository root, for the ``${LP_ROOT_PATH:}`` config
# resolver.
LP_ROOT_PATH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
