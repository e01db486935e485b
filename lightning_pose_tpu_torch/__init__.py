"""lightning_pose_tpu_torch: the PyTorch/CUDA port of lightning_pose_tpu.

The JAX package ``lightning_pose_tpu`` is the reference; this package mirrors
its module paths and is held against it by tests that feed both the same
inputs and weights. Its hand-written Hopper kernels (``csrc/`` and
``ops/*_kernel.py``) each sit beside a plain PyTorch version, which runs on
CPU tensors. JAX is never imported here.
"""
