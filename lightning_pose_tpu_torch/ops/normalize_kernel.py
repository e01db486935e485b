"""Normalize kernel: uint8 frames -> ImageNet-normalized bf16/fp32, in Triton.

Replaces the TPU kernel ``lightning_pose_tpu/ops/pallas_preprocess.py``
(``normalize_images_pallas``, body ``_normalize_kernel``): one FMA per
element, ``u8 * scale[c] + bias[c]`` with ``scale = 1 / (255 std)`` and
``bias = -mean / std`` for channel ``c = index % 3``.

What bounds it on the H100: device-memory bandwidth. It reads 1 byte and
writes 2 (bf16) per element and does one FMA, so it is far below the
card's ratio of operations to bytes. What the design does about it: one
pass over the flat ``(B*H*W*3,)`` view in masked 1-D blocks of contiguous
bytes, with the per-channel constants picked in registers, so each byte is
read once and each output written once. It needs no shared memory and no
tensor cores, which is why it is Triton and not CUDA C++. The TPU gate on
alignment (``W*3 % 128``, ``rows % 8``) is gone: the mask covers the ragged
last block.

The output is written ``(..., H, W, 3)`` contiguous and returned as the
``(..., 3, H, W)`` permutation: for ``(B, H, W, 3)`` frames a channels-last
tensor, which the first convolution reads without a copy; multiview
``(B, V, H, W, 3)`` batches go through as they are, one launch over all
views. The kernel runs inside the registered op
``lightning_pose_tpu_torch::normalize``, which ``torch.export`` keeps as one
node of its graph and ``torch.compile`` calls as it is.
"""

from __future__ import annotations

import os

import torch

from lightning_pose_tpu_torch.ops.cuda_build import BUILD_DIR
from lightning_pose_tpu_torch.ops.preprocess import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    normalize_images,
)

__all__ = ["launches", "normalize", "normalize_plain"]

# launches of the Triton kernel in this process; the CUDA body of the
# registered op ``lightning_pose_tpu_torch::normalize`` (``_normalize_op``)
# adds one per launch, whether ``normalize`` or an exported or compiled
# graph calls the op
launches = 0

_BLOCK = 4096
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_kernel = None


def normalize_plain(
    images_uint8: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """Plain PyTorch version: the reference formula ``(x/255 - mean)/std``
    in fp32, cast to ``out_dtype``, as ``(..., 3, H, W)`` (channels-last for
    4-d input)."""
    return normalize_images(images_uint8).to(out_dtype).movedim(-1, -3)


def _scale_bias() -> tuple[list[float], list[float]]:
    scale = [1.0 / (255.0 * s) for s in IMAGENET_STD]
    bias = [-m / s for m, s in zip(IMAGENET_MEAN, IMAGENET_STD)]
    return scale, bias


def _get_kernel():
    """Define the Triton kernel at first use (Triton exists only where CUDA
    does; importing this module must not need it)."""
    global _kernel
    if _kernel is None:
        # keep Triton's compile cache inside the checkout's build directory
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def normalize_kernel(
            x_ptr, out_ptr, n,
            s0, s1, s2, b0, b1, b2,
            BLOCK: tl.constexpr,
        ):
            offs = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            mask = offs < n
            x = tl.load(x_ptr + offs, mask=mask, other=0).to(tl.float32)
            c = offs % 3
            scale = tl.where(c == 0, s0, tl.where(c == 1, s1, s2))
            bias = tl.where(c == 0, b0, tl.where(c == 1, b1, b2))
            y = x * scale + bias
            tl.store(out_ptr + offs, y.to(out_ptr.dtype.element_ty), mask=mask)

        _kernel = (triton, normalize_kernel)
    return _kernel


# the kernel as a registered PyTorch op, so that ``torch.export`` keeps it
# in its graph and ``torch.compile`` takes it without a graph break: the
# CUDA implementation is the Triton kernel, the CPU one the plain version.
# It returns the ``(..., H, W, 3)`` buffer; the wrapper takes the
# ``(..., 3, H, W)`` view outside, so that the op's output strides are the
# plain contiguous ones
@torch.library.custom_op(
    "lightning_pose_tpu_torch::normalize", mutates_args=(), device_types="cuda",
    tags=(torch.Tag.needs_fixed_stride_order,),
)
def _normalize_op(images_uint8: torch.Tensor, out_dtype: torch.dtype) -> torch.Tensor:
    global launches
    n = images_uint8.numel()
    triton, kernel = _get_kernel()
    out = torch.empty(images_uint8.shape, dtype=out_dtype, device=images_uint8.device)
    if n:
        scale, bias = _scale_bias()
        with torch.cuda.device(images_uint8.device):
            kernel[(triton.cdiv(n, _BLOCK),)](
                images_uint8, out, n, *scale, *bias, BLOCK=_BLOCK, num_warps=8,
            )
        launches += 1
    return out


@_normalize_op.register_kernel("cpu")
def _(images_uint8, out_dtype):
    return normalize_images(images_uint8).to(out_dtype)


@_normalize_op.register_fake
def _(images_uint8, out_dtype):
    return torch.empty_like(images_uint8, dtype=out_dtype, memory_format=torch.contiguous_format)


def normalize(
    images_uint8: torch.Tensor, out_dtype: torch.dtype = torch.float32
) -> torch.Tensor:
    """uint8 ``(..., H, W, 3)`` (frames ``(B, H, W, 3)``, or multiview
    ``(B, V, H, W, 3)``) -> normalized ``(..., 3, H, W)``, through the op
    ``lightning_pose_tpu_torch::normalize``.

    A CUDA tensor runs the Triton kernel; a CPU tensor runs the plain
    version (:func:`normalize_plain`'s formula). Anything else raises.
    """
    if images_uint8.dtype != torch.uint8:
        raise TypeError(f"normalize takes uint8 frames, got {images_uint8.dtype}")
    if images_uint8.ndim < 4 or images_uint8.shape[-1] != 3:
        raise ValueError(
            f"normalize takes (..., H, W, 3) frames, got {tuple(images_uint8.shape)}"
        )
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"normalize writes bf16 or fp32, not {out_dtype}")
    if images_uint8.device.type == "cuda":
        if not images_uint8.is_contiguous():
            raise ValueError("normalize needs contiguous (..., H, W, 3) frames")
        if images_uint8.numel() >= 2**31:
            raise ValueError(f"normalize indexes with int32; {images_uint8.numel()} elements is too many")
    elif images_uint8.device.type != "cpu":
        raise ValueError(f"normalize runs on cpu or cuda, not {images_uint8.device}")
    return torch.ops.lightning_pose_tpu_torch.normalize(images_uint8, out_dtype).movedim(-1, -3)
