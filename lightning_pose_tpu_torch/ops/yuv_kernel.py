"""I420 kernel: planar YUV 4:2:0 uint8 -> RGB, with three epilogues.

The JAX package converts I420 batches in plain XLA (``ops/yuv.py``), which
the TPU compiler fuses into one pass; no Pallas kernel stands behind it.
Here one hand-written CUDA kernel does that pass (``csrc/i420.cu``; its
header says what bounds it on the H100 and how it is laid out):

- normalized: ImageNet-normalized RGB in bf16 or fp32, for the predict step
  (it takes the place of the normalize kernel on the yuv420 route);
- raw: RGB float32 in [0, 255], for the unlabeled window of semi-supervised
  training before its augmentation.

The arithmetic is the plain version's (``ops/yuv.py``): BT.601 video range,
nearest-neighbour chroma, a clamp to [0, 255], then the normalization as one
FMA a channel. The kernel runs inside the registered op
``lightning_pose_tpu_torch::i420_to_rgb``, which ``torch.export`` keeps as
one node of its graph; on a CPU tensor the op runs the plain versions, on a
CUDA tensor the kernel (or it raises).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lightning_pose_tpu_torch.ops import yuv
from lightning_pose_tpu_torch.ops.cuda_build import load_library
from lightning_pose_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["i420_to_normalized", "i420_to_rgb", "launches"]

# launches of the CUDA kernel in this process; the CUDA body of the
# registered op (``_i420_op``) adds one per launch
launches = 0

_OUT_DTYPES = (torch.bfloat16, torch.float32)
# the kernel's ``epilogue`` argument (csrc/i420.cu)
_NORMALIZED_BF16, _NORMALIZED_FP32, _RGB_FP32 = 0, 1, 2
# images go on one grid axis of the launch
_MAX_IMAGES = 65535


def _bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare ``lp_i420_launch``'s C signature on a loaded build of
    ``csrc/i420.cu``."""
    lib.lp_i420_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        *[ctypes.c_float] * 6, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.lp_i420_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    return _bind(load_library("i420.cu"))


def _scale_bias() -> tuple[list[float], list[float]]:
    scale = [1.0 / (255.0 * s) for s in IMAGENET_STD]
    bias = [-m / s for m, s in zip(IMAGENET_MEAN, IMAGENET_STD)]
    return scale, bias


# the kernel as a registered PyTorch op, as ``lightning_pose_tpu_torch::
# normalize`` is: ``normalize`` picks the epilogue (True: ImageNet-normalized
# in ``out_dtype``; False: RGB in [0, 255], float32)
@torch.library.custom_op(
    "lightning_pose_tpu_torch::i420_to_rgb", mutates_args=(), device_types="cuda",
    tags=(torch.Tag.needs_fixed_stride_order,),
)
def _i420_op(yuv_uint8: torch.Tensor, out_dtype: torch.dtype, normalize: bool) -> torch.Tensor:
    global launches
    n, h, w = yuv.check_i420(yuv_uint8)
    if n > _MAX_IMAGES:
        raise ValueError(f"the I420 kernel takes at most {_MAX_IMAGES} images a launch, got {n}")
    if not normalize and out_dtype != torch.float32:
        raise ValueError(f"the I420 kernel writes raw RGB in float32, not {out_dtype}")
    out = torch.empty((n, h, w, 3), dtype=out_dtype, device=yuv_uint8.device)
    if n * h * w:
        if normalize:
            epilogue = _NORMALIZED_BF16 if out_dtype == torch.bfloat16 else _NORMALIZED_FP32
        else:
            epilogue = _RGB_FP32
        scale, bias = _scale_bias()
        err = _library().lp_i420_launch(
            yuv_uint8.data_ptr(), out.data_ptr(), n, h, w, epilogue, *scale, *bias,
            yuv_uint8.device.index, torch.cuda.current_stream(yuv_uint8.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"I420 kernel launch failed with CUDA error {err}")
        launches += 1
    return out


@_i420_op.register_kernel("cpu")
def _(yuv_uint8, out_dtype, normalize):
    if normalize:
        return yuv.i420_to_normalized_rgb(yuv_uint8, out_dtype)
    return yuv.i420_to_rgb(yuv_uint8).to(out_dtype)


@_i420_op.register_fake
def _(yuv_uint8, out_dtype, normalize):
    n, rows, w = yuv_uint8.shape
    return yuv_uint8.new_empty((n, rows * 2 // 3, w, 3), dtype=out_dtype)


def _checked(yuv_uint8: torch.Tensor) -> None:
    yuv.check_i420(yuv_uint8)
    if yuv_uint8.device.type == "cuda":
        if not yuv_uint8.is_contiguous():
            raise ValueError("the I420 kernel needs contiguous (N, H*3/2, W) batches")
    elif yuv_uint8.device.type != "cpu":
        raise ValueError(f"the I420 conversion runs on cpu or cuda, not {yuv_uint8.device}")


def i420_to_normalized(yuv_uint8: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """I420 ``(N, H*3/2, W)`` uint8 -> ImageNet-normalized ``(N, 3, H, W)``
    in ``out_dtype`` (bf16 or fp32), channels-last, as the normalize
    kernel's output. A CUDA tensor runs the kernel; a CPU tensor the plain
    version (``ops/yuv.i420_to_normalized_rgb``)."""
    if out_dtype not in _OUT_DTYPES:
        raise TypeError(f"the I420 kernel writes bf16 or fp32, not {out_dtype}")
    _checked(yuv_uint8)
    return torch.ops.lightning_pose_tpu_torch.i420_to_rgb(yuv_uint8, out_dtype, True).movedim(-1, -3)


def i420_to_rgb(yuv_uint8: torch.Tensor) -> torch.Tensor:
    """I420 ``(N, H*3/2, W)`` uint8 -> ``(N, H, W, 3)`` float32 RGB in [0,
    255]. A CUDA tensor runs the kernel; a CPU tensor the plain version
    (``ops/yuv.i420_to_rgb``)."""
    _checked(yuv_uint8)
    return torch.ops.lightning_pose_tpu_torch.i420_to_rgb(yuv_uint8, torch.float32, False)
