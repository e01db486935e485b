"""I420 kernel: planar YUV 4:2:0 uint8 -> RGB, in Triton, with two epilogues.

The JAX package converts I420 batches in plain XLA (``ops/yuv.py``), which
the TPU compiler fuses into one pass; no Pallas kernel stands behind it.
Here one hand-written kernel does that pass:

- normalized: ImageNet-normalized RGB in bf16 or fp32, for the predict step
  (it takes the place of the normalize kernel on the yuv420 route);
- raw: RGB float32 in [0, 255], for the unlabeled window of semi-supervised
  training before its augmentation.

What bounds it on the H100: device-memory bandwidth. Per pixel it reads
1.5 bytes and writes 6 (bf16) or 12 (fp32), with about twenty operations.
What the design does about it: one program takes ``BLOCK_W`` pixels of one
image row (the grid is rows of all images by blocks of a row, so the
image, row and column come from the program ids and no lane divides),
reads their Y bytes and the U and V bytes of their 2x2 chroma blocks by
plane offset (``H*W`` and ``H*W + H*W/4`` into each image), and writes
their interleaved RGB as one ``(BLOCK_W, 4)`` tile masked to 3 channels, so
each output byte is written once and each input byte read once from memory
(the chroma bytes shared by neighbouring pixels come from cache). Nothing
is reused beyond a 2x2 block and it needs neither tensor cores nor shared
memory, which is why it is Triton and not CUDA C++, as the normalize kernel
is. The arithmetic is the plain version's (``ops/yuv.py``): BT.601 video
range, nearest-neighbour chroma, a clip to [0, 255], then the
normalization as one FMA a channel. The masked fourth lane of the stored
tile leaves the 2-byte bf16 stores unvectorized: the bf16 epilogue takes
about the fp32 one's time (``scripts/torch_bench_i420.py`` times this
design against a one-pixel-a-lane grid over the flat pixel index and a
one-output-element-a-lane grid).

The kernel runs inside the registered op
``lightning_pose_tpu_torch::i420_to_rgb``; on a CPU tensor the op runs the
plain versions.
"""

from __future__ import annotations

import os

import torch

from lightning_pose_tpu_torch.ops import yuv
from lightning_pose_tpu_torch.ops.cuda_build import BUILD_DIR
from lightning_pose_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["i420_to_normalized", "i420_to_rgb", "launches"]

# launches of the Triton kernel in this process; the CUDA body of the
# registered op (``_i420_op``) adds one per launch
launches = 0

_BLOCK_W = 256
_OUT_DTYPES = (torch.bfloat16, torch.float32)
_kernel = None


def _get_kernel():
    """Define the Triton kernel at first use (Triton exists only where CUDA
    does; importing this module must not need it)."""
    global _kernel
    if _kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def i420_kernel(
            yuv_ptr, out_ptr, height, width,
            s0, s1, s2, b0, b1, b2,
            NORMALIZE: tl.constexpr, BLOCK_W: tl.constexpr,
        ):
            image_row = tl.program_id(0)  # image * height + row
            img = image_row // height
            row = image_row - img * height
            col = tl.program_id(1) * BLOCK_W + tl.arange(0, BLOCK_W)
            mask = col < width
            plane = height * width
            base = img * (plane + plane // 2)
            chroma = base + plane + (row // 2) * (width // 2) + col // 2
            y = tl.load(yuv_ptr + base + row * width + col, mask=mask, other=0).to(tl.float32)
            u = tl.load(yuv_ptr + chroma, mask=mask, other=0).to(tl.float32)
            v = tl.load(yuv_ptr + chroma + plane // 4, mask=mask, other=0).to(tl.float32)
            yp = 1.1643836 * (y - 16.0)
            up = u - 128.0
            vp = v - 128.0
            r = tl.minimum(tl.maximum(yp + 1.5960268 * vp, 0.0), 255.0)
            g = tl.minimum(tl.maximum(yp - 0.3917623 * up - 0.8129676 * vp, 0.0), 255.0)
            b = tl.minimum(tl.maximum(yp + 2.0172321 * up, 0.0), 255.0)
            c = tl.arange(0, 4)[None, :]
            rgb = tl.where(c == 0, r[:, None], tl.where(c == 1, g[:, None], b[:, None]))
            if NORMALIZE:
                scale = tl.where(c == 0, s0, tl.where(c == 1, s1, s2))
                bias = tl.where(c == 0, b0, tl.where(c == 1, b1, b2))
                rgb = rgb * scale + bias
            pix = image_row * width + col
            tl.store(out_ptr + pix[:, None] * 3 + c, rgb.to(out_ptr.dtype.element_ty),
                     mask=mask[:, None] & (c < 3))

        _kernel = (triton, i420_kernel)
    return _kernel


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
    triton, kernel = _get_kernel()
    out = torch.empty((n, h, w, 3), dtype=out_dtype, device=yuv_uint8.device)
    if n * h * w:
        scale, bias = _scale_bias()
        with torch.cuda.device(yuv_uint8.device):
            kernel[(n * h, triton.cdiv(w, _BLOCK_W))](
                yuv_uint8, out, h, w, *scale, *bias,
                NORMALIZE=normalize, BLOCK_W=_BLOCK_W, num_warps=2,
            )
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
        if yuv_uint8.numel() * 2 >= 2**31:
            raise ValueError(f"the I420 kernel indexes with int32; {yuv_uint8.numel()} input bytes is too many")
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
