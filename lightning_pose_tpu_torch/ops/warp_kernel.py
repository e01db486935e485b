"""Warp kernel: bilinear sampling of images at per-pixel coordinates, in Triton.

Replaces the TPU kernel ``lightning_pose_tpu/ops/pallas_warp.py``
(``warp_bilinear_pallas``, body ``_warp_kernel``). It computes what the
reference's ``grid_sample_bilinear`` (``lightning_pose_tpu/ops/augment.py:50-82``)
computes: for every output pixel, floor the (x, y) coordinate, form the four
bilinear weights in fp32, read the four neighbouring pixels of each channel
(zero outside the frame) and sum them in the reference's order

    v00 (1-wx)(1-wy) + v01 wx (1-wy) + v10 (1-wx) wy + v11 wx wy.

The TPU kernel did this as one-hot row-weight matmuls over a row window, with
the image and weights rounded to bf16, because a TPU gathers one element at a
time. A GPU gathers natively, so none of that is carried over: there is no
row window, no bf16 rounding, and no multiple-of-128 gate on H and W.

What bounds it on the H100: device-memory traffic and the latency of the
gathered loads. Per output pixel it reads 8 bytes of coordinates and 12
gathered taps of 4 bytes (which hit L1/L2, since neighbouring pixels sample
neighbouring rows) and writes 12 bytes; there are a few FLOPs per byte and
no matmul, so no tensor cores and nothing worth staging in shared memory.
What the design does about it: one program per block of consecutive output
pixels of the flat ``(B*H*W)`` view, so the coordinate loads and the output
stores are contiguous, and the taps of a pixel's three channels are three
adjacent words.

Layouts are the engine's: images ``(B, H, W, C)`` fp32 0-255, coordinates
``(B, H, W, 2)`` fp32 (x, y) in input pixels, output ``(B, H, W, C)`` fp32.
"""

from __future__ import annotations

import os

import torch

from lightning_pose_tpu_torch.ops.cuda_build import BUILD_DIR

__all__ = ["launches", "warp", "warp_plain"]

# launches of the Triton kernel in this process; only ``warp`` adds to it
launches = 0

_BLOCK = 256
_kernel = None


def warp_plain(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: ``grid_sample_bilinear`` of the reference,
    4-tap gathers with zero padding outside the frame."""
    b, h, w, c = images.shape
    x = coords[..., 0]
    y = coords[..., 1]
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    wx = (x - x0)[..., None]
    wy = (y - y0)[..., None]
    x0i = x0.to(torch.int64)
    y0i = y0.to(torch.int64)
    bidx = torch.arange(b, device=images.device).reshape(b, 1, 1)

    def gather(yi, xi):
        valid = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
        vals = images[bidx, yi.clamp(0, h - 1), xi.clamp(0, w - 1)]
        return vals * valid[..., None]

    v00 = gather(y0i, x0i)
    v01 = gather(y0i, x0i + 1)
    v10 = gather(y0i + 1, x0i)
    v11 = gather(y0i + 1, x0i + 1)
    return (
        v00 * (1 - wx) * (1 - wy)
        + v01 * wx * (1 - wy)
        + v10 * (1 - wx) * wy
        + v11 * wx * wy
    )


def _get_kernel():
    """Define the Triton kernel at first use (Triton exists only where CUDA
    does; importing this module must not need it)."""
    global _kernel
    if _kernel is None:
        os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR.parent / "triton"))
        import triton
        import triton.language as tl

        @triton.jit
        def warp_kernel(
            img_ptr, coord_ptr, out_ptr, n_pix, h, w,
            C: tl.constexpr, BLOCK: tl.constexpr,
        ):
            pix = tl.program_id(0) * BLOCK + tl.arange(0, BLOCK)
            live = pix < n_pix
            x = tl.load(coord_ptr + 2 * pix, mask=live, other=0.0)
            y = tl.load(coord_ptr + 2 * pix + 1, mask=live, other=0.0)
            x0 = tl.floor(x)
            y0 = tl.floor(y)
            wx = x - x0
            wy = y - y0
            x0i = x0.to(tl.int32)
            y0i = y0.to(tl.int32)
            x1i = x0i + 1
            y1i = y0i + 1
            # first pixel of this output pixel's image in the flat input
            img0 = (pix // (h * w)) * (h * w)
            in_x0 = (x0i >= 0) & (x0i < w)
            in_x1 = (x1i >= 0) & (x1i < w)
            in_y0 = (y0i >= 0) & (y0i < h)
            in_y1 = (y1i >= 0) & (y1i < h)
            m00 = live & in_y0 & in_x0
            m01 = live & in_y0 & in_x1
            m10 = live & in_y1 & in_x0
            m11 = live & in_y1 & in_x1
            p00 = (img0 + y0i * w + x0i) * C
            p01 = (img0 + y0i * w + x1i) * C
            p10 = (img0 + y1i * w + x0i) * C
            p11 = (img0 + y1i * w + x1i) * C
            for ch in tl.static_range(C):
                v00 = tl.load(img_ptr + p00 + ch, mask=m00, other=0.0)
                v01 = tl.load(img_ptr + p01 + ch, mask=m01, other=0.0)
                v10 = tl.load(img_ptr + p10 + ch, mask=m10, other=0.0)
                v11 = tl.load(img_ptr + p11 + ch, mask=m11, other=0.0)
                out = (
                    v00 * (1.0 - wx) * (1.0 - wy)
                    + v01 * wx * (1.0 - wy)
                    + v10 * (1.0 - wx) * wy
                    + v11 * wx * wy
                )
                tl.store(out_ptr + pix * C + ch, out, mask=live)

        _kernel = (triton, warp_kernel)
    return _kernel


def warp(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``images (B, H, W, C)`` at ``coords (B, H, W, 2)`` (x, y),
    bilinear with zero padding outside; returns ``(B, H, W, C)`` fp32.

    A CUDA tensor runs the Triton kernel; a CPU tensor runs
    :func:`warp_plain`. Anything else raises.
    """
    global launches
    if images.ndim != 4 or coords.ndim != 4 or coords.shape[-1] != 2:
        raise ValueError(
            f"warp takes (B, H, W, C) images and (B, H, W, 2) coords, got "
            f"{tuple(images.shape)} and {tuple(coords.shape)}"
        )
    if coords.shape[:3] != images.shape[:3]:
        raise ValueError(
            f"warp writes an output of the input's size: coords {tuple(coords.shape)} "
            f"do not match images {tuple(images.shape)}"
        )
    if images.dtype != torch.float32 or coords.dtype != torch.float32:
        raise TypeError(f"warp takes float32 images and coords, got {images.dtype}, {coords.dtype}")
    if images.device != coords.device:
        raise ValueError(f"images on {images.device} but coords on {coords.device}")
    if images.device.type == "cpu":
        return warp_plain(images, coords)
    if images.device.type != "cuda":
        raise ValueError(f"warp runs on cpu or cuda, not {images.device}")
    if not (images.is_contiguous() and coords.is_contiguous()):
        raise ValueError("the warp kernel needs contiguous images and coords")
    if images.numel() >= 2**31:
        raise ValueError(f"the warp kernel indexes with int32; {images.numel()} elements is too many")

    b, h, w, c = images.shape
    out = torch.empty_like(images)
    n_pix = b * h * w
    if n_pix:
        triton, kernel = _get_kernel()
        with torch.cuda.device(images.device):
            kernel[(triton.cdiv(n_pix, _BLOCK),)](
                images, coords, out, n_pix, h, w, C=c, BLOCK=_BLOCK, num_warps=4,
            )
        launches += 1
    return out
