"""Warp kernel: bilinear sampling of images at per-pixel coordinates.

Replaces the TPU kernel ``lightning_pose_tpu/ops/pallas_warp.py``
(``warp_bilinear_pallas``). The CUDA source is ``csrc/warp.cu``; its header
says what it computes, what bounds it on the H100 and how it is laid out.
This module holds the plain PyTorch version (the reference's
``grid_sample_bilinear``, ``lightning_pose_tpu/ops/augment.py:50-82``) and
the wrapper that picks between them by device.

Layouts are the engine's: images ``(B, H, W, C)`` fp32 0-255, coordinates
``(B, H, W, 2)`` fp32 (x, y) in input pixels, output ``(B, H, W, C)`` fp32.
The kernel takes C = 3, the augmentation's RGB images.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lightning_pose_tpu_torch.ops.cuda_build import load_library

__all__ = ["launches", "warp", "warp_plain"]

# launches of the CUDA kernel in this process; only ``warp`` adds to it
launches = 0


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


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = load_library("warp.cu")
    lib.lp_warp_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.lp_warp_launch.restype = ctypes.c_int
    return lib


def warp(images: torch.Tensor, coords: torch.Tensor) -> torch.Tensor:
    """Sample ``images (B, H, W, C)`` at ``coords (B, H, W, 2)`` (x, y),
    bilinear with zero padding outside; returns ``(B, H, W, C)`` fp32.

    A CUDA tensor runs the CUDA kernel; a CPU tensor runs
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
    if coords.data_ptr() % 8:
        raise ValueError("the warp kernel reads (x, y) pairs as 8-byte words: coords must be 8-byte aligned")
    b, h, w, c = images.shape
    if c != 3:
        raise ValueError(f"the warp kernel takes 3-channel images, got {c}")
    if b > 65535:
        raise ValueError(f"the warp kernel takes at most 65535 images a launch, got {b}")
    out = torch.empty_like(images)
    if images.numel():
        err = _library().lp_warp_launch(
            images.data_ptr(), coords.data_ptr(), out.data_ptr(), b, h, w,
            images.device.index, torch.cuda.current_stream(images.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"warp kernel launch failed with CUDA error {err}")
        launches += 1
    return out
