"""CLAHE blend kernel: bilinear blend of per-tile LUTs at every pixel.

Replaces the TPU kernel ``lightning_pose_tpu/ops/pallas_clahe.py``
(``clahe_apply_pallas``). The CUDA source is ``csrc/clahe.cu``; its header
says what the kernel computes, what bounds it on the H100 and how it is laid
out. This module holds the plain PyTorch version and the wrapper that picks
between them by device.

``x (N, H, W)`` fp32 pixel values 0-255 (one image-channel per ``n``),
``lut (N, g, g, 256)`` fp32 per-tile LUTs (tile row, tile column, bin);
the output is ``(N, H, W)`` fp32. H and W must split into half-blocks:
``H % (2g) == 0`` and ``W % (2g) == 0``.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from lightning_pose_tpu_torch.ops.cuda_build import load_library

__all__ = ["clahe_apply", "clahe_apply_plain", "launches"]

# launches of the CUDA kernel in this process; only ``clahe_apply`` adds to it
launches = 0

_MAX_IMAGE_CHANNELS = 65535  # gridDim.y


def _tile_maps(size: int, g: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Along one axis of ``size`` pixels split into ``g`` tiles: the lower
    and upper tile index of every pixel and its fp32 weight toward the
    upper one (``_static_maps`` of the reference): half-block
    ``hb = i // (size / 2g)``, ``lo = clamp(floor((hb-1)/2), 0, g-1)``,
    ``hi = clamp(floor((hb-1)/2) + 1, 0, g-1)``,
    ``w = frac((i + 0.5) / (size / g) - 0.5)``."""
    tile = size // g
    half = tile // 2
    pos = torch.arange(size, device=device)
    t = torch.div(pos // half - 1, 2, rounding_mode="floor")
    lo = t.clamp(0, g - 1)
    hi = (t + 1).clamp(0, g - 1)
    frac = (pos.to(torch.float32) + 0.5) / tile - 0.5
    return lo, hi, frac - torch.floor(frac)


def clahe_apply_plain(x: torch.Tensor, lut: torch.Tensor, g: int) -> torch.Tensor:
    """Plain PyTorch version: gather ``lut[n, ylo/yhi, xlo/xhi, v]`` at
    every pixel and blend."""
    n, h, w = x.shape
    ylo, yhi, wy = _tile_maps(h, g, x.device)
    xlo, xhi, wx = _tile_maps(w, g, x.device)
    v = x.clamp(0.0, 255.0).to(torch.int64)
    ni = torch.arange(n, device=x.device)[:, None, None]
    wy = wy[None, :, None]
    wx = wx[None, None, :]

    def at(rows, cols):
        return lut[ni, rows[None, :, None], cols[None, None, :], v]

    top = (1.0 - wx) * at(ylo, xlo) + wx * at(ylo, xhi)
    bot = (1.0 - wx) * at(yhi, xlo) + wx * at(yhi, xhi)
    return (1.0 - wy) * top + wy * bot


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = load_library("clahe.cu")
    lib.lp_clahe_smem_bytes.argtypes = [ctypes.c_int]
    lib.lp_clahe_smem_bytes.restype = ctypes.c_size_t
    lib.lp_clahe_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.lp_clahe_launch.restype = ctypes.c_int
    return lib


def clahe_apply(x: torch.Tensor, lut: torch.Tensor, g: int) -> torch.Tensor:
    """Blend per-tile LUTs over pixels: ``x (N, H, W)``, ``lut (N, g, g,
    256)`` -> ``(N, H, W)`` fp32.

    A CUDA tensor runs the CUDA kernel; a CPU tensor runs
    :func:`clahe_apply_plain`. Anything else raises.
    """
    global launches
    if x.ndim != 3 or lut.ndim != 4:
        raise ValueError(
            f"clahe_apply takes (N, H, W) pixels and (N, g, g, 256) LUTs, got "
            f"{tuple(x.shape)} and {tuple(lut.shape)}"
        )
    n, h, w = x.shape
    if g < 2 or tuple(lut.shape) != (n, g, g, 256):
        raise ValueError(f"LUTs {tuple(lut.shape)} do not fit {n} image-channels and grid {g}")
    if h % (2 * g) or w % (2 * g):
        raise ValueError(f"({h}, {w}) pixels do not split into half-blocks of a {g}x{g} grid")
    if x.dtype != torch.float32 or lut.dtype != torch.float32:
        raise TypeError(f"clahe_apply takes float32 pixels and LUTs, got {x.dtype}, {lut.dtype}")
    if x.device != lut.device:
        raise ValueError(f"pixels on {x.device} but LUTs on {lut.device}")
    if x.device.type == "cpu":
        return clahe_apply_plain(x, lut, g)
    if x.device.type != "cuda":
        raise ValueError(f"clahe_apply runs on cpu or cuda, not {x.device}")
    if not (x.is_contiguous() and lut.is_contiguous()):
        raise ValueError("the CLAHE kernel needs contiguous pixels and LUTs")
    if n > _MAX_IMAGE_CHANNELS:
        raise ValueError(f"the CLAHE kernel takes at most {_MAX_IMAGE_CHANNELS} image-channels, got {n}")

    lib = _library()
    smem = lib.lp_clahe_smem_bytes(g)
    limit = torch.cuda.get_device_properties(x.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"CLAHE kernel: a {g}x{g} grid needs {smem} bytes of shared memory per "
            f"block; the card allows {limit}"
        )
    out = torch.empty_like(x)
    if n:
        err = lib.lp_clahe_launch(
            x.data_ptr(), lut.data_ptr(), out.data_ptr(), n, h, w, g,
            x.device.index, torch.cuda.current_stream(x.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"CLAHE kernel launch failed with CUDA error {err}")
        launches += 1
    return out
