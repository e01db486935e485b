"""Decode kernel: fused upsample + softmax + expectation + confidence.

Replaces the TPU kernel ``lightning_pose_tpu/ops/pallas_decode.py``
(``run_subpixelmaxima_pallas``). The CUDA source is ``csrc/decode.cu``; its
header says what bounds it on the H100 and how it is laid out. This module
holds the upsample matrices, the plain PyTorch version of the decode (the
reference's XLA path, ``lightning_pose_tpu/ops/softargmax.py:123-147``), and
the wrapper that picks between them by device.

Heatmaps are ``(B, K, h, w)`` here, the layout the port's head emits: the
kernel walks them as ``B*K`` maps of ``(h, w)`` with no transpose.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from lightning_pose_tpu_torch.data.heatmaps import evaluate_heatmaps_at_location
from lightning_pose_tpu_torch.ops.cuda_build import load_library
from lightning_pose_tpu_torch.ops.softargmax import (
    spatial_expectation2d,
    spatial_softmax2d,
)

__all__ = [
    "CONFIDENCE_WINDOW",
    "GRID_OFFSETS",
    "decode",
    "decode_plain",
    "launches",
    "upsample_matrix",
]

# launches of the CUDA kernel in this process; only ``decode`` adds to it
launches = 0

# grid-offset correction of repeated align_corners=False upsampling, by
# downsample factor (reference heads/heatmap.py:131-136)
GRID_OFFSETS = {0: 0.0, 1: 0.5, 2: 1.5, 3: 2.5}
# half-width of the confidence window: floor(sigma * num_stds) = floor(1.25 * 2)
CONFIDENCE_WINDOW = 2


def _keys_bicubic_resize_matrix(in_size: int, out_size: int) -> np.ndarray:
    """``(out_size, in_size)`` matrix of ``jax.image.resize(..., "bicubic")``
    along one axis: Keys cubic with a = -0.5, half-pixel centres, taps outside
    the input given zero weight and each row's weights renormalised to sum 1
    (``jax/_src/image/scale.py``). Not ``F.interpolate``, which uses a = -0.75
    and clamps at the edges."""
    scale = out_size / in_size
    kernel_scale = max(1.0 / scale, 1.0)
    sample_f = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample_f[:, None] - np.arange(in_size, dtype=np.float64)[None, :])
    x /= kernel_scale
    out = ((1.5 * x - 2.5) * x) * x + 1.0
    out = np.where(x >= 1.0, ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0, out)
    weights = np.where(x >= 2.0, 0.0, out)
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps,
                       weights / np.where(total != 0, total, 1.0), 0.0)
    valid = (sample_f >= -0.5) & (sample_f <= in_size - 0.5)
    return np.where(valid[:, None], weights, 0.0)


@functools.lru_cache(maxsize=8)
def upsample_matrix(in_size: int, downsample_factor: int) -> np.ndarray:
    """``(in_size * 2**df, in_size)`` float32 operator of ``df`` rounds of
    (bicubic x2 + [1,4,6,4,1]/16 blur with zero boundary), built in numpy.
    Equal to ``lightning_pose_tpu.ops.pallas_decode.upsample_matrix``."""
    m = np.eye(in_size, dtype=np.float64)
    size = in_size
    kernel1d = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for _ in range(downsample_factor):
        u = _keys_bicubic_resize_matrix(size, 2 * size)
        b = sum(w * np.eye(2 * size, k=k) for k, w in zip(range(-2, 3), kernel1d))
        m = b @ u @ m
        size *= 2
    out = m.astype(np.float32)
    out.flags.writeable = False
    return out


def decode_plain(
    heatmaps: torch.Tensor,
    downsample_factor: int = 2,
    temperature: float = 1000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch decode of ``(B, K, h, w)`` heatmaps.

    Returns ``(B, 2K)`` keypoints (x, y) in full-resolution pixels and
    ``(B, K)`` confidences, both float32.
    """
    b, k, h, w = heatmaps.shape
    up = heatmaps.to(torch.float32)
    if downsample_factor > 0:
        mh, mw = (
            torch.from_numpy(np.array(upsample_matrix(n, downsample_factor))).to(heatmaps.device)
            for n in (h, w)
        )
        up = torch.matmul(mh, torch.matmul(up, mw.T))  # (B, K, H, W)
    probs = spatial_softmax2d(up, temperature=temperature)
    preds = spatial_expectation2d(probs)  # (B, K, 2)
    confidences = evaluate_heatmaps_at_location(probs, preds)
    preds = preds - GRID_OFFSETS[downsample_factor]
    return preds.reshape(b, 2 * k), confidences


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = load_library("decode.cu")
    lib.lp_decode_band_rows.argtypes = []
    lib.lp_decode_band_rows.restype = ctypes.c_int
    lib.lp_decode_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
    lib.lp_decode_smem_bytes.restype = ctypes.c_size_t
    lib.lp_decode_launch.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.lp_decode_launch.restype = ctypes.c_int
    return lib


def row_tile_bands(m: np.ndarray, rows_per_tile: int) -> np.ndarray:
    """``(ceil(rows / rows_per_tile), 2)`` int32: for each tile of
    consecutive rows of ``m``, the ``[lo, hi)`` range of the columns where
    the tile has non-zeros (``[0, 0)`` for an all-zero tile)."""
    n_tiles = -(-m.shape[0] // rows_per_tile)
    bands = np.zeros((n_tiles, 2), dtype=np.int32)
    for t in range(n_tiles):
        cols = np.flatnonzero((m[t * rows_per_tile:(t + 1) * rows_per_tile] != 0).any(axis=0))
        if cols.size:
            bands[t] = (cols[0], cols[-1] + 1)
    return bands


@functools.lru_cache(maxsize=16)
def _device_operands(h: int, w: int, df: int, rows_per_tile: int, device: torch.device):
    """Mh ``(H, h)``, Mw^T ``(w, W)`` and the row-tile bands of Mh and Mw."""
    m_h, m_w = upsample_matrix(h, df), upsample_matrix(w, df)
    return tuple(
        torch.from_numpy(np.array(a, order="C")).to(device)
        for a in (m_h, m_w.T, row_tile_bands(m_h, rows_per_tile), row_tile_bands(m_w, rows_per_tile))
    )


def decode(
    heatmaps: torch.Tensor,
    downsample_factor: int = 2,
    temperature: float = 1000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused decode of ``(B, K, h, w)`` heatmaps (drop-in for
    :func:`decode_plain`).

    A CUDA tensor runs the CUDA kernel; a CPU tensor runs
    :func:`decode_plain`. Anything else raises.
    """
    global launches
    if heatmaps.ndim != 4:
        raise ValueError(f"decode takes (B, K, h, w) heatmaps, got {tuple(heatmaps.shape)}")
    if downsample_factor not in GRID_OFFSETS:
        raise ValueError(f"downsample_factor must be 0-3, got {downsample_factor}")
    if heatmaps.device.type == "cpu":
        return decode_plain(heatmaps, downsample_factor, temperature)
    if heatmaps.device.type != "cuda":
        raise ValueError(f"decode runs on cpu or cuda, not {heatmaps.device}")
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"the decode kernel takes float32 heatmaps, got {heatmaps.dtype}")
    if not heatmaps.is_contiguous():
        raise ValueError("the decode kernel needs contiguous (B, K, h, w) heatmaps")

    b, k, h, w = heatmaps.shape
    big_h, big_w = h * 2**downsample_factor, w * 2**downsample_factor
    lib = _library()
    smem = lib.lp_decode_smem_bytes(h, w, big_w)
    limit = torch.cuda.get_device_properties(heatmaps.device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(
            f"decode kernel: ({h}, {w}) maps upsampled to width {big_w} need "
            f"{smem} bytes of shared memory per block; the card allows {limit}"
        )
    mh, mwt, mh_band, mw_band = _device_operands(
        h, w, downsample_factor, lib.lp_decode_band_rows(), heatmaps.device
    )
    keypoints = torch.empty((b, 2 * k), dtype=torch.float32, device=heatmaps.device)
    confidences = torch.empty((b, k), dtype=torch.float32, device=heatmaps.device)
    if b * k:
        err = lib.lp_decode_launch(
            heatmaps.data_ptr(), mh.data_ptr(), mwt.data_ptr(),
            mh_band.data_ptr(), mw_band.data_ptr(),
            keypoints.data_ptr(), confidences.data_ptr(),
            b * k, h, w, big_h, big_w, float(temperature), CONFIDENCE_WINDOW,
            GRID_OFFSETS[downsample_factor], heatmaps.device.index,
            torch.cuda.current_stream(heatmaps.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"decode kernel launch failed with CUDA error {err}")
        launches += 1
    return keypoints, confidences
