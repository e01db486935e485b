"""Decode kernel: fused upsample + softmax + expectation + confidence, and
its backward.

The forward replaces the TPU kernel ``lightning_pose_tpu/ops/pallas_decode.py``
(``run_subpixelmaxima_pallas``); its CUDA source is ``csrc/decode.cu``. The
backward (``csrc/decode_grad.cu``) replaces no TPU kernel: the JAX package
trains through its XLA decode and differentiates it by autodiff. Each
source's header says what bounds it on the H100 and how it is laid out.
This module holds the upsample matrices, the plain PyTorch version of the
decode (the reference's XLA path,
``lightning_pose_tpu/ops/softargmax.py:123-147``), the registered op
``lightning_pose_tpu_torch::decode`` (the kernel on CUDA, the plain version
on the CPU; ``torch.export`` and ``torch.compile`` see it as one node), and
the wrapper that picks between the op and, on the card under autograd, the
autograd function of the two kernels.

Heatmaps are ``(B, K, h, w)`` here, the layout the port's head emits: the
kernel walks them as ``B*K`` maps of ``(h, w)`` with no transpose.
"""

from __future__ import annotations

import ctypes
import functools
import math
from dataclasses import dataclass

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
    "grad_launches",
    "launches",
    "upsample_matrix",
]

# launches of the CUDA kernels in this process: the forward (``launches``),
# added to by ``_launch``, the CUDA body of the registered ops
# ``lightning_pose_tpu_torch::decode`` and ``::decode_with_lse``, whoever
# calls them (the wrappers, an exported or compiled graph); and the backward
# (``grad_launches``), added to by its launch
launches = 0
grad_launches = 0

# grid-offset correction of repeated align_corners=False upsampling, by
# downsample factor (reference heads/heatmap.py:131-136)
GRID_OFFSETS = {0: 0.0, 1: 0.5, 2: 1.5, 3: 2.5}
# half-width of the confidence window: floor(sigma * num_stds) = floor(1.25 * 2)
CONFIDENCE_WINDOW = 2
# the kernel's logits are base 2: temperature * log2(e) * up
_LOG2_E = 1.0 / math.log(2.0)


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
    Equal to ``upsample_matrix`` of ``lightning_pose_tpu/ops/pallas_decode.py``."""
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
    """Plain PyTorch decode of ``(B, K, h, w)`` heatmaps, differentiable by
    autograd.

    Returns ``(B, 2K)`` keypoints (x, y) in full-resolution pixels and
    ``(B, K)`` confidences, float32 (float64 for float64 maps).
    """
    b, k, h, w = heatmaps.shape
    up = heatmaps.to(torch.promote_types(heatmaps.dtype, torch.float32))
    if downsample_factor > 0:
        mh, mw = (
            torch.from_numpy(np.array(upsample_matrix(n, downsample_factor))).to(heatmaps.device, up.dtype)
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
    for name in ("lp_decode_band_rows", "lp_decode_band_cols", "lp_decode_cluster_blocks", "lp_decode_max_band"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.lp_decode_smem_bytes.argtypes = [ctypes.c_int] * 5
    lib.lp_decode_smem_bytes.restype = ctypes.c_size_t
    lib.lp_decode_launch.argtypes = [
        *[ctypes.c_void_p] * 9,
        *[ctypes.c_int] * 9,
        ctypes.c_float, ctypes.c_int, ctypes.c_float, ctypes.c_int,
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


@dataclass(frozen=True)
class _Layout:
    """How the kernel cuts an ``(h, w)`` map upsampled to ``(H, W)``: Mh
    bands of ``band_rows`` rows, Mw bands of ``band_cols`` columns, and
    ``cluster`` strips of ``strip_rows`` output rows, one per block. An Mw
    band is at most ``max_band`` wide."""

    band_rows: int
    band_cols: int
    cluster: int
    max_band: int

    def padded_width(self, big_w: int) -> int:
        """``Wp``: ``W`` rounded up to two column bands, since an up tile
        takes its columns from the two halves of ``Wp``."""
        step = 2 * self.band_cols
        return -(-big_w // step) * step

    def strip_rows(self, big_h: int) -> int:
        tiles = -(-big_h // self.band_rows)
        return -(-tiles // self.cluster) * self.band_rows


def _tile_packed_mh(m_h: np.ndarray, bands: np.ndarray, layout: _Layout) -> np.ndarray:
    """``(row tiles, widest tile band, band_rows)``: for row tile ``t`` and
    band step ``k``, ``Mh[t * band_rows + r, lo_t + k]`` at ``[t, k, r]``,
    zero past the tile's band and past ``H``. A block copies its strip's
    tiles into shared memory as they are."""
    rows_per_tile = layout.band_rows
    packed = np.zeros((len(bands), int((bands[:, 1] - bands[:, 0]).max()), rows_per_tile), np.float32)
    for t, (lo, hi) in enumerate(bands):
        rows = m_h[t * rows_per_tile:(t + 1) * rows_per_tile, lo:hi]
        packed[t, : hi - lo, : rows.shape[0]] = rows.T
    return packed


def _band_packed_mw(m_w: np.ndarray, bands: np.ndarray, layout: _Layout) -> np.ndarray:
    """``(max_band, tiles, band_cols)``: for band step ``k`` and column tile
    ``t``, ``Mw^T[lo_t + k, t * band_cols + c]``, zero past the tile's band.
    ``m_w`` is ``(Wp, w)``."""
    packed = np.zeros((layout.max_band, len(bands), layout.band_cols), np.float32)
    for t, (lo, hi) in enumerate(bands):
        packed[: hi - lo, t] = m_w[t * layout.band_cols:(t + 1) * layout.band_cols, lo:hi].T
    return packed


@dataclass(frozen=True)
class _Operands:
    """What the kernels read besides the maps, on the maps' device: the row
    tiles' Mh bands and the column tiles' Mw bands, packed as the kernels
    read them, and the ``[lo, hi)`` bands of Mh's row tiles, of Mw's column
    tiles and of each strip's Mh rows (``[0, 0)`` for a strip past ``H``);
    ``wp`` columns (``W`` padded, zero past it), strips of ``strip_rows``
    rows, the widest strip band ``band_rows`` and tile band ``tile_band``."""

    mh_tiles: torch.Tensor
    mw_packed: torch.Tensor
    mh_band: torch.Tensor
    mw_band: torch.Tensor
    strip_band: torch.Tensor
    wp: int
    strip_rows: int
    band_rows: int
    tile_band: int


def _operands_from_bands(
    m_h: np.ndarray, m_w: np.ndarray, mh_bands: np.ndarray, mw_bands: np.ndarray,
    layout: _Layout, device: torch.device,
) -> _Operands:
    """The operands for the bands given; ``m_w`` is padded to ``Wp`` rows."""
    strip_rows = layout.strip_rows(m_h.shape[0])
    strips = np.zeros((layout.cluster, 2), np.int32)
    bands = row_tile_bands(m_h, strip_rows)
    strips[: len(bands)] = bands
    if int((mw_bands[:, 1] - mw_bands[:, 0]).max()) > layout.max_band:
        raise ValueError(f"decode kernel: Mw bands wider than the kernel's {layout.max_band}")
    tensors = [
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (
            _tile_packed_mh(m_h, mh_bands, layout), _band_packed_mw(m_w, mw_bands, layout),
            mh_bands, mw_bands, strips,
        )
    ]
    return _Operands(
        *tensors, wp=m_w.shape[0], strip_rows=strip_rows,
        band_rows=int((strips[:, 1] - strips[:, 0]).max()),
        tile_band=int((mh_bands[:, 1] - mh_bands[:, 0]).max()),
    )


def _padded_matrices(h: int, w: int, df: int, layout: _Layout) -> tuple[np.ndarray, np.ndarray]:
    """Mh ``(H, h)`` and Mw ``(Wp, w)``, zero rows past ``W``."""
    m_h, m_w = upsample_matrix(h, df), upsample_matrix(w, df)
    wp = layout.padded_width(m_w.shape[0])
    return m_h, np.concatenate([m_w, np.zeros((wp - m_w.shape[0], w), np.float32)])


@functools.lru_cache(maxsize=16)
def _device_operands(h: int, w: int, df: int, layout: _Layout, device: torch.device) -> _Operands:
    """The kernel's operands for ``(h, w)`` maps at ``df``."""
    m_h, m_w = _padded_matrices(h, w, df, layout)
    return _operands_from_bands(
        m_h, m_w, row_tile_bands(m_h, layout.band_rows), row_tile_bands(m_w, layout.band_cols),
        layout, device,
    )


def _layout() -> _Layout:
    lib = _library()
    return _Layout(
        lib.lp_decode_band_rows(), lib.lp_decode_band_cols(),
        lib.lp_decode_cluster_blocks(), lib.lp_decode_max_band(),
    )


def _launch(
    heatmaps: torch.Tensor, ops: _Operands, downsample_factor: int, temperature: float,
    lse2: torch.Tensor | None = None,
):
    """Run the kernel on contiguous fp32 CUDA ``(B, K, h, w)`` heatmaps; with
    ``lse2`` (a ``(B * K,)`` fp32 tensor) it also writes each map's base-2
    log-sum-exp there."""
    global launches
    b, k, h, w = heatmaps.shape
    big_h, big_w = h * 2**downsample_factor, w * 2**downsample_factor
    lib = _library()
    smem = lib.lp_decode_smem_bytes(ops.band_rows, ops.tile_band, ops.strip_rows, w, ops.wp)
    _check_smem(smem, heatmaps.device, f"decode kernel: ({h}, {w}) maps upsampled to ({big_h}, {big_w})")
    keypoints = torch.empty((b, 2 * k), dtype=torch.float32, device=heatmaps.device)
    confidences = torch.empty((b, k), dtype=torch.float32, device=heatmaps.device)
    if b * k:
        err = lib.lp_decode_launch(
            heatmaps.data_ptr(),
            *(t.data_ptr() for t in (ops.mh_tiles, ops.mw_packed, ops.mh_band, ops.mw_band, ops.strip_band)),
            keypoints.data_ptr(), confidences.data_ptr(), None if lse2 is None else lse2.data_ptr(),
            b * k, h, w, big_h, big_w, ops.wp, ops.strip_rows, ops.band_rows, ops.tile_band,
            float(temperature) * _LOG2_E, CONFIDENCE_WINDOW,
            GRID_OFFSETS[downsample_factor], heatmaps.device.index,
            torch.cuda.current_stream(heatmaps.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"decode kernel launch failed with CUDA error {err}")
        launches += 1
    return keypoints, confidences


def _check_smem(smem: int, device: torch.device, what: str) -> None:
    limit = torch.cuda.get_device_properties(device).shared_memory_per_block_optin
    if smem > limit:
        raise ValueError(f"{what} need {smem} bytes of shared memory per block; the card allows {limit}")


# strips of output rows a map in the backward kernel (decode_grad.cu's
# kCluster), and the shared memory a backward block may take so that two
# share an SM (228 KB an SM, 1 KB of it reserved a block)
GRAD_CLUSTER = 4
_GRAD_SMEM_TARGET = 113 * 1024
# a strip that does not fit is walked in chunks of a multiple of this many
# rows (decode_grad.cu's kULanes: the rows one u pass gives a thread each)
_GRAD_CHUNK_STEP = 16


@functools.lru_cache(maxsize=1)
def _grad_library() -> ctypes.CDLL:
    lib = load_library("decode_grad.cu")
    for name in ("lp_decode_grad_band_rows", "lp_decode_grad_band_cols", "lp_decode_grad_max_band",
                 "lp_decode_grad_cluster_blocks", "lp_decode_grad_max_items"):
        getattr(lib, name).argtypes = []
        getattr(lib, name).restype = ctypes.c_int
    lib.lp_decode_grad_smem_bytes.argtypes = [ctypes.c_int] * 6
    lib.lp_decode_grad_smem_bytes.restype = ctypes.c_size_t
    lib.lp_decode_grad_launch.argtypes = [
        *[ctypes.c_void_p] * 14,
        *[ctypes.c_int] * 12,
        ctypes.c_float, ctypes.c_float, ctypes.c_float, ctypes.c_int,
        ctypes.c_void_p,
    ]
    lib.lp_decode_grad_launch.restype = ctypes.c_int
    layout = _layout()
    theirs = (lib.lp_decode_grad_band_rows(), lib.lp_decode_grad_band_cols(), lib.lp_decode_grad_max_band())
    if theirs != (layout.band_rows, layout.band_cols, layout.max_band):
        raise RuntimeError(f"decode_grad.cu packs bands as {theirs}, decode.cu as {layout}")
    if lib.lp_decode_grad_cluster_blocks() != GRAD_CLUSTER:
        raise RuntimeError(f"decode_grad.cu runs {lib.lp_decode_grad_cluster_blocks()} strips a map, "
                           f"the wrapper plans {GRAD_CLUSTER}")
    return lib


@dataclass(frozen=True)
class GradPlan:
    """How the backward kernel cuts an ``(h, w)`` map upsampled to ``(H,
    W)``, in numpy: ``GRAD_CLUSTER`` strips of ``strip_rows`` output rows,
    one a block, each walked in chunks of ``chunk_rows``; ``strip_band`` the
    ``[lo, hi)`` hm rows each strip's Mh band reaches (``[0, 0)`` past
    ``H``), at most ``band_rows``. The transposed bands: for each tile of 4
    input columns, ``mwt_band`` the ``[lo, hi)`` output columns its Mw
    columns reach, widened to multiples of 4, and ``mwt_packed[jt, k, c] =
    Mw[lo + k, 4 jt + c]``; for each tile of 4 input rows, ``mht_band`` the
    ``[lo, hi)`` output rows its Mh columns reach and ``mht_packed[it, k, c]
    = Mh[lo + k, 4 it + c]``; zero past a band and past ``h`` or ``w``.
    ``m_h`` is ``(H, h)`` and ``m_w`` ``(Wp, w)``, zero rows past ``W``."""

    m_h: np.ndarray
    m_w: np.ndarray
    strip_rows: int
    chunk_rows: int
    strip_band: np.ndarray
    band_rows: int
    mwt_band: np.ndarray
    mwt_packed: np.ndarray
    mht_band: np.ndarray
    mht_packed: np.ndarray

    def dhm_tiles(self, strip: int) -> int:
        """4x4 tiles of partial dhm that a strip's block accumulates."""
        lo, hi = (int(v) for v in self.strip_band[strip])
        return (-(-hi // 4) - lo // 4) * -(-self.m_w.shape[1] // 4) if hi > lo else 0


def _packed_transposed_bands(m: np.ndarray, align: int) -> tuple[np.ndarray, np.ndarray]:
    """For each tile of 4 columns of ``m``, the ``[lo, hi)`` rows where the
    tile has non-zeros, widened to multiples of ``align``, and the tile's
    rows over that range, ``(tiles, widest range, 4)``."""
    bands = row_tile_bands(np.ascontiguousarray(m.T), 4)
    bands[:, 0] = bands[:, 0] // align * align
    bands[:, 1] = -(-bands[:, 1] // align) * align
    packed = np.zeros((len(bands), max(int((bands[:, 1] - bands[:, 0]).max()), 1), 4), np.float32)
    for t, (lo, hi) in enumerate(bands):
        cols = m[lo:hi, 4 * t:4 * t + 4]
        packed[t, : hi - lo, : cols.shape[1]] = cols
    return bands, packed


def grad_plan(h: int, w: int, df: int, layout: _Layout, chunk_rows: int | None = None) -> GradPlan:
    """The backward kernel's plan for ``(h, w)`` maps at ``df``; chunks of
    ``chunk_rows`` rows (a multiple of 4; default a whole strip)."""
    m_h, m_w = _padded_matrices(h, w, df, layout)
    tiles = -(-m_h.shape[0] // layout.band_rows)
    strip_rows = -(-tiles // GRAD_CLUSTER) * layout.band_rows
    strips = np.zeros((GRAD_CLUSTER, 2), np.int32)
    bands = row_tile_bands(m_h, strip_rows)
    strips[: len(bands)] = bands
    mwt_band, mwt_packed = _packed_transposed_bands(m_w, 4)
    mht_band, mht_packed = _packed_transposed_bands(m_h, 1)
    chunk_rows = strip_rows if chunk_rows is None else min(chunk_rows, strip_rows)
    if chunk_rows <= 0 or chunk_rows % layout.band_rows:
        raise ValueError(f"decode backward: chunks of {chunk_rows} rows are not whole row tiles")
    return GradPlan(
        m_h, m_w, strip_rows, chunk_rows, strips, int((strips[:, 1] - strips[:, 0]).max()),
        mwt_band, mwt_packed, mht_band, mht_packed,
    )


@dataclass(frozen=True)
class _GradOperands:
    """A :class:`GradPlan` on the maps' device, with the chunk that keeps
    a block within ``_GRAD_SMEM_TARGET`` where a whole strip does not."""

    strip_band: torch.Tensor
    mwt_packed: torch.Tensor
    mwt_band: torch.Tensor
    mht_packed: torch.Tensor
    mht_band: torch.Tensor
    strip_rows: int
    chunk_rows: int
    band_rows: int
    smem: int


@functools.lru_cache(maxsize=16)
def _device_grad_operands(h: int, w: int, df: int, wp: int, tile_band: int, device: torch.device) -> _GradOperands:
    lib = _grad_library()
    plan = grad_plan(h, w, df, _layout())
    most = max(plan.dhm_tiles(s) for s in range(GRAD_CLUSTER))
    if most > lib.lp_decode_grad_max_items():
        raise ValueError(f"decode backward: ({h}, {w}) maps need {most} dhm tiles a strip, "
                         f"more than the kernel's {lib.lp_decode_grad_max_items()}")

    def smem(chunk: int) -> int:
        return lib.lp_decode_grad_smem_bytes(w, wp, plan.strip_rows, chunk, plan.band_rows, tile_band)

    chunk = plan.strip_rows
    while smem(chunk) > _GRAD_SMEM_TARGET and chunk > _GRAD_CHUNK_STEP:
        chunk = max(_GRAD_CHUNK_STEP, (chunk - 1) // _GRAD_CHUNK_STEP * _GRAD_CHUNK_STEP)
    tensors = [
        torch.from_numpy(np.ascontiguousarray(a)).to(device)
        for a in (plan.strip_band, plan.mwt_packed, plan.mwt_band, plan.mht_packed, plan.mht_band)
    ]
    return _GradOperands(*tensors, strip_rows=plan.strip_rows, chunk_rows=chunk, band_rows=plan.band_rows,
                         smem=smem(chunk))


def _launch_grad(
    heatmaps: torch.Tensor, keypoints: torch.Tensor, lse2: torch.Tensor, grad_keypoints: torch.Tensor,
    ops: _Operands, downsample_factor: int, temperature: float,
) -> torch.Tensor:
    """Run the backward kernel: the gradient of the keypoints' loss with
    respect to contiguous fp32 CUDA ``(B, K, h, w)`` heatmaps, given the
    forward's keypoints and ``lse2`` and the keypoints' gradient ``(B, 2K)``."""
    global grad_launches
    b, k, h, w = heatmaps.shape
    big_h, big_w = h * 2**downsample_factor, w * 2**downsample_factor
    lib = _grad_library()
    g = _device_grad_operands(h, w, downsample_factor, ops.wp, ops.tile_band, heatmaps.device)
    _check_smem(g.smem, heatmaps.device, f"decode backward kernel: ({h}, {w}) maps upsampled to ({big_h}, {big_w})")
    grad = torch.empty_like(heatmaps)
    if b * k:
        err = lib.lp_decode_grad_launch(
            *(t.data_ptr() for t in (heatmaps, keypoints, lse2, grad_keypoints, ops.mh_tiles, ops.mw_packed,
                                     ops.mh_band, ops.mw_band, g.strip_band, g.mwt_packed, g.mwt_band,
                                     g.mht_packed, g.mht_band, grad)),
            b * k, h, w, big_h, big_w, ops.wp, g.strip_rows, g.chunk_rows, g.band_rows, ops.tile_band,
            g.mwt_packed.shape[1], g.mht_packed.shape[1],
            float(temperature) * _LOG2_E, float(temperature), GRID_OFFSETS[downsample_factor],
            heatmaps.device.index, torch.cuda.current_stream(heatmaps.device).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"decode backward kernel launch failed with CUDA error {err}")
        grad_launches += 1
    return grad


# the decode as a registered PyTorch op, so that ``torch.export`` keeps it
# in its graph and ``torch.compile`` takes it without a graph break: the
# CUDA implementation is the kernel, the CPU one the plain version.
# ``decode_with_lse`` (CUDA only) also returns each map's base-2
# log-sum-exp, which the backward kernel reads
@torch.library.custom_op(
    "lightning_pose_tpu_torch::decode", mutates_args=(), device_types="cuda",
    tags=(torch.Tag.needs_fixed_stride_order,),
)
def _decode_op(heatmaps: torch.Tensor, downsample_factor: int, temperature: float) -> tuple[torch.Tensor, torch.Tensor]:
    b, k, h, w = heatmaps.shape
    ops = _device_operands(h, w, downsample_factor, _layout(), heatmaps.device)
    return _launch(heatmaps, ops, downsample_factor, temperature)


@_decode_op.register_kernel("cpu")
def _(heatmaps, downsample_factor, temperature):
    return decode_plain(heatmaps, downsample_factor, temperature)


@_decode_op.register_fake
def _(heatmaps, downsample_factor, temperature):
    b, k = heatmaps.shape[:2]
    dtype = torch.promote_types(heatmaps.dtype, torch.float32)
    return heatmaps.new_empty((b, 2 * k), dtype=dtype), heatmaps.new_empty((b, k), dtype=dtype)


@torch.library.custom_op(
    "lightning_pose_tpu_torch::decode_with_lse", mutates_args=(), device_types="cuda",
    tags=(torch.Tag.needs_fixed_stride_order,),
)
def _decode_with_lse_op(
    heatmaps: torch.Tensor, downsample_factor: int, temperature: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    b, k, h, w = heatmaps.shape
    ops = _device_operands(h, w, downsample_factor, _layout(), heatmaps.device)
    lse2 = torch.empty(b * k, dtype=torch.float32, device=heatmaps.device)
    keypoints, confidences = _launch(heatmaps, ops, downsample_factor, temperature, lse2)
    return keypoints, confidences, lse2


@_decode_with_lse_op.register_fake
def _(heatmaps, downsample_factor, temperature):
    b, k = heatmaps.shape[:2]
    return (heatmaps.new_empty((b, 2 * k)), heatmaps.new_empty((b, k)), heatmaps.new_empty((b * k,)))


class _DecodeFunction(torch.autograd.Function):
    """The decode kernel forward and the backward kernel, for CUDA heatmaps
    that require grad. The confidences carry no gradient."""

    @staticmethod
    @torch.amp.custom_fwd(device_type="cuda", cast_inputs=torch.float32)
    def forward(ctx, heatmaps, downsample_factor, temperature):
        keypoints, confidences, lse2 = torch.ops.lightning_pose_tpu_torch.decode_with_lse(
            heatmaps, downsample_factor, temperature
        )
        ctx.save_for_backward(heatmaps, keypoints, lse2)
        ctx.downsample_factor, ctx.temperature = downsample_factor, temperature
        ctx.mark_non_differentiable(confidences)
        return keypoints, confidences

    @staticmethod
    @torch.amp.custom_bwd(device_type="cuda")
    def backward(ctx, grad_keypoints, grad_confidences):
        heatmaps, keypoints, lse2 = ctx.saved_tensors
        _, _, h, w = heatmaps.shape
        ops = _device_operands(h, w, ctx.downsample_factor, _layout(), heatmaps.device)
        grad = _launch_grad(
            heatmaps, keypoints, lse2, grad_keypoints.contiguous(), ops, ctx.downsample_factor, ctx.temperature
        )
        return grad, None, None


def decode(
    heatmaps: torch.Tensor,
    downsample_factor: int = 2,
    temperature: float = 1000.0,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused decode of ``(B, K, h, w)`` heatmaps (drop-in for
    :func:`decode_plain`), through the op ``lightning_pose_tpu_torch::decode``.

    A CUDA tensor runs the CUDA kernel; where grad mode is on and the
    heatmaps require grad, it runs the kernel and the backward kernel as an
    autograd function, so the keypoints carry a gradient. A CPU tensor runs
    :func:`decode_plain`: through the op, or, where it needs a gradient,
    directly under autograd. Anything else raises.
    """
    if heatmaps.ndim != 4:
        raise ValueError(f"decode takes (B, K, h, w) heatmaps, got {tuple(heatmaps.shape)}")
    if downsample_factor not in GRID_OFFSETS:
        raise ValueError(f"downsample_factor must be 0-3, got {downsample_factor}")
    needs_grad = torch.is_grad_enabled() and heatmaps.requires_grad
    if heatmaps.device.type == "cpu":
        if needs_grad:
            return decode_plain(heatmaps, downsample_factor, temperature)
        return torch.ops.lightning_pose_tpu_torch.decode(heatmaps, downsample_factor, float(temperature))
    if heatmaps.device.type != "cuda":
        raise ValueError(f"decode runs on cpu or cuda, not {heatmaps.device}")
    if heatmaps.dtype != torch.float32:
        raise TypeError(f"the decode kernel takes float32 heatmaps, got {heatmaps.dtype}")
    if not heatmaps.is_contiguous():
        raise ValueError("the decode kernel needs contiguous (B, K, h, w) heatmaps")

    if not temperature > 0:
        raise ValueError(f"the decode kernel takes a positive temperature, got {temperature}")
    b, k, h, w = heatmaps.shape
    if b * k * 4 >= 2**31:
        raise ValueError(f"the decode kernel takes fewer than 2**29 maps a launch, got {b * k}")
    if needs_grad:
        return _DecodeFunction.apply(heatmaps, downsample_factor, temperature)
    return torch.ops.lightning_pose_tpu_torch.decode(heatmaps, downsample_factor, float(temperature))
