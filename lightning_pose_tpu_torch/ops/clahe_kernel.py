"""CLAHE blend kernel: bilinear blend of per-tile LUTs at every pixel.

Replaces the TPU kernel ``lightning_pose_tpu/ops/pallas_clahe.py``
(``clahe_apply_pallas``). The CUDA source is ``csrc/clahe.cu``; its header
says what the kernel computes, what bounds it on the H100 and how it is laid
out. This module holds the plain PyTorch version, the launch plan and the
per-column and per-row maps the kernel is given, and the wrapper that picks
between kernel and plain version by device.

``x (N, H, W)`` fp32 pixel values 0-255 (one image-channel per ``n``),
``lut (N, g, g, 256)`` fp32 per-tile LUTs (tile row, tile column, bin);
the output is ``(N, H, W)`` fp32. H and W must split into half-blocks:
``H % (2g) == 0`` and ``W % (2g) == 0``.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass

import numpy as np
import torch

from lightning_pose_tpu_torch.ops.cuda_build import load_library

__all__ = ["BlendPlan", "blend_maps", "blend_plan", "clahe_apply", "clahe_apply_plain", "launches"]

# launches of the CUDA kernel in this process; only ``_launch`` adds to it
launches = 0

THREADS = 256  # threads a block (csrc/clahe.cu: kThreads)
RING = 3  # tile-row slots in a block's shared memory (kRing)
BINS = 256
MAX_BLOCKS = 2**31 - 1  # gridDim.x
# what limits the blocks an SM of an H100 holds: the kernel's launch bounds
# keep it at 64 registers a thread (kMinBlocks); 228 KB of shared memory, of
# which the SM reserves 1 KB per block; 2048 threads
BLOCKS_PER_SM_BY_REGISTERS = 4
SM_SHARED_MEMORY = 228 * 1024
RESERVED_SMEM = 1024
SM_THREADS = 2048
# blocks an SM is given by the default plan: at (48, 256, 256) and
# (6, 256, 256), g = 16, 3 blocks an SM with 32-thread column tiles beat
# one full wave of 4 (scripts/torch_bench_clahe.py)
BLOCKS_PER_SM_TARGET = 3


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


@functools.lru_cache(maxsize=16)
def blend_maps(h: int, w: int, g: int) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The maps the kernel is given: per column ``xlo | xhi << 16`` (int32)
    and ``wx`` (fp32), per row ``wy`` (fp32); the plain version's maps.
    Read-only (cached)."""
    xlo, xhi, wx = _tile_maps(w, g, "cpu")
    _, _, wy = _tile_maps(h, g, "cpu")
    maps = ((xlo | (xhi << 16)).to(torch.int32).numpy(), wx.numpy(), wy.numpy())
    for m in maps:
        m.setflags(write=False)
    return maps


# -- the launch plan: csrc/clahe.cu's grid, mirrored ------------------------------


def group_tile_rows(k: int, g: int) -> tuple[int, int]:
    """The tile rows (ylo, yhi) that group ``k`` of half-block rows reads:
    group 0 is half-block row 0, group k in 1..g-1 rows 2k-1 and 2k, group g
    row 2g-1."""
    return max(k - 1, 0), min(k, g - 1)


def group_rows(k: int, h: int, g: int) -> tuple[int, int]:
    """The pixel rows ``[begin, end)`` of group ``k``."""
    hh = h // (2 * g)
    return max(0, (2 * k - 1) * hh), min(h, (2 * k + 1) * hh)


def band_half_rows(band: int, bands: int, g: int) -> tuple[int, int]:
    """The half-block rows ``[r0, r1)`` of band ``band`` of ``bands``."""
    return band * 2 * g // bands, (band + 1) * 2 * g // bands


def band_groups(band: int, bands: int, g: int) -> tuple[int, int]:
    """The groups ``[k0, k1)`` that band ``band`` of ``bands`` reaches into."""
    r0, r1 = band_half_rows(band, bands, g)
    return (r0 + 1) // 2, r1 // 2 + 1


def band_group_rows(k: int, band: int, bands: int, h: int, g: int) -> tuple[int, int]:
    """The pixel rows ``[begin, end)`` of group ``k`` that band ``band`` blends."""
    r0, r1 = band_half_rows(band, bands, g)
    hh = h // (2 * g)
    begin, end = group_rows(k, h, g)
    return max(begin, r0 * hh), min(end, r1 * hh)


def staged_tile_rows(k0: int, k1: int, g: int) -> list[tuple[int, int]]:
    """The kernel's staging of a band ``[k0, k1)``, in order: ``(tile row,
    group)`` for each copy, where ``group`` is the iteration that issues it
    (``k0 - 1`` for the copies before the loop)."""
    lo, hi = group_tile_rows(k0, g)
    out = [(lo, k0 - 1)] + ([(hi, k0 - 1)] if hi != lo else [])
    for k in range(k0, k1 - 1):
        nxt = group_tile_rows(k + 1, g)[1]
        if nxt != group_tile_rows(k, g)[1]:
            out.append((nxt, k))
    return out


@dataclass(frozen=True)
class BlendPlan:
    """How one launch covers ``n`` image-channels of ``(h, w)`` pixels: a
    block per (image-channel, band of half-block rows, column tile); ``threads_x``
    threads along a row, each on ``vec`` consecutive columns, so a column
    tile is ``threads_x * vec`` columns; ``tile_cols`` is the most tile
    columns a block stages of a tile row."""

    n: int
    h: int
    w: int
    g: int
    vec: int
    threads_x: int
    bands: int
    tile_cols: int

    @property
    def threads_y(self) -> int:
        return THREADS // self.threads_x

    @property
    def tile_width(self) -> int:
        return self.threads_x * self.vec

    @property
    def col_tiles(self) -> int:
        return -(-self.w // self.tile_width)

    @property
    def blocks(self) -> int:
        return self.n * self.bands * self.col_tiles

    @property
    def smem_bytes(self) -> int:
        return 4 * RING * self.tile_cols * BINS

    def columns(self, ct: int) -> tuple[int, int]:
        """The pixel columns ``[begin, end)`` of column tile ``ct``."""
        begin = ct * self.tile_width
        return begin, min(begin + self.tile_width, self.w)

    def staged_tile_cols(self, ct: int) -> tuple[int, int]:
        """The tile columns ``[begin, end)`` that column tile ``ct`` stages:
        from its first column's xlo to its last column's xhi."""
        hw = self.w // (2 * self.g)
        begin, end = self.columns(ct)
        lo = min(max((begin // hw - 1) // 2, 0), self.g - 1)
        hi = min(((end - 1) // hw - 1) // 2 + 1, self.g - 1)
        return lo, hi + 1

    @property
    def blocks_per_sm(self) -> int:
        """Blocks an SM holds at once: by registers (the kernel's launch
        bounds), shared memory and threads."""
        by_smem = SM_SHARED_MEMORY // (self.smem_bytes + RESERVED_SMEM)
        return min(BLOCKS_PER_SM_BY_REGISTERS, by_smem, SM_THREADS // THREADS)


def make_plan(n: int, h: int, w: int, g: int, vec: int, threads_x: int, bands: int) -> BlendPlan:
    """A plan with these choices; raises where the kernel cannot take them."""
    if vec not in (1, 4) or (vec == 4 and (w // (2 * g)) % 4):
        raise ValueError(f"{vec} columns a thread do not fit half-block columns of {w // (2 * g)}")
    if threads_x < 1 or THREADS % threads_x:
        raise ValueError(f"{threads_x} threads along a row do not divide {THREADS}")
    if not 1 <= bands <= 2 * g:
        raise ValueError(f"{bands} bands of {2 * g} half-block rows")
    plan = BlendPlan(n, h, w, g, vec, threads_x, bands, 0)
    tile_cols = max(e - b for b, e in (plan.staged_tile_cols(ct) for ct in range(plan.col_tiles)))
    plan = BlendPlan(n, h, w, g, vec, threads_x, bands, tile_cols)
    if plan.blocks > MAX_BLOCKS:
        raise ValueError(f"the CLAHE kernel takes at most {MAX_BLOCKS} blocks a launch, {n} image-channels need "
                         f"{plan.blocks}")
    return plan


@functools.lru_cache(maxsize=64)
def blend_plan(n: int, h: int, w: int, g: int, vec_ok: bool, sm_count: int) -> BlendPlan:
    """The launch plan for ``n`` image-channels of ``(h, w)`` pixels on a
    card of ``sm_count`` SMs. ``vec_ok``: x and out are 16-byte aligned.

    A thread takes 4 columns where half-block columns are a multiple of 4
    wide and the pointers allow it; a column tile is up to 32 threads wide
    (128 columns on the 16-byte path). Bands of half-block rows (all the
    same size, so blocks are evenly loaded): as many as give each SM up to
    BLOCKS_PER_SM_TARGET blocks in one wave, and no more, since every band
    waits once for its first tile rows and stages again the tile row it
    shares with the band above."""
    vec = 4 if vec_ok and (w // (2 * g)) % 4 == 0 else 1
    threads_x = min(32, 1 << max(w // vec - 1, 0).bit_length())
    plan = make_plan(n, h, w, g, vec, threads_x, 1)
    per_sm = max(min(BLOCKS_PER_SM_TARGET, plan.blocks_per_sm), 1)
    bands = min(2 * g, max(1, sm_count * per_sm // max(n * plan.col_tiles, 1)))
    return make_plan(n, h, w, g, vec, threads_x, bands)


@functools.lru_cache(maxsize=16)
def _device_maps(h: int, w: int, g: int, index: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    return tuple(torch.tensor(m, device=torch.device("cuda", index)) for m in blend_maps(h, w, g))


@functools.lru_cache(maxsize=1)
def _library() -> ctypes.CDLL:
    lib = load_library("clahe.cu")
    lib.lp_clahe_smem_bytes.argtypes = [ctypes.c_int]
    lib.lp_clahe_smem_bytes.restype = ctypes.c_size_t
    lib.lp_clahe_blocks_per_sm.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int)]
    lib.lp_clahe_blocks_per_sm.restype = ctypes.c_int
    lib.lp_clahe_launch.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10 + [ctypes.c_void_p]
    lib.lp_clahe_launch.restype = ctypes.c_int
    return lib


@functools.lru_cache(maxsize=8)
def _card(index: int) -> tuple[int, int]:
    """SMs and the shared memory a block may opt in to, of CUDA device ``index``."""
    props = torch.cuda.get_device_properties(index)
    return props.multi_processor_count, props.shared_memory_per_block_optin


def blocks_per_sm(plan: BlendPlan, device: torch.device) -> int:
    """What the CUDA occupancy calculator says one SM holds of the kernel
    for ``plan`` (``BlendPlan.blocks_per_sm`` is its mirror)."""
    blocks = ctypes.c_int(0)
    err = _library().lp_clahe_blocks_per_sm(plan.vec, plan.tile_cols, device.index, ctypes.byref(blocks))
    if err != 0:
        raise RuntimeError(f"CLAHE kernel occupancy query failed with CUDA error {err}")
    return blocks.value


def _launch(x: torch.Tensor, lut: torch.Tensor, out: torch.Tensor, plan: BlendPlan) -> torch.Tensor:
    """Launch the kernel by ``plan`` on checked CUDA tensors, writing ``out``."""
    global launches
    index = x.device.index
    limit = _card(index)[1]
    if plan.smem_bytes > limit:
        raise ValueError(
            f"CLAHE kernel: {plan.tile_cols} tile columns of a {plan.g}x{plan.g} grid need {plan.smem_bytes} "
            f"bytes of shared memory per block; the card allows {limit}"
        )
    if plan.vec == 4 and (x.data_ptr() % 16 or out.data_ptr() % 16):
        raise ValueError("the CLAHE kernel's 16-byte path needs 16-byte aligned pixels and output")
    xmap, wx, wy = _device_maps(plan.h, plan.w, plan.g, index)
    if plan.blocks:
        err = _library().lp_clahe_launch(
            x.data_ptr(), lut.data_ptr(), xmap.data_ptr(), wx.data_ptr(), wy.data_ptr(), out.data_ptr(),
            plan.blocks, plan.h, plan.w, plan.g, plan.vec, plan.threads_x, plan.bands, plan.col_tiles,
            plan.tile_cols, index, torch.cuda.current_stream(index).cuda_stream,
        )
        if err != 0:
            raise RuntimeError(f"CLAHE kernel launch failed with CUDA error {err}")
        launches += 1
    return out


def clahe_apply(x: torch.Tensor, lut: torch.Tensor, g: int) -> torch.Tensor:
    """Blend per-tile LUTs over pixels: ``x (N, H, W)``, ``lut (N, g, g,
    256)`` -> ``(N, H, W)`` fp32.

    A CUDA tensor runs the CUDA kernel; a CPU tensor runs
    :func:`clahe_apply_plain`. Anything else raises.
    """
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
    out = torch.empty_like(x)
    plan = blend_plan(n, h, w, g, x.data_ptr() % 16 == 0 and out.data_ptr() % 16 == 0, _card(x.device.index)[0])
    return _launch(x, lut, out, plan)
