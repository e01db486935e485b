"""The CLAHE kernel's launch plan and maps, on the CPU: the bands, column
tiles and tile-row staging that ``ops/clahe_kernel.py`` mirrors from
``csrc/clahe.cu`` cover every pixel once and stage what each block reads,
and the maps the kernel is given equal the JAX package's ``_static_maps``."""

from __future__ import annotations

import numpy as np
import pytest

from lightning_pose_tpu.ops.pallas_clahe import _static_maps
from lightning_pose_tpu_torch.ops import clahe_kernel as ck

# (N, H, W, g): the product shape, a train step's fired subsets, the card
# tests' shapes, tall half-blocks, odd grids, half-block columns that are
# not a multiple of 4 wide
SHAPES = [
    (48, 256, 256, 16),
    (6, 256, 256, 16),
    (1, 256, 256, 16),
    (6, 256, 256, 8),
    (5, 96, 160, 8),
    (3, 64, 64, 2),
    (2, 60, 36, 3),
    (4, 128, 384, 16),
    (1, 1024, 64, 4),
    (7, 40, 1000, 5),
]


def _plans(n, h, w, g):
    """Every plan the kernel takes at this shape: both pixel paths where
    they fit, each width of a column tile, each number of bands."""
    vecs = (1, 4) if (w // (2 * g)) % 4 == 0 else (1,)
    for vec in vecs:
        for threads_x in (64, 32, 16, 256):
            for bands in range(1, 2 * g + 1):
                yield ck.make_plan(n, h, w, g, vec, threads_x, bands)


@pytest.mark.parametrize("n, h, w, g", SHAPES)
def test_bands_cover_every_half_block_row_once(n, h, w, g):
    """Each band's half-block rows, and the rows it blends group by group,
    cover the image once; a band blends rows of every group it stages for."""
    hh = h // (2 * g)
    for bands in range(1, 2 * g + 1):
        rows = np.zeros(h, dtype=int)
        half_rows = np.zeros(2 * g, dtype=int)
        for band in range(bands):
            r0, r1 = ck.band_half_rows(band, bands, g)
            assert r0 < r1, (bands, band)
            half_rows[r0:r1] += 1
            k0, k1 = ck.band_groups(band, bands, g)
            for k in range(k0, k1):
                begin, end = ck.band_group_rows(k, band, bands, h, g)
                assert begin < end and begin % hh == 0 and end % hh == 0, (bands, band, k)
                assert ck.group_rows(k, h, g)[0] <= begin and end <= ck.group_rows(k, h, g)[1]
                rows[begin:end] += 1
        assert (rows == 1).all() and (half_rows == 1).all(), bands


@pytest.mark.parametrize("n, h, w, g", SHAPES)
def test_column_tiles_cover_every_column_once(n, h, w, g):
    xmap = ck.blend_maps(h, w, g)[0]
    hw = w // (2 * g)
    for plan in _plans(n, h, w, g):
        cols = np.zeros(w, dtype=int)
        for ct in range(plan.col_tiles):
            begin, end = plan.columns(ct)
            cols[begin:end] += 1
            for c in range(begin, end, plan.vec):  # a thread's columns lie in one half-block column
                assert c // hw == (c + plan.vec - 1) // hw
                assert len(set(xmap[c:c + plan.vec].tolist())) == 1
        assert (cols == 1).all(), plan
        assert plan.blocks == n * plan.bands * plan.col_tiles


@pytest.mark.parametrize("n, h, w, g", SHAPES)
def test_each_band_stages_the_tile_rows_it_reads(n, h, w, g):
    """Replays the kernel's ring of tile rows: every row a group reads was
    staged before the group (by an earlier iteration or before the loop),
    once per band, and its slot was not staged over before the group."""
    for bands in range(1, 2 * g + 1):
        for band in range(bands):
            k0, k1 = ck.band_groups(band, bands, g)
            staged = ck.staged_tile_rows(k0, k1, g)
            rows = [t for t, _ in staged]
            assert len(rows) == len(set(rows))
            read = {t for k in range(k0, k1) for t in ck.group_tile_rows(k, g)}
            assert set(rows) == read
            slots: dict[int, int] = {}
            for k in range(k0, k1):
                for t, issued in staged:
                    if issued == k - 1:
                        slots[t % ck.RING] = t
                for t in ck.group_tile_rows(k, g):
                    assert slots[t % ck.RING] == t, (bands, band, k, t)


@pytest.mark.parametrize("n, h, w, g", SHAPES)
def test_staged_tile_columns_hold_what_the_columns_read(n, h, w, g):
    xmap = ck.blend_maps(h, w, g)[0]
    xlo, xhi = xmap & 0xFFFF, xmap >> 16
    for plan in _plans(n, h, w, g):
        for ct in range(plan.col_tiles):
            begin, end = plan.columns(ct)
            t0, t1 = plan.staged_tile_cols(ct)
            assert t0 == xlo[begin:end].min() and t1 == xhi[begin:end].max() + 1
            assert t1 - t0 <= plan.tile_cols <= g
        assert plan.smem_bytes == 4 * ck.RING * plan.tile_cols * ck.BINS


@pytest.mark.parametrize("n, h, w, g", SHAPES)
def test_blend_maps_equal_jax_static_maps(n, h, w, g):
    """The per-column tile columns and weights the kernel is given make the
    JAX package's selection matrix SW (W, g), and the per-row weights its
    wy; bit for bit."""
    xmap, wx, wy = ck.blend_maps(h, w, g)
    sw_ref, wy_ref = _static_maps(h, w, g)
    sw = np.zeros((w, g), dtype=np.float32)
    sw[np.arange(w), xmap & 0xFFFF] += 1.0 - wx
    sw[np.arange(w), xmap >> 16] += wx
    assert xmap.dtype == np.int32 and wx.dtype == np.float32 and wy.dtype == np.float32
    np.testing.assert_array_equal(sw, sw_ref)
    np.testing.assert_array_equal(wy, wy_ref.reshape(-1))


@pytest.mark.parametrize("n, h, w, g", SHAPES)
@pytest.mark.parametrize("sm_count", [132, 8])
def test_default_plan(n, h, w, g, sm_count):
    """The wrapper's plan: 16-byte accesses where half-block columns are a
    multiple of 4 wide and the pointers are aligned; the most bands that
    keep the blocks within one wave of up to 3 an SM."""
    for vec_ok in (True, False):
        plan = ck.blend_plan(n, h, w, g, vec_ok, sm_count)
        assert plan.vec == (4 if vec_ok and (w // (2 * g)) % 4 == 0 else 1)
        assert plan.threads_x * plan.threads_y == ck.THREADS and plan.threads_x <= 32
        wave = sm_count * min(ck.BLOCKS_PER_SM_TARGET, plan.blocks_per_sm)
        assert plan.blocks <= wave or plan.bands == 1
        assert plan.bands == 2 * g or plan.blocks + n * plan.col_tiles > wave


def test_fewer_bands_for_more_image_channels():
    """Product shape: the 48 image-channels of a batch take fewer bands
    (a tile row staged again less often) than a train step's 6."""
    many = ck.blend_plan(48, 256, 256, 16, True, 132)
    few = ck.blend_plan(6, 256, 256, 16, True, 132)
    assert many.bands < few.bands
    assert few.blocks >= 132 and 132 < many.blocks <= 132 * ck.BLOCKS_PER_SM_TARGET


@pytest.mark.parametrize(
    "args",
    [
        (2, 96, 160, 8, 4, 64, 3),  # half-block columns of 10: no 16-byte path
        (2, 64, 64, 4, 2, 64, 3),  # 2 columns a thread
        (2, 64, 64, 4, 4, 48, 3),  # 48 threads along a row do not divide 256
        (2, 64, 64, 4, 4, 64, 0),  # no band
        (2, 64, 64, 4, 4, 64, 9),  # more bands than half-block rows
        (2**30, 256, 256, 16, 4, 64, 17),  # more blocks than a grid holds
    ],
)
def test_make_plan_rejects_what_the_kernel_does_not_take(args):
    with pytest.raises(ValueError):
        ck.make_plan(*args)
