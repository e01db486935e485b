"""The decode backward kernel's plan, emulated on the CPU in float64.

``csrc/decode_grad.cu`` cuts each map into ``GRAD_CLUSTER`` strips of
output rows, builds only the rows of T that a strip's Mh band reaches,
walks the strip in chunks, forms u = dup @ Mw and the strip's partial
Mh^T @ u over transposed bands that the wrapper packs (``grad_plan``), and
sums the strips' overlapping partial rows in rank order. This file replays
that index logic in numpy over the plan's packed arrays and holds it to
autograd of the plain decode in float64, so that a wrong range, offset or
ownership shows here and not first on the card.
"""

from __future__ import annotations

import math

import numpy as np
import pytest
import torch

from lightning_pose_tpu_torch.ops import decode_kernel
from lightning_pose_tpu_torch.ops.decode_kernel import GRAD_CLUSTER, grad_plan, row_tile_bands

# decode.cu's kRows, kCols, kCluster and kMaxBand
LAYOUT = decode_kernel._Layout(4, 4, 2, 10)
# decode_grad.cu's u tile: rows kULanes apart, kUTile of them; dhm tiles a block holds
U_LANES, U_TILE, MAX_DHM_TILES = 16, 4, 2 * 256
TEMPERATURE = 1000.0
# float64 sums in another order than autograd's
F64_REL_TOL = 1e-10


def _peaked(b, k, h, w, seed):
    rng = np.random.default_rng(seed)
    rows, cols = np.mgrid[0:h, 0:w]
    centers = rng.uniform(2, [h - 3, w - 3], (b, k, 2))
    d2 = (rows - centers[..., 0, None, None]) ** 2 + (cols - centers[..., 1, None, None]) ** 2
    return np.exp(-d2 / 4.0) + 0.01 * rng.random((b, k, h, w))


def _u_rows(crows4: int, reads: list[int] | None = None) -> list[int]:
    """The u rows the kernel's items write, in item order; the dup rows they
    read are appended to ``reads``. An item whose first row is past the
    chunk does nothing; its other rows past the chunk read its first."""
    n_lg = U_LANES * -(-crows4 // (U_LANES * U_TILE))
    rows = []
    for lg in range(n_lg):
        base = (lg // U_LANES) * U_LANES * U_TILE + lg % U_LANES
        if base >= crows4:
            continue
        rows += [base + U_LANES * m for m in range(U_TILE) if base + U_LANES * m < crows4]
        if reads is not None:
            reads += [base + U_LANES * m if base + U_LANES * m < crows4 else base for m in range(U_TILE)]
    return rows


def _emulate(hm, kp, grad_kp, df, plan):
    """dhm of ``(N, h, w)`` float64 maps as the kernel's blocks compute it:
    each strip's two partial arrays added, then the strips in rank order.
    ``kp`` are the forward's keypoints (N, 2) with the grid offset removed,
    ``grad_kp`` their gradient."""
    n, h, w = hm.shape
    m_h, m_w = plan.m_h.astype(np.float64), plan.m_w.astype(np.float64)
    big_h, wp, big_w = m_h.shape[0], m_w.shape[0], w * 2**df
    wu = 4 * -(-w // 4)
    mh_bands = row_tile_bands(plan.m_h, LAYOUT.band_rows)
    mh_tiles = decode_kernel._tile_packed_mh(plan.m_h, mh_bands, LAYOUT).astype(np.float64)
    mw_bands = row_tile_bands(plan.m_w, LAYOUT.band_cols)
    mw_packed = decode_kernel._band_packed_mw(plan.m_w, mw_bands, LAYOUT).astype(np.float64)
    mwt, mht = plan.mwt_packed.astype(np.float64), plan.mht_packed.astype(np.float64)
    up_dense = m_h @ hm @ m_w[:big_w].T
    z = TEMPERATURE * up_dense.reshape(n, -1)
    lse = z.max(1) + np.log(np.exp(z - z.max(1, keepdims=True)).sum(1))
    x = kp[:, 0] + decode_kernel.GRID_OFFSETS[df]
    y = kp[:, 1] + decode_kernel.GRID_OFFSETS[df]
    gx, gy = grad_kp[:, 0], grad_kp[:, 1]

    partials = []
    for rank in range(GRAD_CLUSTER):
        p_begin = min(rank * plan.strip_rows, big_h)
        p_end = min(p_begin + plan.strip_rows, big_h)
        ilo, ihi = (int(v) for v in plan.strip_band[rank])
        nb = ihi - ilo if p_end > p_begin else 0
        assert nb <= plan.band_rows
        t = np.zeros((n, nb, wp))
        for ct, (jlo, jhi) in enumerate(mw_bands):
            t[:, :, 4 * ct:4 * ct + 4] = hm[:, ilo:ilo + nb, jlo:jhi] @ mw_packed[: jhi - jlo, ct]
        it_lo = ilo // 4
        it_hi = -(-(ilo + nb) // 4) if nb else it_lo
        n_items = (it_hi - it_lo) * (wu // 4)
        assert n_items == plan.dhm_tiles(rank) <= MAX_DHM_TILES
        # each item's rows p cut in two parts where the threads hold both
        parts = 2 if 2 * n_items <= MAX_DHM_TILES else 1
        dacc = np.zeros((parts, n, 4 * (it_hi - it_lo), wu))
        for c0 in range(p_begin, p_end, plan.chunk_rows):
            c1 = min(c0 + plan.chunk_rows, p_end)
            crows4 = -(-(c1 - c0) // 4) * 4
            assert crows4 <= plan.chunk_rows
            dup = np.zeros((n, crows4, wp))
            for tl in range(crows4 // 4):
                p0 = c0 + 4 * tl
                lo, hi = mh_bands[p0 // 4]
                # the strip's staged T holds every row its tiles' bands reach
                assert ilo <= lo and hi <= ilo + nb
                up = np.einsum("kr,nkq->nrq", mh_tiles[p0 // 4, : hi - lo], t[:, lo - ilo:hi - ilo])
                rows = (p0 + np.arange(4))[None, :, None]
                cols = np.arange(wp)[None, None, :]
                p = np.exp(TEMPERATURE * up - lse[:, None, None])
                d = TEMPERATURE * p * (gx[:, None, None] * (cols - x[:, None, None])
                                       + gy[:, None, None] * (rows - y[:, None, None]))
                dup[:, 4 * tl:4 * tl + 4] = np.where((rows < p_end) & (cols < big_w), d, 0.0)
            assert sorted(_u_rows(crows4)) == list(range(crows4))
            u = np.zeros((n, crows4, wu))
            for jt, (qlo, qhi) in enumerate(plan.mwt_band):
                assert qlo % 4 == 0 and qhi % 4 == 0 and qhi <= wp
                u[:, :, 4 * jt:4 * jt + 4] = dup[:, :, qlo:qhi] @ mwt[jt, : qhi - qlo]
            for it in range(it_lo, it_hi):
                blo, bhi = (int(v) for v in plan.mht_band[it])
                plo, phi = max(blo, c0), min(bhi, c1)
                mid = (plo + phi) // 2
                cuts = [(plo, phi)] if parts == 1 else [(plo, mid), (mid, phi)]
                for part, (a, b) in enumerate(cuts):
                    if b > a:
                        dacc[part, :, 4 * (it - it_lo):4 * (it - it_lo) + 4] += np.einsum(
                            "pc,npj->ncj", mht[it, a - blo:b - blo], u[:, a - c0:b - c0])
        partials.append(dacc.sum(0))

    out = np.zeros((n, h, w))
    rows_per = -(-h // GRAD_CLUSTER)
    for rank in range(GRAD_CLUSTER):
        for i in range(min(rank * rows_per, h), min(rank * rows_per + rows_per, h)):
            acc = np.zeros((n, wu))
            for r in range(GRAD_CLUSTER):
                lo, hi = (int(v) for v in plan.strip_band[r])
                if lo <= i < hi:
                    acc = acc + partials[r][:, i - 4 * (lo // 4)]
            out[:, i] = acc[:, :w]
    return out


def _autograd(hm, df, seed):
    b, k, h, w = hm.shape
    g = torch.from_numpy(np.random.default_rng(seed).standard_normal((b, 2 * k)))
    x = torch.from_numpy(hm).requires_grad_()
    kp, _ = decode_kernel.decode_plain(x, df, TEMPERATURE)
    (kp * g).sum().backward()
    return kp.detach().numpy().reshape(-1, 2), g.numpy().reshape(-1, 2), x.grad.numpy().reshape(-1, h, w)


@pytest.mark.parametrize(
    "b, k, h, w, df, chunk",
    [
        (32, 17, 64, 64, 2, None),  # the unlabeled window's maps at the product shape
        (4, 17, 48, 64, 2, None),  # rectangular
        (2, 5, 32, 32, 3, None),
        (2, 5, 32, 32, 3, 16),  # a strip walked in chunks
        (3, 3, 20, 12, 1, 4),
        (2, 3, 9, 7, 0, None),
        (1, 2, 128, 128, 2, None),  # too many dhm tiles a strip to cut their rows in two
    ],
)
def test_emulated_plan_equals_autograd_of_plain(b, k, h, w, df, chunk):
    hm = _peaked(b, k, h, w, seed=h + w)
    kp, g, ref = _autograd(hm, df, seed=h)
    plan = grad_plan(h, w, df, LAYOUT, chunk_rows=chunk)
    out = _emulate(hm.reshape(-1, h, w), kp, g, df, plan)
    scale = np.abs(ref).max()
    assert scale > 0
    np.testing.assert_allclose(out, ref, rtol=0, atol=F64_REL_TOL * scale)


def test_plan_at_the_product_shape():
    """Four strips of 64 rows, each reaching about 20 of the 64 hm rows; the
    transposed bands aligned to 4 and holding every non-zero."""
    plan = grad_plan(64, 64, 2, LAYOUT)
    assert plan.strip_rows == plan.chunk_rows == 64
    widths = plan.strip_band[:, 1] - plan.strip_band[:, 0]
    assert plan.band_rows == widths.max() <= 24 and widths.sum() < 2 * 64
    assert (plan.mwt_band % 4 == 0).all()
    dense_w = np.zeros_like(plan.m_w)
    for jt, (lo, hi) in enumerate(plan.mwt_band):
        dense_w[lo:hi, 4 * jt:4 * jt + 4] = plan.mwt_packed[jt, : hi - lo]
    np.testing.assert_array_equal(dense_w, plan.m_w)
    dense_h = np.zeros_like(plan.m_h)
    for it, (lo, hi) in enumerate(plan.mht_band):
        dense_h[lo:hi, 4 * it:4 * it + 4] = plan.mht_packed[it, : hi - lo]
    np.testing.assert_array_equal(dense_h, plan.m_h)
    assert max(plan.dhm_tiles(s) for s in range(GRAD_CLUSTER)) <= MAX_DHM_TILES


@pytest.mark.parametrize("crows4", [4, 12, 16, 48, 64, 100, 128])
def test_u_items_cover_each_row_once(crows4):
    """Each row written once, and no row read past the chunk: the dup
    region holds only the chunk's rows."""
    reads = []
    rows = _u_rows(crows4, reads)
    assert sorted(rows) == list(range(crows4))
    assert all(0 <= r < crows4 for r in reads)


def test_plan_rejects_a_chunk_of_partial_row_tiles():
    with pytest.raises(ValueError):
        grad_plan(64, 64, 2, LAYOUT, chunk_rows=6)


def test_grad_flops_of_the_plan_are_finite():
    """The strips' T rows: about 1.3x the map's rows at the product shape."""
    plan = grad_plan(64, 64, 2, LAYOUT)
    widths = plan.strip_band[:, 1] - plan.strip_band[:, 0]
    assert math.isclose(widths.sum() / 64, 1.3, abs_tol=0.15)
