"""The FLOP and byte counters against counts made by hand."""

from __future__ import annotations

import numpy as np
import pytest

from lpbench.counts import kernels
from lpbench.counts.flops import context_model_flops
from lpbench.reference.model import upsample_matrix


def _banded_fmas(h: int, w: int, df: int) -> int:
    """Multiply-adds of ``Mh @ (hm @ Mw^T)`` counted one by one, skipping
    the zeros of the upsample matrices."""
    mh, mw = upsample_matrix(h, df), upsample_matrix(w, df)
    fmas = 0
    for _row in range(h):  # T = hm @ Mw^T: (h, W)
        for c in range(mw.shape[0]):
            fmas += sum(1 for j in range(w) if mw[c, j] != 0)
    for r in range(mh.shape[0]):  # up = Mh @ T: (H, W)
        for _col in range(mw.shape[0]):
            fmas += sum(1 for i in range(h) if mh[r, i] != 0)
    return fmas


@pytest.mark.parametrize("h, w, df", [(3, 3, 1), (4, 6, 2), (8, 5, 2)])
def test_decode_flops_count_each_multiply_add(h, w, df):
    assert kernels.decode_flops(7, h, w, df) == 7 * 2 * _banded_fmas(h, w, df)


def test_decode_flops_at_the_smoke_shape():
    # chip_smoke's decode bound at (96, 17, 64, 64): 0.03280 ms of FP32 ops
    flops = kernels.decode_flops(96 * 17, 64, 64)
    assert flops / kernels.FP32_FLOPS_PER_S * 1e3 == pytest.approx(0.03280, abs=5e-6)


def test_decode_grad_flops_are_the_forward_and_its_transpose():
    h = w = 64
    mh, mw = upsample_matrix(h, 2), upsample_matrix(w, 2)
    nnz_h, nnz_w = np.count_nonzero(mh), np.count_nonzero(mw)
    forward = h * nnz_w + mw.shape[0] * nnz_h
    assert kernels.decode_grad_flops(1, h, w) == 2 * (forward + mh.shape[0] * nnz_w + w * nnz_h)


def test_bytes():
    assert kernels.normalize_bytes(2 * 4 * 4) == 2 * 4 * 4 * 3 * (1 + 2)
    assert kernels.decode_bytes(3, 4, 5) == (3 * 4 * 5 + 3 * 3) * 4
    assert kernels.decode_grad_bytes(3, 4, 5) == (2 * 3 * 4 * 5 + 3 * 5) * 4


def test_bound_takes_the_larger():
    assert kernels.bound_s(3.35e12, 0) == pytest.approx(1.0)
    assert kernels.bound_s(0, 67e12) == pytest.approx(1.0)
    assert kernels.bound_s(3.35e12, 2 * 67e12) == pytest.approx(2.0)


def test_resnet50_trunk_flops_match_the_published_count():
    # torchvision's ResNet-50: 4.09 GMAC a 224 x 224 image, of which the
    # classifier (2048 x 1000) is 0.002; FlopCounterMode counts 2 a MAC
    trunk, heads = context_model_flops(17, 224, 224)
    assert trunk == pytest.approx(2 * (4.09e9 - 2048 * 1000), rel=0.01)
    assert 0 < heads < trunk
    # the convolutions scale with the pixels
    trunk256, _ = context_model_flops(7, 256, 256)
    assert trunk256 == pytest.approx(trunk * (256 / 224) ** 2, rel=0.02)
