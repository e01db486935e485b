"""Roofline bounds of the port's kernels (copied from ``chip_smoke.py``'s
``decode_flops``, ``decode_grad_flops`` and ``bound_of``), and the peaks of
one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W limit).

Each input byte is counted read once and each output byte written once,
whatever a kernel reads again, so that the count is the same whatever
implements the kernel."""

from __future__ import annotations

import numpy as np

from lpbench.reference.model import upsample_matrix

__all__ = [
    "BF16_FLOPS_PER_S", "FP32_FLOPS_PER_S", "HBM_BYTES_PER_S",
    "bound_s", "decode_bytes", "decode_flops", "decode_grad_bytes", "decode_grad_flops", "normalize_bytes",
]

HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12


def bound_s(n_bytes: float, flops: float) -> float:
    """The least time the card could take: bytes at the HBM rate or FP32
    operations at the FP32 rate, the larger."""
    return max(n_bytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S)


def decode_flops(n_maps: int, h: int, w: int, df: int = 2) -> int:
    """FP32 operations of the banded decode: 2 per multiply-add of ``T = hm
    @ Mw^T`` and ``up = Mh @ T`` over the non-zeros of the upsample
    matrices."""
    m_h, m_w = upsample_matrix(h, df), upsample_matrix(w, df)
    fmas = h * int(np.count_nonzero(m_w)) + m_w.shape[0] * int(np.count_nonzero(m_h))
    return 2 * fmas * n_maps


def decode_bytes(n_maps: int, h: int, w: int) -> int:
    """fp32 maps read; two keypoint coordinates and a confidence written."""
    return (n_maps * h * w + n_maps * 3) * 4


def decode_grad_flops(n_maps: int, h: int, w: int, df: int = 2) -> int:
    """FP32 operations of the banded backward: ``T`` and ``up`` recomputed as
    the forward has them, ``u = dup @ Mw`` and ``Mh^T @ u``."""
    m_h, m_w = upsample_matrix(h, df), upsample_matrix(w, df)
    nnz_h, nnz_w = int(np.count_nonzero(m_h)), int(np.count_nonzero(m_w))
    fmas = h * nnz_w + m_w.shape[0] * nnz_h + m_h.shape[0] * nnz_w + w * nnz_h
    return 2 * fmas * n_maps


def decode_grad_bytes(n_maps: int, h: int, w: int) -> int:
    """fp32 maps read and their gradient written; keypoints, their
    gradient and the log-sum-exp read."""
    return (2 * n_maps * h * w + n_maps * 5) * 4


def normalize_bytes(n_pixels: int, out_bytes: int = 2) -> int:
    """uint8 RGB read, the normalized values written (bf16: 2 bytes)."""
    return n_pixels * 3 * (1 + out_bytes)
