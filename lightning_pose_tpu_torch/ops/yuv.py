"""I420 (YUV 4:2:0) -> RGB, the plain PyTorch versions (counterpart of
``lightning_pose_tpu/ops/yuv.py``).

Video prediction, and the unlabeled stream of semi-supervised training, can
move frames host -> device as planar 4:2:0 YUV: 1.5 bytes a pixel instead of
RGB's 3, the analog of DALI shipping the video's subsampled-chroma stream to
the GPU (reference lightning_pose/data/dali.py:70-124). The conversion uses
ITU-R BT.601 video-range coefficients (Y in [16, 235]) and nearest-neighbour
chroma upsampling, as OpenCV's ``COLOR_YUV2RGB_I420`` does on the host.

These are the plain versions of the I420 kernel (``ops/yuv_kernel.py``),
which the CPU runs; the arithmetic is the JAX package's, in fp32 with one
cast at the end.

An I420 image of ``H`` rows holds ``H`` rows of Y, then ``H/4`` rows of
width ``W`` holding the ``(H/2, W/2)`` U plane, then the V plane likewise.
The JAX package finds the U plane by a reshape of those ``H/4`` rows, which
fails for ``H % 4 == 2``; here such a height raises ``ValueError`` up front.
"""

from __future__ import annotations

import torch

from lightning_pose_tpu_torch.ops.preprocess import IMAGENET_MEAN, IMAGENET_STD

__all__ = ["check_i420", "i420_to_normalized_rgb", "i420_to_rgb"]

# BT.601 video range (Y 16-235, chroma 16-240), as the JAX package's
Y_SCALE = 1.1643836
R_FROM_V = 1.5960268
G_FROM_U = 0.3917623
G_FROM_V = 0.8129676
B_FROM_U = 2.0172321


def check_i420(yuv: torch.Tensor) -> tuple[int, int, int]:
    """``(N, H, W)`` of an I420 batch ``(N, H*3/2, W)`` uint8; raises unless
    ``H % 4 == 0`` and ``W`` is even."""
    if yuv.dtype != torch.uint8 or yuv.ndim != 3:
        raise ValueError(f"I420 batches are (N, H*3/2, W) uint8, got {tuple(yuv.shape)} {yuv.dtype}")
    n, rows, w = yuv.shape
    if rows % 6 or w % 2:
        raise ValueError(
            f"I420 needs an image height that is a multiple of 4 and an even width: {rows} rows of width {w} "
            f"are not H*3/2 rows for such an H"
        )
    return n, rows * 2 // 3, w


def i420_to_rgb(yuv: torch.Tensor) -> torch.Tensor:
    """Planar I420 ``(N, H*3/2, W)`` uint8 -> ``(N, H, W, 3)`` float32 RGB
    in [0, 255]."""
    n, h, w = check_i420(yuv)
    y = yuv[:, :h, :].to(torch.float32)
    u = yuv[:, h:h + h // 4, :].reshape(n, h // 2, w // 2).to(torch.float32)
    v = yuv[:, h + h // 4:, :].reshape(n, h // 2, w // 2).to(torch.float32)
    # nearest-neighbour chroma upsample (cv2's I420 handling)
    u = u.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    v = v.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    yp = Y_SCALE * (y - 16.0)
    up = u - 128.0
    vp = v - 128.0
    r = yp + R_FROM_V * vp
    g = yp - G_FROM_U * up - G_FROM_V * vp
    b = yp + B_FROM_U * up
    return torch.stack([r, g, b], dim=-1).clamp(0.0, 255.0)


def i420_to_normalized_rgb(yuv: torch.Tensor, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """I420 batches -> ImageNet-normalized ``(N, H, W, 3)`` RGB in
    ``out_dtype`` (the I420 analog of ``normalize_images``)."""
    rgb = i420_to_rgb(yuv) / 255.0
    mean = torch.tensor(IMAGENET_MEAN, dtype=torch.float32, device=yuv.device)
    std = torch.tensor(IMAGENET_STD, dtype=torch.float32, device=yuv.device)
    return ((rgb - mean) / std).to(out_dtype)
