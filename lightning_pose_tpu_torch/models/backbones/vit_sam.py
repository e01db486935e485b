"""The SAM ViTDet vision encoder (counterpart of
``lightning_pose_tpu/models/backbones/vit_sam.py``): ``(B, 3, H, W)`` in, a
``(B, D, H/16, W/16)`` token grid out.

A patch-16 embedding, a spatial position table ``(1, g, g, D)`` (SAM's
64 x 64 table resized to the fine-tune grid when its file is loaded;
resized bicubically in the forward for another input size), and blocks of
14 x 14 windowed attention except at the global-attention indexes. As in
the JAX package (and the reference's wrapper), there is no relative
position bias, no neck and no final LayerNorm.

A grid that windows do not tile is zero-padded at its bottom and right
after ``ln1`` (a 16 x 16 grid becomes 28 x 28): the padded tokens go
through ``qkv``, so they carry its bias, and they are attended with no
mask, exactly as in the JAX package. The blocks work on ``(B, h, w, D)``
grids; the layers keep flax's names (``block{i}/{ln1, qkv, proj, ln2,
lin1, lin2}``).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lightning_pose_tpu_torch.models.backbones.vit_dino import attention
from lightning_pose_tpu_torch.ops.interpolate import bicubic_resize_2d

__all__ = ["SamBlock", "SamViT", "window_partition", "window_unpartition"]


def window_partition(x: torch.Tensor, window: int) -> tuple[torch.Tensor, tuple[int, int]]:
    """``(B, H, W, C)`` -> ``(B * nWin, window, window, C)``, zero-padding
    the bottom and right; also returns the padded ``(H, W)``."""
    b, h, w, c = x.shape
    pad_h = (window - h % window) % window
    pad_w = (window - w % window) % window
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    ph, pw = h + pad_h, w + pad_w
    x = x.reshape(b, ph // window, window, pw // window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(-1, window, window, c), (ph, pw)


def window_unpartition(
    windows: torch.Tensor, window: int, padded_hw: tuple[int, int], hw: tuple[int, int]
) -> torch.Tensor:
    """Inverse of :func:`window_partition`, the padding cropped."""
    ph, pw = padded_hw
    h, w = hw
    c = windows.shape[-1]
    b = windows.shape[0] // ((ph // window) * (pw // window))
    x = windows.reshape(b, ph // window, pw // window, window, window, c).permute(0, 1, 3, 2, 4, 5)
    return x.reshape(b, ph, pw, c)[:, :h, :w, :]


class SamBlock(nn.Module):
    def __init__(self, dim: int, num_heads: int, window_size: int, mlp_dim: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.window_size = window_size  # 0: global attention
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.lin1 = nn.Linear(dim, mlp_dim)
        self.lin2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h, w, d = x.shape[1:]
        y = self.ln1(x)
        if self.window_size > 0:
            y, padded_hw = window_partition(y, self.window_size)
        b, wh, ww, _ = y.shape
        q, k, v = self.qkv(y.reshape(b, wh * ww, d)).chunk(3, dim=-1)
        y = self.proj(attention(q, k, v, self.num_heads)).reshape(b, wh, ww, d)
        if self.window_size > 0:
            y = window_unpartition(y, self.window_size, padded_hw, (h, w))
        x = x + y
        return x + self.lin2(F.gelu(self.lin1(self.ln2(x)), approximate="none"))


class SamViT(nn.Module):
    """The SAM vision encoder, neck dropped. ``pos_grid`` is the side of the
    stored position table, the fine-tune grid (``image_size / 16``)."""

    def __init__(
        self,
        embed_dim: int = 768,
        depth: int = 12,
        num_heads: int = 12,
        patch_size: int = 16,
        window_size: int = 14,
        global_attn_indexes: tuple[int, ...] = (2, 5, 8, 11),
        pos_grid: int = 16,
    ) -> None:
        super().__init__()
        self.depth = depth
        self.pos_grid = pos_grid
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.pos_embed = nn.Parameter(torch.zeros(1, pos_grid, pos_grid, embed_dim))
        for i in range(depth):
            window = 0 if i in global_attn_indexes else window_size
            setattr(self, f"block{i}", SamBlock(embed_dim, num_heads, window, 4 * embed_dim))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.patch_embed(x).permute(0, 2, 3, 1)  # (B, gh, gw, D)
        gh, gw = tokens.shape[1:3]
        pos = self.pos_embed
        if (gh, gw) != (self.pos_grid, self.pos_grid):
            pos = bicubic_resize_2d(pos.permute(0, 3, 1, 2), (gh, gw)).permute(0, 2, 3, 1)
        tokens = tokens + pos.to(tokens.dtype)
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        return tokens.permute(0, 3, 1, 2)
