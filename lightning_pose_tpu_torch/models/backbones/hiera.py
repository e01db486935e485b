"""The SAM2 Hiera trunk (counterpart of
``lightning_pose_tpu/models/backbones/hiera.py``): ``(B, 3, H, W)`` in, a
``(B, 8 * embed_dim, H/32, W/32)`` map out.

A 7 x 7, stride 4, pad 3 patch embedding; a position term that is the
background table resized bicubically to the token grid plus the window
table tiled over it; then four stages of windowed-attention blocks. The
first block of stages 1-3 doubles the width and halves the grid: it
attends at the previous stage's window, max-pools its queries 2 x 2 inside
each window and unpartitions at half that window; its skip path is a Dense
on the ``ln1`` output, max-pooled 2 x 2. The blocks whose index is in
``global_attention_blocks`` attend over the whole grid.

The blocks work on ``(B, h, w, C)`` grids; the layers keep flax's names
(``block{i}/{ln1, proj, attn/{qkv, proj}, ln2, fc1, fc2}``, the tables
``pos_embed`` and ``pos_embed_window`` in flax's ``(1, h, w, C)``). The
max-pools are ``F.max_pool2d`` over 2 x 2 windows that do not overlap, so
their backward adds no two gradients into one place.
"""

from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F
from torch import nn

from lightning_pose_tpu_torch.models.backbones.vit_dino import attention
from lightning_pose_tpu_torch.models.backbones.vit_sam import window_partition, window_unpartition
from lightning_pose_tpu_torch.ops.interpolate import bicubic_resize_2d

__all__ = ["HIERA_CONFIGS", "Hiera", "HieraAttention", "HieraBlock"]

# name -> the variant's fields (SAM2.1 tiny, small, base-plus)
HIERA_CONFIGS: dict[str, dict[str, Any]] = {
    "vitt_sam2": dict(embed_dim=96, num_heads=1, blocks_per_stage=(1, 2, 7, 2), global_attention_blocks=(5, 7, 9),
                      bkg_size=7),
    "vits_sam2": dict(embed_dim=96, num_heads=1, blocks_per_stage=(1, 2, 11, 2), global_attention_blocks=(7, 10, 13),
                      bkg_size=7),
    "vitb_sam2": dict(embed_dim=112, num_heads=2, blocks_per_stage=(2, 3, 16, 3),
                      global_attention_blocks=(12, 16, 20), bkg_size=14),
}


def _max_pool_2x2(x: torch.Tensor) -> torch.Tensor:
    """2 x 2, stride 2 max-pool of a ``(B, H, W, C)`` grid (an odd last row
    or column dropped)."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), 2, 2).permute(0, 2, 3, 1)


class HieraAttention(nn.Module):
    """Fused ``qkv`` (``dim -> 3 * dim_out``), the queries max-pooled 2 x 2
    at a stage change, then ``proj``."""

    def __init__(self, dim: int, dim_out: int, num_heads: int, q_pool: bool = False) -> None:
        super().__init__()
        self.dim_out = dim_out
        self.num_heads = num_heads
        self.q_pool = q_pool
        self.qkv = nn.Linear(dim, 3 * dim_out)
        self.proj = nn.Linear(dim_out, dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, h, w, _ = x.shape
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.dim_out).unbind(2)
        if self.q_pool:
            q = _max_pool_2x2(q.reshape(b, h, w, self.dim_out))
            h, w = q.shape[1:3]
            q = q.reshape(b, h * w, self.dim_out)
        return self.proj(attention(q, k, v, self.num_heads).reshape(b, h, w, self.dim_out))


class HieraBlock(nn.Module):
    def __init__(
        self, dim: int, dim_out: int, num_heads: int, window_size: int, q_pool: bool = False, mlp_ratio: float = 4.0
    ) -> None:
        super().__init__()
        self.dim, self.dim_out = dim, dim_out
        self.window_size = window_size  # 0: global attention
        self.q_pool = q_pool
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        if dim != dim_out:
            self.proj = nn.Linear(dim, dim_out)
        self.attn = HieraAttention(dim, dim_out, num_heads, q_pool)
        self.ln2 = nn.LayerNorm(dim_out, eps=1e-6)
        self.fc1 = nn.Linear(dim_out, int(dim_out * mlp_ratio))
        self.fc2 = nn.Linear(int(dim_out * mlp_ratio), dim_out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        residual = x
        y = self.ln1(x)
        if self.dim != self.dim_out:
            residual = self.proj(y)
            if self.q_pool:
                residual = _max_pool_2x2(residual)
        window = self.window_size
        out_hw = tuple(y.shape[1:3])
        if window > 0:
            y, padded_hw = window_partition(y, window)
        y = self.attn(y)
        if self.q_pool:
            # the attention halved the windows: unpartition at half the
            # window, onto the pooled residual's grid
            window //= 2
            out_hw = tuple(residual.shape[1:3])
            if window:
                padded_hw = tuple(n + (window - n % window) % window for n in out_hw)
        if self.window_size > 0:
            y = window_unpartition(y, window, padded_hw, out_hw)
        x = residual + y
        return x + self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="none"))


class Hiera(nn.Module):
    """The SAM2 Hiera trunk: ``(B, 3, H, W)`` -> ``(B, out_features, H/32,
    W/32)``."""

    def __init__(
        self,
        embed_dim: int = 96,
        num_heads: int = 1,
        blocks_per_stage: tuple[int, ...] = (1, 2, 7, 2),
        global_attention_blocks: tuple[int, ...] = (5, 7, 9),
        window_size_per_stage: tuple[int, ...] = (8, 4, 14, 7),
        num_query_pool_stages: int = 3,
        bkg_size: int = 7,
        mlp_ratio: float = 4.0,
    ) -> None:
        super().__init__()
        self.out_features = embed_dim * 2 ** (len(blocks_per_stage) - 1)
        self.patch_embed = nn.Conv2d(3, embed_dim, 7, stride=4, padding=3)
        self.pos_embed = nn.Parameter(torch.zeros(1, bkg_size, bkg_size, embed_dim))
        ws0 = window_size_per_stage[0]
        self.pos_embed_window = nn.Parameter(torch.zeros(1, ws0, ws0, embed_dim))
        total = 0
        for stage, n_blocks in enumerate(blocks_per_stage):
            for block_idx in range(n_blocks):
                first_of_stage = stage > 0 and block_idx == 0
                in_stage = stage - 1 if first_of_stage else stage
                window = 0 if total in global_attention_blocks else window_size_per_stage[in_stage]
                setattr(self, f"block{total}", HieraBlock(
                    embed_dim * 2**in_stage, embed_dim * 2**stage, num_heads * 2**stage, window,
                    q_pool=first_of_stage and stage <= num_query_pool_stages, mlp_ratio=mlp_ratio,
                ))
                total += 1
        self.depth = total

    def _pos(self, hw: tuple[int, int]) -> torch.Tensor:
        """The background table resized bicubically to ``hw`` plus the window
        table tiled over it: ``(1, h, w, C)``."""
        h, w = hw
        pos = bicubic_resize_2d(self.pos_embed.permute(0, 3, 1, 2), (h, w)).permute(0, 2, 3, 1)
        win = self.pos_embed_window
        ws = win.shape[1]
        win = win.repeat(1, -(-h // ws), -(-w // ws), 1)[:, :h, :w, :]
        return pos + win

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tokens = self.patch_embed(x).permute(0, 2, 3, 1)  # (B, H/4, W/4, C)
        tokens = tokens + self._pos(tuple(tokens.shape[1:3])).to(tokens.dtype)
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        return tokens.permute(0, 3, 1, 2)
