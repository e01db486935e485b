"""DINOv2 and DINOv3 Vision Transformers (counterpart of
``lightning_pose_tpu/models/backbones/vit_dino.py``): ``(B, 3, H, W)`` in,
a ``(B, D, H/16, W/16)`` token grid out.

- **DINOv2** (HF ``Dinov2Model``): pre-LN blocks with LayerScale on both
  residual branches, a learned CLS token and position table (resized
  bicubically when the token grid differs from ``pretrained_grid``),
  LayerNorm eps 1e-6, exact GELU. A published patch-14 projection is
  resized to patch 16 when its file is loaded (``pretrained.py``).
- **DINOv3** (HF ``DINOv3ViTModel``): a CLS token and 4 register tokens, no
  learned position table but axial RoPE over the patch centres (applied to
  the patch tokens only), separate q/k/v/o projections with no key bias,
  LayerNorm eps 1e-5. HF's train-time jitter of the RoPE coordinates is
  left out, as the JAX package leaves it out.

Both split into ``embed`` (patch tokens, no prefix tokens) and
``encode_tokens`` (the blocks and the final LayerNorm), which the multiview
model calls around its view embeddings. The layers keep flax's names
(``block{i}/{ln1, query, key, value, out, ls1, ln2, fc1, fc2, ls2}`` and
``{q_proj, k_proj, v_proj, o_proj, up_proj, down_proj}``; LayerScale's
``lambda``), so that the checkpoint bridge maps them leaf by leaf.
Attention is ``F.scaled_dot_product_attention`` at the scale ``Dh ** -0.5``;
the JAX package scales q first and takes a float32 softmax, the same terms
in another order.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from lightning_pose_tpu_torch.ops.interpolate import bicubic_resize_2d

__all__ = ["DinoV2Block", "DinoV2ViT", "DinoV3Block", "DinoV3ViT", "LayerScale", "attention", "rope_cos_sin"]


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, num_heads: int) -> torch.Tensor:
    """Multi-head attention over ``(B, Nq, D)`` queries and ``(B, Nk, D)``
    keys and values, at the scale ``(D / num_heads) ** -0.5``."""
    b, nq, d = q.shape
    hd = d // num_heads

    def heads(x: torch.Tensor) -> torch.Tensor:
        return x.reshape(b, x.shape[1], num_heads, hd).transpose(1, 2)

    out = F.scaled_dot_product_attention(heads(q), heads(k), heads(v), scale=hd**-0.5)
    return out.transpose(1, 2).reshape(b, nq, d)


def _patch_tokens(patch_embed: nn.Conv2d, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
    """``(B, gh * gw, D)`` patch tokens, row-major over the grid, and the
    grid."""
    tokens = patch_embed(x)
    return tokens.flatten(2).transpose(1, 2), tuple(tokens.shape[-2:])


class LayerScale(nn.Module):
    """Per-channel learned scale of a residual branch, initialised to
    ``init_value``."""

    def __init__(self, dim: int, init_value: float = 1.0) -> None:
        super().__init__()
        self.register_parameter("lambda", nn.Parameter(torch.full((dim,), float(init_value))))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return x * getattr(self, "lambda").to(x.dtype)


class DinoV2Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, ls_init: float = 1.0) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.ln1 = nn.LayerNorm(dim, eps=1e-6)
        self.query = nn.Linear(dim, dim)
        self.key = nn.Linear(dim, dim)
        self.value = nn.Linear(dim, dim)
        self.out = nn.Linear(dim, dim)
        self.ls1 = LayerScale(dim, ls_init)
        self.ln2 = nn.LayerNorm(dim, eps=1e-6)
        self.fc1 = nn.Linear(dim, 4 * dim)
        self.fc2 = nn.Linear(4 * dim, dim)
        self.ls2 = LayerScale(dim, ls_init)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.ln1(x)
        y = attention(self.query(y), self.key(y), self.value(y), self.num_heads)
        x = x + self.ls1(self.out(y))
        y = self.fc2(F.gelu(self.fc1(self.ln2(x)), approximate="none"))
        return x + self.ls2(y)


class DinoV2ViT(nn.Module):
    """DINOv2 encoder. ``pos_embed`` holds ``pretrained_grid ** 2 + 1`` rows
    (CLS first): the fine-tune grid (``image_size / 16``), to which a
    published table is resized when its file is loaded."""

    def __init__(
        self,
        embed_dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        patch_size: int = 16,
        pretrained_grid: int = 16,
    ) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.depth = depth
        self.patch_size = patch_size
        self.pretrained_grid = pretrained_grid
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.pos_embed = nn.Parameter(torch.zeros(1, pretrained_grid**2 + 1, embed_dim))
        for i in range(depth):
            setattr(self, f"block{i}", DinoV2Block(embed_dim, num_heads))
        self.ln = nn.LayerNorm(embed_dim, eps=1e-6)

    def reset_like_flax(self) -> None:
        """The CLS token and position table from normal(0.02), as flax
        initialises them."""
        with torch.no_grad():
            nn.init.normal_(self.cls_token, std=0.02)
            nn.init.normal_(self.pos_embed, std=0.02)

    def _pos(self, grid: tuple[int, int]) -> torch.Tensor:
        """``(1, 1 + gh * gw, D)``: the CLS row, then the grid rows resized
        to ``grid`` (float32 bicubic, ``align_corners=False``)."""
        g = self.pretrained_grid
        if tuple(grid) == (g, g):
            return self.pos_embed
        cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        grid_pos = bicubic_resize_2d(grid_pos.reshape(1, g, g, -1).permute(0, 3, 1, 2), grid)
        return torch.cat([cls_pos, grid_pos.permute(0, 2, 3, 1).reshape(1, grid[0] * grid[1], -1)], dim=1)

    def embed(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """Patch tokens plus their position rows, no CLS token: ``((B, gh *
        gw, D), (gh, gw))``."""
        tokens, grid = _patch_tokens(self.patch_embed, x)
        return tokens + self._pos(grid)[:, 1:].to(tokens.dtype), grid

    def encode_tokens(
        self, tokens: torch.Tensor, grid: tuple[int, int] | None = None, num_views: int = 1
    ) -> torch.Tensor:
        """The blocks and the final LayerNorm over a ``(B, N, D)`` sequence
        (``grid`` and ``num_views`` are DINOv3's and unused here)."""
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens)
        return self.ln(tokens)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        patches, (gh, gw) = _patch_tokens(self.patch_embed, x)
        cls = self.cls_token.to(patches.dtype).expand(b, -1, -1)
        tokens = torch.cat([cls, patches], dim=1) + self._pos((gh, gw)).to(patches.dtype)
        tokens = self.encode_tokens(tokens)
        return tokens[:, 1:].reshape(b, gh, gw, self.embed_dim).permute(0, 3, 1, 2)


def rope_cos_sin(grid: tuple[int, int], head_dim: int, theta: float) -> tuple[np.ndarray, np.ndarray]:
    """DINOv3's axial RoPE tables over the patch centres in [-1, 1]:
    float32 ``(gh * gw, head_dim)`` cos and sin, computed in float64."""
    gh, gw = grid
    coords_h = np.arange(0.5, gh, dtype=np.float64) / gh
    coords_w = np.arange(0.5, gw, dtype=np.float64) / gw
    ch, cw = np.meshgrid(coords_h, coords_w, indexing="ij")
    coords = np.stack([ch, cw], axis=-1).reshape(-1, 2) * 2.0 - 1.0
    inv_freq = 1.0 / theta ** np.arange(0, 1, 4 / head_dim, dtype=np.float64)
    angles = 2 * np.pi * coords[:, :, None] * inv_freq[None, None, :]
    angles = np.tile(angles.reshape(coords.shape[0], -1), (1, 2))
    return np.cos(angles).astype(np.float32), np.sin(angles).astype(np.float32)


@functools.lru_cache(maxsize=32)
def _rope_tables(
    grid: tuple[int, int], head_dim: int, theta: float, num_views: int, device: torch.device
) -> tuple[torch.Tensor, torch.Tensor]:
    """:func:`rope_cos_sin` tiled ``num_views`` times, on ``device`` (made
    once a shape and device; never written to)."""
    cos, sin = rope_cos_sin(grid, head_dim, theta)
    return (torch.from_numpy(np.tile(cos, (num_views, 1))).to(device),
            torch.from_numpy(np.tile(sin, (num_views, 1))).to(device))


def _apply_rope(x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, num_prefix: int) -> torch.Tensor:
    """RoPE on the patch tokens of ``(B, N, H, Dh)``; the first
    ``num_prefix`` tokens pass unchanged."""
    prefix, patches = x[:, :num_prefix], x[:, num_prefix:]
    c = cos[None, :, None, :].to(patches.dtype)
    s = sin[None, :, None, :].to(patches.dtype)
    x1, x2 = patches.chunk(2, dim=-1)
    patches = patches * c + torch.cat([-x2, x1], dim=-1) * s
    return torch.cat([prefix, patches], dim=1)


class DinoV3Block(nn.Module):
    def __init__(self, dim: int, num_heads: int, mlp_dim: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.ln1 = nn.LayerNorm(dim, eps=1e-5)
        self.q_proj = nn.Linear(dim, dim)
        self.k_proj = nn.Linear(dim, dim, bias=False)
        self.v_proj = nn.Linear(dim, dim)
        self.o_proj = nn.Linear(dim, dim)
        self.ls1 = LayerScale(dim)
        self.ln2 = nn.LayerNorm(dim, eps=1e-5)
        self.up_proj = nn.Linear(dim, mlp_dim)
        self.down_proj = nn.Linear(mlp_dim, dim)
        self.ls2 = LayerScale(dim)

    def forward(self, x: torch.Tensor, cos: torch.Tensor, sin: torch.Tensor, num_prefix: int) -> torch.Tensor:
        b, n, d = x.shape
        h = self.num_heads
        y = self.ln1(x)
        q = _apply_rope(self.q_proj(y).reshape(b, n, h, d // h), cos, sin, num_prefix).reshape(b, n, d)
        k = _apply_rope(self.k_proj(y).reshape(b, n, h, d // h), cos, sin, num_prefix).reshape(b, n, d)
        y = attention(q, k, self.v_proj(y), h)
        x = x + self.ls1(self.o_proj(y))
        y = self.down_proj(F.gelu(self.up_proj(self.ln2(x)), approximate="none"))
        return x + self.ls2(y)


class DinoV3ViT(nn.Module):
    """DINOv3 encoder: CLS and register tokens, axial RoPE, no learned
    position table."""

    def __init__(
        self,
        embed_dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        patch_size: int = 16,
        num_register_tokens: int = 4,
        rope_theta: float = 100.0,
    ) -> None:
        super().__init__()
        self.embed_dim = embed_dim
        self.depth = depth
        self.num_heads = num_heads
        self.patch_size = patch_size
        self.num_register_tokens = num_register_tokens
        self.rope_theta = rope_theta
        self.patch_embed = nn.Conv2d(3, embed_dim, patch_size, stride=patch_size)
        self.cls_token = nn.Parameter(torch.zeros(1, 1, embed_dim))
        self.register_tokens = nn.Parameter(torch.zeros(1, num_register_tokens, embed_dim))
        for i in range(depth):
            setattr(self, f"block{i}", DinoV3Block(embed_dim, num_heads, 4 * embed_dim))
        self.ln = nn.LayerNorm(embed_dim, eps=1e-5)

    def reset_like_flax(self) -> None:
        """The CLS and register tokens from normal(0.02), as flax
        initialises them."""
        with torch.no_grad():
            nn.init.normal_(self.cls_token, std=0.02)
            nn.init.normal_(self.register_tokens, std=0.02)

    def embed(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """The patch tokens alone: ``((B, gh * gw, D), (gh, gw))`` (RoPE acts
        inside the attention)."""
        return _patch_tokens(self.patch_embed, x)

    def encode_tokens(
        self, tokens: torch.Tensor, grid: tuple[int, int] | None = None, num_views: int = 1
    ) -> torch.Tensor:
        """The blocks and the final LayerNorm. ``grid`` gives the RoPE
        tables, tiled ``num_views`` times for a multiview sequence so that
        each view keeps its own coordinates; the tokens before the last
        ``num_views * gh * gw`` are prefix tokens, which RoPE skips."""
        if grid is None:
            raise ValueError("DinoV3ViT.encode_tokens requires the patch grid")
        cos, sin = _rope_tables(
            tuple(grid), self.embed_dim // self.num_heads, self.rope_theta, num_views, tokens.device
        )
        num_prefix = tokens.shape[1] - cos.shape[0]
        for i in range(self.depth):
            tokens = getattr(self, f"block{i}")(tokens, cos, sin, num_prefix)
        return self.ln(tokens)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = x.shape[0]
        patches, (gh, gw) = self.embed(x)
        cls = self.cls_token.to(patches.dtype).expand(b, -1, -1)
        reg = self.register_tokens.to(patches.dtype).expand(b, -1, -1)
        tokens = self.encode_tokens(torch.cat([cls, reg, patches], dim=1), grid=(gh, gw))
        num_prefix = 1 + self.num_register_tokens
        return tokens[:, num_prefix:].reshape(b, gh, gw, self.embed_dim).permute(0, 3, 1, 2)
