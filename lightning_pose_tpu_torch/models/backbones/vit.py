"""Plain pre-LN Vision Transformer (counterpart of
``lightning_pose_tpu/models/backbones/vit.py``): the DINO and ImageNet ViT
family, ``(B, 3, H, W)`` in, a ``(B, D, H/16, W/16)`` token grid out.

The encoder is split into :meth:`ViT.embed` (patch embedding and position
embeddings, no CLS token) and :meth:`ViT.encode_tokens` (the blocks and the
final LayerNorm over any token sequence), so that the multiview model can
add view embeddings and attend across views in one sequence.

The layers keep flax's conventions, so the checkpoint bridge maps them
leaf by leaf: LayerNorm eps 1e-6, exact (erf) GELU, and the attention's
projections in flax's ``DenseGeneral`` layout, query, key and value
kernels ``(D, H, Dh)`` with biases ``(H, Dh)`` and the output kernel
``(H, Dh, D)``. Attention is ``F.scaled_dot_product_attention`` at the
scale ``Dh ** -0.5`` (flax divides the query by ``sqrt(Dh)``); the three
projections run as one matmul.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from lightning_pose_tpu_torch.ops.interpolate import bicubic_resize_2d

__all__ = ["VIT_CONFIGS", "DenseGeneral", "EncoderBlock", "MlpBlock", "MultiHeadAttention", "ViT"]

# name -> (embed_dim, depth, num_heads, patch_size)
VIT_CONFIGS: dict[str, tuple[int, int, int, int]] = {
    "vits": (384, 12, 6, 16),
    "vitb": (768, 12, 12, 16),
    "vitt": (192, 12, 3, 16),
}

LAYER_NORM_EPS = 1e-6  # flax's default; torch's is 1e-5


class DenseGeneral(nn.Module):
    """A projection with flax ``DenseGeneral``'s parameter shapes: ``weight``
    of ``weight_shape`` and ``bias`` of ``bias_shape``. ``fan_in`` is the
    product of the contracted axes, which flax's init scales by."""

    def __init__(self, weight_shape: tuple[int, ...], bias_shape: tuple[int, ...], fan_in: int) -> None:
        super().__init__()
        self.weight = nn.Parameter(torch.empty(weight_shape))
        self.bias = nn.Parameter(torch.zeros(bias_shape))
        self.fan_in = fan_in


class MultiHeadAttention(nn.Module):
    """Self-attention as flax's ``MultiHeadDotProductAttention(x, x)``."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.num_heads = num_heads
        self.head_dim = dim // num_heads
        hd = num_heads * self.head_dim
        for name in ("query", "key", "value"):
            setattr(self, name, DenseGeneral((dim, num_heads, self.head_dim), (num_heads, self.head_dim), dim))
        self.out = DenseGeneral((num_heads, self.head_dim, dim), (dim,), hd)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, n, d = x.shape
        h, dh = self.num_heads, self.head_dim
        projections = (self.query, self.key, self.value)
        weight = torch.cat([p.weight.reshape(d, h * dh) for p in projections], dim=1)
        bias = torch.cat([p.bias.reshape(h * dh) for p in projections])
        qkv = F.linear(x, weight.T, bias).view(b, n, 3, h, dh).permute(2, 0, 3, 1, 4)
        o = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=dh**-0.5)
        o = o.transpose(1, 2).reshape(b, n, h * dh)
        return F.linear(o, self.out.weight.reshape(h * dh, d).T, self.out.bias)


class MlpBlock(nn.Module):
    def __init__(self, dim: int, mlp_dim: int) -> None:
        super().__init__()
        self.fc1 = nn.Linear(dim, mlp_dim)
        self.fc2 = nn.Linear(mlp_dim, dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.gelu(self.fc1(x), approximate="none"))


class EncoderBlock(nn.Module):
    """Pre-LN block: ``x + attn(ln1(x))``, then ``+ mlp(ln2(.))``."""

    def __init__(self, dim: int, num_heads: int) -> None:
        super().__init__()
        self.ln1 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.attn = MultiHeadAttention(dim, num_heads)
        self.ln2 = nn.LayerNorm(dim, eps=LAYER_NORM_EPS)
        self.mlp = MlpBlock(dim, 4 * dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = x + self.attn(self.ln1(x))
        return x + self.mlp(self.ln2(x))


class ViT(nn.Module):
    """Pre-LN ViT encoder: ``(B, 3, H, W)`` -> ``(B, D, H/patch, W/patch)``.

    ``pos_embed`` holds ``pretrained_grid ** 2 + 1`` rows (CLS first); it is
    resized bicubically (torch's a = -0.75) when the input's token grid
    differs."""

    def __init__(
        self,
        embed_dim: int = 384,
        depth: int = 12,
        num_heads: int = 6,
        patch_size: int = 16,
        pretrained_grid: int = 14,
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
            setattr(self, f"block{i}", EncoderBlock(embed_dim, num_heads))
        self.ln = nn.LayerNorm(embed_dim, eps=LAYER_NORM_EPS)

    def reset_like_flax(self) -> None:
        """The token and position embeddings from normal(0.02), as flax
        initialises them."""
        with torch.no_grad():
            nn.init.normal_(self.cls_token, std=0.02)
            nn.init.normal_(self.pos_embed, std=0.02)

    def resized_pos_embed(self, grid: tuple[int, int]) -> torch.Tensor:
        """``(1, 1 + gh * gw, D)``: the CLS row, then the grid rows resized to
        ``grid``."""
        g = self.pretrained_grid
        if (g, g) == tuple(grid):
            return self.pos_embed
        cls_pos, grid_pos = self.pos_embed[:, :1], self.pos_embed[:, 1:]
        grid_pos = grid_pos.reshape(1, g, g, -1).permute(0, 3, 1, 2)
        grid_pos = bicubic_resize_2d(grid_pos, grid).permute(0, 2, 3, 1).reshape(1, grid[0] * grid[1], -1)
        return torch.cat([cls_pos, grid_pos], dim=1)

    def embed(self, x: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int]]:
        """Patch embedding plus the grid's position embeddings, no CLS
        token: ``((B, gh * gw, D) tokens, (gh, gw))``, tokens row-major over
        the grid."""
        tokens = self.patch_embed(x)
        gh, gw = tokens.shape[-2:]
        tokens = tokens.flatten(2).transpose(1, 2)
        return tokens + self.resized_pos_embed((gh, gw))[:, 1:], (gh, gw)

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
        tokens, (gh, gw) = self.embed(x)
        cls = self.cls_token + self.resized_pos_embed((gh, gw))[:, :1]
        tokens = self.encode_tokens(torch.cat([cls.expand(b, -1, -1).to(tokens.dtype), tokens], dim=1))
        return tokens[:, 1:].reshape(b, gh, gw, self.embed_dim).permute(0, 3, 1, 2)


def vit_fan_in(layer: nn.Module) -> int | None:
    """The fan-in flax's ``lecun_normal`` init uses for a ViT layer, or None
    for a layer it does not draw (LayerNorm, embeddings)."""
    if isinstance(layer, DenseGeneral):
        return layer.fan_in
    if isinstance(layer, nn.Linear):
        return layer.in_features
    return None
