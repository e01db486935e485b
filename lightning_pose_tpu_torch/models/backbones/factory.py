"""Backbone registry and constructor (counterpart of
``lightning_pose_tpu/models/backbones/factory.py``).

The names and strides are the reference's; every name builds: the ResNet
family, EfficientNet b0-b2, the plain ViTs (``vits_dino``, ``vitb_dino``,
``vitb_imagenet``), DINOv2 and DINOv3, the SAM encoder and the SAM2 Hiera
trunks.
"""

from __future__ import annotations

from torch import nn

from lightning_pose_tpu_torch.models.backbones.efficientnet import EFFICIENTNET_CONFIGS, EfficientNet
from lightning_pose_tpu_torch.models.backbones.hiera import HIERA_CONFIGS, Hiera
from lightning_pose_tpu_torch.models.backbones.resnet import RESNET_CONFIGS, ResNet
from lightning_pose_tpu_torch.models.backbones.vit import VIT_CONFIGS, ViT
from lightning_pose_tpu_torch.models.backbones.vit_dino import DinoV2ViT, DinoV3ViT
from lightning_pose_tpu_torch.models.backbones.vit_sam import SamViT

__all__ = [
    "ALLOWED_BACKBONES",
    "ALLOWED_CONVNET_BACKBONES",
    "ALLOWED_TRANSFORMER_BACKBONES",
    "ALLOWED_TRANSFORMER_BACKBONES_MULTIVIEW",
    "BACKBONE_STRIDES",
    "build_backbone",
    "make_transformer_module",
]

ALLOWED_CONVNET_BACKBONES = [
    "resnet18",
    "resnet34",
    "resnet50",
    "resnet101",
    "resnet152",
    "resnet50_animal_apose",
    "resnet50_animal_ap10k",
    "resnet50_human_jhmdb",
    "resnet50_human_res_rle",
    "resnet50_human_top_res",
    "resnet50_human_hand",
    "efficientnet_b0",
    "efficientnet_b1",
    "efficientnet_b2",
]

ALLOWED_TRANSFORMER_BACKBONES = [
    "vits_dino",
    "vits_dinov2",
    "vits_dinov3",
    "vitb_dino",
    "vitb_dinov2",
    "vitb_dinov3",
    "vitb_imagenet",
    "vitb_sam",
    "vitb_sam2",
    "vits_sam2",
    "vitt_sam2",
]

ALLOWED_TRANSFORMER_BACKBONES_MULTIVIEW = [
    "vits_dino",
    "vits_dinov2",
    "vits_dinov3",
    "vitb_dino",
    "vitb_dinov2",
    "vitb_dinov3",
    "vitb_imagenet",
]

ALLOWED_BACKBONES = ALLOWED_CONVNET_BACKBONES + ALLOWED_TRANSFORMER_BACKBONES

# feature-map stride (input size / feature-map size); sets the number of
# upsampling layers in the heatmap head
BACKBONE_STRIDES: dict[str, int] = {
    **{name: 32 for name in ALLOWED_CONVNET_BACKBONES},
    **{name: 16 for name in ALLOWED_TRANSFORMER_BACKBONES},
    "vitb_sam2": 32,
    "vits_sam2": 32,
    "vitt_sam2": 32,
}


def make_transformer_module(backbone_arch: str, image_size: int = 256) -> tuple[nn.Module, int]:
    """The module of a transformer backbone name and its feature count:
    the SAM2 Hiera trunk (``*_sam2``), the SAM encoder (``vitb_sam``),
    DINOv2 and DINOv3 (``*_dinov2``, ``*_dinov3``) or the plain ViT (DINO,
    ImageNet). A learned position grid is ``image_size / 16``, as in the
    JAX package."""
    if backbone_arch.endswith("_sam2"):
        module = Hiera(**HIERA_CONFIGS[backbone_arch])
        return module, module.out_features
    size_key = backbone_arch.split("_")[0]
    if size_key not in VIT_CONFIGS:
        raise NotImplementedError(f'"{backbone_arch}" transformer not supported yet')
    embed_dim, depth, num_heads, patch = VIT_CONFIGS[size_key]
    grid = int(image_size) // patch
    if backbone_arch == "vitb_sam":
        module = SamViT(embed_dim=embed_dim, depth=depth, num_heads=num_heads, patch_size=patch, pos_grid=grid)
    elif backbone_arch.endswith("_dinov2"):
        module = DinoV2ViT(embed_dim=embed_dim, depth=depth, num_heads=num_heads, patch_size=patch,
                           pretrained_grid=grid)
    elif backbone_arch.endswith("_dinov3"):
        module = DinoV3ViT(embed_dim=embed_dim, depth=depth, num_heads=num_heads, patch_size=patch,
                           num_register_tokens=4)
    else:
        module = ViT(embed_dim=embed_dim, depth=depth, num_heads=num_heads, patch_size=patch, pretrained_grid=grid)
    return module, embed_dim


def build_backbone(backbone_arch: str, model_type: str = "heatmap", image_size: int = 256) -> tuple[nn.Module, int]:
    """Build a backbone by name; returns ``(module, num output features)``.

    Weights are random until a checkpoint is loaded (into the whole model,
    or a local torch file into the backbone: ``models/backbones/pretrained``).
    A regression model's convnet is globally pooled; a transformer's
    learned position grid is made for ``image_size``.
    """
    if backbone_arch not in ALLOWED_BACKBONES:
        raise ValueError(
            f'"{backbone_arch}" is not a valid backbone; '
            f"allowed backbones: {sorted(ALLOWED_BACKBONES)}"
        )
    if backbone_arch.startswith("vit"):
        return make_transformer_module(backbone_arch, image_size)
    if backbone_arch.startswith("efficientnet"):
        variant = backbone_arch.split("_")[-1]
        module = EfficientNet(variant=variant, global_pool=(model_type == "regression"))
        return module, EFFICIENTNET_CONFIGS[variant][-1]
    # all resnet50_* pose variants share the resnet50 architecture
    arch = "resnet50" if backbone_arch.startswith("resnet50_") else backbone_arch
    module = ResNet(arch=arch, global_pool=(model_type == "regression"))
    return module, RESNET_CONFIGS[arch][2]
