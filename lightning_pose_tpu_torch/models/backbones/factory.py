"""Backbone registry and constructor (counterpart of
``lightning_pose_tpu/models/backbones/factory.py``).

The names and strides are the reference's. Only the ResNet family is ported
so far; the other names are recognised and raise ``NotImplementedError``.
"""

from __future__ import annotations

from torch import nn

from lightning_pose_tpu_torch.models.backbones.resnet import RESNET_CONFIGS, ResNet

__all__ = [
    "ALLOWED_BACKBONES",
    "ALLOWED_CONVNET_BACKBONES",
    "ALLOWED_TRANSFORMER_BACKBONES",
    "BACKBONE_STRIDES",
    "build_backbone",
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


def build_backbone(backbone_arch: str, model_type: str = "heatmap") -> tuple[nn.Module, int]:
    """Build a backbone by name; returns ``(module, num output features)``.

    Weights are random until a checkpoint is loaded into the whole model.
    """
    if backbone_arch not in ALLOWED_BACKBONES:
        raise ValueError(
            f'"{backbone_arch}" is not a valid backbone; '
            f"allowed backbones: {sorted(ALLOWED_BACKBONES)}"
        )
    if backbone_arch.startswith("efficientnet"):
        raise NotImplementedError(
            f"{backbone_arch} is not ported yet (ROADMAP queue 1, item 13)"
        )
    if backbone_arch.startswith("vit"):
        raise NotImplementedError(
            f"{backbone_arch} is not ported yet (ROADMAP queue 1, items 12-13)"
        )
    # all resnet50_* pose variants share the resnet50 architecture
    arch = "resnet50" if backbone_arch.startswith("resnet50_") else backbone_arch
    module = ResNet(arch=arch, global_pool=(model_type == "regression"))
    return module, RESNET_CONFIGS[arch][2]
