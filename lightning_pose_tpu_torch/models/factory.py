"""Model factory (counterpart of ``lightning_pose_tpu/models/factory.py``).

The single-view ``heatmap`` model and the temporal-context ``heatmap_mhcrnn``
model are ported; the other model types are recognised and raise
``NotImplementedError``. Weights are initialised as the JAX package's flax
modules initialise theirs (:func:`init_like_flax`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lightning_pose_tpu_torch.models.heatmap_tracker import HeatmapTracker
from lightning_pose_tpu_torch.models.heatmap_tracker_mhcrnn import HeatmapTrackerMHCRNN

__all__ = [
    "ALLOWED_MODEL_TYPES",
    "build_model",
    "check_if_semi_supervised",
    "get_model",
    "init_like_flax",
    "normalize_model_type",
]

ALLOWED_MODEL_TYPES = [
    "regression",
    "heatmap",
    "heatmap_mhcrnn",
    "heatmap_multiview_transformer",
    "heatmap_multiview",
]

_MODEL_TYPE_ALIASES = {"heatmap_multiview_transformer": "heatmap_multiview"}

_NOT_PORTED = {
    "regression": "ROADMAP queue 1, item 7: remaining model families",
    "heatmap_multiview": "ROADMAP queue 1, item 6: multiview",
}


def normalize_model_type(model_type: str) -> str:
    """Map config model_type strings to the internal canonical name."""
    return _MODEL_TYPE_ALIASES.get(model_type, model_type)


def check_if_semi_supervised(losses_to_use) -> bool:
    """True when unsupervised losses are configured (the JAX package's
    ``models/factory.check_if_semi_supervised``)."""
    losses = list(losses_to_use or [])
    return bool(losses) and losses != [""]


# std of a standard normal truncated to [-2, 2]: flax's truncated-normal
# variance scaling divides by it so the kept samples have variance 1/fan_in
_TRUNCATED_NORMAL_STD = 0.87962566103423978


def init_like_flax(module: nn.Module) -> nn.Module:
    """Re-initialise ``module`` in place as flax initialises the JAX
    package's modules: every ``nn.Conv2d`` kernel from ``lecun_normal``
    (a normal of variance ``1/fan_in``, ``fan_in = in_channels * kh * kw``,
    truncated at two standard deviations) and bias zero; BatchNorm scale 1,
    bias 0, statistics 0 and 1. Transposed convs (the heatmap head) keep
    their Xavier-uniform init, and a layer that defines ``reset_like_flax``
    (the context head's CRNN) re-initialises its own layers after that.
    Draws from torch's default generator."""
    with torch.no_grad():
        for layer in module.modules():
            if isinstance(layer, nn.Conv2d):
                fan_in = layer.in_channels // layer.groups * math.prod(layer.kernel_size)
                std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STD
                nn.init.trunc_normal_(layer.weight, 0.0, std, -2.0 * std, 2.0 * std)
                if layer.bias is not None:
                    nn.init.zeros_(layer.bias)
            elif isinstance(layer, nn.BatchNorm2d):
                layer.reset_parameters()
    for layer in module.modules():
        if hasattr(layer, "reset_like_flax"):
            layer.reset_like_flax()
    return module


def build_model(
    model_type: str,
    backbone: str,
    num_keypoints: int,
    downsample_factor: int = 2,
    context_repeat: bool = False,
) -> nn.Module:
    """Build a tracker module from explicit settings. ``context_repeat``
    (context model only): encode each stack's center frame once."""
    model_type = normalize_model_type(model_type)
    if model_type not in ALLOWED_MODEL_TYPES:
        raise ValueError(
            f"{model_type} is an invalid model_type; choose from {ALLOWED_MODEL_TYPES}"
        )
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type} is not ported yet ({_NOT_PORTED[model_type]})"
        )
    if model_type == "heatmap_mhcrnn":
        return init_like_flax(
            HeatmapTrackerMHCRNN(
                backbone_arch=backbone,
                num_keypoints=num_keypoints,
                downsample_factor=downsample_factor,
                context_repeat=context_repeat,
            )
        )
    return init_like_flax(
        HeatmapTracker(
            backbone_arch=backbone,
            num_keypoints=num_keypoints,
            downsample_factor=downsample_factor,
        )
    )


def get_model(cfg, num_keypoints: int | None = None) -> nn.Module:
    """Build the tracker described by the config."""
    model_type = normalize_model_type(cfg.model.model_type)
    num_keypoints = num_keypoints or cfg.data.num_keypoints
    downsample_factor = int(cfg.data.get("downsample_factor", 2))
    view_names = cfg.data.get("view_names") or []
    if len(view_names) > 1:
        raise NotImplementedError(
            "heatmap models on multiview data are not ported yet "
            "(ROADMAP queue 1, item 6: multiview)"
        )
    context_repeat = cfg.model.get("mhcrnn_context_mode", "adjacent") == "repeat_center"
    return build_model(model_type, cfg.model.backbone, int(num_keypoints), downsample_factor, context_repeat)
