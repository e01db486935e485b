"""Model factory (counterpart of ``lightning_pose_tpu/models/factory.py``).

Every model type is ported: the single-view ``heatmap`` and ``regression``
models, the temporal-context ``heatmap_mhcrnn`` model and the multiview
transformer (``heatmap_multiview``, alias ``heatmap_multiview_transformer``).
``heatmap`` and ``heatmap_mhcrnn`` on multiview data fold the views into
the batch; their meta (:func:`model_meta`) records the view count. Weights
are initialised as the JAX package's flax modules initialise theirs
(:func:`init_like_flax`).
"""

from __future__ import annotations

import math

import torch
from torch import nn

from lightning_pose_tpu_torch.models.heatmap_tracker import HeatmapTracker
from lightning_pose_tpu_torch.models.backbones.vit import vit_fan_in
from lightning_pose_tpu_torch.models.heatmap_tracker_mhcrnn import HeatmapTrackerMHCRNN
from lightning_pose_tpu_torch.models.heatmap_tracker_multiview import HeatmapTrackerMultiviewTransformer
from lightning_pose_tpu_torch.models.regression_tracker import RegressionTracker

__all__ = [
    "ALLOWED_MODEL_TYPES",
    "build_model",
    "check_if_semi_supervised",
    "get_model",
    "init_like_flax",
    "model_meta",
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
    truncated at two standard deviations) and bias zero; the transformers'
    dense layers the same with their flax fan-in (``D`` for the plain ViT's
    query, key and value kernels, ``H * Dh`` for its attention's output, a
    ``Linear``'s ``in_features``); BatchNorm and LayerNorm scale 1, bias 0,
    statistics 0 and 1. Transposed convs (the heatmap head) keep their
    Xavier-uniform init, LayerScale its 1.0 and the SAM and Hiera position
    tables their zeros; a layer that defines ``reset_like_flax`` (the
    context head's CRNN; the ViTs' CLS, register tokens and learned
    position tables and the view embeddings, normal(0.02)) re-initialises
    its own parameters after that. Draws from torch's
    default generator."""

    def lecun_normal(weight: torch.Tensor, fan_in: int) -> None:
        std = math.sqrt(1.0 / fan_in) / _TRUNCATED_NORMAL_STD
        nn.init.trunc_normal_(weight, 0.0, std, -2.0 * std, 2.0 * std)

    with torch.no_grad():
        for layer in module.modules():
            if isinstance(layer, nn.Conv2d):
                lecun_normal(layer.weight, layer.in_channels // layer.groups * math.prod(layer.kernel_size))
                if layer.bias is not None:
                    nn.init.zeros_(layer.bias)
            elif vit_fan_in(layer) is not None:
                lecun_normal(layer.weight, vit_fan_in(layer))
                if layer.bias is not None:
                    nn.init.zeros_(layer.bias)
            elif isinstance(layer, (nn.BatchNorm2d, nn.LayerNorm)):
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
    num_views: int = 1,
    image_size: int = 256,
) -> nn.Module:
    """Build a tracker module from explicit settings. ``context_repeat``
    (context model only): encode each stack's center frame once.
    ``num_views`` (the multiview transformer only): its views;
    ``image_size``: the side a transformer's learned position grid
    is made for; ``num_keypoints`` counts one view's keypoints."""
    model_type = normalize_model_type(model_type)
    if model_type not in ALLOWED_MODEL_TYPES:
        raise ValueError(
            f"{model_type} is an invalid model_type; choose from {ALLOWED_MODEL_TYPES}"
        )
    if model_type == "regression":
        return init_like_flax(RegressionTracker(backbone_arch=backbone, num_keypoints=num_keypoints))
    if model_type == "heatmap_multiview":
        return init_like_flax(
            HeatmapTrackerMultiviewTransformer(
                backbone_arch=backbone,
                num_keypoints=num_keypoints,
                num_views=num_views,
                downsample_factor=downsample_factor,
                image_size=image_size,
            )
        )
    if model_type == "heatmap_mhcrnn":
        return init_like_flax(
            HeatmapTrackerMHCRNN(
                backbone_arch=backbone,
                num_keypoints=num_keypoints,
                downsample_factor=downsample_factor,
                context_repeat=context_repeat,
                image_size=image_size,
            )
        )
    return init_like_flax(
        HeatmapTracker(
            backbone_arch=backbone,
            num_keypoints=num_keypoints,
            downsample_factor=downsample_factor,
            image_size=image_size,
        )
    )


def model_meta(cfg) -> dict:
    """What the training loop and the predict step read of the configured
    model (the JAX package's ``get_model`` meta): ``model_type``,
    ``downsample_factor`` and ``num_views``, the view count of the
    multiview transformer and of a heatmap model on multiview data (their
    targets and bboxes are view-major), else 1."""
    model_type = normalize_model_type(cfg.model.model_type)
    view_names = cfg.data.get("view_names") or []
    folds_views = model_type in ("heatmap", "heatmap_mhcrnn") and len(view_names) > 1
    return {
        "model_type": model_type,
        "downsample_factor": int(cfg.data.get("downsample_factor", 2)),
        "num_views": len(view_names) if model_type == "heatmap_multiview" or folds_views else 1,
    }


def get_model(cfg, num_keypoints: int | None = None) -> nn.Module:
    """Build the tracker described by the config; ``num_keypoints`` counts
    one view's keypoints."""
    model_type = normalize_model_type(cfg.model.model_type)
    num_keypoints = num_keypoints or cfg.data.num_keypoints
    downsample_factor = int(cfg.data.get("downsample_factor", 2))
    view_names = cfg.data.get("view_names") or []
    context_repeat = cfg.model.get("mhcrnn_context_mode", "adjacent") == "repeat_center"
    return build_model(
        model_type, cfg.model.backbone, int(num_keypoints), downsample_factor, context_repeat,
        num_views=len(view_names), image_size=int(cfg.data.image_resize_dims.get("height") or 256),
    )
