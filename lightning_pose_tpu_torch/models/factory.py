"""Model factory (counterpart of ``lightning_pose_tpu/models/factory.py``).

Only the single-view ``heatmap`` model is ported; the other model types are
recognised and raise ``NotImplementedError``.
"""

from __future__ import annotations

from torch import nn

from lightning_pose_tpu_torch.models.heatmap_tracker import HeatmapTracker

__all__ = ["ALLOWED_MODEL_TYPES", "build_model", "get_model", "normalize_model_type"]

ALLOWED_MODEL_TYPES = [
    "regression",
    "heatmap",
    "heatmap_mhcrnn",
    "heatmap_multiview_transformer",
    "heatmap_multiview",
]

_MODEL_TYPE_ALIASES = {"heatmap_multiview_transformer": "heatmap_multiview"}

_NOT_PORTED = {
    "regression": "ROADMAP queue 1, item 13",
    "heatmap_mhcrnn": "ROADMAP queue 1, item 11",
    "heatmap_multiview": "ROADMAP queue 1, item 12",
}


def normalize_model_type(model_type: str) -> str:
    """Map config model_type strings to the internal canonical name."""
    return _MODEL_TYPE_ALIASES.get(model_type, model_type)


def build_model(
    model_type: str,
    backbone: str,
    num_keypoints: int,
    downsample_factor: int = 2,
) -> nn.Module:
    """Build a tracker module from explicit settings."""
    model_type = normalize_model_type(model_type)
    if model_type not in ALLOWED_MODEL_TYPES:
        raise ValueError(
            f"{model_type} is an invalid model_type; choose from {ALLOWED_MODEL_TYPES}"
        )
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"model_type {model_type} is not ported yet ({_NOT_PORTED[model_type]})"
        )
    return HeatmapTracker(
        backbone_arch=backbone,
        num_keypoints=num_keypoints,
        downsample_factor=downsample_factor,
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
            "(ROADMAP queue 1, item 12)"
        )
    return build_model(model_type, cfg.model.backbone, int(num_keypoints), downsample_factor)
