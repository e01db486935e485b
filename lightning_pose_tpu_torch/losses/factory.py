"""Loss factory (counterpart of ``lightning_pose_tpu/losses/factory.py``).

``get_loss_factories(cfg, data_module)`` builds the ``supervised`` and
``unsupervised`` :class:`LossFactory` of a config (the heatmap loss, or the
coordinate MSE of a regression model, at log weight 0); a factory call
sums ``anneal_weight * weight * loss`` over its losses, the heatmap losses
exempt from the anneal weight (reference factory.py:272-279). The PCA
losses are fitted on the data module's train split when the factory is
built. ``pca_multiview`` is ported for the multiview transformer: flat
per-view keypoint indices in ``data.mirrored_column_matches`` expand to one
list a view, ``data.num_keypoints`` apart. The supervised 3D losses and the
mirrored ``pca_multiview`` of a single-view model raise
``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from lightning_pose_tpu_torch.losses.losses import (
    HeatmapJSLoss,
    HeatmapKLLoss,
    HeatmapMSELoss,
    PCALoss,
    RegressionMSELoss,
    TemporalHeatmapLoss,
    TemporalLoss,
    UnimodalLoss,
)
from lightning_pose_tpu_torch.models.factory import MULTIVIEW_HEATMAP_ITEM, normalize_model_type

__all__ = ["LossFactory", "get_loss_classes", "get_loss_factories"]

# losses never scaled by the anneal weight
_ANNEAL_EXEMPT = ["heatmap_mse", "heatmap_kl", "heatmap_js"]


def get_loss_classes() -> dict[str, type]:
    """Name -> class of the ported losses."""
    return {
        "regression": RegressionMSELoss,
        "heatmap_mse": HeatmapMSELoss,
        "heatmap_kl": HeatmapKLLoss,
        "heatmap_js": HeatmapJSLoss,
        "pca_singleview": PCALoss,
        "pca_multiview": PCALoss,
        "temporal": TemporalLoss,
        "temporal_heatmap_mse": TemporalHeatmapLoss,
        "temporal_heatmap_kl": TemporalHeatmapLoss,
        "unimodal_mse": UnimodalLoss,
        "unimodal_kl": UnimodalLoss,
        "unimodal_js": UnimodalLoss,
    }


def get_loss_factories(cfg, data_module=None) -> dict[str, "LossFactory"]:
    """Supervised and unsupervised loss factories of a config (reference
    factory.py:79-200)."""
    regression = cfg.model.model_type == "regression"
    if "heatmap" in cfg.model.model_type:
        supervised = {"heatmap_" + cfg.model.heatmap_loss_type: {"log_weight": 0.0}}
    else:
        supervised = {cfg.model.model_type: {"log_weight": 0.0}}
    unsupervised: dict[str, dict] = {}
    for loss_name in [name for name in (cfg.model.get("losses_to_use") or []) if name]:
        if loss_name == "pca_multiview" and normalize_model_type(cfg.model.model_type) != "heatmap_multiview":
            raise NotImplementedError(
                f"pca_multiview with a {cfg.model.model_type} model is not ported yet ({MULTIVIEW_HEATMAP_ITEM})"
            )
        params = dict(cfg.losses[loss_name].to_dict(resolve=True))
        params["loss_name"] = loss_name
        if loss_name.startswith("unimodal") or loss_name.startswith("temporal_heatmap"):
            if regression:
                raise NotImplementedError("unimodal loss can only be used with heatmap models")
            height = int(cfg.data.image_resize_dims.height)
            width = int(cfg.data.image_resize_dims.width)
            df = int(cfg.data.get("downsample_factor", 2))
            params["original_image_height"] = height
            params["original_image_width"] = width
            params["downsampled_image_height"] = height // 2**df
            params["downsampled_image_width"] = width // 2**df
        elif loss_name == "pca_multiview":
            view_names = cfg.data.get("view_names", None)
            matches = cfg.data.mirrored_column_matches
            if view_names and len(view_names) > 1 and isinstance(matches[0], int):
                # one list a view, data.num_keypoints apart (reference
                # factory.py:159-176)
                num_keypoints = cfg.data.num_keypoints
                params["mirrored_column_matches"] = [
                    (v * num_keypoints + np.array(matches, dtype=int)).tolist() for v in range(len(view_names))
                ]
            else:
                params["mirrored_column_matches"] = matches
        elif loss_name == "pca_singleview":
            if cfg.data.get("view_names", None) and len(cfg.data.view_names) > 1:
                raise NotImplementedError(
                    "The Pose PCA loss is currently not implemented for multiview data."
                )
            params["columns_for_singleview_pca"] = cfg.data.get("columns_for_singleview_pca", None)
        unsupervised[loss_name] = params
    return {
        "supervised": LossFactory(supervised, data_module=data_module),
        "unsupervised": LossFactory(unsupervised, data_module=data_module),
    }


class LossFactory:
    """Holds loss instances and sums their weighted values."""

    def __init__(self, losses_params_dict: dict[str, dict], data_module=None) -> None:
        self.losses_params_dict = losses_params_dict
        self.data_module = data_module
        classes = get_loss_classes()
        unknown = sorted(set(losses_params_dict) - set(classes))
        if unknown:
            raise NotImplementedError(
                f"losses {unknown} are not ported yet (ROADMAP queue 1, items 6b-7: calibration and 3D, "
                "remaining model families)"
            )
        self.loss_instance_dict: dict[str, Any] = {}
        for loss_name, params in losses_params_dict.items():
            params = dict(params)
            if loss_name.startswith("pca"):
                # a PCA loss needs its subspace, fitted on the train split
                from lightning_pose_tpu_torch.utils.pca import KeypointPCA

                if data_module is None:
                    raise ValueError("a PCA loss needs a data_module to fit on")
                pca = KeypointPCA(
                    loss_type=loss_name,
                    data_module=data_module,
                    components_to_keep=params.pop("components_to_keep", 0.95),
                    empirical_epsilon_percentile=params.pop("empirical_epsilon_percentile", 99.0),
                    mirrored_column_matches=params.pop("mirrored_column_matches", None),
                    columns_for_singleview_pca=params.pop("columns_for_singleview_pca", None),
                    centering_method=params.pop("centering_method", None),
                )
                pca()
                params["pca"] = pca
            self.loss_instance_dict[loss_name] = classes[loss_name](**params)

    def __call__(
        self,
        stage: str | None = None,
        anneal_weight: Any = 1.0,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Total weighted loss and a flat dict of logs; an empty factory
        gives a zero on the device of the tensors it was given."""
        total = None
        logs: dict[str, torch.Tensor] = {}
        for name, loss in self.loss_instance_dict.items():
            value, loss_logs = loss(stage=stage, **kwargs)
            weighted = loss.weight * value
            scaled = weighted if anneal_weight is None or name in _ANNEAL_EXEMPT else anneal_weight * weighted
            total = scaled if total is None else total + scaled
            logs.update(loss_logs)
            logs[f"{stage}_{name}_loss_weighted"] = weighted
        if total is None:
            device = next((v.device for v in kwargs.values() if isinstance(v, torch.Tensor)), None)
            total = torch.zeros((), dtype=torch.float32, device=device)
        return total, logs
