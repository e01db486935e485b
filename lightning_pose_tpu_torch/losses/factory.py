"""Loss factory (counterpart of ``lightning_pose_tpu/losses/factory.py``).

``get_loss_factories(cfg, data_module)`` builds the ``supervised`` and
``unsupervised`` :class:`LossFactory` of a config (the heatmap loss, or the
coordinate MSE of a regression model, at log weight 0); a factory call
sums ``anneal_weight * weight * loss`` over its losses, the heatmap losses
exempt from the anneal weight (reference factory.py:272-279). The PCA
losses are fitted on the data module's train split when the factory is
built. ``pca_multiview``: on multiview data (the multiview transformer, or
a heatmap model whose views fold into the batch) flat per-view keypoint
indices in ``data.mirrored_column_matches`` expand to one list a view,
``data.num_keypoints`` apart; otherwise the config's lists of mirrored
columns are taken as they are. A multiview transformer with a
``data.camera_params_file``, or whose dataset found its calibration, adds
the supervised 3D losses (``supervised_pairwise_projections`` and
``supervised_reprojection_heatmap_mse``) whose ``log_weight`` the config
sets; a heatmap model on calibrated data adds none, as in the JAX package.
"""

from __future__ import annotations

import logging
from typing import Any

import numpy as np
import torch

from lightning_pose_tpu_torch.losses.losses import (
    HeatmapJSLoss,
    HeatmapKLLoss,
    HeatmapMSELoss,
    PairwiseProjectionsLoss,
    PCALoss,
    RegressionMSELoss,
    ReprojectionHeatmapLoss,
    TemporalHeatmapLoss,
    TemporalLoss,
    UnimodalLoss,
)

logger = logging.getLogger(__name__)

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
        "supervised_pairwise_projections": PairwiseProjectionsLoss,
        "supervised_reprojection_heatmap_mse": ReprojectionHeatmapLoss,
    }


def get_loss_factories(cfg, data_module=None) -> dict[str, "LossFactory"]:
    """Supervised and unsupervised loss factories of a config (reference
    factory.py:79-200)."""
    regression = cfg.model.model_type == "regression"
    if "heatmap" in cfg.model.model_type:
        supervised = {"heatmap_" + cfg.model.heatmap_loss_type: {"log_weight": 0.0}}
        calibrated = bool(getattr(getattr(data_module, "dataset", None), "is_calibrated", False))
        if "multiview" in cfg.model.model_type and (cfg.data.get("camera_params_file") or calibrated):
            supervised.update(_supervised_3d_losses(cfg))
    else:
        supervised = {cfg.model.model_type: {"log_weight": 0.0}}
    unsupervised: dict[str, dict] = {}
    for loss_name in [name for name in (cfg.model.get("losses_to_use") or []) if name]:
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


def _supervised_3d_losses(cfg) -> dict[str, dict]:
    """The supervised 3D losses whose ``log_weight`` the config sets
    (reference factory.py:102-128)."""
    losses = {}
    pairwise = cfg.losses.get("supervised_pairwise_projections", None)
    if pairwise is not None and pairwise.get("log_weight") is not None:
        logger.info("adding supervised pairwise projection loss")
        losses["supervised_pairwise_projections"] = {"log_weight": pairwise.get("log_weight")}
    reprojection = cfg.losses.get("supervised_reprojection_heatmap_mse", None)
    if reprojection is not None and reprojection.get("log_weight") is not None:
        logger.info("adding supervised reprojection heatmap loss")
        height = int(cfg.data.image_resize_dims.height)
        width = int(cfg.data.image_resize_dims.width)
        df = int(cfg.data.get("downsample_factor", 2))
        losses["supervised_reprojection_heatmap_mse"] = {
            "log_weight": reprojection.get("log_weight"),
            "original_image_height": height,
            "original_image_width": width,
            "downsampled_image_height": height // 2**df,
            "downsampled_image_width": width // 2**df,
        }
    return losses


class LossFactory:
    """Holds loss instances and sums their weighted values."""

    def __init__(self, losses_params_dict: dict[str, dict], data_module=None) -> None:
        self.losses_params_dict = losses_params_dict
        self.data_module = data_module
        classes = get_loss_classes()
        unknown = sorted(set(losses_params_dict) - set(classes))
        if unknown:
            # every loss of the JAX package is ported: these are no losses
            raise ValueError(f"unknown losses {unknown}; the losses are {sorted(classes)}")
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
