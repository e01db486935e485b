"""Loss factory (counterpart of ``lightning_pose_tpu/losses/factory.py``).

Only the supervised heatmap losses are ported. A configured unsupervised
loss (``model.losses_to_use``) raises ``NotImplementedError``.
"""

from __future__ import annotations

from typing import Any

import torch

from lightning_pose_tpu_torch.losses.losses import (
    HeatmapJSLoss,
    HeatmapKLLoss,
    HeatmapMSELoss,
)

__all__ = ["LossFactory", "get_loss_classes", "get_loss_factories"]

# losses never scaled by the anneal weight
_ANNEAL_EXEMPT = ["heatmap_mse", "heatmap_kl", "heatmap_js"]


def get_loss_classes() -> dict[str, type]:
    """Name -> class of the ported losses."""
    return {
        "heatmap_mse": HeatmapMSELoss,
        "heatmap_kl": HeatmapKLLoss,
        "heatmap_js": HeatmapJSLoss,
    }


def get_loss_factories(cfg, data_module=None) -> dict[str, "LossFactory"]:
    """Supervised and unsupervised loss factories of a heatmap config."""
    if "heatmap" not in cfg.model.model_type:
        raise NotImplementedError(
            f"losses of model_type {cfg.model.model_type} are not ported yet "
            "(ROADMAP queue 1, item 13)"
        )
    losses_to_use = [name for name in (cfg.model.get("losses_to_use") or []) if name]
    if losses_to_use:
        raise NotImplementedError(
            f"unsupervised losses {losses_to_use} are not ported yet "
            "(ROADMAP queue 1, item 10)"
        )
    supervised = {"heatmap_" + cfg.model.heatmap_loss_type: {"log_weight": 0.0}}
    return {
        "supervised": LossFactory(supervised, data_module=data_module),
        "unsupervised": LossFactory({}, data_module=data_module),
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
                f"losses {unknown} are not ported yet (ROADMAP queue 1, items 10-13)"
            )
        self.loss_instance_dict: dict[str, Any] = {
            name: classes[name](**params) for name, params in losses_params_dict.items()
        }

    def __call__(
        self,
        stage: str | None = None,
        anneal_weight: Any = 1.0,
        **kwargs: Any,
    ) -> tuple[torch.Tensor, dict[str, torch.Tensor]]:
        """Total weighted loss and a flat dict of logs."""
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
            total = torch.zeros((), dtype=torch.float32)
        return total, logs
