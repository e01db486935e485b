"""The model FLOPs that a cell's outputs need, counted by
``torch.utils.flop_counter.FlopCounterMode`` over the plain reference at
the cell's shapes, on the meta device (no memory, no arithmetic)."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from lpbench.reference import model as ref

__all__ = ["context_model_flops"]


def context_model_flops(num_keypoints: int, height: int, width: int) -> tuple[int, int]:
    """``(trunk FLOPs of one frame, heads' FLOPs of one 5-frame window)``
    of the ResNet-50 context model at ``(height, width)`` inputs."""
    meta = torch.device("meta")
    weights = {name: torch.empty(shape, device=meta) for name, shape, _ in ref.param_specs(num_keypoints)}
    with FlopCounterMode(display=False) as counter:
        features = ref.trunk(torch.empty(1, 3, height, width, device=meta), weights)
    trunk = counter.get_total_flops()
    windows = features[:, None].expand(1, ref.CONTEXT, *features.shape[1:])
    with FlopCounterMode(display=False) as counter:
        ref.context_heads(windows, weights)
    return trunk, counter.get_total_flops()
