"""Seeded random weights, made on the device in two large draws.

No trained weights ship with the repository, so every cell runs seeded
random weights in the type they are served in (float32 parameters; the
program computes in bf16 by autocast). The trunk's convolutions are
He-normal, its BatchNorms near identity with no shift (each bottleneck's
last scale at 0.2), so that a frame's features are zero wherever the frame
shows the background that normalization takes to zero (``lpbench/synth.py``)
and grow only around the blobs. The heads' weights are positive
(uniform on ``[0, head_gain * limit)``, ``limit`` Xavier's), so that every
map rises where the features do: each keypoint is pulled toward the blobs
and moves with them from frame to frame. ``head_gain`` keeps the decode's
logits (a thousand times each map's softmax) within about a nat, where
the soft-argmax moves smoothly with the content; well above it a map
peaks at one blob, and where two blobs tie, rounding makes the keypoint
leap from one to the other. The recurrence's grouped convolutions are positive
too (uniform on ``[0, 1 / fan_in)``) and shrink the state they carry.
"""

from __future__ import annotations

import math

import torch

from lpbench.reference.model import fan_in

__all__ = ["make_weights"]


def make_weights(specs, seed: int, device, head_gain: float) -> dict[str, torch.Tensor]:
    """``{name: float32 tensor on device}`` for ``specs`` (``(name, shape,
    kind)``, :func:`lpbench.reference.model.param_specs`) from ``seed``: one
    normal and one uniform draw over all of them, then scaled per kind."""
    gen = torch.Generator(device).manual_seed(int(seed))
    sizes = [math.prod(shape) for _, shape, _ in specs]
    total = sum(sizes)
    normal = torch.randn(total, generator=gen, device=device).split(sizes)
    uniform = torch.rand(total, generator=gen, device=device).split(sizes)
    out = {}
    for (name, shape, kind), n, u in zip(specs, normal, uniform):
        if kind == "conv":
            x = n * math.sqrt(2.0 / fan_in(name, shape))
        elif kind == "head":  # (in, out, kh, kw): fans in + out over the taps
            x = u * head_gain * math.sqrt(6.0 / (shape[2] * shape[3] * (shape[0] + shape[1])))
        elif kind == "recurrent":
            x = u / fan_in(name, shape)
        elif kind == "zero":
            x = torch.zeros_like(n)
        elif kind == "bn_weight":
            x = torch.ones_like(n)
        elif kind == "bn_weight_last":
            x = torch.full_like(n, 0.2)
        elif kind == "bn_var":
            x = 0.8 + 0.4 * u
        else:
            raise ValueError(f"unknown weight kind {kind!r} of {name}")
        out[name] = x.reshape(shape).contiguous()
    return out
