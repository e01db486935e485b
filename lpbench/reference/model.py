"""Plain PyTorch reference of Lightning Pose's temporal-context heatmap model
(``heatmap_mhcrnn``) on a ResNet-50 trunk, with its soft-argmax decode.

It follows the published description (Biderman et al., "Lightning Pose",
Nature Methods 2024, and the ``lightning-pose`` code it ships with):

- trunk: torchvision's ResNet-50 truncated after ``layer4`` (stride 32),
  BatchNorm from its running statistics (eval mode);
- single-frame head: PixelShuffle(2), then transposed 3x3 stride-2
  convolutions (two for a stride-32 trunk at downsample factor 2) and a
  temperature-1 spatial softmax, on the window's middle frame;
- multi-frame head: per frame PixelShuffle(2) and a transposed conv to the
  keypoint count, then the bidirectional convolutional RNN (``x_f =
  W_f(x_t) + H_f(x_f)`` forward, the same backward with ``W_b``/``H_b``),
  whose two final states are averaged and given a temperature-1 spatial
  softmax;
- decode: each map upsampled 2x per downsample level (bicubic with Keys
  a = -0.5 and a [1, 4, 6, 4, 1]/16 blur), a temperature-1000 spatial
  softmax, its expectation, the confidence as the mass in the 5x5 window at
  the truncated expectation, and the constant grid offset removed; the two
  heads merged per keypoint by the higher confidence (in
  ``lpbench/compare.py``, which also accepts either head where their
  confidences tie).

Departures from that description, each on purpose:

- The transposed 3x3 convolutions are flax's ``padding="SAME"`` form (no
  padding, output cropped to twice the input), as the JAX rebuild and its
  port define the model; torch's ``padding=1, output_padding=1`` is another
  operator. The grouped 2x2 transposed convolutions of the recurrence take
  torch's weight layout.
- In eval mode a frame's trunk features do not depend on its window, so the
  trunk runs once per frame and the windows gather the features.
- ``Precision`` can round every convolution to bf16 (the yardstick of
  what serving in bf16 moves, ``lpbench/compare.py``) or its input and
  weight to float8 (e4m3, one scale a tensor: the benchmark's control),
  around an fp32 convolution; the reference itself is ``FP32``.

Everything is float32 with TF32 off (the caller sets the flags: see
:func:`fp32_exact`). Weights are a dict of tensors under the names of the
``state_dict`` of the model they describe.
"""

from __future__ import annotations

import contextlib
import functools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

__all__ = [
    "BF16",
    "BN_EPS",
    "CONTEXT",
    "FP32",
    "FP8",
    "GRID_OFFSET",
    "Precision",
    "TEMPERATURE",
    "context_heads",
    "decode",
    "fp32_exact",
    "param_specs",
    "trunk",
    "upsample_matrix",
]

BN_EPS = 1e-5
CONTEXT = 5
TEMPERATURE = 1000.0
# the grid offset of two rounds of 2x upsampling at downsample factor 2
GRID_OFFSET = 1.5
CONFIDENCE_HALF_WINDOW = 2  # floor(sigma 1.25 * 2 standard deviations)
STAGES = (3, 4, 6, 3)
FLOAT8_MAX = 448.0


@contextlib.contextmanager
def fp32_exact():
    """float32 matrix products and convolutions without TF32."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


@dataclass(frozen=True)
class Precision:
    """How each convolution rounds, around a float32 convolution:
    ``float32`` not at all; ``bfloat16`` its input, weight and output to
    bf16, as a bf16 autocast computes it; ``float8`` its input and weight
    to float8 e4m3 with one scale a tensor (amax / 448)."""

    dtype: str = "float32"

    def q(self, x: torch.Tensor) -> torch.Tensor:
        if self.dtype == "bfloat16":
            return x.to(torch.bfloat16).to(x.dtype)
        if self.dtype == "float8":
            scale = x.detach().abs().amax().clamp_min(1e-30) / FLOAT8_MAX
            return (x / scale).to(torch.float8_e4m3fn).to(x.dtype) * scale
        return x

    def out(self, y: torch.Tensor) -> torch.Tensor:
        return y.to(torch.bfloat16).to(y.dtype) if self.dtype == "bfloat16" else y

    def conv(self, x, weight, bias=None, **kw):
        return self.out(F.conv2d(self.q(x), self.q(weight), bias, **kw))

    def deconv(self, x, weight, bias=None, **kw):
        return self.out(F.conv_transpose2d(self.q(x), self.q(weight), bias, **kw))


FP32 = Precision()
BF16 = Precision("bfloat16")
FP8 = Precision("float8")


# ------------------------------------------------------------------------------
# parameters
# ------------------------------------------------------------------------------


def param_specs(num_keypoints: int) -> list[tuple[str, tuple[int, ...], str]]:
    """``(name, shape, kind)`` of every weight and BatchNorm statistic of the
    ResNet-50 context model with ``num_keypoints`` maps a view. ``kind`` is
    ``conv`` (a trunk convolution's weight), ``head`` (a head's 3x3
    transposed convolution), ``recurrent`` (the recurrence's 2x2 grouped
    convolutions), ``zero`` (a bias, a BatchNorm's shift or running mean),
    ``bn_weight``, ``bn_weight_last`` (a bottleneck's last BatchNorm) or
    ``bn_var``."""
    specs: list[tuple[str, tuple[int, ...], str]] = []

    def bn(prefix: str, c: int, last: bool = False) -> None:
        specs.extend([
            (f"{prefix}.weight", (c,), "bn_weight_last" if last else "bn_weight"),
            (f"{prefix}.bias", (c,), "zero"),
            (f"{prefix}.running_mean", (c,), "zero"),
            (f"{prefix}.running_var", (c,), "bn_var"),
        ])

    specs.append(("backbone.conv1.weight", (64, 3, 7, 7), "conv"))
    bn("backbone.bn1", 64)
    cin = 64
    for stage, blocks in enumerate(STAGES):
        width = 64 * 2**stage
        for block in range(blocks):
            p = f"backbone.layer{stage + 1}.{block}"
            specs.append((f"{p}.conv1.weight", (width, cin, 1, 1), "conv"))
            bn(f"{p}.bn1", width)
            specs.append((f"{p}.conv2.weight", (width, width, 3, 3), "conv"))
            bn(f"{p}.bn2", width)
            specs.append((f"{p}.conv3.weight", (4 * width, width, 1, 1), "conv"))
            bn(f"{p}.bn3", 4 * width, last=True)
            if block == 0:
                specs.append((f"{p}.downsample.0.weight", (4 * width, cin, 1, 1), "conv"))
                bn(f"{p}.downsample.1", 4 * width)
            cin = 4 * width
    k = num_keypoints
    shuffled = cin // 4
    specs += [
        ("head.head_sf.deconv0.weight", (shuffled, k, 3, 3), "head"),
        ("head.head_sf.deconv0.bias", (k,), "zero"),
        ("head.head_sf.deconv1.weight", (k, k, 3, 3), "head"),
        ("head.head_sf.deconv1.bias", (k,), "zero"),
        ("head.head_mf.W_pre.weight", (shuffled, k, 3, 3), "head"),
        ("head.head_mf.W_pre.bias", (k,), "zero"),
    ]
    for d in ("f", "b"):
        specs += [
            (f"head.head_mf.W_{d}.weight", (k, k, 3, 3), "head"),
            (f"head.head_mf.W_{d}.bias", (k,), "zero"),
            (f"head.head_mf.H_{d}_conv.weight", (16 * k, 1, 2, 2), "recurrent"),
            (f"head.head_mf.H_{d}_conv.bias", (16 * k,), "zero"),
            (f"head.head_mf.H_{d}_deconv.weight", (16 * k, 1, 2, 2), "recurrent"),
            (f"head.head_mf.H_{d}_deconv.bias", (k,), "zero"),
        ]
    return specs


def fan_in(name: str, shape: tuple[int, ...]) -> int:
    """Inputs a weight's output sums over: ``in/G * kh * kw`` for a
    convolution ``(out, in/G, kh, kw)``; for a transposed convolution
    ``(in, out/G, kh, kw)``, ``kh * kw`` times the input channels of its
    group (``in`` for the ungrouped ones, 16 for the recurrence's)."""
    if "deconv" in name or name.split(".")[-2] in ("W_pre", "W_f", "W_b"):
        groups_in = 16 if "_deconv" in name else shape[0]
        return groups_in * shape[2] * shape[3]
    return int(np.prod(shape[1:]))


# ------------------------------------------------------------------------------
# forward
# ------------------------------------------------------------------------------


def _bn(x: torch.Tensor, w: dict, prefix: str) -> torch.Tensor:
    scale = w[f"{prefix}.weight"] * torch.rsqrt(w[f"{prefix}.running_var"] + BN_EPS)
    shift = w[f"{prefix}.bias"] - w[f"{prefix}.running_mean"] * scale
    return x * scale[None, :, None, None] + shift[None, :, None, None]


def trunk(images: torch.Tensor, w: dict, prec: Precision = FP32) -> torch.Tensor:
    """ImageNet-normalized ``(N, 3, H, W)`` -> ``(N, 2048, H/32, W/32)``."""
    x = prec.conv(images, w["backbone.conv1.weight"], stride=2, padding=3)
    x = F.max_pool2d(torch.relu(_bn(x, w, "backbone.bn1")), 3, stride=2, padding=1)
    for stage, blocks in enumerate(STAGES):
        for block in range(blocks):
            p = f"backbone.layer{stage + 1}.{block}"
            stride = 2 if stage > 0 and block == 0 else 1
            residual = x
            if block == 0:
                residual = _bn(prec.conv(x, w[f"{p}.downsample.0.weight"], stride=stride), w, f"{p}.downsample.1")
            y = torch.relu(_bn(prec.conv(x, w[f"{p}.conv1.weight"]), w, f"{p}.bn1"))
            y = torch.relu(_bn(prec.conv(y, w[f"{p}.conv2.weight"], stride=stride, padding=1), w, f"{p}.bn2"))
            y = _bn(prec.conv(y, w[f"{p}.conv3.weight"]), w, f"{p}.bn3")
            x = torch.relu(y + residual)
    return x


def _same_deconv(x: torch.Tensor, weight, bias, prec: Precision) -> torch.Tensor:
    """3x3 stride-2 transposed conv, output cropped to ``(2n, 2m)``."""
    n, m = x.shape[-2:]
    return prec.deconv(x, weight, bias, stride=2)[..., : 2 * n, : 2 * m]


def spatial_softmax(x: torch.Tensor, temperature: float = 1.0) -> torch.Tensor:
    b, k, h, w = x.shape
    return torch.softmax(x.reshape(b, k, h * w) * temperature, dim=-1).reshape(b, k, h, w)


def context_heads(features: torch.Tensor, w: dict, prec: Precision = FP32) -> tuple[torch.Tensor, torch.Tensor]:
    """Windows of trunk features ``(B, 5, C, h, w)`` -> the single-frame and
    multi-frame heads' maps, each ``(B, K, 8h, 8w)``."""
    b, t = features.shape[:2]
    x = F.pixel_shuffle(features[:, t // 2], 2)
    for layer in range(2):
        x = _same_deconv(x, w[f"head.head_sf.deconv{layer}.weight"], w[f"head.head_sf.deconv{layer}.bias"], prec)
    sf = spatial_softmax(x)

    x = F.pixel_shuffle(features.reshape(b * t, *features.shape[2:]), 2)
    x = _same_deconv(x, w["head.head_mf.W_pre.weight"], w["head.head_mf.W_pre.bias"], prec)
    k = x.shape[1]

    def per_frame(d: str) -> torch.Tensor:
        y = _same_deconv(x, w[f"head.head_mf.W_{d}.weight"], w[f"head.head_mf.W_{d}.bias"], prec)
        return y.reshape(b, t, *y.shape[1:])

    def recur(d: str, state: torch.Tensor) -> torch.Tensor:
        h = prec.conv(state, w[f"head.head_mf.H_{d}_conv.weight"], w[f"head.head_mf.H_{d}_conv.bias"],
                      stride=2, groups=k)
        return prec.deconv(h, w[f"head.head_mf.H_{d}_deconv.weight"], w[f"head.head_mf.H_{d}_deconv.bias"],
                           stride=2, groups=k)

    wf, wb = per_frame("f"), per_frame("b")
    x_f = wf[:, 0]
    for i in range(1, t):
        x_f = wf[:, i] + recur("f", x_f)
    x_b = wb[:, t - 1]
    for i in range(t - 2, -1, -1):
        x_b = wb[:, i] + recur("b", x_b)
    return sf, spatial_softmax((x_f + x_b) / 2)


# ------------------------------------------------------------------------------
# decode
# ------------------------------------------------------------------------------


def _keys_bicubic(in_size: int, out_size: int) -> np.ndarray:
    """``(out, in)`` bicubic resize along one axis: Keys a = -0.5, half-pixel
    centres, taps outside the input weighted 0 and each row renormalised."""
    scale = out_size / in_size
    sample = (np.arange(out_size, dtype=np.float64) + 0.5) / scale - 0.5
    x = np.abs(sample[:, None] - np.arange(in_size, dtype=np.float64)[None, :]) / max(1.0 / scale, 1.0)
    near = ((1.5 * x - 2.5) * x) * x + 1.0
    far = ((-0.5 * x + 2.5) * x - 4.0) * x + 2.0
    weights = np.where(x >= 2.0, 0.0, np.where(x >= 1.0, far, near))
    total = weights.sum(axis=1, keepdims=True)
    weights = np.where(np.abs(total) > 1000.0 * np.finfo(np.float32).eps, weights / np.where(total != 0, total, 1), 0)
    inside = (sample >= -0.5) & (sample <= in_size - 0.5)
    return np.where(inside[:, None], weights, 0.0)


@functools.lru_cache(maxsize=4)
def upsample_matrix(in_size: int, downsample_factor: int = 2) -> np.ndarray:
    """``(in * 2**df, in)`` float32: ``df`` rounds of bicubic x2 then the
    zero-padded [1, 4, 6, 4, 1]/16 blur."""
    m = np.eye(in_size)
    size = in_size
    taps = np.array([1.0, 4.0, 6.0, 4.0, 1.0]) / 16.0
    for _ in range(downsample_factor):
        blur = sum(t * np.eye(2 * size, k=k) for k, t in zip(range(-2, 3), taps))
        m = blur @ _keys_bicubic(size, 2 * size) @ m
        size *= 2
    return m.astype(np.float32)


def upsampled_logits(maps: torch.Tensor) -> torch.Tensor:
    """``(B, K, h, w)`` maps -> the decode's ``(B, K, 4h, 4w)`` logits
    (the upsampled maps times the temperature)."""
    h, w = maps.shape[-2:]
    mh = torch.from_numpy(upsample_matrix(h)).to(maps.device)
    mw = torch.from_numpy(upsample_matrix(w)).to(maps.device)
    return torch.matmul(mh, torch.matmul(maps.float(), mw.T)) * TEMPERATURE


def decode(maps: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Soft-argmax of ``(B, K, h, w)`` maps: keypoints ``(B, K, 2)`` (x, y) in
    model pixels and confidences ``(B, K)``."""
    logits = upsampled_logits(maps)
    b, k, hh, ww = logits.shape
    probs = torch.softmax(logits.reshape(b, k, hh * ww), dim=-1).reshape(b, k, hh, ww)
    xs = torch.arange(ww, dtype=probs.dtype, device=probs.device)
    ys = torch.arange(hh, dtype=probs.dtype, device=probs.device)
    loc = torch.stack([torch.einsum("bkhw,w->bk", probs, xs), torch.einsum("bkhw,h->bk", probs, ys)], dim=-1)
    p = CONFIDENCE_HALF_WINDOW
    xi = loc[..., 0].to(torch.int64).clamp(0, ww - 1)
    yi = loc[..., 1].to(torch.int64).clamp(0, hh - 1)
    padded = F.pad(probs, (p, p, p, p))
    offs = torch.arange(2 * p + 1, device=probs.device)
    rows = (yi[..., None] + offs)[..., :, None]
    cols = (xi[..., None] + offs)[..., None, :]
    bi = torch.arange(b, device=probs.device)[:, None, None, None]
    ki = torch.arange(k, device=probs.device)[None, :, None, None]
    conf = padded[bi, ki, rows, cols].sum(dim=(-2, -1))
    return loc - GRID_OFFSET, conf


def normalize(frames_uint8: torch.Tensor) -> torch.Tensor:
    """``(N, H, W, 3)`` uint8 RGB -> ImageNet-normalized ``(N, 3, H, W)``."""
    mean = torch.tensor((0.485, 0.456, 0.406), device=frames_uint8.device)
    std = torch.tensor((0.229, 0.224, 0.225), device=frames_uint8.device)
    x = (frames_uint8.float() / 255.0 - mean) / std
    return x.permute(0, 3, 1, 2).contiguous()
