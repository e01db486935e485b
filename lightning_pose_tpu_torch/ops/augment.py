"""Batched augmentation on the device (counterpart of
``lightning_pose_tpu/ops/augment.py``).

The engine reproduces the JAX package's ``AugmentationEngine._augment`` op
for op, with the randomness split out:

- :meth:`AugmentationEngine.sample` makes every random draw of one call, by
  the names of the JAX keys they replace (``Draws``). The per-image scalars
  and flags (a few per image) come from a CPU generator, so which images
  fire the rare ops (histogram equalization, CLAHE, emboss) is known on the
  host and the sparse application needs no device-to-host copy. The large
  fields (the elastic noise, the coarse-dropout uniforms) come from a
  generator on the images' device.
- :meth:`AugmentationEngine.apply` is deterministic given the draws. The
  geometric ops (Rot90, rotation, CropAndPad, horizontal flip) compose into
  one 3x3 matrix per image, the elastic field adds a smooth displacement,
  and the image is sampled once with the bilinear warp kernel
  (``ops/warp_kernel.py``). Motion blur, coarse dropout, salt and pepper,
  histogram equalization, CLAHE (per-tile LUTs here, their blend in
  ``ops/clahe_kernel.py``) and emboss follow. Keypoints ride the same
  matrices.

The tests replay the JAX engine's draws into :meth:`apply`. What the JAX
package computes with TPU workarounds (nibble-split matmul histograms, the
XLA half-block blend, the warp row window, dynamic-update-slice chains for
the sparse ops) is computed here directly: histograms by ``scatter_add``,
LUTs by exact gathers, and the fired subset by indexing.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from lightning_pose_tpu_torch.ops.clahe_kernel import clahe_apply
from lightning_pose_tpu_torch.ops.warp_kernel import warp

__all__ = ["AugmentationEngine", "Draws", "build_spec"]


# ------------------------------------------------------------------------------
# affine helpers (3x3 homogeneous, acting on (x, y, 1)), float32
# ------------------------------------------------------------------------------


def _identity(b: int) -> torch.Tensor:
    return torch.eye(3, dtype=torch.float32).expand(b, 3, 3).clone()


def _matrices(rows: list[list[torch.Tensor]]) -> torch.Tensor:
    """Stack nine ``(B,)`` entries into ``(B, 3, 3)``."""
    return torch.stack([torch.stack(row, dim=-1) for row in rows], dim=-2)


def _rotation_about_center(theta: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Forward keypoint matrix of a rotation by ``theta`` about the image centre."""
    cx, cy = (w - 1) / 2.0, (h - 1) / 2.0
    cos, sin = torch.cos(theta), torch.sin(theta)
    zeros, ones = torch.zeros_like(cos), torch.ones_like(cos)
    return _matrices([
        [cos, -sin, cx - cos * cx + sin * cy],
        [sin, cos, cy - sin * cx - cos * cy],
        [zeros, zeros, ones],
    ])


def _rot90_matrix(k: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Forward keypoint matrix of ``k`` quarter turns."""
    return _rotation_about_center(-k.to(torch.float32) * (np.pi / 2.0), h, w)


def _croppad_matrix(percents: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Forward keypoint matrix of CropAndPad (``percents (B, 4)`` = top,
    right, bottom, left; positive pads, negative crops) and the resize back
    to ``(h, w)``."""
    top, right, bottom, left = percents.unbind(dim=1)
    x0 = -left * w
    y0 = -top * h
    sx = w / (w * (1.0 + left + right))
    sy = h / (h * (1.0 + top + bottom))
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    return _matrices([
        [sx, zeros, -x0 * sx],
        [zeros, sy, -y0 * sy],
        [zeros, zeros, ones],
    ])


def _hflip_matrix(flip: torch.Tensor, h: int, w: int) -> torch.Tensor:
    sx = torch.where(flip, -1.0, 1.0)
    tx = torch.where(flip, float(w - 1), 0.0)
    zeros, ones = torch.zeros_like(sx), torch.ones_like(sx)
    return _matrices([
        [sx, zeros, tx],
        [zeros, ones, zeros],
        [zeros, zeros, ones],
    ])


# ------------------------------------------------------------------------------
# elastic field, masks and photometric ops
# ------------------------------------------------------------------------------


def _blur_band_matrix(n: int, sigma: float) -> np.ndarray:
    """``(n, n)`` banded matrix applying a zero-padded Gaussian along one axis."""
    radius = int(3 * sigma)
    xs = np.arange(-radius, radius + 1, dtype=np.float32)
    k = np.exp(-(xs**2) / (2 * sigma**2))
    k /= k.sum()
    d = np.subtract.outer(np.arange(n), np.arange(n))  # d[i, j] = i - j
    band = np.where(np.abs(d) <= radius, k[np.clip(d + radius, 0, 2 * radius)], 0.0)
    return band.astype(np.float32)


def _separable_gaussian_blur(field: torch.Tensor, sigma: float) -> torch.Tensor:
    """Blur ``(B, H, W, C)`` with a fixed-sigma separable Gaussian, zero
    padded, as two banded-matrix products in fp32."""
    _, h, w, _ = field.shape
    bh = torch.from_numpy(_blur_band_matrix(h, sigma)).to(field.device)
    bw = torch.from_numpy(_blur_band_matrix(w, sigma)).to(field.device)
    out = torch.einsum("ij,bjwc->biwc", bh, field)
    return torch.einsum("xu,biuc->bixc", bw, out)


def _coarse_size(h: int, w: int, size_percent: float) -> tuple[int, int]:
    return max(1, int(h * size_percent)), max(1, int(w * size_percent))


def _coarse_mask(low: torch.Tensor, h: int, w: int, drop_p: float) -> torch.Tensor:
    """Keep-mask ``(B, H, W, 1)`` (True = keep) from low-resolution uniforms
    ``(B, lh, lw, 1)``, upsampled nearest. ``nearest-exact`` is the rounding
    of ``jax.image.resize(..., "nearest")``; plain ``nearest`` is not."""
    keep = (low >= drop_p).to(torch.float32).permute(0, 3, 1, 2)
    up = F.interpolate(keep, size=(h, w), mode="nearest-exact")
    return up.permute(0, 2, 3, 1) > 0.5


def _equalize_hist(images: torch.Tensor, clip_limit: torch.Tensor | None = None) -> torch.Tensor:
    """Per-image per-channel histogram equalization of 0-255 floats
    ``(B, H, W, C)``. With ``clip_limit`` (a multiple of the mean bin count)
    the bins are clipped and the excess spread evenly: a global stand-in for
    CLAHE on sizes that do not split into tiles."""
    b, h, w, c = images.shape
    vals = images.clamp(0, 255).to(torch.int64).permute(0, 3, 1, 2).reshape(b * c, h * w)
    offsets = torch.arange(b * c, device=images.device)[:, None] * 256
    counts = torch.zeros(b * c * 256, dtype=torch.float32, device=images.device)
    counts.scatter_add_(0, (vals + offsets).reshape(-1), torch.ones(vals.numel(), device=images.device))
    counts = counts.reshape(b, c, 256)
    if clip_limit is not None:
        limit = clip_limit[:, None, None] * counts.mean(dim=-1, keepdim=True)
        excess = (counts - limit).clamp(min=0.0).sum(dim=-1, keepdim=True)
        counts = torch.minimum(counts, limit) + excess / 256.0
    cdf = torch.cumsum(counts, dim=-1)
    cdf_min = cdf[..., :1]
    denom = (cdf[..., -1:] - cdf_min).clamp(min=1.0)
    lut = ((cdf - cdf_min) / denom * 255.0).clamp(0, 255).reshape(b * c, 256)
    eq = torch.gather(lut, 1, vals)
    return eq.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _clahe_lut_grid(x: torch.Tensor, clip_limit: torch.Tensor, g: int) -> torch.Tensor:
    """Per-tile clip-limited LUTs of tiled CLAHE: ``x (B, C, H, W)`` integer
    values 0-255 -> ``(B, C, g, g, 256)`` fp32.

    The clip is cv2's integer clip and redistribution (clahe.cpp), kept bit
    for bit: ``limit = max(floor(clip * tile_area / 256), 1)``; the clipped
    mass spreads as ``floor(clipped / 256)`` to every bin plus one to the
    first ``residual`` bins at stride ``max(256 // residual, 1)``.
    """
    b, c, h, w = x.shape
    th, tw = h // g, w // g
    n = th * tw
    tiles = x.reshape(b, c, g, th, g, tw).permute(0, 1, 2, 4, 3, 5).reshape(b * c * g * g, n)
    offsets = torch.arange(b * c * g * g, device=x.device)[:, None] * 256
    counts = torch.zeros(b * c * g * g * 256, dtype=torch.float32, device=x.device)
    counts.scatter_add_(0, (tiles + offsets).reshape(-1), torch.ones(tiles.numel(), device=x.device))
    counts = counts.reshape(b, c, g * g, 256)
    limit = torch.floor(clip_limit[:, None, None, None] * n / 256.0).clamp(min=1.0)
    clipped = (counts - limit).clamp(min=0.0).sum(dim=-1, keepdim=True)
    redist = torch.floor(clipped / 256.0)
    residual = clipped - redist * 256.0
    step = torch.floor(256.0 / residual.clamp(min=1.0)).clamp(min=1.0)
    bins = torch.arange(256, dtype=torch.float32, device=x.device)
    bump = ((torch.remainder(bins, step) == 0) & (torch.floor(bins / step) < residual)).to(torch.float32)
    counts = torch.minimum(counts, limit) + redist + bump
    cdf = torch.cumsum(counts, dim=-1)
    return (cdf * (255.0 / n)).clamp(0.0, 255.0).reshape(b, c, g, g, 256)


def _equalize_clahe_tiled(images: torch.Tensor, clip_limit: torch.Tensor, grid: int = 16) -> torch.Tensor:
    """Tiled CLAHE (cv2.createCLAHE semantics) of 0-255 floats ``(B, H, W,
    C)``: per-tile clip-limited LUTs, then a bilinear blend of the four
    nearest tiles' LUTs at every pixel (the CLAHE kernel on a CUDA tensor).
    Sizes that do not split into half-blocks take the global clip-limited
    equalization, as in the reference."""
    b, h, w, c = images.shape
    g = int(grid)
    if g <= 1 or h % (2 * g) or w % (2 * g):
        return _equalize_hist(images, clip_limit=clip_limit)
    x = images.permute(0, 3, 1, 2).contiguous()  # (B, C, H, W)
    lut = _clahe_lut_grid(x.clamp(0, 255).to(torch.int64), clip_limit, g)
    out = clahe_apply(x.reshape(b * c, h, w), lut.reshape(b * c, g, g, 256), g)
    return out.reshape(b, c, h, w).permute(0, 2, 3, 1)


def _emboss(images: torch.Tensor, alpha: torch.Tensor, strength: torch.Tensor) -> torch.Tensor:
    """imgaug's emboss: the kernel ``[[-1-s, -s, 0], [-s, 1, s], [0, s,
    1+s]]`` correlated with the zero-padded image, blended with per-image
    ``alpha`` and clipped to 0-255."""
    h, w = images.shape[1], images.shape[2]
    s = strength[:, None, None, None]
    padded = F.pad(images, (0, 0, 1, 1, 1, 1))

    def sh(ky: int, kx: int) -> torch.Tensor:
        return padded[:, ky:ky + h, kx:kx + w, :]

    embossed = (
        (-1.0 - s) * sh(0, 0)
        - s * sh(0, 1)
        - s * sh(1, 0)
        + sh(1, 1)
        + s * sh(1, 2)
        + s * sh(2, 1)
        + (1.0 + s) * sh(2, 2)
    )
    a = alpha[:, None, None, None]
    return ((1 - a) * images + a * embossed).clamp(0, 255)


def _motion_blur_kernels(dx: torch.Tensor, dy: torch.Tensor, ksz: int) -> torch.Tensor:
    """``(B, k, k)`` line kernels: the ``k`` taps along ``(dx, dy)``
    bilinearly splatted onto a ``k x k`` grid, divided by ``k``."""
    half = (ksz - 1) // 2
    taps = torch.arange(-half, half + 1, dtype=torch.float32, device=dx.device)
    tx = taps[None, :] * dx[:, None]
    ty = taps[None, :] * dy[:, None]
    grid = taps
    wxk = (1.0 - (tx[:, :, None] - grid).abs()).clamp(min=0.0)
    wyk = (1.0 - (ty[:, :, None] - grid).abs()).clamp(min=0.0)
    return torch.einsum("bty,btx->byx", wyk, wxk) / float(ksz)


# ------------------------------------------------------------------------------
# pipeline spec
# ------------------------------------------------------------------------------


def build_spec(pipeline: str | dict | None) -> dict:
    """Normalize a preset string or an imgaug-style per-transform dict into
    the engine's parameter spec (the JAX package's ``build_spec``). Each key
    is an optional transform; None disables it. Unknown transforms raise."""
    spec: dict = {
        "rot90": None,          # {"p", "k": [choices]}
        "affine": None,         # {"p", "rotate": deg}
        "croppad": None,        # {"p", "percent"}
        "elastic": None,        # {"p", "alpha": (lo, hi), "sigma"}
        "motion_blur": None,    # {"p", "k", "angle": deg}
        "coarse_dropout": None,  # {"p", "drop", "size", "per_channel"}
        "coarse_salt": None,    # {"p", "drop", "size"}
        "coarse_pepper": None,  # {"p", "drop", "size"}
        "histeq": None,         # {"p"}
        "clahe": None,          # {"p", "clip": (lo, hi), "tiles": grid (0 = global)}
        "emboss": None,         # {"p", "alpha": (lo, hi), "strength": (lo, hi)}
        "fliplr": None,         # {"p"}: imgaug Fliplr, a plain mirror with no swap
    }
    if pipeline is None or pipeline in ("default", "none"):
        return spec
    if isinstance(pipeline, str):
        if not pipeline.startswith("dlc"):
            raise NotImplementedError(
                f"cfg.training.imgaug string {pipeline} must be a preset "
                "(default/none/dlc/dlc-lr/dlc-top-down/dlc-mv) or a dict"
            )
        if pipeline == "dlc-lr":
            spec["rot90"] = {"p": 1.0, "k": [0, 2]}
        elif pipeline == "dlc-top-down":
            spec["rot90"] = {"p": 1.0, "k": [0, 1, 2, 3]}
        if not pipeline.endswith("mv"):
            spec["affine"] = {"p": 0.4, "rotate": 25.0}
            spec["croppad"] = {"p": 0.4, "percent": 0.15}
            spec["elastic"] = {"p": 0.5, "alpha": (0.0, 10.0), "sigma": 5.0}
        spec["motion_blur"] = {"p": 0.5, "k": 5, "angle": 90.0}
        spec["coarse_dropout"] = {"p": 0.5, "drop": 0.02, "size": 0.3, "per_channel": 0.5}
        spec["coarse_salt"] = {"p": 0.5, "drop": 0.01, "size": 0.075}
        spec["coarse_pepper"] = {"p": 0.5, "drop": 0.01, "size": 0.075}
        spec["histeq"] = {"p": 0.1}
        spec["clahe"] = {"p": 0.1, "clip": (1.0, 8.0)}
        spec["emboss"] = {"p": 0.1, "alpha": (0.0, 0.5), "strength": (0.5, 1.5)}
        return spec

    def _rng_mag(value, default):
        if value is None:
            return default
        if isinstance(value, (list, tuple)):
            return float(max(abs(v) for v in value))
        return float(abs(value))

    def _rng_pair(value, default):
        if value is None:
            return default
        if isinstance(value, (list, tuple)) and len(value) == 2:
            return (float(value[0]), float(value[1]))
        v = float(value)
        return (v, v)

    def _mean_size(size):
        return float(sum(size) / len(size)) if isinstance(size, (list, tuple)) else float(size)

    for name, args in dict(pipeline).items():
        args = args or {}
        prob = float(args.get("p", 0.5))
        kwargs = dict(args.get("kwargs", {}) or {})
        if prob == 0.0:
            continue
        if name == "Rot90":
            k = kwargs.get("k", [0, 1, 2, 3])
            if isinstance(k, (list, tuple)) and len(k) == 1 and isinstance(k[0], (list, tuple)):
                choices = list(k[0])
            elif isinstance(k, (list, tuple)) and len(k) == 2:
                choices = list(range(int(k[0]), int(k[1]) + 1))
            elif isinstance(k, (list, tuple)):
                choices = [int(v) for v in k]
            else:
                choices = [int(k)]
            spec["rot90"] = {"p": prob, "k": choices}
        elif name == "Affine":
            spec["affine"] = {"p": prob, "rotate": _rng_mag(kwargs.get("rotate"), 25.0)}
        elif name == "Fliplr":
            spec["fliplr"] = {"p": prob}
        elif name == "MotionBlur":
            spec["motion_blur"] = {
                "p": prob,
                "k": int(kwargs.get("k", 5)),
                "angle": _rng_mag(kwargs.get("angle"), 90.0),
            }
        elif name == "CoarseDropout":
            spec["coarse_dropout"] = {
                "p": prob,
                "drop": float(kwargs.get("p", 0.02)),
                "size": _mean_size(kwargs.get("size_percent", 0.3)),
                "per_channel": float(kwargs.get("per_channel", 0.0)),
            }
        elif name in ("CoarseSalt", "CoarsePepper"):
            key = "coarse_salt" if name == "CoarseSalt" else "coarse_pepper"
            spec[key] = {
                "p": prob,
                "drop": float(kwargs.get("p", 0.01)),
                "size": _mean_size(kwargs.get("size_percent", 0.075)),
            }
        elif name == "ElasticTransformation":
            sigma = kwargs.get("sigma", 5.0)
            spec["elastic"] = {
                "p": prob,
                "alpha": _rng_pair(kwargs.get("alpha"), (0.0, 10.0)),
                "sigma": float(sum(sigma) / 2 if isinstance(sigma, (list, tuple)) else sigma),
            }
        elif name == "AllChannelsHistogramEqualization":
            spec["histeq"] = {"p": prob}
        elif name == "AllChannelsCLAHE":
            spec["clahe"] = {
                "p": prob,
                "clip": _rng_pair(kwargs.get("clip_limit"), (1.0, 8.0)),
                "tiles": int(kwargs.get("tiles", 16)),
            }
        elif name == "Emboss":
            spec["emboss"] = {
                "p": prob,
                "alpha": _rng_pair(kwargs.get("alpha"), (0.0, 0.5)),
                "strength": _rng_pair(kwargs.get("strength"), (0.5, 1.5)),
            }
        elif name == "CropAndPad":
            spec["croppad"] = {"p": prob, "percent": _rng_mag(kwargs.get("percent", 0.15), 0.15)}
        elif name == "Resize":
            pass  # images are already resized on the host
        else:
            raise NotImplementedError(
                f"unsupported augmentation transform '{name}'; supported "
                "names: Rot90, Affine, Fliplr, MotionBlur, CoarseDropout, "
                "CoarseSalt, CoarsePepper, ElasticTransformation, "
                "AllChannelsHistogramEqualization, AllChannelsCLAHE, "
                "Emboss, CropAndPad, Resize"
            )
    return spec


# ------------------------------------------------------------------------------
# the engine
# ------------------------------------------------------------------------------


@dataclass
class Draws:
    """Every random draw of one engine call, named after the key of the JAX
    engine that makes it (``keys[i]`` of ``_augment``). Uniforms in [0, 1)
    decide the Bernoulli flags (``u < p``); the others are the drawn values.
    Per-image entries are ``(B,)`` or ``(B, 4)`` CPU tensors; the fields
    (elastic noise, coarse-dropout uniforms) lie on the images' device.
    A transform the spec disables has ``None``."""

    rot90_u: torch.Tensor | None = None             # keys[27]
    rot90_choice: torch.Tensor | None = None        # keys[0], index into spec k
    affine_u: torch.Tensor | None = None            # keys[1]
    affine_deg: torch.Tensor | None = None          # keys[2]
    croppad_u: torch.Tensor | None = None           # keys[3]
    croppad_percents: torch.Tensor | None = None    # keys[4], (B, 4)
    flip_u: torch.Tensor | None = None              # keys[5]
    elastic_u: torch.Tensor | None = None           # keys[6]
    elastic_alpha: torch.Tensor | None = None       # keys[7]
    elastic_raw: torch.Tensor | None = None         # keys[8], (B, H, W, 2) in [-1, 1)
    blur_u: torch.Tensor | None = None              # keys[9]
    blur_deg: torch.Tensor | None = None            # keys[10]
    dropout_u: torch.Tensor | None = None           # keys[11]
    dropout_low: torch.Tensor | None = None         # keys[12], (B, lh, lw, 1)
    dropout_channel_u: torch.Tensor | None = None   # keys[13]
    dropout_low_rgb: torch.Tensor | None = None     # keys[14..16], (3, B, lh, lw, 1)
    salt_u: torch.Tensor | None = None              # keys[17]
    salt_low: torch.Tensor | None = None            # keys[18], (B, lh, lw, 1)
    pepper_u: torch.Tensor | None = None            # keys[19]
    pepper_low: torch.Tensor | None = None          # keys[20], (B, lh, lw, 1)
    histeq_u: torch.Tensor | None = None            # keys[21]
    clahe_u: torch.Tensor | None = None             # keys[22]
    emboss_u: torch.Tensor | None = None            # keys[23]
    clahe_clip: torch.Tensor | None = None          # keys[24]
    emboss_alpha: torch.Tensor | None = None        # keys[25]
    emboss_strength: torch.Tensor | None = None     # keys[26]


def _fired(u: torch.Tensor, p: float) -> torch.Tensor:
    """Indices of the images whose flag fires, from a CPU uniform."""
    return torch.nonzero(u < p).flatten()


class AugmentationEngine:
    """Batched augmentation from a preset string or an imgaug-style
    per-transform dict, on the device of the images it is given."""

    def __init__(
        self,
        pipeline: str | dict | None,
        image_height: int,
        image_width: int,
        hflip: bool = False,
        hflip_swap_indices: np.ndarray | None = None,
    ) -> None:
        self.pipeline = pipeline if pipeline is not None else "default"
        self.spec = build_spec(self.pipeline)
        self.h = int(image_height)
        self.w = int(image_width)
        self.hflip = hflip
        self.swap_indices = (
            torch.as_tensor(np.asarray(hflip_swap_indices), dtype=torch.int64)
            if hflip_swap_indices is not None
            else None
        )
        self.is_dlc = self.spec["motion_blur"] is not None or any(
            self.spec[k] is not None
            for k in ("coarse_dropout", "coarse_salt", "coarse_pepper", "histeq", "clahe", "emboss")
        )
        self.identity = all(v is None for v in self.spec.values()) and not hflip

    # -- draws ------------------------------------------------------------------------

    def sample(
        self,
        generator: torch.Generator,
        b: int,
        field_generator: torch.Generator | None = None,
    ) -> Draws:
        """All random draws of one call on ``b`` images. ``generator`` is a
        CPU generator for the per-image scalars; ``field_generator`` (default
        ``generator``) makes the fields, on its own device."""
        if generator.device.type != "cpu":
            raise ValueError("the per-image draws come from a CPU generator")
        field_generator = field_generator or generator
        fdev = field_generator.device
        spec, h, w = self.spec, self.h, self.w
        d = Draws()

        def u(*shape):
            return torch.rand(shape, generator=generator)

        def between(lo, hi, *shape):
            return torch.rand(shape, generator=generator) * (hi - lo) + lo

        def field(*shape):
            return torch.rand(shape, generator=field_generator, device=fdev)

        if spec["rot90"] is not None:
            d.rot90_u = u(b)
            d.rot90_choice = torch.randint(len(spec["rot90"]["k"]), (b,), generator=generator)
        if spec["affine"] is not None:
            rot = spec["affine"]["rotate"]
            d.affine_u, d.affine_deg = u(b), between(-rot, rot, b)
        if spec["croppad"] is not None:
            pct = spec["croppad"]["percent"]
            d.croppad_u, d.croppad_percents = u(b), between(-pct, pct, b, 4)
        if self.hflip or spec["fliplr"] is not None:
            d.flip_u = u(b)
        if spec["elastic"] is not None:
            alo, ahi = spec["elastic"]["alpha"]
            d.elastic_u, d.elastic_alpha = u(b), between(alo, ahi, b)
            d.elastic_raw = field(b, h, w, 2) * 2.0 - 1.0
        if spec["motion_blur"] is not None:
            ang = spec["motion_blur"]["angle"]
            d.blur_u, d.blur_deg = u(b), between(-ang, ang, b)
        if spec["coarse_dropout"] is not None:
            lh, lw = _coarse_size(h, w, spec["coarse_dropout"]["size"])
            d.dropout_u, d.dropout_channel_u = u(b), u(b)
            d.dropout_low = field(b, lh, lw, 1)
            d.dropout_low_rgb = field(3, b, lh, lw, 1)
        if spec["coarse_salt"] is not None:
            lh, lw = _coarse_size(h, w, spec["coarse_salt"]["size"])
            d.salt_u, d.salt_low = u(b), field(b, lh, lw, 1)
        if spec["coarse_pepper"] is not None:
            lh, lw = _coarse_size(h, w, spec["coarse_pepper"]["size"])
            d.pepper_u, d.pepper_low = u(b), field(b, lh, lw, 1)
        if spec["histeq"] is not None:
            d.histeq_u = u(b)
        if spec["clahe"] is not None:
            clo, chi = spec["clahe"]["clip"]
            d.clahe_u, d.clahe_clip = u(b), between(clo, chi, b)
        if spec["emboss"] is not None:
            em = spec["emboss"]
            d.emboss_u = u(b)
            d.emboss_alpha = between(*em["alpha"], b)
            d.emboss_strength = between(*em["strength"], b)
        return d

    # -- the deterministic transform -----------------------------------------------

    def apply(
        self,
        images: torch.Tensor,
        keypoints: torch.Tensor,
        visibility: torch.Tensor | None = None,
        draws: Draws | None = None,
    ):
        """Augment ``images (B, H, W, 3)`` uint8/float 0-255 and keypoints
        ``(B, K, 2)`` with the given draws; ``visibility (B, K)`` flags ride
        the hflip identity swap with the keypoints.

        Context stacks ``(B, T, H, W, 3)`` take draws for ``B`` stacks
        (``sample(b)``): each stack's one transform goes to all its T frames,
        and every per-stack quantity (the sampling field, the motion-blur
        kernel, the dropout masks, the photometric flags) repeats over them.
        The keypoints are the center frame's.

        Returns ``(images float32 0-255, keypoints)`` plus the visibility when
        one was passed. Keypoints that leave the frame, or were NaN, are NaN.
        """
        if images.ndim not in (4, 5):
            raise ValueError(f"apply takes (B, H, W, 3) images or (B, T, H, W, 3) stacks, got {tuple(images.shape)}")
        if self.identity:
            out = (images.to(torch.float32), keypoints)
            return out if visibility is None else (*out, visibility)
        if draws is None:
            raise ValueError("apply needs the draws of this call (AugmentationEngine.sample)")
        dev = images.device
        spec, h, w = self.spec, self.h, self.w
        b = images.shape[0]
        t = images.shape[1] if images.ndim == 5 else 1
        images = images.to(torch.float32).reshape(b * t, h, w, images.shape[-1])

        def rep(x: torch.Tensor) -> torch.Tensor:
            """A per-stack quantity, repeated over each stack's frames."""
            return x.repeat_interleave(t, dim=0) if t > 1 else x

        def frames_of(groups: torch.Tensor) -> torch.Tensor:
            """The frame indices of the stacks ``groups`` (a CPU tensor)."""
            return (groups[:, None] * t + torch.arange(t)).flatten() if t > 1 else groups

        forward, coords, disp, flip = self.sampling_grid(draws, b, dev)

        if spec["motion_blur"] is not None:
            # a k-tap line kernel along a random direction, applied after
            # the warp as one per-image depthwise conv; the warp samples
            # replicate-clamped coords and the zero-outside mask is applied
            # after the blur
            mb = spec["motion_blur"]
            fire = draws.blur_u < mb["p"]
            angle = draws.blur_deg * (np.pi / 180.0)
            dx = torch.where(fire, torch.cos(angle), 0.0)
            dy = torch.where(fire, torch.sin(angle), 0.0)
            ksz = int(mb["k"])
            half = (ksz - 1) // 2
            kern = rep(_motion_blur_kernels(dx, dy, ksz)).to(dev, non_blocking=True)
            coords = rep(coords)
            cx = coords[..., 0:1].clamp(0.0, float(w - 1))
            cy = coords[..., 1:2].clamp(0.0, float(h - 1))
            in_bounds = (
                (coords[..., 0:1] >= -0.5) & (coords[..., 0:1] <= w - 0.5)
                & (coords[..., 1:2] >= -0.5) & (coords[..., 1:2] <= h - 0.5)
            ).to(torch.float32)
            warped = warp(images.contiguous(), torch.cat([cx, cy], dim=-1).contiguous())
            c_ = warped.shape[-1]
            x_g = warped.permute(0, 3, 1, 2).reshape(1, b * t * c_, h, w)
            x_g = F.pad(x_g, (half, half, half, half), mode="replicate")
            weight = kern.repeat_interleave(c_, dim=0)[:, None]  # (B*T*C, 1, k, k)
            blurred = F.conv2d(x_g, weight, groups=b * t * c_)
            warped = blurred.reshape(b * t, c_, h, w).permute(0, 2, 3, 1) * in_bounds
        else:
            warped = warp(images.contiguous(), rep(coords).contiguous())

        # -- keypoints through the forward matrix --------------------------------
        kp_h = torch.cat([keypoints, torch.ones_like(keypoints[..., :1])], dim=-1)
        kp_new = torch.einsum("bij,bkj->bki", forward, kp_h)[..., :2]
        if disp is not None:
            # the displacement at the transformed location, truncated to a pixel
            kxi = torch.nan_to_num(kp_new[..., 0], nan=0.0).to(torch.int64).clamp(0, w - 1)
            kyi = torch.nan_to_num(kp_new[..., 1], nan=0.0).to(torch.int64).clamp(0, h - 1)
            bidx = torch.arange(b, device=dev)[:, None]
            kp_new = kp_new - disp[bidx, kyi, kxi]
        if self.hflip and self.swap_indices is not None:
            flip_d = flip.to(dev, non_blocking=True)
            swap = self.swap_indices.to(dev)
            kp_new = torch.where(flip_d[:, None, None], kp_new[:, swap, :], kp_new)
            if visibility is not None:
                visibility = torch.where(flip_d[:, None], visibility[:, swap], visibility)
        nan_mask = torch.isnan(keypoints).any(dim=-1, keepdim=True)
        oob = (
            (kp_new[..., 0:1] < -0.5) | (kp_new[..., 0:1] > w - 0.5)
            | (kp_new[..., 1:2] < -0.5) | (kp_new[..., 1:2] > h - 0.5)
        )
        kp_new = torch.where(nan_mask | oob, float("nan"), kp_new)

        # -- photometric stack ---------------------------------------------------
        out = warped
        if spec["coarse_dropout"] is not None:
            cd = spec["coarse_dropout"]
            fire = rep(draws.dropout_u < cd["p"]).to(dev, non_blocking=True)
            per_ch = rep(draws.dropout_channel_u < cd["per_channel"]).to(dev, non_blocking=True)
            mask1 = rep(_coarse_mask(draws.dropout_low.to(dev), h, w, cd["drop"]))
            mask_c = rep(torch.cat(
                [_coarse_mask(low.to(dev), h, w, cd["drop"]) for low in draws.dropout_low_rgb], dim=-1
            ))
            drop_mask = torch.where(per_ch[:, None, None, None], mask_c, mask1)
            keep = torch.where(fire[:, None, None, None], drop_mask, True)
            out = out * keep
        if spec["coarse_salt"] is not None:
            cs = spec["coarse_salt"]
            fire = rep(draws.salt_u < cs["p"]).to(dev, non_blocking=True)
            salt = rep(~_coarse_mask(draws.salt_low.to(dev), h, w, cs["drop"]))
            out = torch.where(fire[:, None, None, None] & salt, 255.0, out)
        if spec["coarse_pepper"] is not None:
            cp = spec["coarse_pepper"]
            fire = rep(draws.pepper_u < cp["p"]).to(dev, non_blocking=True)
            pepper = rep(~_coarse_mask(draws.pepper_low.to(dev), h, w, cp["drop"]))
            out = torch.where(fire[:, None, None, None] & pepper, 0.0, out)

        # the rare ops run on the fired stacks' frames only; which fired is
        # known on the host
        if spec["histeq"] is not None:
            fired = _fired(draws.histeq_u, spec["histeq"]["p"])
            out = self._on_fired(out, frames_of(fired), _equalize_hist)
        if spec["clahe"] is not None:
            grid_n = int(spec["clahe"].get("tiles", 16))
            fired = _fired(draws.clahe_u, spec["clahe"]["p"])
            clip = rep(draws.clahe_clip[fired]).to(dev, non_blocking=True)
            out = self._on_fired(
                out, frames_of(fired), lambda sub: _equalize_clahe_tiled(sub, clip_limit=clip, grid=grid_n)
            )
        if spec["emboss"] is not None:
            fired = _fired(draws.emboss_u, spec["emboss"]["p"])
            alpha = rep(draws.emboss_alpha[fired]).to(dev, non_blocking=True)
            strength = rep(draws.emboss_strength[fired]).to(dev, non_blocking=True)
            out = self._on_fired(out, frames_of(fired), lambda sub: _emboss(sub, alpha, strength))

        if t > 1:
            out = out.reshape(b, t, h, w, out.shape[-1])
        if visibility is None:
            return out, kp_new
        return out, kp_new, visibility

    def sampling_grid(self, draws: Draws, b: int, device) -> tuple:
        """The geometric part of :meth:`apply` for ``b`` images: the forward
        keypoint matrices ``(B, 3, 3)``, the input pixel ``(x, y)`` that each
        output pixel samples ``(B, H, W, 2)``, the elastic displacement
        ``(B, H, W, 2)`` (None without elastic) and the flip flags (a CPU
        ``(B,)`` bool). The matrices are built on the host from the per-image
        draws and moved to ``device`` once."""
        spec, h, w = self.spec, self.h, self.w
        forward = _identity(b)
        if spec["rot90"] is not None:
            choices = torch.tensor(spec["rot90"]["k"])
            k = torch.where(draws.rot90_u < spec["rot90"]["p"], choices[draws.rot90_choice], 0)
            forward = _rot90_matrix(k, h, w) @ forward
        if spec["affine"] is not None:
            theta = draws.affine_deg * (np.pi / 180.0)
            theta = torch.where(draws.affine_u < spec["affine"]["p"], theta, 0.0)
            forward = _rotation_about_center(theta, h, w) @ forward
        if spec["croppad"] is not None:
            fire = draws.croppad_u < spec["croppad"]["p"]
            percents = torch.where(fire[:, None], draws.croppad_percents, 0.0)
            forward = _croppad_matrix(percents, h, w) @ forward
        if self.hflip or spec["fliplr"] is not None:
            flip = draws.flip_u < (0.5 if self.hflip else spec["fliplr"]["p"])
            forward = _hflip_matrix(flip, h, w) @ forward
        else:
            flip = torch.zeros(b, dtype=torch.bool)
        inverse = torch.linalg.inv(forward).to(device, non_blocking=True)
        ys, xs = torch.meshgrid(
            torch.arange(h, dtype=torch.float32, device=device),
            torch.arange(w, dtype=torch.float32, device=device),
            indexing="ij",
        )
        grid = torch.stack([xs, ys, torch.ones_like(xs)], dim=-1)  # (H, W, 3)
        coords = torch.einsum("bij,hwj->bhwi", inverse, grid)[..., :2]
        disp = None
        if spec["elastic"] is not None:
            fire = draws.elastic_u < spec["elastic"]["p"]
            alpha = torch.where(fire, draws.elastic_alpha, 0.0).to(device, non_blocking=True)
            disp = _separable_gaussian_blur(draws.elastic_raw.to(device), sigma=spec["elastic"]["sigma"])
            disp = disp * alpha[:, None, None, None]
            coords = coords + disp
        return forward.to(device, non_blocking=True), coords, disp, flip

    @staticmethod
    def _on_fired(images: torch.Tensor, fired: torch.Tensor, fn) -> torch.Tensor:
        """``fn`` applied to the images whose indices are in ``fired`` (a
        CPU tensor); the others pass unchanged. ``fn`` is per-image."""
        if fired.numel() == 0:
            return images
        idx = fired.to(images.device, non_blocking=True)
        return images.index_copy(0, idx, fn(images.index_select(0, idx)))
