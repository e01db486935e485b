"""Pretrained backbone weights from local torch checkpoint files
(counterpart of ``lightning_pose_tpu/models/backbones/torch_port.py``).

The reference downloads ImageNet weights from torchvision, pose weights from
MMPose and ViT weights from Hugging Face. Here a local file takes their
place (``model.backbone_checkpoint``): a torch state dict in one of those
published layouts, raw or in a ``{"state_dict": ...}`` container, MMPose's
``backbone.`` prefix stripped. It is read with ``weights_only=True``.

Each family's keys are first mapped to the JAX package's flax tree, as its
``torch_port`` does (the same functions, kept here so that the port needs
nothing of the JAX package), and the tree then goes through the checkpoint
bridge (``train/checkpoints.state_dict_from_flax``) to the port's names:

- ResNet: torchvision's names (``conv1``, ``layer1.0.downsample.0``, ...);
- EfficientNet b0-b2: torchvision's ``features.0`` stem, ``features.1-7``
  MBConv stages (``block.{i}``: [expand,] depthwise, squeeze-excite
  ``fc1``/``fc2``, project) and ``features.8`` head conv;
- the plain ViTs (``vits_dino``, ``vitb_dino``, ``vitb_imagenet``): HF
  ``ViTModel`` names, optionally under ``vit.`` or ``vit_mae.vit.``; the
  position embeddings are resized to the fine-tune grid (``image_size /
  16``) by fp32 bicubic with ``align_corners=False`` (torch's a = -0.75), as
  HF's ``interpolate_pos_encoding`` does.

Keys of the file that no layer takes (a classifier, a pooler, BatchNorm's
``num_batches_tracked``) are logged and skipped, as the reference's
``strict=False`` load does; a layer of the backbone that the file lacks
raises, as the JAX package's ``from_state_dict`` does.
"""

from __future__ import annotations

import logging
import os
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

logger = logging.getLogger(__name__)

__all__ = [
    "load_backbone_checkpoint",
    "load_torch_checkpoint",
    "port_backbone_checkpoint",
    "port_efficientnet_state_dict",
    "port_resnet_state_dict",
    "port_vit_state_dict",
]

_TRANSFORMERS_NOT_PORTED = ("_dinov2", "_dinov3", "_sam", "_sam2")


def _to_numpy(t: Any) -> np.ndarray:
    if isinstance(t, torch.Tensor):
        return t.detach().cpu().numpy()
    return np.asarray(t)


def _conv_kernel(t: Any) -> np.ndarray:
    """OIHW -> HWIO."""
    return _to_numpy(t).transpose(2, 3, 1, 0)


def load_torch_checkpoint(path: str) -> dict[str, Any]:
    """A torch checkpoint file's state dict: the file itself or its
    ``state_dict`` entry, with MMPose's ``backbone.`` prefix stripped."""
    try:
        ckpt = torch.load(path, map_location="cpu", weights_only=True)
    except Exception as e:  # pickle.UnpicklingError and kin
        raise ValueError(
            f"{path} cannot be read with torch.load(weights_only=True): it holds pickled objects, not only "
            f"tensors. Save its state dict alone (torch.save(model.state_dict(), path)). ({e})"
        ) from e
    state_dict = ckpt.get("state_dict", ckpt) if isinstance(ckpt, dict) else ckpt
    return {key.removeprefix("backbone."): value for key, value in state_dict.items()}


def _bn_pair(state_dict: Mapping[str, Any], prefix: str) -> tuple[dict, dict]:
    return (
        {"scale": _to_numpy(state_dict[f"{prefix}.weight"]), "bias": _to_numpy(state_dict[f"{prefix}.bias"])},
        {"mean": _to_numpy(state_dict[f"{prefix}.running_mean"]), "var": _to_numpy(state_dict[f"{prefix}.running_var"])},
    )


def port_resnet_state_dict(
    state_dict: Mapping[str, Any], stage_sizes: tuple[int, ...], bottleneck: bool
) -> tuple[dict, dict]:
    """A torchvision-layout ResNet state dict -> ``(params, batch_stats)``
    flax trees of the JAX package's ``ResNet``. A missing layer is logged
    and left out of the trees."""
    params: dict[str, Any] = {}
    batch_stats: dict[str, Any] = {}
    if "conv1.weight" in state_dict:
        params["conv1"] = {"kernel": _conv_kernel(state_dict["conv1.weight"])}
    else:
        logger.warning("missing conv weight: conv1.weight")
    try:
        params["bn1"], batch_stats["bn1"] = _bn_pair(state_dict, "bn1")
    except KeyError as e:
        logger.warning(f"missing bn params for bn1: {e}")
    convs_per_block = 3 if bottleneck else 2
    for stage, num_blocks in enumerate(stage_sizes):
        for block in range(num_blocks):
            prefix = f"layer{stage + 1}.{block}"
            flax_block: dict[str, Any] = {}
            flax_stats: dict[str, Any] = {}
            for c in range(1, convs_per_block + 1):
                if f"{prefix}.conv{c}.weight" in state_dict:
                    flax_block[f"conv{c}"] = {"kernel": _conv_kernel(state_dict[f"{prefix}.conv{c}.weight"])}
                if f"{prefix}.bn{c}.weight" in state_dict:
                    flax_block[f"bn{c}"], flax_stats[f"bn{c}"] = _bn_pair(state_dict, f"{prefix}.bn{c}")
            ds = f"{prefix}.downsample"
            if f"{ds}.0.weight" in state_dict:
                flax_block["downsample_conv"] = {"kernel": _conv_kernel(state_dict[f"{ds}.0.weight"])}
                flax_block["downsample_bn"], flax_stats["downsample_bn"] = _bn_pair(state_dict, f"{ds}.1")
            params[f"layer{stage + 1}_{block}"] = flax_block
            batch_stats[f"layer{stage + 1}_{block}"] = flax_stats
    return params, batch_stats


def port_efficientnet_state_dict(state_dict: Mapping[str, Any], variant: str) -> tuple[dict, dict]:
    """A torchvision ``efficientnet_b0/b1/b2`` state dict -> ``(params,
    batch_stats)`` flax trees of the JAX package's ``EfficientNet``."""
    from lightning_pose_tpu_torch.models.backbones.efficientnet import stage_layout

    def conv(key: str, bias_key: str | None = None) -> dict:
        out = {"kernel": _conv_kernel(state_dict[key])}
        if bias_key and bias_key in state_dict:
            out["bias"] = _to_numpy(state_dict[bias_key])
        return out

    params: dict[str, Any] = {"stem_conv": conv("features.0.0.weight")}
    batch_stats: dict[str, Any] = {}
    params["stem_bn"], batch_stats["stem_bn"] = _bn_pair(state_dict, "features.0.1")
    for stage, i, expand, _, _ in stage_layout(variant):
        tvp = f"features.{stage}.{i}.block"
        blk: dict[str, Any] = {}
        stats: dict[str, Any] = {}
        idx = 0
        if expand != 1:
            blk["expand_conv"] = conv(f"{tvp}.{idx}.0.weight")
            blk["expand_bn"], stats["expand_bn"] = _bn_pair(state_dict, f"{tvp}.{idx}.1")
            idx += 1
        blk["dw_conv"] = conv(f"{tvp}.{idx}.0.weight")
        blk["dw_bn"], stats["dw_bn"] = _bn_pair(state_dict, f"{tvp}.{idx}.1")
        idx += 1
        blk["se"] = {
            "reduce": conv(f"{tvp}.{idx}.fc1.weight", f"{tvp}.{idx}.fc1.bias"),
            "expand": conv(f"{tvp}.{idx}.fc2.weight", f"{tvp}.{idx}.fc2.bias"),
        }
        idx += 1
        blk["project_conv"] = conv(f"{tvp}.{idx}.0.weight")
        blk["project_bn"], stats["project_bn"] = _bn_pair(state_dict, f"{tvp}.{idx}.1")
        params[f"stage{stage}_{i}"] = blk
        batch_stats[f"stage{stage}_{i}"] = stats
    params["head_conv"] = conv("features.8.0.weight")
    params["head_bn"], batch_stats["head_bn"] = _bn_pair(state_dict, "features.8.1")
    return params, batch_stats


def port_vit_state_dict(state_dict: Mapping[str, Any], depth: int, num_heads: int) -> dict:
    """An HF ``ViTModel`` state dict (facebook/dino-*, vit-mae-*) -> the flax
    tree of the JAX package's ``ViT``: the attention's projections in
    ``DenseGeneral``'s 3-d layouts, ``Dense`` kernels ``(in, out)``."""

    def arr(key: str) -> np.ndarray:
        return _to_numpy(state_dict[key])

    def ln(prefix: str) -> dict:
        return {"scale": arr(f"{prefix}.weight"), "bias": arr(f"{prefix}.bias")}

    def dense(prefix: str) -> dict:
        return {"kernel": arr(f"{prefix}.weight").T, "bias": arr(f"{prefix}.bias")}

    cls_token = arr("embeddings.cls_token")
    embed_dim = cls_token.shape[-1]
    head_dim = embed_dim // num_heads

    def qkv(prefix: str) -> dict:
        return {
            "kernel": arr(f"{prefix}.weight").T.reshape(embed_dim, num_heads, head_dim),
            "bias": arr(f"{prefix}.bias").reshape(num_heads, head_dim),
        }

    params: dict[str, Any] = {
        "cls_token": cls_token,
        "pos_embed": arr("embeddings.position_embeddings"),
        "patch_embed": {
            "kernel": _conv_kernel(state_dict["embeddings.patch_embeddings.projection.weight"]),
            "bias": arr("embeddings.patch_embeddings.projection.bias"),
        },
    }
    for i in range(depth):
        hf = f"encoder.layer.{i}"
        params[f"block{i}"] = {
            "ln1": ln(f"{hf}.layernorm_before"),
            "attn": {
                "query": qkv(f"{hf}.attention.attention.query"),
                "key": qkv(f"{hf}.attention.attention.key"),
                "value": qkv(f"{hf}.attention.attention.value"),
                "out": {
                    "kernel": arr(f"{hf}.attention.output.dense.weight").T.reshape(num_heads, head_dim, embed_dim),
                    "bias": arr(f"{hf}.attention.output.dense.bias"),
                },
            },
            "ln2": ln(f"{hf}.layernorm_after"),
            "mlp": {"fc1": dense(f"{hf}.intermediate.dense"), "fc2": dense(f"{hf}.output.dense")},
        }
    params["ln"] = ln("layernorm")
    return params


def _resize_token_pos_embed(pos: Any, target_grid: int, num_prefix: int = 1) -> np.ndarray:
    """A ``(1, prefix + g*g, D)`` position-embedding table resized to
    ``target_grid``: fp32 bicubic, ``align_corners=False``."""
    p = pos if isinstance(pos, torch.Tensor) else torch.as_tensor(np.asarray(pos))
    src = int(round(float(p.shape[1] - num_prefix) ** 0.5))
    if src == target_grid:
        return _to_numpy(p)
    prefix, grid_pos = p[:, :num_prefix], p[:, num_prefix:]
    d = p.shape[-1]
    grid_pos = grid_pos.reshape(1, src, src, d).permute(0, 3, 1, 2)
    grid_pos = F.interpolate(grid_pos.float(), size=(target_grid, target_grid), mode="bicubic", align_corners=False)
    grid_pos = grid_pos.permute(0, 2, 3, 1).reshape(1, target_grid * target_grid, d)
    return _to_numpy(torch.cat([prefix.float(), grid_pos], dim=1))


class _ReadKeys(dict):
    """A state dict that records the keys read from it."""

    def __init__(self, state_dict: Mapping[str, Any]) -> None:
        super().__init__(state_dict)
        self.read: set[str] = set()

    def __getitem__(self, key: str) -> Any:
        self.read.add(key)
        return super().__getitem__(key)


def _strip_to_submodel(state_dict: Mapping[str, Any], prefixes: list[str]) -> tuple[dict, str]:
    """The keys under the first of ``prefixes`` that any key starts with,
    the prefix stripped, and that prefix; else the whole dict and ``""``."""
    for prefix in prefixes:
        sub = {k[len(prefix):]: v for k, v in state_dict.items() if k.startswith(prefix)}
        if sub:
            return sub, prefix
    return dict(state_dict), ""


def _port(backbone_arch: str, state_dict: Mapping[str, Any], image_size: int) -> tuple[dict, set[str]]:
    """The flax trees of a backbone's state dict and the keys of
    ``state_dict`` they were made from."""
    from lightning_pose_tpu_torch.models.backbones import vit
    from lightning_pose_tpu_torch.models.backbones.resnet import RESNET_CONFIGS

    if backbone_arch.endswith(_TRANSFORMERS_NOT_PORTED):
        raise NotImplementedError(
            f"{backbone_arch} is not ported yet (ROADMAP queue 1, item 7: remaining model families)"
        )
    if backbone_arch.startswith(("resnet", "efficientnet")):
        sd = _ReadKeys(state_dict)
        if backbone_arch.startswith("resnet"):
            arch = "resnet50" if backbone_arch.startswith("resnet50_") else backbone_arch
            stage_sizes, bottleneck, _ = RESNET_CONFIGS[arch]
            params, batch_stats = port_resnet_state_dict(sd, tuple(stage_sizes), bottleneck)
        else:
            params, batch_stats = port_efficientnet_state_dict(sd, backbone_arch.split("_")[-1])
        return {"params": params, "batch_stats": batch_stats}, sd.read
    _, depth, num_heads, _ = vit.VIT_CONFIGS[backbone_arch.split("_")[0]]
    # lightning's MAE checkpoints prefix with 'vit_mae.vit.', HF's with 'vit.'
    sub, prefix = _strip_to_submodel(state_dict, ["vit_mae.vit.", "vit."])
    sd = _ReadKeys(sub)
    params = port_vit_state_dict(sd, depth, num_heads)
    params["pos_embed"] = _resize_token_pos_embed(params["pos_embed"], image_size // 16)
    return {"params": params}, {prefix + k for k in sd.read}


def port_backbone_checkpoint(backbone_arch: str, checkpoint_path: str, image_size: int = 256) -> dict:
    """A local torch checkpoint of ``backbone_arch`` -> ``{"params": tree}``
    (and ``"batch_stats"`` for convnets), flax trees of the backbone alone.
    A ViT's position embeddings are resized to ``image_size // 16``."""
    return _port(backbone_arch, load_torch_checkpoint(checkpoint_path), image_size)[0]


def load_backbone_checkpoint(backbone: nn.Module, backbone_arch: str, path: str, image_size: int = 256) -> list[str]:
    """Load a local torch checkpoint of ``backbone_arch`` into ``backbone``
    (on any device) and return the keys of the file that no layer takes.
    Raises if the file lacks a layer of the backbone or a shape differs."""
    from lightning_pose_tpu_torch.train.checkpoints import state_dict_from_flax

    if not os.path.isfile(path):
        raise FileNotFoundError(path)
    state_dict = load_torch_checkpoint(path)
    pretrained, read = _port(backbone_arch, state_dict, image_size)
    state = state_dict_from_flax(pretrained["params"], pretrained.get("batch_stats") or {})
    own = backbone.state_dict()
    missing = sorted(k for k in own if k not in state)
    if missing:
        raise ValueError(f"{path} lacks {len(missing)} tensors of the {backbone_arch} backbone: {missing[:5]}")
    unexpected = sorted(k for k in state if k not in own)
    if unexpected:
        raise ValueError(f"{path} maps to tensors the {backbone_arch} backbone does not have: {unexpected[:5]}")
    for key, value in state.items():
        if tuple(value.shape) != tuple(own[key].shape):
            raise ValueError(f"{path}: {key} is {tuple(value.shape)}, the backbone's {tuple(own[key].shape)}")
    backbone.load_state_dict(state, strict=True)
    skipped = sorted(k for k in state_dict if k not in read)
    if skipped:
        logger.info(f"skipped {len(skipped)} keys of {path} that no backbone layer takes: {skipped[:8]}")
    return skipped
