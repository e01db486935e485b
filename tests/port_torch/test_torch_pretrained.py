"""Pretrained backbone files (``models/backbones/pretrained.py``) against the
JAX package's ``torch_port``: each published layout, written with
``torch.save`` from seeded random weights, goes through the JAX package's
``port_backbone_checkpoint`` into its flax backbone and through the port's
``load_backbone_checkpoint`` into the port's backbone, and the two forwards
agree. The files are torchvision ResNet-18/50, MMPose ResNet-50 (a
``state_dict`` container with ``backbone.`` keys), torchvision
EfficientNet-B0/B1/B2 and HF ViT-S (a narrow one) whose 14 x 14 position
grid is resized to 16 x 16."""

from __future__ import annotations

import argparse

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu_torch.models.backbones.pretrained import load_backbone_checkpoint, load_torch_checkpoint
from lightning_pose_tpu_torch.utils.synthetic import (
    hf_vit_state_dict,
    torchvision_efficientnet_state_dict,
    torchvision_resnet_state_dict,
)


IMAGE = 64
# fp32 on both sides, only the order of the sums differs: within this share
# of the largest output
OUT_TOL = 1e-4
# a narrow ViT-S for the CPU: (embed_dim, depth, num_heads, patch)
SMALL_VIT = (64, 2, 2, 16)


def _jax_backbone(arch: str, image: int):
    from lightning_pose_tpu.models.backbones.factory import build_backbone

    return build_backbone(arch, image_size=image, dtype=jnp.float32)[0]


def _jax_forward(arch: str, path: str, x: np.ndarray) -> np.ndarray:
    """The JAX package's backbone with the file ported in, eval mode."""
    import flax.serialization

    from lightning_pose_tpu.models.backbones.torch_port import port_backbone_checkpoint

    module = _jax_backbone(arch, x.shape[1])
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False))
    ported = port_backbone_checkpoint(arch, path, image_size=x.shape[1])
    variables = {"params": flax.serialization.from_state_dict(shapes["params"], ported["params"])}
    if "batch_stats" in shapes:
        variables["batch_stats"] = flax.serialization.from_state_dict(shapes["batch_stats"], ported["batch_stats"])
    return np.asarray(jax.jit(lambda v, x: module.apply(v, x, train=False))(variables, jnp.asarray(x)))


def _port_backbone(arch: str, image: int) -> torch.nn.Module:
    from lightning_pose_tpu_torch.models.backbones.factory import build_backbone, make_transformer_module

    if arch.startswith("vit"):
        return make_transformer_module(arch, image)[0]
    return build_backbone(arch)[0]


def _write(tmp_path, name: str, state_dict: dict, container: bool = False) -> str:
    path = tmp_path / name
    torch.save({"state_dict": {f"backbone.{k}": v for k, v in state_dict.items()}} if container else state_dict, path)
    return str(path)


def _check(arch: str, path: str, x: np.ndarray, skipped_expected: set[str]) -> torch.nn.Module:
    ref = _jax_forward(arch, path, x)
    backbone = _port_backbone(arch, x.shape[1]).eval()
    skipped = load_backbone_checkpoint(backbone, arch, path, image_size=x.shape[1])
    assert set(skipped) == skipped_expected
    with torch.no_grad():
        out = backbone(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=0, atol=OUT_TOL * np.abs(ref).max())
    return backbone


def _batch_counters(state_dict: dict) -> set[str]:
    return {k for k in state_dict if k.endswith("num_batches_tracked")}


@pytest.mark.parametrize("arch, container", [("resnet18", False), ("resnet50", False), ("resnet50_animal_ap10k", True)])
def test_resnet_files_load_as_in_the_jax_package(arch, container, tmp_path):
    """torchvision ResNet-18/50, and an MMPose ResNet-50 (``{"state_dict":
    {"backbone.*"}}``) into a ``resnet50_*`` pose backbone; the classifier
    and the batch counters are skipped."""
    sd = torchvision_resnet_state_dict("resnet18" if arch == "resnet18" else "resnet50", seed=1)
    path = _write(tmp_path, "resnet.pth", sd, container)
    x = np.random.default_rng(2).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    backbone = _check(arch, path, x, {"fc.weight", "fc.bias"} | _batch_counters(sd))
    # the port keeps torchvision's names: the load is the file, tensor by tensor
    own = backbone.state_dict()
    for key, value in sd.items():
        if key in own and not key.endswith("num_batches_tracked"):
            assert torch.equal(own[key], value), key


@pytest.mark.parametrize("variant", ["b0", "b1", "b2"])
def test_efficientnet_files_load_as_in_the_jax_package(variant, tmp_path):
    sd = torchvision_efficientnet_state_dict(variant, seed=3)
    path = _write(tmp_path, "efficientnet.pth", sd)
    x = np.random.default_rng(4).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    _check(f"efficientnet_{variant}", path, x, {"classifier.1.weight", "classifier.1.bias"} | _batch_counters(sd))


@pytest.mark.parametrize("prefix", ["", "vit."])
def test_vit_file_resizes_its_position_grid_as_the_jax_package(prefix, tmp_path, monkeypatch):
    """HF ``ViTModel`` keys (plain, or under ``vit.``) of a 14 x 14 grid into
    a 256 px model (16 x 16): the port's resize is the JAX package's
    (fp32 bicubic, align_corners=False)."""
    from lightning_pose_tpu.models.backbones import vit as jax_vit
    from lightning_pose_tpu_torch.models.backbones import vit

    monkeypatch.setitem(jax_vit.VIT_CONFIGS, "vits", SMALL_VIT)
    monkeypatch.setitem(vit.VIT_CONFIGS, "vits", SMALL_VIT)
    d, depth = SMALL_VIT[:2]
    sd = hf_vit_state_dict(d, depth, grid=14, seed=5, prefix=prefix)
    path = _write(tmp_path, "vit.pth", sd)
    x = np.random.default_rng(6).standard_normal((1, 256, 256, 3)).astype(np.float32)
    backbone = _check("vits_dino", path, x, {f"{prefix}pooler.dense.weight", f"{prefix}pooler.dense.bias"})
    assert tuple(backbone.pos_embed.shape) == (1, 16 * 16 + 1, d)
    assert sd[f"{prefix}embeddings.position_embeddings"].shape == (1, 14 * 14 + 1, d)
    # the CLS entry is carried, the grid interpolated
    torch.testing.assert_close(backbone.pos_embed[:, 0], sd[f"{prefix}embeddings.position_embeddings"][:, 0],
                               rtol=0, atol=0)


def test_a_file_of_pickled_objects_raises_a_clear_error(tmp_path):
    path = tmp_path / "pickled.pth"
    torch.save({"state_dict": {"conv1.weight": torch.zeros(1)}, "meta": argparse.Namespace(epoch=3)}, path)
    with pytest.raises(ValueError, match="weights_only"):
        load_torch_checkpoint(str(path))


def test_a_missing_layer_or_an_unported_family_raises(tmp_path):
    sd = torchvision_resnet_state_dict("resnet18", seed=7)
    del sd["layer4.1.conv2.weight"]
    path = _write(tmp_path, "partial.pth", sd)
    with pytest.raises(ValueError, match="lacks"):
        load_backbone_checkpoint(_port_backbone("resnet18", IMAGE), "resnet18", path)
    with pytest.raises(ValueError, match="does not have"):
        load_backbone_checkpoint(_port_backbone("resnet18", IMAGE), "resnet18",
                                 _write(tmp_path, "r50.pth", torchvision_resnet_state_dict("resnet50", seed=7)))
    # a transformer file that lacks a tensor raises naming it
    from lightning_pose_tpu_torch.utils.synthetic import hf_dinov2_state_dict

    sd = hf_dinov2_state_dict(64, 12, seed=7)
    del sd["encoder.layer.1.mlp.fc2.weight"]
    with pytest.raises(ValueError, match="encoder.layer.1.mlp.fc2.weight"):
        load_backbone_checkpoint(torch.nn.Linear(1, 1), "vits_dinov2", _write(tmp_path, "dinov2.pth", sd))
