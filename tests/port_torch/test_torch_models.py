"""The port's ResNet backbones, heatmap head and HeatmapTracker against the
JAX package's flax modules, with the same weights through the bridge."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from lightning_pose_tpu.models.backbones.resnet import ResNet as JaxResNet
from lightning_pose_tpu.models.heads.heatmap import (
    HeatmapHead as JaxHead,
    pixel_shuffle as jax_pixel_shuffle,
)
from lightning_pose_tpu.models.heatmap_tracker import HeatmapTracker as JaxTracker
from lightning_pose_tpu_torch.models.backbones.factory import build_backbone
from lightning_pose_tpu_torch.models.backbones.resnet import ResNet, max_pool_3x3_s2
from lightning_pose_tpu_torch.models.factory import build_model
from lightning_pose_tpu_torch.models.heads.heatmap import (
    HeatmapHead,
    SameConvTranspose2d,
    pixel_shuffle,
)
from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables

IMAGE = 64
# fp32 eval on both sides; only the order of the sums differs
FEATURE_TOL = 1e-4


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _nhwc(x: torch.Tensor) -> np.ndarray:
    return x.detach().permute(0, 2, 3, 1).numpy()


def _perturbed_stats(batch_stats, seed: int):
    """Running statistics away from identity, so BN is exercised."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: (np.asarray(x) + rng.uniform(0.0, 0.5, np.shape(x))).astype(np.float32),
        batch_stats,
    )


@pytest.mark.parametrize("arch", ["resnet18", "resnet50"])
def test_resnet_matches_flax_through_bridge(arch):
    jax_model = JaxResNet(arch=arch, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    variables = jax_model.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = _perturbed_stats(variables["batch_stats"], seed=2)
    ref = np.asarray(jax_model.apply({"params": params, "batch_stats": stats}, jnp.asarray(x)))

    model = ResNet(arch=arch).eval()
    load_flax_variables(model, params, stats)
    with torch.no_grad():
        out = _nhwc(model(_nchw(x)))
    assert out.shape == ref.shape == (2, IMAGE // 32, IMAGE // 32, model.num_features)
    np.testing.assert_allclose(out, ref, rtol=0, atol=FEATURE_TOL * max(1.0, np.abs(ref).max()))


def test_max_pool_pads_with_minus_inf():
    from lightning_pose_tpu.models.backbones.resnet import max_pool_3x3_s2 as jax_pool

    x = -np.abs(np.random.default_rng(3).standard_normal((1, 7, 9, 2))).astype(np.float32) - 1.0
    ref = np.asarray(jax_pool(jnp.asarray(x)))
    np.testing.assert_array_equal(_nhwc(max_pool_3x3_s2(_nchw(x))), ref)


def test_pixel_shuffle_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 8)).astype(np.float32)
    np.testing.assert_array_equal(
        _nhwc(pixel_shuffle(_nchw(x), 2)), np.asarray(jax_pixel_shuffle(jnp.asarray(x), 2))
    )


@pytest.mark.parametrize("hw", [(4, 4), (3, 5)])
def test_same_conv_transpose_matches_flax(hw):
    """torch transposed conv, no padding, cropped to 2n x 2m, with the flax
    kernel flipped: flax's ConvTranspose(3x3, stride 2, "SAME")."""
    from lightning_pose_tpu_torch.train.checkpoints import state_dict_from_flax

    layer = nn.ConvTranspose(features=5, kernel_size=(3, 3), strides=(2, 2), padding="SAME")
    x = np.random.default_rng(5).standard_normal((2, *hw, 4)).astype(np.float32)
    variables = layer.init(jax.random.PRNGKey(0), jnp.asarray(x))
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    params["bias"] = np.linspace(-1, 1, 5).astype(np.float32)
    ref = np.asarray(layer.apply({"params": params}, jnp.asarray(x)))
    conv = SameConvTranspose2d(4, 5)
    conv.load_state_dict(
        {k.split(".", 1)[1]: v for k, v in state_dict_from_flax({"deconv0": params}, {}).items()}
    )
    with torch.no_grad():
        out = _nhwc(conv(_nchw(x)))
    assert out.shape == ref.shape == (2, 2 * hw[0], 2 * hw[1], 5)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)


def test_heatmap_head_matches_flax():
    jax_head = JaxHead(backbone_arch="resnet18", out_channels=3, downsample_factor=2)
    feats = np.random.default_rng(6).standard_normal((2, 2, 2, 512)).astype(np.float32)
    variables = jax_head.init(jax.random.PRNGKey(0), jnp.asarray(feats))
    params = jax.tree_util.tree_map(lambda a: np.asarray(a) * 300.0, variables["params"])
    ref = np.asarray(jax_head.apply({"params": params}, jnp.asarray(feats)))

    head = HeatmapHead("resnet18", in_channels=512, out_channels=3, downsample_factor=2)
    load_flax_variables(head, params, {})
    with torch.no_grad():
        out = _nhwc(head(_nchw(feats)))
    assert out.shape == ref.shape == (2, 16, 16, 3)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-6)
    np.testing.assert_allclose(out.sum(axis=(1, 2)), 1.0, rtol=1e-5)


@pytest.mark.parametrize("df", [2, 3])
def test_heatmap_tracker_and_decode_match_flax(df, peaked_jax_variables):
    jax_model = JaxTracker(
        backbone_arch="resnet18", num_keypoints=3, downsample_factor=df,
        image_size=IMAGE, dtype=jnp.float32,
    )
    params, stats = peaked_jax_variables(jax_model, IMAGE, seed=df)
    x = np.random.default_rng(8).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    ref = np.asarray(jax_model.apply(variables, jnp.asarray(x)))
    kp_ref, conf_ref = jax_model.apply(
        variables, jnp.asarray(ref), method=lambda m, h: m.decode(h)
    )

    model = build_model("heatmap", "resnet18", 3, df).eval()
    load_flax_variables(model, params, stats)
    with torch.no_grad():
        heatmaps = model(_nchw(x))
        kp, conf = model.decode(heatmaps)
    assert heatmaps.shape == (2, 3, IMAGE // 2**df, IMAGE // 2**df)
    np.testing.assert_allclose(_nhwc(heatmaps), ref, rtol=0, atol=1e-5)
    assert float(conf.mean()) > 0.1  # peaked maps, not near-uniform ones
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_ref), rtol=0, atol=1e-2)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_ref), rtol=0, atol=1e-3)


@pytest.mark.parametrize(
    "name, error",
    [
        ("resnet9000", ValueError),
    ],
)
def test_build_backbone_rejects_unported_names(name, error):
    with pytest.raises(error):
        build_backbone(name)


def test_resnet50_pose_variants_share_the_architecture():
    model, features = build_backbone("resnet50_animal_ap10k")
    assert features == 2048 and model.arch == "resnet50"


@pytest.mark.parametrize("model_type", ["regression", "heatmap_multiview", "heatmap_multiview_transformer"])
def test_build_model_rejects_unported_types(model_type):
    # the multiview transformer takes the ViT, DINOv2 and DINOv3 names, not
    # SAM's; a ViT backbone in the regression model is a limit of the JAX
    # package too (no ROADMAP item)
    backbone = "vits_dino" if model_type == "regression" else "vitb_sam"
    error = NotImplementedError if model_type == "regression" else ValueError
    with pytest.raises(error, match="ViT backbones" if model_type == "regression" else "not supported for multiview"):
        build_model(model_type, backbone, 3, num_views=2)
