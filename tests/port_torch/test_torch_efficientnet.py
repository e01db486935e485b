"""The port's EfficientNet b0-b2 (``models/backbones/efficientnet.py``) and a
heatmap model with it, against the JAX package's flax modules, with the same
weights through the checkpoint bridge; the pooled variant of a regression
backbone; flax's init."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models.backbones.efficientnet import EfficientNet as JaxEfficientNet
from lightning_pose_tpu_torch.models.backbones.efficientnet import EFFICIENTNET_CONFIGS, EfficientNet
from lightning_pose_tpu_torch.models.backbones.factory import build_backbone
from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

pytestmark = pytest.mark.usefixtures("few_torch_threads")

IMAGE = 64
# fp32 on both sides, only the order of the sums differs: within this share
# of the largest output
FEATURE_TOL = 1e-4


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


@pytest.mark.parametrize("variant, global_pool", [("b0", False), ("b1", False), ("b2", False), ("b0", True)])
def test_efficientnet_matches_flax_through_bridge(variant, global_pool, seeded_jax_variables):
    jax_model = JaxEfficientNet(variant=variant, dtype=jnp.float32, global_pool=global_pool)
    x = np.random.default_rng(0).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    variables = seeded_jax_variables(jax_model, jnp.asarray(x), seed=1, train=False)
    ref = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))

    model = EfficientNet(variant, global_pool=global_pool).eval()
    load_flax_variables(model, variables["params"], variables["batch_stats"])  # strict: names and shapes match
    with torch.no_grad():
        out = model(_nchw(x)).numpy()
    if not global_pool:
        out = out.transpose(0, 2, 3, 1)
    head = EFFICIENTNET_CONFIGS[variant][2]
    assert out.shape == ref.shape == ((2, head) if global_pool else (2, IMAGE // 32, IMAGE // 32, head))
    np.testing.assert_allclose(out, ref, rtol=0, atol=FEATURE_TOL * np.abs(ref).max())


def test_efficientnet_train_mode_batch_statistics_match_flax(seeded_jax_variables):
    """One train-mode forward: the outputs and the updated running
    statistics (flax's momentum 0.9 is torch's 0.1, its biased variance)."""
    jax_model = JaxEfficientNet(variant="b0", dtype=jnp.float32)
    x = np.random.default_rng(3).standard_normal((4, IMAGE, IMAGE, 3)).astype(np.float32)
    variables = seeded_jax_variables(jax_model, jnp.asarray(x), seed=4, train=False)
    ref, mutated = jax.jit(lambda v, x: jax_model.apply(v, x, train=True, mutable=["batch_stats"]))(
        variables, jnp.asarray(x)
    )
    model = EfficientNet("b0").train()
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        out = model(_nchw(x)).permute(0, 2, 3, 1).numpy()
    ref = np.asarray(ref)
    np.testing.assert_allclose(out, ref, rtol=0, atol=FEATURE_TOL * np.abs(ref).max())
    ref_stats = jax.tree_util.tree_leaves(mutated["batch_stats"])
    got = jax.tree_util.tree_leaves(state_dict_to_flax(model.state_dict())[1])
    assert len(ref_stats) == len(got) == 2 * 49
    for a, b in zip(ref_stats, got):
        np.testing.assert_allclose(b, np.asarray(a), rtol=1e-4, atol=1e-5)


def test_efficientnet_heatmap_model_and_decode_match_flax(seeded_jax_variables):
    from lightning_pose_tpu.models.heatmap_tracker import HeatmapTracker as JaxTracker
    from lightning_pose_tpu_torch.models.factory import build_model

    jax_model = JaxTracker(backbone_arch="efficientnet_b0", num_keypoints=3, image_size=IMAGE, dtype=jnp.float32)
    x = np.random.default_rng(6).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    variables = seeded_jax_variables(jax_model, jnp.asarray(x), seed=5, train=False)
    for layer in variables["params"]["head"].values():  # peaked maps: the decode then depends on the features
        layer["kernel"] = layer["kernel"] * 30.0
    ref = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))
    kp_ref, conf_ref = jax_model.apply(variables, jnp.asarray(ref), method=lambda m, h: m.decode(h))

    model = build_model("heatmap", "efficientnet_b0", 3).eval()
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        heatmaps = model(_nchw(x))
        kp, conf = model.decode(heatmaps)
    np.testing.assert_allclose(heatmaps.permute(0, 2, 3, 1).numpy(), ref, rtol=0, atol=1e-5)
    assert float(conf.mean()) > 0.1
    np.testing.assert_allclose(kp.numpy(), np.asarray(kp_ref), rtol=0, atol=1e-2)
    np.testing.assert_allclose(conf.numpy(), np.asarray(conf_ref), rtol=0, atol=1e-3)


def test_efficientnet_init_matches_flax_per_layer_std():
    """lecun_normal convolutions (the depthwise fan-in is k*k), zero biases,
    BatchNorm at identity: each layer's std within 10% of flax's."""
    jax_model = JaxEfficientNet(variant="b0", dtype=jnp.float32)
    variables = jax.jit(lambda k: jax_model.init(k, jnp.zeros((1, IMAGE, IMAGE, 3)), train=False))(
        jax.random.PRNGKey(0)
    )
    ref = jax.tree_util.tree_leaves_with_path(jax.tree_util.tree_map(np.asarray, variables["params"]))
    from lightning_pose_tpu_torch.models.factory import init_like_flax

    torch.manual_seed(0)
    backbone, features = build_backbone("efficientnet_b0")
    init_like_flax(backbone)
    assert features == 1280
    out = dict(jax.tree_util.tree_leaves_with_path(state_dict_to_flax(backbone.state_dict())[0]))
    assert {jax.tree_util.keystr(p) for p, _ in ref} == {jax.tree_util.keystr(p) for p in out}
    for path, value in ref:
        mine = out[path]
        assert mine.shape == value.shape, jax.tree_util.keystr(path)
        if value.size > 64 and value.std() > 0:
            np.testing.assert_allclose(mine.std(), value.std(), rtol=0.1, err_msg=jax.tree_util.keystr(path))
        elif value.std() == 0:
            np.testing.assert_array_equal(mine, value)
