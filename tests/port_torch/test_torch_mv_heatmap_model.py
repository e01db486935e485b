"""Slice 11, the heatmap models on multiview data against the JAX package's
flax modules: ``HeatmapTracker`` on ``(B, V, H, W, 3)`` views and
``HeatmapTrackerMHCRNN`` on ``(B, V, 5, H, W, 3)`` stacks, the views folded
into the batch and the maps unfolded into view-major channels (eval and
train mode, fp32, the same weights through the bridge), their decoded
keypoints, the unfold itself element by element, and the predict step's
multiview context windows against the JAX package's."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models import heatmap_tracker_mhcrnn as jtracker
from lightning_pose_tpu.models.heatmap_tracker import HeatmapTracker as JaxTracker
from lightning_pose_tpu_torch.models import heatmap_tracker_mhcrnn as ptracker
from lightning_pose_tpu_torch.models.factory import build_model
from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

IMAGE = 64
KEYPOINTS = 3
VIEWS = 2
BATCH = 2
# fp32 on both sides, the same terms summed in another order: maps within
# 1e-4 of each value and of the largest, BatchNorm statistics within 1e-5
MODULE_TOL = 1e-4
STATS_TOL = 1e-5
# both packages' decode of the same view-major maps (the JAX package's
# XLA decode on the CPU; fp32 sums in another order)
DECODE_PX_TOL = 1e-3
DECODE_CONF_TOL = 1e-4


def _np(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _assert_maps(out: torch.Tensor, ref) -> None:
    ref = np.asarray(ref)
    out = np.moveaxis(_np(out), 1, -1)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out, ref, rtol=MODULE_TOL, atol=MODULE_TOL * ref.max())


@pytest.fixture(scope="module")
def jax_models():
    """The JAX trackers (resnet18, 64 px, 3 keypoints a view): the heatmap
    tracker and the context tracker (adjacent and repeat_center), each with
    its head peaked (deconv kernels x 300) and BatchNorm statistics off
    identity."""
    rng = np.random.default_rng(3)

    def variables(module, dummy, head_layers, stats_shift):
        init = jax.tree_util.tree_map(np.asarray, module.init(jax.random.PRNGKey(4), dummy, train=False))
        params = jax.tree_util.tree_map(np.copy, init["params"])
        for layer in head_layers(params["head"]):
            layer["kernel"] = layer["kernel"] * 300.0
        stats = jax.tree_util.tree_map(lambda x: (x + rng.uniform(0.0, stats_shift, x.shape)).astype(np.float32),
                                       init["batch_stats"])
        return {"params": params, "batch_stats": stats}

    heatmap = JaxTracker(backbone_arch="resnet18", num_keypoints=KEYPOINTS, image_size=IMAGE, dtype=jnp.float32)
    context = {rep: jtracker.HeatmapTrackerMHCRNN(backbone_arch="resnet18", num_keypoints=KEYPOINTS,
                                                  image_size=IMAGE, dtype=jnp.float32, context_repeat=rep)
               for rep in (False, True)}
    return {
        "heatmap": (heatmap, variables(heatmap, jnp.zeros((1, IMAGE, IMAGE, 3)),
                                       lambda h: [v for k, v in h.items() if k.startswith("deconv")], 0.05)),
        "heatmap_mhcrnn": (context, variables(context[False], jnp.zeros((1, 5, IMAGE, IMAGE, 3)),
                                              lambda h: h["head_sf"].values(), 0.5)),
    }


def _port(model_type: str, variables: dict, repeat: bool = False):
    model = build_model(model_type, "resnet18", KEYPOINTS, context_repeat=repeat, image_size=IMAGE)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    return model


def test_unfold_view_channels_matches_jax_element_by_element():
    """``(B*V, K, h, w)`` -> ``(B, V*K, h, w)``: channel ``v*K + k`` of sample
    ``b`` is map ``k`` of folded image ``b*V + v``, as the JAX package's
    ``_unfold_view_channels`` lays out its NHWC maps, bitwise."""
    b, v, k, h, w = 3, 2, 4, 5, 6
    x = np.arange(b * v * h * w * k, dtype=np.float32).reshape(b * v, h, w, k)
    ref = np.asarray(jtracker._unfold_view_channels(jnp.asarray(x), b, v))
    out = ptracker.unfold_view_channels(_nchw(x), b, v)
    assert out.shape == (b, v * k, h, w)
    np.testing.assert_array_equal(np.moveaxis(_np(out), 1, -1), ref)
    for bi, vi, ki in ((0, 0, 0), (1, 1, 2), (2, 1, 3), (2, 0, 1)):
        np.testing.assert_array_equal(_np(out[bi, vi * k + ki]), x[bi * v + vi, :, :, ki])


@pytest.mark.parametrize("train", [False, True])
def test_folded_heatmap_tracker_matches_flax(jax_models, train):
    """``(B, V, 3, H, W)`` views through one trunk and head: the ``V*K``
    view-major maps (train mode: batch statistics over the ``B*V`` view
    images, and the updated running statistics) against the JAX tracker on
    ``(B, V, H, W, 3)``, and the decode of those maps against the JAX
    tracker's."""
    module, variables = jax_models["heatmap"]
    x = np.random.default_rng(5).standard_normal((BATCH, VIEWS, IMAGE, IMAGE, 3)).astype(np.float32)
    if train:
        ref, mutated = module.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = module.apply(variables, jnp.asarray(x), train=False)
    kp_ref, conf_ref = module.apply(variables, ref, method=lambda m, hm: m.decode(hm))
    model = _port("heatmap", variables).train(train)
    with torch.no_grad():
        maps = model(_nchw(x))
        kp, conf = model.decode(_nchw(np.asarray(ref)))
    assert maps.shape == (BATCH, VIEWS * KEYPOINTS, IMAGE // 4, IMAGE // 4)
    _assert_maps(maps, ref)
    assert kp.shape == (BATCH, 2 * VIEWS * KEYPOINTS) and float(conf.mean()) > 0.1
    np.testing.assert_allclose(_np(kp), np.asarray(kp_ref), rtol=0, atol=DECODE_PX_TOL)
    np.testing.assert_allclose(_np(conf), np.asarray(conf_ref), rtol=0, atol=DECODE_CONF_TOL)
    if train:
        np.testing.assert_allclose(_flat(state_dict_to_flax(model.state_dict())[1]), _flat(mutated["batch_stats"]),
                                   rtol=0, atol=STATS_TOL)
    # each view's maps are the single-view tracker's on that view's images
    model.eval()
    with torch.no_grad():
        folded = model(_nchw(x))
        for v in range(VIEWS):
            alone = model(_nchw(x[:, v]))
            torch.testing.assert_close(folded[:, v * KEYPOINTS:(v + 1) * KEYPOINTS], alone, rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("repeat, train", [(False, False), (False, True), (True, False)])
def test_folded_context_tracker_matches_flax(jax_models, repeat, train):
    """``(B, V, 5, 3, H, W)`` stacks: both heads' view-major maps (train
    mode with the updated running statistics; repeat_center encoding each
    view's center once) against the JAX tracker on ``(B, V, 5, H, W, 3)``,
    and the decodes of those maps merged by confidence against the JAX
    tracker's."""
    modules, variables = jax_models["heatmap_mhcrnn"]
    module = modules[repeat]
    x = np.random.default_rng(6).standard_normal((BATCH, VIEWS, 5, IMAGE, IMAGE, 3)).astype(np.float32)
    if train:
        (ref_sf, ref_mf), mutated = module.apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref_sf, ref_mf = module.apply(variables, jnp.asarray(x), train=False)
    ref_kp, ref_conf = jtracker.merge_heads_by_confidence(
        *module.apply(variables, ref_sf, method=lambda m, hm: m.decode(hm)),
        *module.apply(variables, ref_mf, method=lambda m, hm: m.decode(hm)),
    )
    model = _port("heatmap_mhcrnn", variables, repeat).train(train)
    with torch.no_grad():
        maps = model(_nchw(x))
        kp, conf = model.decode_heads((_nchw(np.asarray(ref_sf)), _nchw(np.asarray(ref_mf))))
    for out, ref in zip(maps, (ref_sf, ref_mf)):
        assert out.shape == (BATCH, VIEWS * KEYPOINTS, IMAGE // 4, IMAGE // 4)
        _assert_maps(out, ref)
    np.testing.assert_allclose(_np(kp), np.asarray(ref_kp), rtol=0, atol=DECODE_PX_TOL)
    np.testing.assert_allclose(_np(conf), np.asarray(ref_conf), rtol=0, atol=DECODE_CONF_TOL)
    if train:
        np.testing.assert_allclose(_flat(state_dict_to_flax(model.state_dict())[1]), _flat(mutated["batch_stats"]),
                                   rtol=0, atol=STATS_TOL)


@pytest.mark.parametrize("repeat", [False, True])
def test_predict_step_windows_multiview_sequences_as_jax(jax_models, repeat):
    """A ``(T, V, h, w, 3)`` sequence into the context model's predict step:
    the ``T - 4`` windows of each view, ``(T-4, V, 5, ...)`` (repeated centers
    under repeat_center), give what the same step gives on the stacks the
    JAX package's predict step builds (``make_context_windows``, then the
    view and time axes swapped): the model's input equal to those stacks
    normalized, bitwise, and the keypoints within 1e-3 px of the step's on
    them (another memory layout, another convolution plan); the bboxes are
    trimmed to the window centers."""
    from lightning_pose_tpu_torch.api.model import PredictStep

    _, variables = jax_models["heatmap_mhcrnn"]
    frames = np.random.default_rng(8).integers(0, 256, (7, VIEWS, IMAGE, IMAGE, 3), dtype=np.uint8)
    stacks = np.array(jtracker.make_context_windows(jnp.asarray(frames), repeat_center=repeat)
                        ).transpose(0, 2, 1, 3, 4, 5)
    assert stacks.shape == (3, VIEWS, 5, IMAGE, IMAGE, 3)
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images

    model = _port("heatmap_mhcrnn", variables, repeat).eval()
    seen = []
    model.register_forward_pre_hook(lambda _, args: seen.append(args[0].clone()))
    step = PredictStep(model, IMAGE, IMAGE, torch.float32, num_views=VIEWS)
    bbox = torch.tensor([[0.0, 0.0, 80.0, 100.0, 5.0, 6.0, 60.0, 70.0]] * 7)
    kp, conf = step(torch.from_numpy(frames), bbox)
    torch.testing.assert_close(seen[0], normalize_images(torch.from_numpy(stacks)).movedim(-1, -3), rtol=0, atol=0)
    kp_ref, conf_ref = step(torch.from_numpy(np.ascontiguousarray(stacks)), bbox[2:-2])
    assert kp.shape == (3, 2 * VIEWS * KEYPOINTS) and conf.shape == (3, VIEWS * KEYPOINTS)
    torch.testing.assert_close(kp, kp_ref, rtol=0, atol=DECODE_PX_TOL)
    torch.testing.assert_close(conf, conf_ref, rtol=0, atol=DECODE_CONF_TOL)
