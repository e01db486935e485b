"""Slice 6, the context model's modules against the JAX package's flax
modules: the grouped 2x2 transposed conv, the CRNN, the two-head head and
the tracker (eval and train mode, fp32, the same weights through the
bridge), flax's init, the bridge both ways, the ``context_repeat``
equalities, and the window, repeat and merge helpers."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models import heatmap_tracker_mhcrnn as jtracker
from lightning_pose_tpu.models.heads import heatmap_mhcrnn as jhead
from lightning_pose_tpu_torch.models import heatmap_tracker_mhcrnn as ptracker
from lightning_pose_tpu_torch.models.factory import build_model
from lightning_pose_tpu_torch.models.heads import heatmap_mhcrnn as phead
from lightning_pose_tpu_torch.train.checkpoints import (
    load_flax_variables,
    state_dict_from_flax,
    state_dict_to_flax,
)

IMAGE = 64
KEYPOINTS = 4
# fp32 on both sides, the same terms summed in another order: maps within
# 1e-4 of each value and of the largest
MODULE_TOL = 1e-4
STATS_TOL = 1e-5


def _np(x) -> np.ndarray:
    return np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(np.moveaxis(x, -1, -3)))


def _tree(variables) -> dict:
    return jax.tree_util.tree_map(np.asarray, variables)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _scaled_sf(head: dict, scale: float = 300.0) -> dict:
    """The single-frame head's deconvs (of the head's parameter tree) scaled,
    so its maps are peaked (its Xavier gain 0.01 gives near-uniform maps)."""
    for layer in head["head_sf"].values():
        layer["kernel"] = layer["kernel"] * scale
    return head


# -- layers --------------------------------------------------------------------------


@pytest.mark.parametrize("in_ch, out_ch, groups", [(16, 4, 4), (12, 6, 3), (8, 8, 1), (6, 6, 6)])
def test_grouped_conv_transpose_matches_flax(in_ch, out_ch, groups):
    """Torch's grouped transposed conv with the regrouped, flipped kernel is
    the JAX package's input-dilated grouped correlation; the kernel maps
    back bitwise."""
    layer = jhead.GroupedConvTranspose2x2(out_channels=out_ch, groups=groups)
    x = np.random.default_rng(groups).standard_normal((2, 5, 3, in_ch)).astype(np.float32)
    variables = _tree(layer.init(jax.random.PRNGKey(0), jnp.asarray(x)))
    variables["params"]["bias"] = np.linspace(-1, 1, out_ch).astype(np.float32)
    ref = np.asarray(layer.apply(variables, jnp.asarray(x)))
    kernel = variables["params"]["kernel"]
    conv = phead.GroupedConvTranspose2x2(in_ch, out_ch, groups)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(phead.grouped_deconv_kernel_from_flax(kernel, groups)))
        conv.bias.copy_(torch.from_numpy(variables["params"]["bias"]))
        out = np.moveaxis(_np(conv(_nchw(x))), 1, -1)
    assert out.shape == ref.shape == (2, 10, 6, out_ch)
    np.testing.assert_allclose(out, ref, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(phead.grouped_deconv_kernel_to_flax(_np(conv.weight), groups), kernel)


def test_upsampling_crnn_and_head_match_flax():
    feats = np.random.default_rng(1).standard_normal((2, 5, 2, 2, 512)).astype(np.float32)
    jax_head = jhead.HeatmapMHCRNNHead(backbone_arch="resnet18", in_channels=512, out_channels=KEYPOINTS)
    params = _tree(jax_head.init(jax.random.PRNGKey(2), jnp.asarray(feats)))
    _scaled_sf(params["params"])
    ref_sf, ref_mf = (np.asarray(a) for a in jax_head.apply(params, jnp.asarray(feats)))
    ref_crnn = np.asarray(jhead.UpsamplingCRNN(num_filters_for_upsampling=512, num_keypoints=KEYPOINTS).apply(
        {"params": params["params"]["head_mf"]}, jnp.moveaxis(jnp.asarray(feats), 1, 0)))

    head = phead.HeatmapMHCRNNHead("resnet18", in_channels=512, out_channels=KEYPOINTS)
    load_flax_variables(head, params["params"], {})
    with torch.no_grad():
        out_sf, out_mf = head(_nchw(feats))
        out_crnn = head.head_mf(_nchw(feats))
    for out, ref in ((out_sf, ref_sf), (out_mf, ref_mf), (out_crnn, ref_crnn)):
        out = np.moveaxis(_np(out), 1, -1)
        assert out.shape == ref.shape == (2, 16, 16, KEYPOINTS) and out.dtype == np.float32
        np.testing.assert_allclose(out, ref, rtol=MODULE_TOL, atol=MODULE_TOL * ref.max())
    np.testing.assert_allclose(_np(out_mf).sum(axis=(2, 3)), 1.0, rtol=1e-5)


@pytest.fixture(scope="module")
def jax_tracker_variables():
    """The JAX tracker (resnet18, 64 px, adjacent and repeat_center), its
    random init, and the same with the single-frame head peaked and the
    BatchNorm statistics off identity."""
    rng = np.random.default_rng(3)
    modules = {rep: jtracker.HeatmapTrackerMHCRNN(backbone_arch="resnet18", num_keypoints=KEYPOINTS,
                                                  image_size=IMAGE, dtype=jnp.float32, context_repeat=rep)
               for rep in (False, True)}
    init = _tree(modules[False].init(jax.random.PRNGKey(4), jnp.zeros((1, 5, IMAGE, IMAGE, 3)), train=False))
    params = jax.tree_util.tree_map(np.copy, init["params"])
    _scaled_sf(params["head"])
    stats = jax.tree_util.tree_map(lambda x: (x + rng.uniform(0.0, 0.5, x.shape)).astype(np.float32),
                                   init["batch_stats"])
    return modules, params, stats, init["params"]


def _port_tracker(params, stats, repeat: bool = False):
    model = build_model("heatmap_mhcrnn", "resnet18", KEYPOINTS, context_repeat=repeat)
    load_flax_variables(model, params, stats)
    return model


@pytest.mark.parametrize("train", [False, True])
def test_tracker_matches_flax(jax_tracker_variables, train):
    """Both heads' maps of 5-frame stacks, eval mode and train mode (batch
    statistics over the 10 frames, and the updated running statistics)."""
    modules, params, stats, _ = jax_tracker_variables
    x = np.random.default_rng(5).standard_normal((2, 5, IMAGE, IMAGE, 3)).astype(np.float32)
    variables = {"params": params, "batch_stats": stats}
    if train:
        (ref_sf, ref_mf), mutated = modules[False].apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
        ref_stats = _tree(mutated["batch_stats"])
    else:
        ref_sf, ref_mf = modules[False].apply(variables, jnp.asarray(x), train=False)
    model = _port_tracker(params, stats).train(train)
    with torch.no_grad():
        out_sf, out_mf = model(_nchw(x))
    for out, ref in ((out_sf, ref_sf), (out_mf, ref_mf)):
        ref = np.asarray(ref)
        np.testing.assert_allclose(np.moveaxis(_np(out), 1, -1), ref, rtol=MODULE_TOL, atol=MODULE_TOL * ref.max())
    if train:
        np.testing.assert_allclose(_flat(state_dict_to_flax(model.state_dict())[1]), _flat(ref_stats),
                                   rtol=0, atol=STATS_TOL)


def test_init_matches_flax_per_layer_std(jax_tracker_variables):
    """Every CRNN layer Xavier-uniform at gain 1.0 on flax's fans of the HWIO
    kernel, the single-frame head at gain 0.01, the backbone lecun_normal:
    each kernel's std within 5% of the JAX package's init (kernels of at
    most 1000 entries, down to 144, within 20%: four standard errors of two
    estimates), biases 0, BatchNorm scale 1."""
    ref = jax_tracker_variables[3]
    torch.manual_seed(0)
    params, _ = state_dict_to_flax(build_model("heatmap_mhcrnn", "resnet18", KEYPOINTS).state_dict())
    flat_port = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    assert len(flat_port) == len(flat_ref)
    n_head = 0
    for path, value in flat_port:
        ref_value = np.asarray(flat_ref[path])
        name = jax.tree_util.keystr(path)
        assert value.shape == ref_value.shape, name
        if name.endswith("['kernel']"):
            rtol = 0.05 if value.size > 1000 else 0.2
            np.testing.assert_allclose(value.std(), ref_value.std(), rtol=rtol, err_msg=name)
            n_head += "head" in name
        elif name.endswith("['scale']"):
            assert (value == 1).all()
        else:
            assert (value == 0).all(), name
    assert n_head == 9  # head_sf deconv0, deconv1; W_pre, W_f, W_b, H_f/H_b conv and deconv


def test_bridge_round_trip_is_bitwise_both_ways(jax_tracker_variables):
    _, params, stats, _ = jax_tracker_variables
    state = state_dict_from_flax(params, stats)
    back_params, back_stats = state_dict_to_flax(state)
    for tree, back in ((params, back_params), (stats, back_stats)):
        assert jax.tree_util.tree_structure(tree) == jax.tree_util.tree_structure(back)
        for a, b in zip(jax.tree_util.tree_leaves(tree), jax.tree_util.tree_leaves(back)):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    torch.manual_seed(1)
    model = build_model("heatmap_mhcrnn", "resnet18", KEYPOINTS)
    again = state_dict_from_flax(*state_dict_to_flax(model.state_dict()))
    for key, value in model.state_dict().items():
        assert torch.equal(again[key], value), key


@pytest.mark.parametrize("train", [False, True])
def test_context_repeat_encodes_the_center_once_with_equal_outputs(jax_tracker_variables, train):
    """On repeated stacks, ``context_repeat`` runs the backbone on B images
    instead of 5B and gives the same maps and, in train mode, the same
    BatchNorm statistics as the adjacent model; the JAX package's
    repeat_center tracker agrees."""
    modules, params, stats, _ = jax_tracker_variables
    centers = np.random.default_rng(7).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    x = np.repeat(centers[:, None], 5, axis=1)
    outs, seen = {}, {}
    for repeat in (False, True):
        model = _port_tracker(params, stats, repeat).train(train)
        seen[repeat] = []
        model.backbone.register_forward_pre_hook(lambda m, args, s=seen[repeat]: s.append(args[0].shape[0]))
        with torch.no_grad():
            outs[repeat] = [_np(o) for o in model(_nchw(x))], _flat(state_dict_to_flax(model.state_dict())[1])
    assert seen == {False: [10], True: [2]}
    # eval mode: the same per-image sums; train mode: batch statistics over
    # 10 copies or 2 images, the same values summed in another order
    for a, b in zip(outs[False][0], outs[True][0]):
        np.testing.assert_allclose(a, b, rtol=MODULE_TOL, atol=MODULE_TOL * a.max())
    np.testing.assert_allclose(outs[False][1], outs[True][1], rtol=0, atol=STATS_TOL)
    variables = {"params": params, "batch_stats": stats}
    if train:
        ref, _ = modules[True].apply(variables, jnp.asarray(x), train=True, mutable=["batch_stats"])
    else:
        ref = modules[True].apply(variables, jnp.asarray(x), train=False)
    for out, r in zip(outs[True][0], ref):
        r = np.asarray(r)
        np.testing.assert_allclose(np.moveaxis(out, 1, -1), r, rtol=MODULE_TOL, atol=MODULE_TOL * r.max())


def test_tracker_refuses_multiview_stacks_and_other_downsample_factors():
    """Multiview stacks ``(B, V, 5, 3, H, W)`` fold into the batch
    (``test_torch_mv_heatmap_model.py`` holds them to the JAX module);
    stacks of any other rank, and downsample factors but 2, are refused."""
    model = build_model("heatmap_mhcrnn", "resnet18", KEYPOINTS).eval()
    with torch.no_grad():
        sf, mf = model(torch.zeros(1, 2, 5, 3, IMAGE, IMAGE))
    assert sf.shape == mf.shape == (1, 2 * KEYPOINTS, IMAGE // 4, IMAGE // 4)
    with pytest.raises(ValueError, match="stacks"):
        model(torch.zeros(1, 1, 2, 5, 3, IMAGE, IMAGE))
    with pytest.raises(ValueError, match="downsample_factor"):
        build_model("heatmap_mhcrnn", "resnet18", KEYPOINTS, downsample_factor=3)


# -- windows, repeats, merge ---------------------------------------------------------


@pytest.mark.parametrize("t", [5, 6, 9])
@pytest.mark.parametrize("repeat_center", [False, True])
def test_make_context_windows_matches_jax(t, repeat_center):
    frames = np.random.default_rng(t).standard_normal((t, 3, 4, 2)).astype(np.float32)
    ref = np.asarray(jtracker.make_context_windows(jnp.asarray(frames), repeat_center=repeat_center))
    out = _np(ptracker.make_context_windows(torch.from_numpy(frames), repeat_center=repeat_center))
    assert out.shape == ref.shape == (t - 4, 5, 3, 4, 2)
    np.testing.assert_array_equal(out, ref)


def test_make_context_windows_raises_under_5_frames():
    for module in (jtracker, ptracker):
        frames = np.zeros((4, 2, 2, 3), np.float32)
        with pytest.raises(ValueError, match="at least 5 frames"):
            module.make_context_windows(jnp.asarray(frames) if module is jtracker else torch.from_numpy(frames))


@pytest.mark.parametrize("time_axis", [1, 2])
def test_repeat_center_stack_matches_jax(time_axis):
    shape = (2, 5, 3, 4) if time_axis == 1 else (2, 3, 5, 4)
    stacks = np.random.default_rng(8).standard_normal(shape).astype(np.float32)
    ref = np.asarray(jtracker.repeat_center_stack(jnp.asarray(stacks), time_axis=time_axis))
    np.testing.assert_array_equal(_np(ptracker.repeat_center_stack(torch.from_numpy(stacks), time_axis)), ref)


def test_merge_heads_by_confidence_matches_jax_with_ties():
    rng = np.random.default_rng(9)
    kp_sf, kp_mf = (rng.standard_normal((3, 8)).astype(np.float32) for _ in range(2))
    conf_sf = rng.uniform(size=(3, 4)).astype(np.float32)
    conf_mf = rng.uniform(size=(3, 4)).astype(np.float32)
    conf_mf[0, :2] = conf_sf[0, :2]  # ties take the multi-frame head
    ref = jtracker.merge_heads_by_confidence(*(jnp.asarray(a) for a in (kp_sf, conf_sf, kp_mf, conf_mf)))
    out = ptracker.merge_heads_by_confidence(*(torch.from_numpy(a) for a in (kp_sf, conf_sf, kp_mf, conf_mf)))
    for o, r in zip(out, ref):
        np.testing.assert_array_equal(_np(o), np.asarray(r))
    np.testing.assert_array_equal(_np(out[0])[0, :4], kp_mf[0, :4])


def test_merge_gives_the_gradient_to_the_chosen_head_only():
    kp_sf, kp_mf = torch.zeros(1, 4, requires_grad=True), torch.zeros(1, 4, requires_grad=True)
    kp, _ = ptracker.merge_heads_by_confidence(kp_sf, torch.tensor([[0.9, 0.1]]), kp_mf, torch.tensor([[0.5, 0.5]]))
    kp.sum().backward()
    np.testing.assert_array_equal(_np(kp_sf.grad), [[1, 1, 0, 0]])
    np.testing.assert_array_equal(_np(kp_mf.grad), [[0, 0, 1, 1]])
