"""Slice 9, the transformer backbones in training: every name of
``ALLOWED_TRANSFORMER_BACKBONES`` in the single-view heatmap model and every
name of ``ALLOWED_TRANSFORMER_BACKBONES_MULTIVIEW`` in the multiview
transformer takes an optimizer step and predicts on the CPU; one float64
train step with a DINOv3 trunk and one with a SAM2 Hiera trunk against the
JAX step's loss and gradients; and the context model with a stride-16 trunk,
which behaves as in the JAX package (the same map shapes, prediction runs,
training fails at its first step).

The backbones are small: ``VIT_CONFIGS`` width 64, 2 heads, depth 2 (head
dim 32, a multiple of 4 as RoPE needs; the SAM encoder is then windowed
only), ``HIERA_CONFIGS`` width 16 with the published depths, windows and
global blocks."""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models.backbones import hiera as jhiera
from lightning_pose_tpu.models.backbones import vit as jvit
from lightning_pose_tpu_torch.models.backbones import factory as pfactory
from lightning_pose_tpu_torch.models.backbones import hiera as phiera
from lightning_pose_tpu_torch.models.backbones import vit as pvit


SMALL_VIT = (64, 2, 2, 16)
HIERA_WIDTH = 16
IMAGE = 64
KEYPOINTS = 3
# float64 in both packages: the loss, and each gradient leaf within this
# share of its largest entry
F64_RTOL = 1e-6


def _shrink(mp) -> None:
    for configs in (jvit.VIT_CONFIGS, pvit.VIT_CONFIGS):
        for key in ("vits", "vitb"):
            mp.setitem(configs, key, SMALL_VIT)
    for configs in (jhiera.HIERA_CONFIGS, phiera.HIERA_CONFIGS):
        for name, config in list(configs.items()):
            mp.setitem(configs, name, dict(config, embed_dim=HIERA_WIDTH))


@pytest.fixture(autouse=True)
def small_backbones(monkeypatch):
    _shrink(monkeypatch)


def _cfg(model_type: str, backbone: str, views: list[str] | None = None):
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = [f"kp{i}" for i in range(KEYPOINTS)]
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.data.view_names = views
    cfg.model.model_type = model_type
    cfg.model.backbone = backbone
    cfg.model.losses_to_use = []
    cfg.training.max_epochs = cfg.training.min_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
    return cfg


def _one_step_and_prediction(model_type: str, backbone: str, views: int) -> None:
    """One optimizer step of the port's train step (no augmentation), which
    must move the backbone and the head, then a fp32 prediction."""
    from lightning_pose_tpu_torch.api.model import PredictStep
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import trainer

    names = [f"v{i}" for i in range(views)] if views > 1 else None
    cfg = _cfg(model_type, backbone, names)
    torch.manual_seed(0)
    model = build_model(model_type, backbone, KEYPOINTS, num_views=views, image_size=IMAGE)
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, 10, model)
    state = trainer.TrainState(model=model, optimizer=optimizer)
    meta = {"model_type": "heatmap_multiview" if views > 1 else model_type, "downsample_factor": 2,
            "num_views": views}
    step = trainer.make_step_fns(meta, get_loss_factories(cfg), AugmentationEngine("none", IMAGE, IMAGE), cfg,
                                 head_sched, bb_sched, 10, compute_dtype=torch.float32)[0]
    rng = np.random.default_rng(1)
    lead = (2, views) if views > 1 else (2,)
    batch = {
        "images": torch.from_numpy(rng.integers(0, 256, (*lead, IMAGE, IMAGE, 3), dtype=np.uint8)),
        "keypoints": torch.from_numpy(rng.uniform(8, IMAGE - 8, (2, views * KEYPOINTS, 2)).astype(np.float32)),
        "visibility": torch.full((2, views * KEYPOINTS), 2, dtype=torch.int64),
        "bbox": torch.tensor([[0.0, 0.0, IMAGE, IMAGE] * views] * 2),
    }
    before = {n: p.detach().clone() for n, p in model.named_parameters()}
    logs = step(state, batch, None)
    assert np.isfinite(float(logs["total_loss"]))
    moved = {n.split(".")[0] for n, p in model.named_parameters() if not torch.equal(p, before[n])}
    assert {"backbone", "head"} <= moved
    predict = PredictStep(model.eval(), IMAGE, IMAGE, torch.float32)
    kp, conf = predict(batch["images"], batch["bbox"])
    assert kp.shape == (2, 2 * views * KEYPOINTS) and conf.shape == (2, views * KEYPOINTS)
    assert bool(torch.isfinite(kp).all() and torch.isfinite(conf).all())


@pytest.mark.parametrize("backbone", pfactory.ALLOWED_TRANSFORMER_BACKBONES)
def test_single_view_heatmap_model_trains_and_predicts(backbone):
    from lightning_pose_tpu_torch.models.factory import build_model

    model = build_model("heatmap", backbone, KEYPOINTS, image_size=IMAGE)
    stride = pfactory.BACKBONE_STRIDES[backbone]
    assert model.head.n_layers == int(np.log2(stride)) - 3
    _one_step_and_prediction("heatmap", backbone, views=1)


@pytest.mark.parametrize("backbone", pfactory.ALLOWED_TRANSFORMER_BACKBONES_MULTIVIEW)
def test_multiview_transformer_trains_and_predicts(backbone):
    _one_step_and_prediction("heatmap_multiview", backbone, views=2)


# -- float64 train steps against the JAX package --------------------------------------------


def _jax_maps64(module, params, images, last_deconv: str):
    """The JAX tracker's maps in float64: its head casts to float32 before
    the softmax, so the softmax is rebuilt from the captured float64 output
    of its last deconv."""
    from lightning_pose_tpu.ops.softargmax import spatial_softmax2d

    _, state = module.apply({"params": params}, images, train=True, mutable=["intermediates"],
                            capture_intermediates=lambda mdl, _: mdl.name == last_deconv)
    logits = state["intermediates"]["head"][last_deconv]["__call__"][0]
    assert logits.dtype == jnp.float64
    return spatial_softmax2d(logits, temperature=1.0)


class _Float64Numpy:
    """``jax.numpy`` whose ``float32`` is ``float64``: set as the ``jnp`` of
    the JAX package's DINO and Hiera modules, their attention's softmax (and
    their parameter dtypes) run in float64 like the rest of the step."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


@pytest.mark.parametrize("backbone, image", [("vits_dinov3", 64), ("vitt_sam2", 128)])
def test_float64_train_step_matches_jax(seeded_jax_variables, monkeypatch, backbone, image):
    """The supervised loss of one batch and every parameter's gradient, in
    float64, from the same seeded variables: the port's tracker with a
    DINOv3 (RoPE, register tokens, LayerScale) or Hiera (q-pool, windows,
    stride 32, two deconvs) trunk computes the JAX tracker's function. The
    JAX package takes the attention's softmax in float32 whatever the
    compute type; here it takes it in float64 (``_Float64Numpy``)."""
    from lightning_pose_tpu.models.backbones import vit_dino as jdino

    for jax_module in (jdino, jhiera):
        monkeypatch.setattr(jax_module, "jnp", _Float64Numpy())
    from lightning_pose_tpu.data.heatmaps import generate_heatmaps as jax_generate_heatmaps
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.models.heatmap_tracker import HeatmapTracker
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    cfg = _cfg("heatmap", backbone)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = image
    rng = np.random.default_rng(3)
    images = rng.standard_normal((2, image, image, 3))
    keypoints = rng.uniform(8, image - 8, (2, KEYPOINTS, 2))
    module = HeatmapTracker(backbone_arch=backbone, num_keypoints=KEYPOINTS, image_size=image, dtype=jnp.float64)
    params = seeded_jax_variables(module, jnp.zeros((1, image, image, 3)), seed=4)["params"]
    for block in params["backbone"].values():  # LayerScale in [0.5, 1.5], not normal(0, 0.02)
        for name in ("ls1", "ls2"):
            if isinstance(block, dict) and name in block:
                block[name]["lambda"] = rng.uniform(0.5, 1.5, block[name]["lambda"].shape).astype(np.float32)
    last = "deconv1" if backbone.endswith("_sam2") else "deconv0"
    params["head"][last]["kernel"] = params["head"][last]["kernel"] * 300.0  # peaked maps
    size = image // 4

    with jax.enable_x64(True):
        targets = jax_generate_heatmaps(jnp.asarray(keypoints), image, image, (size, size)).astype(jnp.float64)
        supervised = jax_factories(cfg)["supervised"]
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)

        def jax_loss(p):
            maps = _jax_maps64(module, p, jnp.asarray(images), last)
            return supervised(stage="train", anneal_weight=None, heatmaps_targ=targets, heatmaps_pred=maps)[0]

        ref_loss, ref_grads = jax.jit(jax.value_and_grad(jax_loss))(p64)
        ref_loss, ref_grads = float(ref_loss), jax.tree_util.tree_map(np.asarray, ref_grads)
        targets = np.asarray(targets).transpose(0, 3, 1, 2)

    model = build_model("heatmap", backbone, KEYPOINTS, image_size=image)
    load_flax_variables(model, params, {})
    model = model.double().train()
    maps = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    loss, _ = get_loss_factories(cfg)["supervised"](stage="train", anneal_weight=None,
                                                    heatmaps_targ=torch.from_numpy(targets), heatmaps_pred=maps)
    loss.backward()
    np.testing.assert_allclose(float(loss), ref_loss, rtol=F64_RTOL)
    grads = state_dict_to_flax({n: p.grad for n, p in model.named_parameters()})[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(grads)[0])
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    assert len(flat_ref) == len(flat_out)
    for path, ref in flat_ref:
        name = jax.tree_util.keystr(path)
        if "['head']" in name and name.endswith("['bias']"):
            # a deconv's bias shifts a map's logits (all but) alike: its
            # gradient is 0 up to rounding in both
            assert np.abs(flat_out[path]).max() < 1e-9 and np.abs(ref).max() < 1e-9, name
            continue
        np.testing.assert_allclose(flat_out[path], ref, rtol=0, atol=F64_RTOL * np.abs(ref).max(), err_msg=name)


# -- the context model with a stride-16 trunk -----------------------------------------------


def test_context_model_with_a_vit_does_what_the_jax_package_does(seeded_jax_variables):
    """``heatmap_mhcrnn`` with ``vits_dino`` (stride 16): the single-frame
    head's maps are (16, 16) at 64 px and the CRNN head's (32, 32), in both
    packages. Prediction decodes each head on its own and runs in both; the
    train step concatenates the two heads' maps and fails in both."""
    from lightning_pose_tpu.models.heatmap_tracker_mhcrnn import HeatmapTrackerMHCRNN
    from lightning_pose_tpu.ops.softargmax import run_subpixelmaxima
    from lightning_pose_tpu_torch.api.model import PredictStep
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables

    rng = np.random.default_rng(5)
    stacks = rng.integers(0, 256, (2, 5, IMAGE, IMAGE, 3), dtype=np.uint8)
    module = HeatmapTrackerMHCRNN(backbone_arch="vits_dino", num_keypoints=KEYPOINTS, image_size=IMAGE,
                                  dtype=jnp.float32)
    x = jnp.asarray(stacks, jnp.float32) / 255.0
    params = seeded_jax_variables(module, x, seed=6)["params"]
    ref_sf, ref_mf = jax.jit(module.apply)({"params": params}, x)
    assert ref_sf.shape == (2, 16, 16, KEYPOINTS) and ref_mf.shape == (2, 32, 32, KEYPOINTS)
    assert run_subpixelmaxima(ref_mf, downsample_factor=2)[0].shape == (2, 2 * KEYPOINTS)
    with pytest.raises(TypeError):  # the JAX step's concatenation of the two heads' maps
        jnp.concatenate([ref_sf, ref_mf], axis=0)

    model = build_model("heatmap_mhcrnn", "vits_dino", KEYPOINTS, image_size=IMAGE)
    load_flax_variables(model, params, {})
    with torch.no_grad():
        sf, mf = model.eval()(torch.from_numpy(np.asarray(x)).permute(0, 1, 4, 2, 3))
    assert sf.shape == (2, KEYPOINTS, 16, 16) and mf.shape == (2, KEYPOINTS, 32, 32)
    kp, conf = PredictStep(model, IMAGE, IMAGE, torch.float32)(torch.from_numpy(stacks),
                                                              torch.tensor([[0.0, 0.0, IMAGE, IMAGE]] * 2))
    assert kp.shape == (2, 2 * KEYPOINTS) and bool(torch.isfinite(kp).all())

    cfg = _cfg("heatmap_mhcrnn", "vits_dino")
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, 10, model.train())
    step = trainer.make_step_fns({"model_type": "heatmap_mhcrnn", "downsample_factor": 2}, get_loss_factories(cfg),
                                 AugmentationEngine("none", IMAGE, IMAGE), cfg, head_sched, bb_sched, 10,
                                 compute_dtype=torch.float32)[0]
    batch = {"images": torch.from_numpy(stacks),
             "keypoints": torch.from_numpy(rng.uniform(8, 56, (2, KEYPOINTS, 2)).astype(np.float32)),
             "visibility": torch.full((2, KEYPOINTS), 2, dtype=torch.int64),
             "bbox": torch.tensor([[0.0, 0.0, IMAGE, IMAGE]] * 2)}
    with pytest.raises(ValueError, match="stride-32"):
        step(trainer.TrainState(model=model, optimizer=optimizer), batch, None)
