"""Slice 2, supervised training, against the JAX package: targets, losses,
schedules, the two repairs (BatchNorm running variance, flax's init), an
fp32 trajectory of the train step from the same weights and batches, and
``train()`` end to end, whose model directory the JAX package reads."""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.data.heatmaps import generate_heatmaps as jax_generate_heatmaps
from lightning_pose_tpu.losses import losses as jlosses
from lightning_pose_tpu.train import schedules as jsched
from lightning_pose_tpu_torch.data.heatmaps import generate_heatmaps
from lightning_pose_tpu_torch.losses import losses as plosses
from lightning_pose_tpu_torch.train import schedules as psched

TRAIN_IMAGE = 128
TRAIN_KEYPOINTS = 4
TRAIN_FRAMES = 12
NAMES = ["nose", "tail", "paw_left", "paw_right"]
# targets and losses: fp32 sums over a map in another order
TARGET_TOL = 1e-6
LOSS_TOL = 1e-6


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    return write_labeled_dataset(
        tmp_path_factory.mktemp("port_train") / "data", TRAIN_FRAMES, 140, 150, NAMES, seed=0, nan_fraction=0.1
    )


def _train_cfg(data_dir: Path, **training):
    """resnet18 at 128 px on the synthetic dataset, batch 4, step mode."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = TRAIN_KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = TRAIN_IMAGE
    cfg.data.image_resize_dims.width = TRAIN_IMAGE
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = "porttrain"
    cfg.training.train_batch_size = 4
    cfg.training.val_batch_size = 4
    cfg.training.train_prob = 0.7
    cfg.training.val_prob = 0.3
    cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
    cfg.training.max_steps = cfg.training.min_steps = 3
    cfg.training.unfreezing_step = 1
    cfg.training.lr_scheduler_params.multisteplr.milestones = None
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [2]
    cfg.training.check_val_every_n_epoch = 1
    for key, value in training.items():
        cfg.training[key] = value
    return cfg


# -- targets and losses --------------------------------------------------------------


def _keypoints(rng, b, k, size):
    kp = rng.uniform(-3, size + 3, (b, k, 2)).astype(np.float32)
    kp[0, 0] = np.nan
    kp[1, 1] = (size + 20, 5)  # out of range: a zero map
    return kp


@pytest.mark.parametrize("with_visibility", [False, True])
def test_generate_heatmaps_matches_jax(with_visibility):
    rng = np.random.default_rng(0)
    kp = _keypoints(rng, 4, 5, 128)
    vis = rng.integers(0, 3, (4, 5)).astype(np.int64) if with_visibility else None
    ref = np.asarray(jax_generate_heatmaps(
        jnp.asarray(kp), 128, 128, (32, 32), visibility=None if vis is None else jnp.asarray(vis)
    )).transpose(0, 3, 1, 2)
    out = generate_heatmaps(torch.from_numpy(kp), 128, 128, (32, 32),
                            visibility=None if vis is None else torch.from_numpy(vis))
    assert out.shape == (4, 5, 32, 32)
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=TARGET_TOL)
    if vis is None:  # a NaN or out-of-range keypoint gives a zero map
        assert not _np(out)[0, 0].any() and not _np(out)[1, 1].any()


def _maps(rng, b, k, h, w) -> np.ndarray:
    z = rng.standard_normal((b, k, h * w)) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).reshape(b, k, h, w).astype(np.float32)


@pytest.mark.parametrize("name", ["HeatmapMSELoss", "HeatmapKLLoss", "HeatmapJSLoss"])
def test_heatmap_losses_match_jax(name):
    rng = np.random.default_rng(1)
    targets = np.asarray(jax_generate_heatmaps(jnp.asarray(_keypoints(rng, 4, 5, 64)), 64, 64, (16, 16)))
    targets = targets.transpose(0, 3, 1, 2)  # with all-zero maps, which are masked out
    preds = _maps(rng, 4, 5, 16, 16)
    ref, ref_logs = getattr(jlosses, name)()(
        jnp.asarray(targets.transpose(0, 2, 3, 1)), jnp.asarray(preds.transpose(0, 2, 3, 1)), stage="train"
    )
    out, logs = getattr(plosses, name)()(torch.from_numpy(targets), torch.from_numpy(preds), stage="train")
    assert set(logs) == set(ref_logs)
    np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL, atol=LOSS_TOL)


@pytest.mark.parametrize("mask_kind", ["some", "none", "broadcast"])
def test_masked_mean_matches_jax(mask_kind):
    rng = np.random.default_rng(2)
    values = rng.standard_normal((3, 4, 5)).astype(np.float32)
    mask = {
        "some": rng.uniform(size=(3, 4, 5)) < 0.5,
        "none": np.zeros((3, 4, 5), bool),
        "broadcast": rng.uniform(size=(3, 4, 1)) < 0.5,
    }[mask_kind]
    ref = jlosses.masked_mean(jnp.asarray(values), jnp.asarray(mask))
    out = plosses.masked_mean(torch.from_numpy(values), torch.from_numpy(mask))
    np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL, atol=LOSS_TOL)


def test_rmse_and_loss_factory_match_jax():
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories

    rng = np.random.default_rng(3)
    targ = rng.uniform(0, 100, (4, 10)).astype(np.float32)
    targ[0, 2:4] = np.nan
    pred = rng.uniform(0, 100, (4, 10)).astype(np.float32)
    ref, _ = jlosses.RegressionRMSELoss()(jnp.asarray(targ), jnp.asarray(pred))
    out, _ = plosses.RegressionRMSELoss()(torch.from_numpy(targ), torch.from_numpy(pred))
    np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL)

    cfg = load_config()
    targets = _maps(rng, 2, 3, 8, 8)
    preds = _maps(rng, 2, 3, 8, 8)
    for loss_type in ("mse", "kl", "js"):
        cfg.model.heatmap_loss_type = loss_type
        ref, ref_logs = jax_factories(cfg)["supervised"](
            stage="val", anneal_weight=None,
            heatmaps_targ=jnp.asarray(targets.transpose(0, 2, 3, 1)),
            heatmaps_pred=jnp.asarray(preds.transpose(0, 2, 3, 1)),
        )
        out, logs = get_loss_factories(cfg)["supervised"](
            stage="val", anneal_weight=None,
            heatmaps_targ=torch.from_numpy(targets), heatmaps_pred=torch.from_numpy(preds),
        )
        assert set(logs) == set(ref_logs)
        np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL)
        np.testing.assert_allclose(float(logs[f"heatmap_{loss_type}_weight"]), 0.5)
    cfg.model.losses_to_use = ["pca_multiview"]  # the unsupervised losses not ported yet
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        get_loss_factories(cfg)


# -- schedules -------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["epoch", "step"])
def test_schedules_match_jax(mode):
    spe = 7
    milestones = [3, 5]
    if mode == "epoch":
        kw = {"unfreezing_epoch": 2}
        steps = [0, 1, 13, 14, 15, 20, 21, 22, 27, 34, 35, 36, 60]
    else:
        kw = {"unfreezing_step": 9}
        steps = [0, 8, 9, 10, 11, 12, 20, 21, 22, 34, 35, 40]
    pairs = [
        (jsched.multistep_lr(1e-3, milestones, 0.5, spe), psched.multistep_lr(1e-3, milestones, 0.5, spe)),
        (jsched.backbone_lr(1e-3, milestones, 0.5, spe, **kw), psched.backbone_lr(1e-3, milestones, 0.5, spe, **kw)),
    ]
    for ref, out in pairs:
        for step in steps:
            np.testing.assert_allclose(out(step), float(ref(jnp.asarray(step))), rtol=1e-6, err_msg=f"step {step}")
    for epoch in [0, 59, 60, 61, 70, 200]:
        np.testing.assert_allclose(
            psched.anneal_weight(epoch, 0.0, 0.01, 1.0, 60),
            float(jsched.anneal_weight(jnp.asarray(epoch), 0.0, 0.01, 1.0, 60)), rtol=1e-6, atol=1e-7,
        )


# -- the two repairs -------------------------------------------------------------------

# one train-mode BatchNorm layer: biased running variance, as flax's
BN_TOL = 1e-6


def test_batchnorm_running_stats_match_flax():
    """flax updates ``var`` with the biased batch variance; the port's
    ResNet BatchNorm does too (torch's own would use the unbiased one)."""
    import flax.linen as fnn

    from lightning_pose_tpu_torch.models.backbones.resnet import _bn

    rng = np.random.default_rng(4)
    inputs = [rng.normal(0.5, 1.5, (16, 6, 6, 8)).astype(np.float32) for _ in range(3)]
    flax_bn = fnn.BatchNorm(use_running_average=False, momentum=0.9, epsilon=1e-5)
    variables = flax_bn.init(jax.random.PRNGKey(0), jnp.asarray(inputs[0]))
    stats = variables["batch_stats"]
    port_bn = _bn(8).train()
    torch_bn = torch.nn.BatchNorm2d(8, eps=1e-5, momentum=0.1).train()
    for step, x in enumerate(inputs, start=1):
        y_ref, mutated = flax_bn.apply(
            {"params": variables["params"], "batch_stats": stats}, jnp.asarray(x), mutable=["batch_stats"]
        )
        stats = mutated["batch_stats"]
        xt = torch.from_numpy(x.transpose(0, 3, 1, 2))
        y = port_bn(xt)
        torch_bn(xt)
        np.testing.assert_allclose(_np(y).transpose(0, 2, 3, 1), np.asarray(y_ref), rtol=0, atol=1e-5)
        np.testing.assert_allclose(_np(port_bn.running_mean), np.asarray(stats["mean"]), rtol=0, atol=BN_TOL)
        np.testing.assert_allclose(_np(port_bn.running_var), np.asarray(stats["var"]), rtol=0, atol=BN_TOL)
        if step in (1, 3):  # torch's unbiased update is off by about m * var / (n - 1)
            assert float(np.abs(_np(torch_bn.running_var) - np.asarray(stats["var"])).max()) > 100 * BN_TOL


def test_init_matches_flax_per_layer_std():
    """Conv kernels: lecun_normal (variance 1/fan_in, truncated at 2 std),
    per-layer std within 5% of the JAX package's init on resnet18; BatchNorm
    scale 1 and bias 0; the head's deconvs keep Xavier gain 0.01."""
    from lightning_pose_tpu.models.factory import get_model as jax_get_model
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train.checkpoints import state_dict_to_flax

    torch.manual_seed(0)
    port = build_model("heatmap", "resnet18", TRAIN_KEYPOINTS)
    params, _ = state_dict_to_flax(port.state_dict())
    cfg = _train_cfg(Path("/nonexistent"))
    module, _ = jax_get_model(cfg, num_keypoints=TRAIN_KEYPOINTS)
    ref = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 64, 64, 3)), train=False)["params"]
    flat_port = jax.tree_util.tree_flatten_with_path(params)[0]
    flat_ref = dict(jax.tree_util.tree_flatten_with_path(ref)[0])
    n_conv = 0
    for path, value in flat_port:
        ref_value = np.asarray(flat_ref[path])
        assert value.shape == ref_value.shape
        name = jax.tree_util.keystr(path)
        if name.endswith("['kernel']"):
            np.testing.assert_allclose(value.std(), ref_value.std(), rtol=0.05, err_msg=name)
            n_conv += "deconv" not in name
        elif name.endswith("['scale']"):
            assert (value == 1).all()
        else:
            assert (value == 0).all(), name
    assert n_conv == 20  # resnet18: conv1, 16 block convs, 3 downsamples


# -- the train step against the JAX step ------------------------------------------------

# fp32 on the CPU in both packages. The losses of the first steps agree to
# fp32 convolution sums in another order, and so do the BatchNorm statistics
# of the first step, which see the initial weights. The weights then part:
# at this random init the backbone's gradients are tiny sums of large terms,
# and the JAX package's fp32 gradients on the CPU are off by up to 42% of a
# layer's largest entry against float64 (the port's fp32 ones by 4e-6; both
# packages agree in float64, test below). Adam moves each entry by about
# lr * g / |g|, so those errors become parameter differences of up to a
# tenth of a backbone step (1e-4). Most entries still agree within 1e-6; the
# rest are counted and bounded, and so are the statistics after three steps.
TRAJ_LOSS_RTOL = 1e-4
TRAJ_STATS_TOL = 1e-5
TRAJ_STATS_3_TOL = 5e-4
TRAJ_PARAM_TOL = 1e-6
TRAJ_PARAM_OFF_SHARE = 0.02
TRAJ_PARAM_MAX = 2e-5
TRAJ_DLC_LOSS_RTOL = 1e-3


def _trajectory_setup(data_dir, dtype):
    """Config, cached labeled arrays, the JAX module and its init."""
    from lightning_pose_tpu.models.factory import get_model as jax_get_model
    from lightning_pose_tpu_torch.data.factory import get_dataset

    cfg = _train_cfg(data_dir, max_steps=None, min_steps=None, unfreezing_step=None,
                     max_epochs=2, min_epochs=2, unfreezing_epoch=0)
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = None
    cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
    dataset = get_dataset(cfg, str(data_dir))
    cache = {k: np.stack([np.asarray(dataset[i][k]) for i in range(len(dataset))])
             for k in ("images", "keypoints", "visibility", "bbox")}
    module, meta = jax_get_model(cfg, num_keypoints=TRAIN_KEYPOINTS, compute_dtype=dtype)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, TRAIN_IMAGE, TRAIN_IMAGE, 3)), train=False)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables["params"])
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables["batch_stats"])
    return cfg, cache, module, meta, params, stats


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def test_fp32_train_step_trajectory_matches_jax(data_dir, jax_draws):
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.ops.augment import AugmentationEngine as JaxEngine
    from lightning_pose_tpu.train import trainer as jtrainer
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    spe = 10
    cfg, cache, module, meta, params, stats = _trajectory_setup(data_dir, jnp.float32)
    batches = [np.array([0, 1, 2, 3]), np.array([4, 5, 6, 7]), np.array([8, 9, 10, 11]), np.array([2, 5, 7, 11])]
    tx, _, _ = jtrainer.make_optimizer(cfg, spe, params)
    jstate = jtrainer.TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                                 opt_state=tx.init(params))
    jstep = jtrainer.make_step_fns(module, meta, jax_factories(cfg), JaxEngine("none", 128, 128), cfg, tx, spe)[0]

    model = build_model("heatmap", "resnet18", TRAIN_KEYPOINTS)
    load_flax_variables(model, params, stats)
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, spe, model)
    state = trainer.TrainState(model=model, optimizer=optimizer)
    losses = get_loss_factories(cfg)
    pmeta = {"model_type": "heatmap", "downsample_factor": 2}

    def port_step_with(engine):
        return trainer.make_step_fns(pmeta, losses, engine, cfg, head_sched, bb_sched, spe,
                                     compute_dtype=torch.float32)[2]

    port_step = port_step_with(AugmentationEngine("none", 128, 128))
    tcache = {k: torch.from_numpy(v) for k, v in cache.items()}
    valid = torch.ones(4, dtype=torch.bool)
    for step, idxs in enumerate(batches[:3]):
        batch = {k: v[idxs] for k, v in cache.items()}
        jstate, jlogs = jstep(jstate, batch, jax.random.PRNGKey(0))
        logs = port_step(state, tcache, torch.from_numpy(idxs), valid, None)
        np.testing.assert_allclose(float(logs["total_loss"]), float(jlogs["total_loss"]), rtol=TRAJ_LOSS_RTOL)
        if step == 0:
            np.testing.assert_allclose(_flat(state_dict_to_flax(model.state_dict())[1]),
                                       _flat(jstate.batch_stats), rtol=0, atol=TRAJ_STATS_TOL)
    assert state.step == 3

    out_params, out_stats = state_dict_to_flax(model.state_dict())
    np.testing.assert_allclose(_flat(out_stats), _flat(jstate.batch_stats), rtol=0, atol=TRAJ_STATS_3_TOL)
    ref_flat, out_flat = _flat(jstate.params), _flat(out_params)
    assert np.abs(ref_flat - _flat(params)).max() > 1e-3  # the head moved by about 3 x lr
    diff = np.abs(out_flat - ref_flat)
    assert float((diff > TRAJ_PARAM_TOL).mean()) <= TRAJ_PARAM_OFF_SHARE
    assert float(diff.max()) <= TRAJ_PARAM_MAX

    # one more step with the dlc augmentation: the JAX engine's draws
    # replayed into the port's step, the JAX engine run ahead of the JAX step
    jax_engine = JaxEngine("dlc", 128, 128)
    key = jax.random.PRNGKey(5)
    idxs = batches[3]
    images, keypoints, visibility = jax_engine(
        key, jnp.asarray(cache["images"][idxs]), jnp.asarray(cache["keypoints"][idxs]),
        jnp.asarray(cache["visibility"][idxs]),
    )
    batch = {"images": images, "keypoints": keypoints, "visibility": visibility, "bbox": cache["bbox"][idxs]}
    jstate, jlogs = jstep(jstate, batch, jax.random.PRNGKey(0))
    logs = port_step_with(AugmentationEngine("dlc", 128, 128))(
        state, tcache, torch.from_numpy(idxs), valid, jax_draws(jax_engine, key, 4)
    )
    np.testing.assert_allclose(float(logs["total_loss"]), float(jlogs["total_loss"]), rtol=TRAJ_DLC_LOSS_RTOL)


# float64 in both packages: the same loss and gradients, leaf by leaf,
# relative to each leaf's largest entry
F64_RTOL = 1e-6


def test_float64_loss_gradients_and_stats_match_jax(data_dir):
    """The train-mode loss, every parameter's gradient and the BatchNorm
    updates of one batch, in float64: the port's step computes the JAX
    step's function (the fp32 trajectory above bounds what rounding adds)."""
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.ops.preprocess import normalize_images as jax_normalize
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    idxs = np.array([0, 1, 2, 3])
    with jax.enable_x64(True):
        cfg, cache, module, _, params, stats = _trajectory_setup(data_dir, jnp.float64)
        images = np.asarray(jax_normalize(jnp.asarray(cache["images"][idxs], jnp.float64)), np.float64)
        targets = jax_generate_heatmaps(jnp.asarray(cache["keypoints"][idxs], jnp.float64), 128, 128, (32, 32),
                                        visibility=jnp.asarray(cache["visibility"][idxs]))
        variables64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                             {"params": params, "batch_stats": stats})
        supervised = jax_factories(cfg)["supervised"]

        def jax_loss(p):
            heatmaps, mutated = module.apply(
                {"params": p, "batch_stats": variables64["batch_stats"]}, jnp.asarray(images),
                train=True, mutable=["batch_stats"],
            )
            loss, _ = supervised(stage="train", anneal_weight=None, heatmaps_targ=targets.astype(jnp.float64),
                                 heatmaps_pred=heatmaps.astype(jnp.float64))
            return loss, mutated["batch_stats"]

        (ref_loss, ref_stats), ref_grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(variables64["params"])
        ref_loss, ref_grads, ref_stats = float(ref_loss), jax.tree_util.tree_map(np.asarray, ref_grads), \
            jax.tree_util.tree_map(np.asarray, ref_stats)
        targets = np.asarray(targets).transpose(0, 3, 1, 2)

    model = build_model("heatmap", "resnet18", TRAIN_KEYPOINTS)
    load_flax_variables(model, params, stats)
    model = model.double().train()
    assert normalize_images(torch.from_numpy(cache["images"][idxs])).dtype == torch.float32
    heatmaps = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    loss, _ = get_loss_factories(cfg)["supervised"](
        stage="train", anneal_weight=None, heatmaps_targ=torch.from_numpy(targets), heatmaps_pred=heatmaps
    )
    loss.backward()
    np.testing.assert_allclose(float(loss), ref_loss, rtol=F64_RTOL)
    grads, out_stats = state_dict_to_flax(
        {**model.state_dict(), **{n: p.grad for n, p in model.named_parameters()}}
    )
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    for (path, ref), out in zip(flat_ref, jax.tree_util.tree_leaves(grads)):
        if jax.tree_util.keystr(path).endswith("['deconv1']['bias']"):
            continue  # the last bias shifts every logit of a map: its gradient is 0 up to rounding
        scale = np.abs(ref).max()
        np.testing.assert_allclose(out, ref, rtol=0, atol=F64_RTOL * scale, err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(_flat(out_stats), _flat(ref_stats), rtol=0, atol=1e-9)


# -- train() end to end ------------------------------------------------------------------

# the port's and the JAX package's fp32 predictions from one checkpoint
E2E_PX_TOL = 1e-3


@pytest.fixture(scope="module")
def trained_dir(data_dir, tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.train.trainer import train

    model_dir = tmp_path_factory.mktemp("port_trained") / "model"
    train(_train_cfg(data_dir), model_dir, skip_evaluation=True, device="cpu")
    return model_dir


def test_train_writes_the_model_dir_contract(trained_dir):
    from lightning_pose_tpu.utils.io import ckpt_path_from_base_path

    assert (trained_dir / "config.yaml").is_file()
    assert (trained_dir / "CollectedData.csv").is_file()
    assert json.loads((trained_dir / "train_status.json").read_text())["status"] == "COMPLETED"
    ckpts = sorted(p.name for p in (trained_dir / "tb_logs" / "porttrain" / "version_0" / "checkpoints").iterdir())
    assert ckpts == ["epoch=0-step=3-best.ckpt", "epoch=0-step=3-last.ckpt"]
    assert ckpt_path_from_base_path(str(trained_dir), "porttrain").endswith("epoch=0-step=3-best.ckpt")


def test_jax_package_predicts_from_the_port_trained_dir(trained_dir):
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu.train.checkpoints import load_checkpoint as jax_load_checkpoint
    from lightning_pose_tpu_torch.api.model import Model

    ckpt = jax_load_checkpoint(
        str(trained_dir / "tb_logs" / "porttrain" / "version_0" / "checkpoints" / "epoch=0-step=3-best.ckpt")
    )
    assert ckpt["step"] == 3 and ckpt["epoch"] == 0
    frame = np.random.default_rng(5).integers(0, 256, (140, 150, 3), dtype=np.uint8)
    ref = JaxModel.from_dir(trained_dir, precision="fp32").predict_frame(frame)
    out = Model.from_dir(trained_dir, precision="fp32", device="cpu").predict_frame(frame)
    assert np.isfinite(out["keypoints"]).all()
    np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=0, atol=E2E_PX_TOL)


def test_train_in_epoch_mode_with_warm_start(data_dir, trained_dir, tmp_path):
    """Epoch mode, AdamW, warm-started from the trained directory; a second
    run in the same directory takes version_1."""
    from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint
    from lightning_pose_tpu_torch.train.trainer import train

    cfg = _train_cfg(data_dir, max_steps=None, min_steps=None, unfreezing_step=None,
                     max_epochs=2, min_epochs=2, unfreezing_epoch=1, optimizer="AdamW", imgaug="none")
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = None
    cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
    cfg.model.checkpoint = str(trained_dir)
    for version in (0, 1):
        result = train(cfg.copy(), tmp_path, skip_evaluation=True, device="cpu")
        ckpts = list((tmp_path / "tb_logs" / "porttrain" / f"version_{version}" / "checkpoints").glob("*-best.ckpt"))
        assert len(ckpts) == 1
    assert load_checkpoint(str(ckpts[0]))["epoch"] == 1
    assert result.model_dir == tmp_path


@pytest.mark.parametrize(
    "change, match",
    [
        ({"losses_to_use": ["unimodal_mse"]}, "item 4"),
        ({"num_gpus": 2}, "item 8"),
        ({"losses_to_use": ["unimodal_kl"]}, "item 4"),
        ({"checkpoint_backend": "orbax"}, "item 4"),
    ],
)
def test_train_raises_on_what_is_not_ported(data_dir, tmp_path, change, match):
    from lightning_pose_tpu_torch.train.trainer import train

    change = dict(change)
    cfg = _train_cfg(data_dir)
    if "losses_to_use" in change:
        cfg.model.losses_to_use = change.pop("losses_to_use")
    for key, value in change.items():
        cfg.training[key] = value
    with pytest.raises(NotImplementedError, match=match):
        train(cfg, tmp_path / "model", skip_evaluation=True, device="cpu")
    assert not (tmp_path / "model" / "tb_logs").exists()


def test_train_on_cuda_without_cuda_raises(data_dir, tmp_path):
    from lightning_pose_tpu_torch.train.trainer import train

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        train(_train_cfg(data_dir), tmp_path, skip_evaluation=True)


def test_checkpoint_contract_pieces(trained_dir, tmp_path):
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train import checkpoints as ckpt

    assert ckpt.next_version_dir(str(trained_dir), "porttrain").endswith("version_1")
    assert ckpt.next_version_dir(str(tmp_path), "other").endswith("version_0")
    # a head of another size warm-starts the backbone only
    other = build_model("heatmap", "resnet18", TRAIN_KEYPOINTS + 1)
    assert not ckpt.warm_start(other, str(trained_dir))
    same = build_model("heatmap", "resnet18", TRAIN_KEYPOINTS)
    assert ckpt.warm_start(same, str(trained_dir))
    with pytest.raises(ValueError):
        ckpt.warm_start(build_model("heatmap", "resnet34", TRAIN_KEYPOINTS), str(trained_dir))
    params, stats = ckpt.state_dict_to_flax(same.state_dict())
    opt_state = {"inner_states": {"head": {"inner_state": {"0": {"count": np.asarray(2, np.int32)}}}}}
    ckpt.save_checkpoint(str(tmp_path / "x.ckpt"), params, stats, opt_state=opt_state)
    assert ckpt.load_checkpoint(str(tmp_path / "x.ckpt"))["opt_state"] == opt_state
    assert "opt_state" not in ckpt.load_checkpoint(str(ckpt.resolve_checkpoint_path(str(trained_dir))))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        ckpt.save_checkpoint(str(tmp_path / "x.ckpt"), params, stats, backend="orbax")
    path = tmp_path / "a.ckpt"
    ckpt.save_module(str(path), same, step=7, epoch=2, extra={"best_val": 0.5})
    loaded = ckpt.load_checkpoint(str(path))
    assert (loaded["step"], loaded["epoch"], loaded["extra"]) == (7, 2, {"best_val": 0.5})
    ckpt.remove_checkpoint(str(path))
    assert not path.exists()


def test_progress_tracker_and_status(tmp_path):
    from lightning_pose_tpu_torch.callbacks import JSONTrainingProgressTracker, write_status

    path = tmp_path / "train_status.json"
    write_status(path, "TRAINING")
    assert json.loads(path.read_text()) == {"status": "TRAINING"}
    JSONTrainingProgressTracker(path, total_epochs=4).update(1)
    assert json.loads(path.read_text()) == {
        "status": "TRAINING", "current_epoch": 1, "total_epochs": 4, "progress": 50.0,
    }
    JSONTrainingProgressTracker(None, total_epochs=4).update(1)  # disabled: writes nothing
