"""Slice 4, semi-supervised training as a whole, against the JAX package:
the train step with an unlabeled window (pca_singleview + temporal) in
float64 and over three fp32 Adam steps, and ``train()`` end to end, whose
model directory both packages read."""

from __future__ import annotations

import json
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

IMAGE = 64
KEYPOINTS = 4
NAMES = ["nose", "tail", "paw_left", "paw_right"]
LABELED = 4
WINDOW = 8
SPE = 10
# The fp32 trajectory. Through the decode's softmax at a temperature of
# 1000, fp32 gradients are ill-conditioned: against float64, the JAX
# package's are off by up to 6.2% of a leaf's largest entry on the CPU, the
# port's by 0.7% (one step of this test's setup). Adam moves each entry by
# about lr * sign(g) at the first step, so an entry whose sign differs
# moves 2 lr apart, and the next gradients, taken at parameters that
# differ, part further: at lr 1e-3, 98% of the entries differ by more than
# 1e-6 after three steps. At lr 1e-5 the parts stay at the scale of the
# fp32 noise: most entries within lr / 10, none more than a sign flip at
# each of the three steps (6 lr) apart.
TRAJ_LR = 1e-5
TRAJ_LOSS_RTOL = 1e-3
TRAJ_PARAM_TOL = TRAJ_LR / 10
TRAJ_PARAM_OFF_SHARE = 0.02
TRAJ_PARAM_MAX = 6 * TRAJ_LR
TRAJ_STATS_TOL = 5e-4
# float64: the same loss and gradients, leaf by leaf, relative to each
# leaf's largest entry
F64_RTOL = 1e-6


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _cfg():
    """resnet18 at 64 px, epoch mode, pca_singleview + temporal with weight
    1/2 (log_weight 0), epsilons 0 and the anneal weight 1 from epoch 0, so
    that the unsupervised term carries weight."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.backbone = "resnet18"
    cfg.model.losses_to_use = ["pca_singleview", "temporal"]
    for name in ("pca_singleview", "temporal"):
        cfg.losses[name].log_weight = 0.0
        cfg.losses[name].epsilon = 0.0
    cfg.losses.pca_singleview.components_to_keep = 0.9
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.training.max_epochs = cfg.training.min_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
    return cfg


def _data_module(seed: int = 0):
    """What the PCA fit reads of a data module: 40 keypoint rows of a rigid
    body in the 64 px frame, with noise and a NaN label."""
    rng = np.random.default_rng(seed)
    template = rng.uniform(-12, 12, (KEYPOINTS, 2))
    angles = rng.uniform(-0.5, 0.5, 40)
    rot = np.stack([np.stack([np.cos(angles), -np.sin(angles)], -1),
                    np.stack([np.sin(angles), np.cos(angles)], -1)], -2)
    kp = np.einsum("nij,kj->nki", rot, template) + rng.uniform(24, 40, (40, 1, 2)) + rng.normal(0, 1.0, (40, KEYPOINTS, 2))
    kp[5, 2] = np.nan
    dataset = SimpleNamespace(keypoints_resized=lambda i: kp[i].astype(np.float32), num_keypoints=KEYPOINTS)
    return SimpleNamespace(dataset=dataset, train_dataset=SimpleNamespace(indices=np.arange(40)))


def _batches(seed: int = 1):
    """A labeled cache of 8 rows and three unlabeled windows (uint8 frames
    of a 60x80 video resized to 64 px, and their full-frame bboxes)."""
    rng = np.random.default_rng(seed)
    cache = {
        "images": rng.integers(0, 256, (8, IMAGE, IMAGE, 3), dtype=np.uint8),
        "keypoints": rng.uniform(4, IMAGE - 4, (8, KEYPOINTS, 2)).astype(np.float32),
        "visibility": np.full((8, KEYPOINTS), 2, dtype=np.int64),
        "bbox": np.tile(np.array([0.0, 0.0, IMAGE, IMAGE], np.float32), (8, 1)),
    }
    cache["keypoints"][2, 1] = np.nan
    cache["visibility"][2, 1] = 0
    windows = [
        {"frames": rng.integers(0, 256, (WINDOW, IMAGE, IMAGE, 3), dtype=np.uint8),
         "bbox": np.tile(np.array([0.0, 0.0, 60.0, 80.0], np.float32), (WINDOW, 1))}
        for _ in range(3)
    ]
    return cache, windows


def _jax_video_draws(rng, t: int, h: int, w: int):
    """The JAX video augmentation's draws from ``rng`` as the port's."""
    from lightning_pose_tpu_torch.ops.video_augment import VideoDraws

    keys = jax.random.split(rng, 6)

    def u(key, shape, lo, hi):
        return torch.from_numpy(np.array(jax.random.uniform(key, shape, minval=lo, maxval=hi)))

    return VideoDraws(
        angle_deg=u(keys[0], (), -10.0, 10.0), scale=u(keys[1], (2,), 0.8, 1.2),
        brightness=u(keys[2], (), 0.75, 1.25), contrast=u(keys[3], (), 0.75, 1.25),
        shot_factor=u(keys[4], (), 0.0, 10.0),
        noise=torch.from_numpy(np.array(jax.random.normal(keys[5], (t, h, w, 3), dtype=jnp.float32))),
    )


def _setup(peaked_jax_variables, dtype):
    """Config, data module, the JAX module and its init with a peaked head
    (so the decode's confidences pass the temporal loss's threshold)."""
    from lightning_pose_tpu.models.factory import get_model as jax_get_model

    cfg = _cfg()
    module, meta = jax_get_model(cfg, num_keypoints=KEYPOINTS, compute_dtype=dtype)
    params, stats = peaked_jax_variables(module, IMAGE)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), params)
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), stats)
    return cfg, _data_module(), module, meta, params, stats


def test_fp32_semisupervised_trajectory_matches_jax(peaked_jax_variables):
    """Three fp32 steps of the JAX ``train_step`` with an ``unlabeled``
    window against the port's, its video draws replayed, at a learning rate
    of 1e-5 (see TRAJ_LR). The labeled pipeline is the identity with
    ``is_dlc`` set on both engines, so that the video augmentation is
    geometric as under ``dlc``."""
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.ops.augment import AugmentationEngine as JaxEngine
    from lightning_pose_tpu.train import trainer as jtrainer
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    cfg, dm, module, meta, params, stats = _setup(peaked_jax_variables, jnp.float32)
    cfg.training.optimizer_params.learning_rate = TRAJ_LR
    cache, windows = _batches()
    jengine, engine = JaxEngine("none", IMAGE, IMAGE), AugmentationEngine("none", IMAGE, IMAGE)
    jengine.is_dlc = engine.is_dlc = True
    tx, _, _ = jtrainer.make_optimizer(cfg, SPE, params)
    jstate = jtrainer.TrainState(step=jnp.asarray(0, jnp.int32), params=params, batch_stats=stats,
                                 opt_state=tx.init(params))
    jstep = jtrainer.make_step_fns(module, meta, jax_factories(cfg, dm), jengine, cfg, tx, SPE)[0]

    model = build_model("heatmap", "resnet18", KEYPOINTS)
    load_flax_variables(model, params, stats)
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, SPE, model)
    state = trainer.TrainState(model=model, optimizer=optimizer)
    step = trainer.make_step_fns({"model_type": "heatmap", "downsample_factor": 2}, get_loss_factories(cfg, dm),
                                 engine, cfg, head_sched, bb_sched, SPE, compute_dtype=torch.float32)[2]
    tcache = {k: torch.from_numpy(v) for k, v in cache.items()}
    valid = torch.ones(LABELED, dtype=torch.bool)
    rng = jax.random.PRNGKey(0)
    unsup_seen = []
    for s, idxs in enumerate([np.array([0, 1, 2, 3]), np.array([4, 5, 6, 7]), np.array([2, 5, 7, 1])]):
        batch = {k: v[idxs] for k, v in cache.items()}
        batch["unlabeled"] = windows[s]
        jstate, jlogs = jstep(jstate, batch, rng)
        video_draws = _jax_video_draws(jax.random.fold_in(jax.random.fold_in(rng, s), 1), WINDOW, IMAGE, IMAGE)
        window = {k: torch.from_numpy(v) for k, v in windows[s].items()}
        logs = step(state, tcache, torch.from_numpy(idxs), valid, None, window, video_draws)
        assert set(logs) == set(jlogs)
        for name in ("total_loss", "train_unsupervised_loss", "train_pca_singleview_loss", "train_temporal_loss"):
            np.testing.assert_allclose(float(logs[name]), float(jlogs[name]), rtol=TRAJ_LOSS_RTOL, err_msg=name)
        unsup_seen.append((float(logs["train_pca_singleview_loss"]), float(logs["train_temporal_loss"])))
    assert state.step == 3
    assert all(p > 0 and t > 0 for p, t in unsup_seen), unsup_seen

    out_params, out_stats = state_dict_to_flax(model.state_dict())
    np.testing.assert_allclose(_flat(out_stats), _flat(jstate.batch_stats), rtol=0, atol=TRAJ_STATS_TOL)
    ref_flat, out_flat = _flat(jstate.params), _flat(out_params)
    assert np.abs(ref_flat - _flat(params)).max() > 2 * TRAJ_LR  # the head moved by about 3 lr
    diff = np.abs(out_flat - ref_flat)
    assert float((diff > TRAJ_PARAM_TOL).mean()) <= TRAJ_PARAM_OFF_SHARE
    assert float(diff.max()) <= TRAJ_PARAM_MAX


def _jax_decode64(heatmaps_nhwc, df: int = 2):
    """The JAX package's XLA decode in float64 (its pieces; the function
    itself casts the maps to float32 before the upsample)."""
    from lightning_pose_tpu.data.heatmaps import evaluate_heatmaps_at_location
    from lightning_pose_tpu.ops.pallas_decode import upsample_matrix
    from lightning_pose_tpu.ops.softargmax import spatial_expectation2d, spatial_softmax2d

    h, w = heatmaps_nhwc.shape[1:3]
    mh = jnp.asarray(upsample_matrix(h, df), jnp.float64)
    mw = jnp.asarray(upsample_matrix(w, df), jnp.float64)
    up = jnp.einsum("ph,bhwk,qw->bpqk", mh, heatmaps_nhwc, mw)
    softmaxes = spatial_softmax2d(up, temperature=1000.0)
    preds = spatial_expectation2d(softmaxes)
    confidences = evaluate_heatmaps_at_location(softmaxes, preds)
    preds = preds - 1.5
    return preds.reshape(preds.shape[0], -1), confidences


def _jax_apply64(module, params, batch_stats, images):
    """The JAX model in train mode, float64 throughout: its head casts the
    last deconvolution's output to float32 before the softmax, so the
    softmax is taken here, in float64, on that output as captured. Returns
    the heatmaps and the updated BatchNorm statistics."""
    from lightning_pose_tpu.ops.softargmax import spatial_softmax2d

    _, state = module.apply({"params": params, "batch_stats": batch_stats}, images, train=True,
                            mutable=["batch_stats", "intermediates"],
                            capture_intermediates=lambda mdl, _: mdl.name == "deconv1")
    logits = state["intermediates"]["head"]["deconv1"]["__call__"][0]
    assert logits.dtype == jnp.float64
    return spatial_softmax2d(logits, temperature=1.0), state["batch_stats"]


def test_float64_semisupervised_loss_and_gradients_match_jax(peaked_jax_variables):
    """The JAX step's loss function with an unlabeled window, in float64
    (where the JAX package casts to float32, in its head and its decode,
    the same operations are taken in float64): labeled forward and loss,
    then the window (augmented by the JAX package, geometric) through a
    second train-mode forward, the decode, the undo transform, model to
    frame, and the unsupervised factory. The port's step runs the same
    through ``trainer.unsupervised_loss``. Loss, every parameter's gradient
    and the chained BatchNorm statistics."""
    from lightning_pose_tpu.data.bboxes import model_to_frame_batch as jax_model_to_frame
    from lightning_pose_tpu.data.heatmaps import generate_heatmaps as jax_generate_heatmaps
    from lightning_pose_tpu.data.video import undo_affine_transform_batch as jax_undo
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.ops.preprocess import normalize_images as jax_normalize
    from lightning_pose_tpu.ops.video_augment import augment_video_sequence as jax_augment
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax
    from lightning_pose_tpu_torch.train.trainer import unsupervised_loss

    cache, windows = _batches()
    idxs = np.array([0, 1, 2, 3])
    frames, transforms = jax_augment(jax.random.PRNGKey(9), jnp.asarray(windows[0]["frames"]), apply_geometric=True)
    transforms = np.asarray(transforms, np.float64)
    with jax.enable_x64(True):
        cfg, dm, module, _, params, stats = _setup(peaked_jax_variables, jnp.float64)
        images = np.asarray(jax_normalize(jnp.asarray(cache["images"][idxs], jnp.float64)), np.float64)
        ul_images = np.asarray(jax_normalize(jnp.asarray(frames, jnp.float64)), np.float64)
        targets = jax_generate_heatmaps(jnp.asarray(cache["keypoints"][idxs], jnp.float64), IMAGE, IMAGE, (16, 16),
                                        visibility=jnp.asarray(cache["visibility"][idxs]))
        variables64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                             {"params": params, "batch_stats": stats})
        factories = jax_factories(cfg, dm)
        ul_bbox = jnp.asarray(windows[0]["bbox"], jnp.float64)

        def jax_loss(p):
            heatmaps, batch_stats = _jax_apply64(module, p, variables64["batch_stats"], jnp.asarray(images))
            sup, _ = factories["supervised"](stage="train", anneal_weight=None,
                                             heatmaps_targ=targets.astype(jnp.float64), heatmaps_pred=heatmaps)
            ul_heatmaps, batch_stats = _jax_apply64(module, p, batch_stats, jnp.asarray(ul_images))
            preds, confs = _jax_decode64(ul_heatmaps)
            preds = jax_model_to_frame(jax_undo(preds, jnp.asarray(transforms)), ul_bbox, IMAGE, IMAGE)
            unsup, logs = factories["unsupervised"](stage="train", anneal_weight=1.0, keypoints_pred=preds,
                                                    heatmaps_pred=ul_heatmaps, confidences=confs)
            return sup + unsup, (batch_stats, unsup, logs)

        (ref_loss, (ref_stats, ref_unsup, ref_logs)), ref_grads = jax.jit(
            jax.value_and_grad(jax_loss, has_aux=True))(variables64["params"])
        ref_loss, ref_unsup = float(ref_loss), float(ref_unsup)
        ref_parts = {k: float(ref_logs[k]) for k in ("train_pca_singleview_loss", "train_temporal_loss")}
        ref_grads, ref_stats = (jax.tree_util.tree_map(np.asarray, t) for t in (ref_grads, ref_stats))
        targets = np.asarray(targets).transpose(0, 3, 1, 2)

    model = build_model("heatmap", "resnet18", KEYPOINTS)
    load_flax_variables(model, params, stats)
    model = model.double().train()
    factories = get_loss_factories(cfg, dm)
    heatmaps = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    sup, _ = factories["supervised"](stage="train", anneal_weight=None, heatmaps_targ=torch.from_numpy(targets),
                                     heatmaps_pred=heatmaps)
    unsup, logs = unsupervised_loss(
        model, torch.from_numpy(ul_images).permute(0, 3, 1, 2), torch.from_numpy(transforms),
        torch.from_numpy(windows[0]["bbox"]).double(), factories["unsupervised"], 1.0, (IMAGE, IMAGE),
        compute_dtype=torch.float64,
    )
    loss = sup + unsup
    loss.backward()
    assert min(ref_parts.values()) > 0 and float(unsup.detach()) > 0.1 * float(loss.detach())
    np.testing.assert_allclose(float(loss), ref_loss, rtol=F64_RTOL)
    np.testing.assert_allclose(float(unsup), ref_unsup, rtol=F64_RTOL)
    for name, value in ref_parts.items():
        np.testing.assert_allclose(float(logs[name]), value, rtol=F64_RTOL, err_msg=name)
    grads, out_stats = state_dict_to_flax(
        {**model.state_dict(), **{n: p.grad for n, p in model.named_parameters()}}
    )
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    for (path, ref), out in zip(flat_ref, jax.tree_util.tree_leaves(grads)):
        if jax.tree_util.keystr(path).endswith("['deconv1']['bias']"):
            continue  # the last bias shifts every logit of a map: its gradient is 0 up to rounding
        np.testing.assert_allclose(out, ref, rtol=0, atol=F64_RTOL * np.abs(ref).max(), err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(_flat(out_stats), _flat(ref_stats), rtol=0, atol=1e-9)


# -- train() end to end ------------------------------------------------------------------

# the port's and the JAX package's fp32 predictions from one checkpoint
E2E_PX_TOL = 1e-3


@pytest.fixture(scope="module")
def semisup_trained_dir(tmp_path_factory):
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.train.trainer import train
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    root = tmp_path_factory.mktemp("port_semisup_train")
    data = write_labeled_dataset(root / "data", 24, 130, 140, NAMES, seed=4)
    for i in range(2):
        write_unlabeled_video(data, f"session{i}", 10, 120, 160, seed=i)
    cfg = load_config()
    cfg.data.data_dir = str(data)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = "portsemi"
    cfg.model.losses_to_use = ["pca_singleview", "temporal"]
    cfg.losses.temporal.epsilon = 0.0
    cfg.losses.temporal.prob_threshold = 0.0
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.dali.base.train.sequence_length = 4
    cfg.training.train_batch_size = 4
    cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
    cfg.training.max_steps = cfg.training.min_steps = 3
    cfg.training.unfreezing_step = 1
    cfg.training.lr_scheduler_params.multisteplr.milestones = None
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [2]
    cfg.training.log_every_n_steps = 1
    model_dir = root / "model"
    result = train(cfg, model_dir, skip_evaluation=True, device="cpu")
    return model_dir, result


def test_semisupervised_train_writes_a_model_dir_both_packages_read(semisup_trained_dir):
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    model_dir, result = semisup_trained_dir
    assert json.loads((model_dir / "train_status.json").read_text())["status"] == "COMPLETED"
    ckpts = sorted(p.name for p in (model_dir / "tb_logs" / "portsemi" / "version_0" / "checkpoints").iterdir())
    assert ckpts == ["epoch=0-step=3-best.ckpt", "epoch=0-step=3-last.ckpt"]
    steps = [h for h in result.history if "train_unsupervised_loss" in h]
    assert [h["step"] for h in steps] == [1, 2, 3]
    assert all(np.isfinite(v) for h in steps for v in h.values())
    assert any(h["train_temporal_loss"] > 0 for h in steps)
    assert all(h["total_unsupervised_importance"] == 1.0 for h in steps)
    assert not any(t.is_alive() for t in result.data_module.unlabeled_loader._threads)
    frame = np.random.default_rng(5).integers(0, 256, (130, 140, 3), dtype=np.uint8)
    ref = JaxModel.from_dir(model_dir, precision="fp32").predict_frame(frame)
    out = Model.from_dir(model_dir, precision="fp32", device="cpu").predict_frame(frame)
    assert np.isfinite(out["keypoints"]).all()
    np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=0, atol=E2E_PX_TOL)
