"""Slice 11, training and serving the heatmap models on multiview data
against the JAX package: the port's train step of ``heatmap`` and of
``heatmap_mhcrnn`` (the views folded into the batch for the augmentation
and the model, the ``V*K`` maps against view-major targets; then
``pca_multiview`` + ``temporal`` over a synchronized 2-view window,
augmented photometrically, the context model's windows tiled a view) in
float64 against the JAX step's loss function on the same augmented arrays;
``train()`` of both models writing the JAX package's file names; and
prediction from each directory by the other package (the labeled CSVs, a
2-view session, ``predict_frame``), the port's directory read by the JAX
``Model``, and a directory the JAX package's ``train()`` wrote read by the
port's (mirroring the JAX package's tests/test_train.py:372 and :440)."""

from __future__ import annotations

import json
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lightning_pose_tpu.models import heatmap_tracker_mhcrnn as jtracker

IMAGE = 64
KEYPOINTS = 3
NAMES = ["nose", "ear", "tail"]
VIEWS = ["top", "bot"]
LABELED = 2
WINDOW = 6
SPE = 10
MODEL_TYPES = ["heatmap", "heatmap_mhcrnn"]
# float64: the same loss and gradients, leaf by leaf, relative to each
# leaf's largest entry
F64_RTOL = 1e-6
# fp32 on the CPU in both packages, one checkpoint: convolution sums in
# another order, magnified by the temperature-1000 decode
PX_TOL = 1e-3
CONF_TOL = 1e-4


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


# -- the train steps in float64 ------------------------------------------------------------


def _step_cfg(model_type: str):
    """resnet18 at 64 px on 2 views of 3 keypoints, pca_multiview (the flat
    per-view matches) + temporal at weight 1/2, epsilons 0, the anneal
    weight 1 from epoch 0."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.view_names = list(VIEWS)
    cfg.data.mirrored_column_matches = list(range(KEYPOINTS))
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.model_type = model_type
    cfg.model.backbone = "resnet18"
    cfg.model.losses_to_use = ["pca_multiview", "temporal"]
    for name in ("pca_multiview", "temporal"):
        cfg.losses[name].log_weight = 0.0
        cfg.losses[name].epsilon = 0.0
    cfg.losses.temporal.prob_threshold = 0.0
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.training.max_epochs = cfg.training.min_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
    return cfg


def _pca_data_module(seed: int = 0):
    """What the PCA fit reads of a data module: 30 rows of 2 views of one
    rigid 3D body (orthographic cameras 90 degrees apart)."""
    rng = np.random.default_rng(seed)
    body = rng.uniform(-10, 10, (KEYPOINTS, 3))
    angles = rng.uniform(-0.6, 0.6, 30)
    rot = np.stack([np.stack([np.cos(angles), np.zeros(30), np.sin(angles)], -1), np.tile([0.0, 1.0, 0.0], (30, 1)),
                    np.stack([-np.sin(angles), np.zeros(30), np.cos(angles)], -1)], -2)
    pts = np.einsum("nij,kj->nki", rot, body) + rng.uniform(24, 40, (30, 1, 3))
    views = np.concatenate([pts[..., [0, 1]], pts[..., [2, 1]]], axis=1) + rng.normal(0, 0.5, (30, 2 * KEYPOINTS, 2))
    dataset = SimpleNamespace(keypoints_resized=lambda i: views[i].astype(np.float32),
                              num_keypoints=2 * KEYPOINTS, view_names=list(VIEWS))
    return SimpleNamespace(dataset=dataset, train_dataset=SimpleNamespace(indices=np.arange(30)))


def _jax_maps64(module, params, stats, images, context: bool):
    """The JAX model in train mode, float64 throughout, on views ``(B, V,
    ...)``: its heads cast to float32 before their softmax, so the logits
    are rebuilt from the captured float64 outputs of the folded ``B*V``
    images (the heatmap head's last deconv; the context model's single-frame
    deconv and its CRNN's last W_f, W_b and H_*_deconv calls), softmaxed
    here and unfolded into view-major channels. Returns the maps (both
    heads' for the context model) and the updated BatchNorm statistics."""
    from lightning_pose_tpu.ops.softargmax import spatial_softmax2d

    b = images.shape[0]
    names = {"deconv1", "W_f", "W_b", "H_f_deconv", "H_b_deconv"}
    _, state = module.apply({"params": params, "batch_stats": stats}, images, train=True,
                            mutable=["batch_stats", "intermediates"],
                            capture_intermediates=lambda mdl, _: mdl.name in names)
    head = state["intermediates"]["head"]

    def unfold(logits):
        assert logits.dtype == jnp.float64
        return jtracker._unfold_view_channels(spatial_softmax2d(logits, temperature=1.0), b, len(VIEWS))

    if not context:
        return unfold(head["deconv1"]["__call__"][0]), state["batch_stats"]
    mf = head["head_mf"]
    x_f = mf["W_f"]["__call__"][-1] + mf["H_f_deconv"]["__call__"][-1]
    x_b = mf["W_b"]["__call__"][-1] + mf["H_b_deconv"]["__call__"][-1]
    return (unfold(head["head_sf"]["deconv1"]["__call__"][0]), unfold((x_f + x_b) / 2)), state["batch_stats"]


def _jax_decode64(heatmaps_nhwc, df: int = 2):
    """The JAX package's XLA decode in float64 (its pieces; the function
    casts the maps to float32 before the upsample)."""
    from lightning_pose_tpu.data.heatmaps import evaluate_heatmaps_at_location
    from lightning_pose_tpu.ops.pallas_decode import upsample_matrix
    from lightning_pose_tpu.ops.softargmax import spatial_expectation2d, spatial_softmax2d

    h, w = heatmaps_nhwc.shape[1:3]
    up = jnp.einsum("ph,bhwk,qw->bpqk", jnp.asarray(upsample_matrix(h, df), jnp.float64), heatmaps_nhwc,
                    jnp.asarray(upsample_matrix(w, df), jnp.float64))
    softmaxes = spatial_softmax2d(up, temperature=1000.0)
    preds = spatial_expectation2d(softmaxes)
    confidences = evaluate_heatmaps_at_location(softmaxes, preds)
    preds = preds - 1.5
    return preds.reshape(preds.shape[0], -1), confidences


def _float64_steps(model_type: str):
    """The port's train steps (supervised, then semi-supervised) in float64
    from one init, with dlc draws for each view image (a view's 5 frames
    under its one draw for the context model), and the JAX reference of
    both: loss, gradients and BatchNorm statistics. The JAX reference is
    handed the same augmented, normalized arrays."""
    from lightning_pose_tpu.data.bboxes import model_to_frame_batch as jax_model_to_frame
    from lightning_pose_tpu.data.heatmaps import generate_heatmaps as jax_generate_heatmaps
    from lightning_pose_tpu.data.video import undo_affine_transform_batch as jax_undo
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.models.factory import get_model as jax_get_model
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model, model_meta
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images
    from lightning_pose_tpu_torch.ops.video_augment import augment_video_sequence, sample_video_draws
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    context = model_type == "heatmap_mhcrnn"
    cfg, dm = _step_cfg(model_type), _pca_data_module()
    nv = len(VIEWS)
    stack = (5,) if context else ()
    rng = np.random.default_rng(1)
    cache = {
        "images": torch.from_numpy(rng.integers(0, 256, (LABELED, nv, *stack, IMAGE, IMAGE, 3), dtype=np.uint8)),
        "keypoints": torch.from_numpy(rng.uniform(8, IMAGE - 8, (LABELED, nv * KEYPOINTS, 2)).astype(np.float32)),
        "visibility": torch.full((LABELED, nv * KEYPOINTS), 2, dtype=torch.int64),
        "bbox": torch.tensor([[0.0, 0.0, IMAGE, IMAGE, 4.0, 2.0, 50.0, 70.0]] * LABELED),
    }
    window = {"frames": torch.from_numpy(rng.integers(0, 256, (WINDOW, nv, IMAGE, IMAGE, 3), dtype=np.uint8)),
              "bbox": torch.tensor([[0.0, 0.0, 60.0, 80.0, 0.0, 0.0, 70.0, 90.0]] * WINDOW)}
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    gen = torch.Generator().manual_seed(3)
    draws = engine.sample(gen, LABELED * nv)
    video_draws = sample_video_draws(gen, WINDOW * nv, IMAGE, IMAGE)

    # the arrays each step sees
    flat = cache["images"].reshape(LABELED * nv, *cache["images"].shape[2:])
    images, keypoints, vis = engine.apply(flat, cache["keypoints"].reshape(LABELED * nv, KEYPOINTS, 2),
                                          cache["visibility"].reshape(LABELED * nv, KEYPOINTS), draws)
    images = images.reshape(LABELED, nv, *images.shape[1:])
    keypoints, vis = keypoints.reshape(LABELED, -1, 2), vis.reshape(LABELED, -1)
    visibility = torch.where(torch.isnan(keypoints[..., 0]) & (vis == 2), 0, vis)
    frames, transforms = augment_video_sequence(window["frames"].reshape(WINDOW * nv, IMAGE, IMAGE, 3), video_draws,
                                                apply_geometric=False)
    images64 = normalize_images(images).double().numpy()
    frames64 = normalize_images(frames.reshape(WINDOW, nv, IMAGE, IMAGE, 3)).double().numpy()
    transforms64 = transforms[:WINDOW].double().numpy()

    module, meta = jax_get_model(cfg, num_keypoints=KEYPOINTS, compute_dtype=jnp.float64)
    assert meta["num_views"] == nv == model_meta(cfg)["num_views"]
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, *stack, IMAGE, IMAGE, 3)), train=False)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables["params"])
    stats = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables["batch_stats"])
    for layer in (params["head"]["head_sf"] if context else params["head"]).values():  # peaked maps
        layer["kernel"] = layer["kernel"] * 300.0

    with jax.enable_x64(True):
        targets = jax_generate_heatmaps(jnp.asarray(keypoints.numpy()), IMAGE, IMAGE, (16, 16),
                                        visibility=jnp.asarray(visibility.numpy())).astype(jnp.float64)
        factories = jax_factories(cfg, dm)
        p64, s64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t) for t in (params, stats))
        ul_bbox = jnp.asarray(window["bbox"].numpy(), jnp.float64)
        ul_transforms = jnp.asarray(transforms64)

        def jax_loss(p, unsup_weight):
            maps, stats1 = _jax_maps64(module, p, s64, jnp.asarray(images64), context)
            if context:
                sup, _ = factories["supervised"](stage="train", anneal_weight=None,
                                                 heatmaps_targ=jnp.concatenate([targets, targets]),
                                                 heatmaps_pred=jnp.concatenate(maps))
                # each view's sliding windows, (T-4, V, 5, ...)
                windows = jtracker.make_context_windows(jnp.asarray(frames64)).transpose(0, 2, 1, 3, 4, 5)
                (ul_sf, ul_mf), stats2 = _jax_maps64(module, p, stats1, windows, context)
                preds, confs = jtracker.merge_heads_by_confidence(*_jax_decode64(ul_sf), *_jax_decode64(ul_mf))
                preds = jax_undo(preds, ul_transforms[2:-2])
                preds = jax_model_to_frame(preds, ul_bbox[2:-2], IMAGE, IMAGE, num_views=nv)
                ul_maps = ul_mf
            else:
                sup, _ = factories["supervised"](stage="train", anneal_weight=None, heatmaps_targ=targets,
                                                 heatmaps_pred=maps)
                ul_maps, stats2 = _jax_maps64(module, p, stats1, jnp.asarray(frames64), context)
                preds, confs = _jax_decode64(ul_maps)
                preds = jax_model_to_frame(jax_undo(preds, ul_transforms), ul_bbox, IMAGE, IMAGE, num_views=nv)
            unsup, logs = factories["unsupervised"](stage="train", anneal_weight=1.0, keypoints_pred=preds,
                                                    heatmaps_pred=ul_maps, confidences=confs)
            parts = {k: logs[k] for k in ("train_pca_multiview_loss", "train_temporal_loss")}
            return sup + unsup_weight * unsup, (stats1, stats2, unsup, parts)

        fn = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))  # one compile for both steps
        ref = {}
        for kind, weight in (("supervised", 0.0), ("semi", 1.0)):
            (loss, (stats1, stats2, unsup, parts)), grads = fn(p64, jnp.asarray(weight, jnp.float64))
            ref[kind] = {"loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, grads),
                         "stats": jax.tree_util.tree_map(np.asarray, stats1 if weight == 0 else stats2),
                         "unsup": float(unsup), "parts": {k: float(v) for k, v in parts.items()}}

    out = {}
    to_nchw = trainer._to_nchw
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "_to_nchw", lambda x: to_nchw(x).double())
        for kind in ("supervised", "semi"):
            model = build_model(model_type, "resnet18", KEYPOINTS, image_size=IMAGE)
            load_flax_variables(model, params, stats)
            model = model.double()
            optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, SPE, model)
            state = trainer.TrainState(model=model, optimizer=optimizer)
            step = trainer.make_step_fns(model_meta(cfg), get_loss_factories(cfg, dm), engine, cfg,
                                         head_sched, bb_sched, SPE, compute_dtype=torch.float64)[2]
            unlabeled = window if kind == "semi" else None
            logs = step(state, cache, torch.arange(LABELED), torch.ones(LABELED, dtype=torch.bool), draws,
                        unlabeled, video_draws if unlabeled else None)
            grads, out_stats = state_dict_to_flax(
                {**model.state_dict(), **{n: p.grad for n, p in model.named_parameters()}})
            out[kind] = {"logs": logs, "grads": grads, "stats": out_stats}
    return ref, out


@pytest.fixture(scope="module")
def float64_steps():
    return {model_type: _float64_steps(model_type) for model_type in MODEL_TYPES}


@pytest.mark.parametrize("kind", ["supervised", "semi"])
@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_float64_train_step_matches_jax(float64_steps, model_type, kind):
    """The port's train step against the JAX step's loss: supervised, the
    views folded into the batch (the context model's 2 heads against the
    view-major targets twice); semi-supervised, plus the 2-view window
    through a second train-mode forward (the context model's windows tiled
    a view, both heads decoded and merged), the ``V*K`` keypoints mapped to
    each view's frame, ``pca_multiview`` and ``temporal``. The loss, the
    unsupervised terms, every parameter's gradient and the chained
    BatchNorm statistics."""
    ref, out = float64_steps[model_type]
    ref, out = ref[kind], out[kind]
    np.testing.assert_allclose(float(out["logs"]["total_loss"]), ref["loss"], rtol=F64_RTOL)
    if kind == "semi":
        assert min(ref["parts"].values()) > 0
        np.testing.assert_allclose(float(out["logs"]["train_unsupervised_loss"]), ref["unsup"], rtol=F64_RTOL)
        for name, value in ref["parts"].items():
            np.testing.assert_allclose(float(out["logs"][name]), value, rtol=F64_RTOL, err_msg=name)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    flat_out = jax.tree_util.tree_leaves(out["grads"])
    assert len(flat_ref) == len(flat_out)
    for (path, r), o in zip(flat_ref, flat_out):
        name = jax.tree_util.keystr(path)
        if name.endswith("['deconv1']['bias']") and "head_mf" not in name:
            continue  # the last bias shifts every logit of a map: its gradient is 0 up to rounding
        np.testing.assert_allclose(o, r, rtol=0, atol=F64_RTOL * np.abs(r).max(), err_msg=name)
    np.testing.assert_allclose(_flat(out["stats"]), _flat(ref["stats"]), rtol=0, atol=1e-9)


@pytest.mark.parametrize("model_type", ["heatmap", "heatmap_mhcrnn", "heatmap_multiview"])
def test_hflip_swap_over_all_views_fails_as_in_jax(model_type):
    """``training.imgaug_hflip`` on multiview data: the JAX package's step
    fails on its swap indices (every view's keypoints) against a folded
    image's keypoints (one view's), whatever the multiview model; the port's
    step refuses it up front with the same ValueError. ``dlc-lr``'s plain
    mirror swaps nothing and trains."""
    from lightning_pose_tpu.ops.augment import AugmentationEngine as JaxEngine
    from lightning_pose_tpu_torch.losses.factory import LossFactory
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import trainer

    cfg = _step_cfg("heatmap")
    swaps = np.arange(len(VIEWS) * KEYPOINTS)
    kp = jnp.full((2 * len(VIEWS), KEYPOINTS, 2), 20.0)
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        JaxEngine("dlc", IMAGE, IMAGE, hflip=True, hflip_swap_indices=swaps)(
            jax.random.PRNGKey(0), jnp.zeros((2 * len(VIEWS), IMAGE, IMAGE, 3)), kp)
    _, ref_kp = JaxEngine("dlc-lr", IMAGE, IMAGE, hflip_swap_indices=swaps)(
        jax.random.PRNGKey(0), jnp.zeros((2 * len(VIEWS), IMAGE, IMAGE, 3)), kp)
    assert ref_kp.shape == kp.shape
    factories = {"supervised": LossFactory({"heatmap_mse": {"log_weight": 0.0}})}
    meta = {"model_type": model_type, "downsample_factor": 2, "num_views": len(VIEWS)}
    with pytest.raises(ValueError, match="Incompatible shapes for broadcasting"):
        trainer.make_step_fns(meta, factories, AugmentationEngine("dlc", IMAGE, IMAGE, hflip=True), cfg,
                              None, None, SPE)
    assert trainer.make_step_fns(meta, factories, AugmentationEngine("dlc-lr", IMAGE, IMAGE), cfg, None, None, SPE)


# -- train() and prediction from its directories ------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    """14 labeled frames of 2 views in the split layout (``top.csv``,
    ``bot.csv``; consecutive names, so context stacks find their
    neighbours) and a 2-view 20-frame session."""
    from lightning_pose_tpu_torch.utils.synthetic import write_multiview_dataset, write_multiview_videos

    root = write_multiview_dataset(tmp_path_factory.mktemp("port_mv_heatmap_train") / "data", 14, 100, 120, NAMES,
                                   VIEWS, seed=5, csv_name="{view}.csv")
    write_multiview_videos(root, "test_vid", 20, 100, 120, VIEWS, seed=6)
    return root


def _train_cfg(data_dir: Path, model_type: str, name: str):
    """resnet18 at 128 px, batch 4 of 2 views, dlc, 2 steps in step mode,
    semi-supervised with pca_multiview over a 6-frame 2-view window (the
    anneal weight 1, epsilon 0), the test session predicted after training
    in 8-frame batches (overlapping by 4 for the context model)."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.csv_file = [f"{v}.csv" for v in VIEWS]
    cfg.data.view_names = list(VIEWS)
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.mirrored_column_matches = list(range(KEYPOINTS))
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.model_type = model_type
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = name
    cfg.model.losses_to_use = ["pca_multiview"]
    cfg.losses.pca_multiview.epsilon = 0.0
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.training.imgaug = "dlc"
    cfg.training.train_batch_size = cfg.training.val_batch_size = cfg.training.test_batch_size = 4
    cfg.training.train_prob, cfg.training.val_prob = 0.7, 0.3
    cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
    cfg.training.max_steps = cfg.training.min_steps = 2
    cfg.training.unfreezing_step = 1
    cfg.training.lr_scheduler_params.multisteplr.milestones = None
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
    cfg.training.check_val_every_n_epoch = 1
    cfg.training.log_every_n_steps = 1
    cfg.eval.predict_vids_after_training = True
    cfg.eval.test_videos_directory = str(data_dir / "videos")
    cfg.dali.base.train.sequence_length = 6
    cfg.dali.base.predict.sequence_length = cfg.dali.context.predict.sequence_length = 8
    return cfg


@pytest.fixture(scope="module")
def trained_dirs(data_dir, tmp_path_factory) -> dict[str, tuple[Path, object]]:
    """The port's train() on the CPU of both models, semi-supervised, with
    evaluation, its compute type set to fp32 so that the evaluation can be
    held to the JAX package's fp32 prediction."""
    from lightning_pose_tpu_torch.train import trainer

    root = tmp_path_factory.mktemp("port_mv_heatmap_trained")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "COMPUTE_DTYPE", torch.float32)
        for model_type in MODEL_TYPES:
            result = trainer.train(_train_cfg(data_dir, model_type, model_type), root / model_type, device="cpu")
            out[model_type] = (root / model_type, result)
    return out


def _files(model_dir: Path) -> list[str]:
    return sorted(str(p.relative_to(model_dir)) for p in model_dir.rglob("*") if p.is_file())


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_train_writes_the_jax_file_names(trained_dirs, model_type):
    """The JAX package's train() writes these for a multiview model with a
    test session: one image_preds directory, legacy copy and video CSV a
    view (no PCA metric on a true-multiview data module); the unsupervised
    term is logged at every step and the stream's thread is stopped."""
    model_dir, result = trained_dirs[model_type]
    files = [f for f in _files(model_dir) if not f.startswith("tb_logs") or f.endswith(".ckpt")]
    expected = ["config.yaml", "train_status.json",
                f"tb_logs/{model_type}/version_0/checkpoints/epoch=0-step=2-best.ckpt",
                f"tb_logs/{model_type}/version_0/checkpoints/epoch=0-step=2-last.ckpt"]
    for view in VIEWS:
        csv = f"{view}.csv"
        expected += [csv, f"image_preds/{csv}/predictions.csv", f"image_preds/{csv}/predictions_pixel_error.csv",
                     f"predictions_{view}.csv", f"predictions_{view}_pixel_error.csv",
                     f"video_preds/test_vid_{view}.csv", f"video_preds/test_vid_{view}_temporal_norm.csv"]
    assert files == sorted(expected)
    assert json.loads((model_dir / "train_status.json").read_text())["status"] == "COMPLETED"
    steps = [h for h in result.history if "total_loss" in h]
    assert [h["step"] for h in steps] == [1, 2] and all(np.isfinite(v) for h in steps for v in h.values())
    assert all("train_pca_multiview_loss" in h for h in steps)
    assert not result.data_module.unlabeled_loader._thread.is_alive()
    for view in VIEWS:
        video = _read(model_dir / "video_preds" / f"test_vid_{view}.csv")
        assert video.shape == (20, 3 * KEYPOINTS) and np.isfinite(video.to_numpy()).all()


def _read(path: Path) -> pd.DataFrame:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _assert_same_predictions(out: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert out.index.equals(ref.index) and list(out.columns) == list(ref.columns)
    coords = out.columns.get_level_values("coords")
    xy, conf = np.isin(coords, ["x", "y"]), coords == "likelihood"
    np.testing.assert_allclose(out.loc[:, xy].to_numpy(float), ref.loc[:, xy].to_numpy(float), rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(out.loc[:, conf].to_numpy(float), ref.loc[:, conf].to_numpy(float),
                               rtol=0, atol=CONF_TOL)


def _frames(model_type: str) -> np.ndarray:
    """Two inputs of predict_frame: one frame a view, or a 5-frame stack a
    view for the context model."""
    stack = (5,) if model_type == "heatmap_mhcrnn" else ()
    return np.random.default_rng(7).integers(0, 256, (2, len(VIEWS), *stack, 100, 120, 3), dtype=np.uint8)


def _predict_both(model_dir: Path, data_dir: Path, out_dir: Path, model_type: str):
    """The JAX package's and the port's fp32 predictions from one directory:
    the labeled CSVs, the test session and predict_frame, each package
    writing into its own copy of the directory."""
    import shutil

    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    results = {}
    videos = [data_dir / "videos" / f"test_vid_{v}.mp4" for v in VIEWS]
    for name in ("jax", "port"):
        copy = shutil.copytree(model_dir, out_dir / name, ignore=shutil.ignore_patterns("*_preds", "predictions*"))
        model = (JaxModel.from_dir(copy, precision="fp32") if name == "jax"
                 else Model.from_dir(copy, precision="fp32", device="cpu"))
        labeled = model.predict_on_label_csv_multiview([f"{v}.csv" for v in VIEWS], data_dir=data_dir,
                                                       compute_metrics=False)
        video = model.predict_on_video_file_multiview(videos, compute_metrics=False)
        frames = [model.predict_frame(f, bbox=(4, 6, 110, 90)) for f in _frames(model_type)]
        results[name] = (labeled.predictions, video.predictions, frames)
    return results


def _assert_results(results: dict, model_dir: Path | None = None) -> None:
    for view in VIEWS:
        _assert_same_predictions(results["port"][0][view], results["jax"][0][view])
        _assert_same_predictions(results["port"][1][view], results["jax"][1][view])
        assert len(results["port"][1][view]) == 20
        if model_dir is not None:
            _assert_same_predictions(_read(model_dir / "video_preds" / f"test_vid_{view}.csv"),
                                     results["jax"][1][view])
            image_preds = _read(model_dir / "image_preds" / f"{view}.csv" / "predictions.csv")
            _assert_same_predictions(image_preds.iloc[:, :-1], results["jax"][0][view].iloc[:, :-1])
    for out, ref in zip(results["port"][2], results["jax"][2]):
        assert out["keypoints"].shape == (len(VIEWS) * KEYPOINTS, 2)
        np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=0, atol=PX_TOL)
        np.testing.assert_allclose(out["confidence"], ref["confidence"], rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_jax_package_reproduces_the_port_predictions(trained_dirs, data_dir, tmp_path, model_type):
    """The JAX package's Model.from_dir reads the port's directory: its
    labeled-CSV, session (the context model's batches overlapping by 4
    frames, rows moved to their frames in every view) and predict_frame
    predictions equal the port's within 1e-3 px and 1e-4 in likelihood, and
    so do the port's own evaluation files; predict_frame refuses the other
    model's input shape with the JAX package's message."""
    from lightning_pose_tpu_torch.api.model import Model

    model_dir, _ = trained_dirs[model_type]
    _assert_results(_predict_both(model_dir, data_dir, tmp_path, model_type), model_dir)
    model = Model.from_dir(model_dir, device="cpu")
    if model_type == "heatmap":
        with pytest.raises(ValueError, match="Multiview model requires"):
            model.predict_frame(np.zeros((100, 120, 3), dtype=np.uint8))
    else:
        with pytest.raises(ValueError, match="Multiview context model requires"):
            model.predict_frame(np.zeros((5, 100, 120, 3), dtype=np.uint8))


@pytest.fixture(scope="module")
def jax_trained_dirs(data_dir, tmp_path_factory) -> dict[str, Path]:
    """The JAX package's train() of both models, supervised, one step (no
    evaluation)."""
    from lightning_pose_tpu.train import train as jax_train

    root = tmp_path_factory.mktemp("jax_mv_heatmap_trained")
    out = {}
    for model_type in MODEL_TYPES:
        cfg = _train_cfg(data_dir, model_type, f"jax{model_type}")
        cfg.model.losses_to_use = []
        cfg.training.max_steps = cfg.training.min_steps = 1
        cfg.training.unfreezing_step = 0
        cfg.training.lr_scheduler_params.multisteplr.milestone_steps = []
        jax_train(cfg, root / model_type, skip_evaluation=True)
        out[model_type] = root / model_type
    return out


@pytest.mark.parametrize("model_type", MODEL_TYPES)
def test_the_port_reproduces_the_jax_package_predictions(jax_trained_dirs, data_dir, tmp_path, model_type):
    """The port's Model.from_dir reads the JAX package's train() directory
    (a checkpoint with no view count in it: the meta's comes from the
    config): the same labeled-CSV, session and predict_frame predictions
    within 1e-3 px and 1e-4 in likelihood."""
    _assert_results(_predict_both(jax_trained_dirs[model_type], data_dir, tmp_path, model_type))
