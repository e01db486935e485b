"""Slice 10, calibrated multiview training against the JAX package: the
port's train step of the multiview transformer on a calibrated batch (the
3D augmentation before dlc's, both supervised 3D losses on the keypoints
decoded with gradient) in float64 against the JAX step's loss function,
loss and every parameter's gradient within 1e-6 of the leaf's largest
entry; ``train()`` of a calibrated set found by discovery, with its
evaluation, whose ``-last.ckpt`` the JAX package resumes; and the decode's
backward running only when a 3D loss is configured.

The ViT is small (width 64, 2 blocks, 2 heads; width 32 and one block for
``train()``), set in both packages; 3 views."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.models.backbones import vit as jvit
from lightning_pose_tpu_torch.models.backbones import vit as pvit


SMALL_VIT = (64, 2, 2, 16)
# train() and the JAX package's resume of it: width 32, one block, 2 views
TINY_VIT = (32, 1, 2, 16)
TRAIN_VIEWS = ["cam0", "cam1"]
IMAGE = 64
KEYPOINTS = 3
NAMES = ["nose", "ear", "tail"]
VIEWS = ["cam0", "cam1", "cam2"]
LABELED = 2
SPE = 10
FRAME_H, FRAME_W = 240, 320
F64_RTOL = 1e-6
CAMERA_KEYS = ("intrinsic_matrix", "extrinsic_matrix", "distortions")


@pytest.fixture(autouse=True)
def small_vits(monkeypatch):
    monkeypatch.setitem(jvit.VIT_CONFIGS, "vits", SMALL_VIT)
    monkeypatch.setitem(pvit.VIT_CONFIGS, "vits", SMALL_VIT)


def _step_cfg():
    """The multiview transformer at 64 px, dlc and the 3D augmentation, both
    supervised 3D losses (log weights 1 and 2), no patch mask."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.view_names = list(VIEWS)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.model_type = "heatmap_multiview_transformer"
    cfg.model.backbone = "vits_dino"
    cfg.model.losses_to_use = []
    cfg.training.imgaug = "dlc"
    cfg.training.imgaug_3d = True
    cfg.losses.supervised_pairwise_projections = {"log_weight": 1.0}
    cfg.losses.supervised_reprojection_heatmap_mse = {"log_weight": 2.0}
    cfg.training.max_epochs = cfg.training.min_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
    return cfg


def _calibrated_cache(seed: int = 1) -> dict:
    """``LABELED`` samples of 3 views: random uint8 images, the labels (one
    NaN) in model pixels of a per-view crop of the 320x240 frame, whose
    projections of seeded 3D points they are, and the cameras (float32, as
    a dataset gives them)."""
    from lightning_pose_tpu_torch.data.anipose import rodrigues
    from lightning_pose_tpu_torch.utils.synthetic import project_points, synthetic_cameras

    rng = np.random.default_rng(seed)
    nv = len(VIEWS)
    cams = synthetic_cameras(nv, FRAME_H, FRAME_W, span_degrees=120.0, seed=seed)
    extr = np.stack([np.concatenate([rodrigues(r), t[:, None]], axis=1)
                     for r, t in zip(cams["rotations"], cams["translations"])])
    points = rng.uniform(-0.4, 0.4, (LABELED, KEYPOINTS, 3))
    frame = np.stack([project_points(points, cams, v) for v in range(nv)], axis=1)  # (L, V, K, 2)
    x0, y0 = rng.uniform(0, 20, (LABELED, nv)), rng.uniform(0, 15, (LABELED, nv))
    bbox = np.stack([x0, y0, np.full_like(x0, FRAME_H - 20.0), np.full_like(x0, FRAME_W - 30.0)], axis=-1)
    kp = (frame - np.stack([x0, y0], -1)[:, :, None]) * np.array([IMAGE / (FRAME_W - 30.0), IMAGE / (FRAME_H - 20.0)])
    kp[1, 2, 0] = np.nan
    f32 = lambda a: torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32))  # noqa: E731
    return {
        "images": torch.from_numpy(rng.integers(0, 256, (LABELED, nv, IMAGE, IMAGE, 3), dtype=np.uint8)),
        "keypoints": f32(kp.reshape(LABELED, nv * KEYPOINTS, 2)),
        "visibility": torch.full((LABELED, nv * KEYPOINTS), 2, dtype=torch.int64),
        "bbox": f32(bbox.reshape(LABELED, 4 * nv)),
        "intrinsic_matrix": f32(np.broadcast_to(cams["intrinsics"], (LABELED, nv, 3, 3))),
        "extrinsic_matrix": f32(np.broadcast_to(extr, (LABELED, nv, 3, 4))),
        "distortions": f32(np.broadcast_to(cams["distortions"], (LABELED, nv, 5))),
    }


def _jax_softmax_maps(module, params, images):
    """The JAX multiview model's maps in float64: its head casts to float32
    before the softmax, so the logits are rebuilt from the captured float64
    output of its deconv, laid out view-major as the model does."""
    from lightning_pose_tpu.ops.softargmax import spatial_softmax2d

    _, state = module.apply({"params": params}, images, mutable=["intermediates"],
                            capture_intermediates=lambda mdl, _: mdl.name == "deconv0")
    logits = state["intermediates"]["head"]["deconv0"]["__call__"][0]  # (B*V, h, w, K)
    assert logits.dtype == jnp.float64
    b, (h, w) = images.shape[0], logits.shape[1:3]
    logits = jnp.moveaxis(logits.reshape(b, len(VIEWS), h, w, -1), 1, 3).reshape(b, h, w, -1)
    return spatial_softmax2d(logits, temperature=1.0)


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
    return (preds - 1.5).reshape(preds.shape[0], -1), confidences


@pytest.fixture(scope="module")
def float64_step(seeded_jax_variables):
    """The port's calibrated train step in float64 from one init, with dlc
    draws a view image and 3D draws a sample (every sample augmented), and
    the JAX reference: the JAX step's supervised loss (its 3D branch,
    ``train/trainer.py:278-310``) handed the same augmented, normalized
    arrays, and its gradients."""
    from lightning_pose_tpu.data import bboxes as jb
    from lightning_pose_tpu.data import cameras as jc
    from lightning_pose_tpu.data.heatmaps import generate_heatmaps as jax_generate_heatmaps
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.models.factory import get_model as jax_get_model
    from lightning_pose_tpu_torch.data.bboxes import model_to_frame_batch
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import augment3d
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    mp = pytest.MonkeyPatch()
    mp.setitem(jvit.VIT_CONFIGS, "vits", SMALL_VIT)
    mp.setitem(pvit.VIT_CONFIGS, "vits", SMALL_VIT)
    cfg, nv = _step_cfg(), len(VIEWS)
    dm = SimpleNamespace(dataset=SimpleNamespace(is_calibrated=True))
    cache = _calibrated_cache()
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    gen = torch.Generator().manual_seed(3)
    draws = engine.sample(gen, LABELED * nv)
    draws_3d = augment3d.sample(gen, LABELED)
    draws_3d.apply_u.zero_()

    # the arrays the step sees: the 3D augmentation, then dlc's
    bbox = cache["bbox"].reshape(LABELED, nv, 4)
    sx, sy = IMAGE / bbox[..., 3], IMAGE / bbox[..., 2]
    z, o = torch.zeros_like(sx), torch.ones_like(sx)
    f2m = torch.stack([torch.stack([sx, z, -bbox[..., 0] * sx], -1), torch.stack([z, sy, -bbox[..., 1] * sy], -1),
                       torch.stack([z, z, o], -1)], -2)
    kp_frame = model_to_frame_batch(cache["keypoints"].reshape(LABELED, -1), cache["bbox"], IMAGE, IMAGE,
                                    num_views=nv).reshape(LABELED, -1, 2)
    images3d, kp3d = augment3d.apply(cache["images"].float(), kp_frame, *(cache[k] for k in CAMERA_KEYS), draws_3d,
                                     frame_to_model=f2m)
    assert float((kp3d - cache["keypoints"]).abs().nan_to_num().max()) > 1.0  # the 3D augmentation moved them
    images, keypoints, vis = engine.apply(images3d.reshape(LABELED * nv, IMAGE, IMAGE, 3),
                                          kp3d.reshape(LABELED * nv, KEYPOINTS, 2),
                                          cache["visibility"].reshape(LABELED * nv, KEYPOINTS), draws)
    keypoints, vis = keypoints.reshape(LABELED, -1, 2), vis.reshape(LABELED, -1)
    visibility = torch.where(torch.isnan(keypoints[..., 0]) & (vis == 2), 0, vis)
    images64 = normalize_images(images.reshape(LABELED, nv, IMAGE, IMAGE, 3)).double().numpy()

    module, _ = jax_get_model(cfg, num_keypoints=KEYPOINTS, compute_dtype=jnp.float64)
    params = seeded_jax_variables(module, jnp.zeros((1, nv, IMAGE, IMAGE, 3)), train=False)["params"]
    params["head"]["deconv0"]["kernel"] = params["head"]["deconv0"]["kernel"] * 300.0

    with jax.enable_x64(True):
        targets = jax_generate_heatmaps(jnp.asarray(keypoints.numpy()), IMAGE, IMAGE, (IMAGE // 4, IMAGE // 4),
                                        visibility=jnp.asarray(visibility.numpy())).astype(jnp.float64)
        factory = jax_factories(cfg, dm)["supervised"]
        assert list(factory.loss_instance_dict) == ["heatmap_mse", "supervised_pairwise_projections",
                                                    "supervised_reprojection_heatmap_mse"]
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        cal = [jnp.asarray(cache[k].numpy()).astype(jnp.float32) for k in CAMERA_KEYS]
        jbbox = jnp.asarray(cache["bbox"].numpy(), jnp.float64)
        kp_model = jnp.asarray(keypoints.numpy(), jnp.float64)

        def jax_loss(p):
            hm = _jax_softmax_maps(module, p, jnp.asarray(images64))
            preds, _ = _jax_decode64(hm)
            views = jb.model_to_frame_batch(preds, jbbox, IMAGE, IMAGE, num_views=nv).reshape(LABELED, nv, -1, 2)
            pred_3d = jc.project_camera_pairs_to_3d(views, *cal)
            targ = jb.model_to_frame_batch(kp_model.reshape(LABELED, -1), jbbox, IMAGE, IMAGE, num_views=nv)
            targ_3d = jnp.nanmedian(jc.project_camera_pairs_to_3d(
                jax.lax.stop_gradient(targ.reshape(LABELED, nv, -1, 2)), *cal), axis=1)
            reproj = jc.project_3d_to_2d(jnp.mean(pred_3d, axis=1), *cal)
            reproj = jb.frame_to_model_batch(reproj.reshape(LABELED, nv, -1, 2), jbbox, IMAGE, IMAGE)
            loss, logs = factory(stage="train", anneal_weight=None, heatmaps_targ=targets, heatmaps_pred=hm,
                                 keypoints_targ_3d=targ_3d, keypoints_pred_3d=pred_3d,
                                 keypoints_pred_2d_reprojected=reproj.reshape(LABELED, -1, 2))
            parts = {k: logs[f"train_{k}_loss"] for k in ("supervised_pairwise_projections",
                                                          "supervised_reprojection_heatmap_mse")}
            return loss, parts

        (loss, parts), grads = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))(p64)
        ref = {"loss": float(loss), "parts": {k: float(v) for k, v in parts.items()},
               "grads": jax.tree_util.tree_map(np.asarray, grads)}

    to_nchw = trainer._to_nchw
    mp.setattr(trainer, "_to_nchw", lambda x: to_nchw(x).double())
    try:
        model = build_model("heatmap_multiview", "vits_dino", KEYPOINTS, num_views=nv, image_size=IMAGE)
        load_flax_variables(model, params, {})
        model = model.double()
        optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, SPE, model)
        state = trainer.TrainState(model=model, optimizer=optimizer)
        meta = {"model_type": "heatmap_multiview", "downsample_factor": 2, "num_views": nv}
        step = trainer.make_step_fns(meta, get_loss_factories(cfg, dm), engine, cfg, head_sched, bb_sched, SPE,
                                     compute_dtype=torch.float64)[2]
        logs = step(state, cache, torch.arange(LABELED), torch.ones(LABELED, dtype=torch.bool), draws,
                    draws_3d=draws_3d)
        grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in model.named_parameters()}
        out = {"logs": logs, "grads": state_dict_to_flax(grads)[0]}
    finally:
        mp.undo()
    return ref, out


def test_float64_calibrated_train_step_matches_jax(float64_step):
    """The loss, both 3D terms and every parameter's gradient of the
    port's calibrated step against the JAX step's (the 3D augmentation's
    images and keypoints handed to both; the gradient reaches the backbone
    through the decode and the triangulations)."""
    ref, out = float64_step
    np.testing.assert_allclose(float(out["logs"]["total_loss"]), ref["loss"], rtol=F64_RTOL)
    for name, value in ref["parts"].items():
        assert value > 0, name
        np.testing.assert_allclose(float(out["logs"][f"train_{name}_loss"]), value, rtol=F64_RTOL, err_msg=name)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(out["grads"])[0])
    assert len(flat_ref) == len(flat_out)
    for path, r in flat_ref:
        name = jax.tree_util.keystr(path)
        if name.endswith(("['head']['deconv0']['bias']", "['attn']['key']['bias']")):
            # each shifts all the logits of one softmax alike: 0 up to rounding
            assert np.abs(flat_out[path]).max() < 1e-12 and np.abs(r).max() < 1e-12, name
            continue
        np.testing.assert_allclose(flat_out[path], r, rtol=0, atol=F64_RTOL * np.abs(r).max(), err_msg=name)


@pytest.mark.parametrize("calibrated", [True, False], ids=["calibrated", "uncalibrated"])
def test_decode_takes_gradient_only_with_3d_losses(calibrated, monkeypatch):
    """With a 3D loss the step decodes the maps with gradient (on the card:
    the decode's backward kernel); without one it decodes under no_grad, as
    before, and the 3D augmentation and losses are left out."""
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import augment3d
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import trainer

    cfg, nv = _step_cfg(), len(VIEWS)
    cache = _calibrated_cache(seed=2)
    if not calibrated:
        cache = {k: v for k, v in cache.items() if k not in CAMERA_KEYS}
    dm = SimpleNamespace(dataset=SimpleNamespace(is_calibrated=calibrated))
    model = build_model("heatmap_multiview", "vits_dino", KEYPOINTS, num_views=nv, image_size=IMAGE)
    decodes, applies = [], []
    decode = model.decode
    monkeypatch.setattr(model, "decode", lambda maps: decodes.append(torch.is_grad_enabled()) or decode(maps))
    apply = augment3d.apply
    monkeypatch.setattr(augment3d, "apply", lambda *a, **k: applies.append(1) or apply(*a, **k))
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, SPE, model)
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    meta = {"model_type": "heatmap_multiview", "downsample_factor": 2, "num_views": nv}
    factories = get_loss_factories(cfg, dm)
    assert ("supervised_pairwise_projections" in factories["supervised"].loss_instance_dict) == calibrated
    _, eval_step, step = trainer.make_step_fns(meta, factories, engine, cfg, head_sched, bb_sched, SPE,
                                               compute_dtype=torch.float32)
    gen = torch.Generator().manual_seed(0)
    logs = step(trainer.TrainState(model=model, optimizer=optimizer), cache, torch.arange(LABELED),
                torch.ones(LABELED, dtype=torch.bool), engine.sample(gen, LABELED * nv),
                draws_3d=augment3d.sample(gen, LABELED) if calibrated else None)
    val_logs, _, _ = eval_step(trainer.TrainState(model=model, optimizer=optimizer), cache, "val")
    assert decodes == [calibrated, False] and len(applies) == int(calibrated)
    assert ("train_supervised_pairwise_projections_loss" in logs) == calibrated
    assert ("val_supervised_reprojection_heatmap_mse_loss" in val_logs) == calibrated
    if calibrated:
        with pytest.raises(ValueError, match="3D draws"):
            step(trainer.TrainState(model=model, optimizer=optimizer), cache, torch.arange(LABELED),
                 torch.ones(LABELED, dtype=torch.bool), engine.sample(gen, LABELED * nv))


# -- train() by discovery, resumed by the JAX package ---------------------------------------


def _train_cfg(data_dir: Path, name: str, steps: int, resume: bool = False):
    """The tiny multiview transformer at 128 px on the discovered
    calibration: batch 4 of 2 views, dlc and the 3D augmentation, both 3D
    losses, validation (and a -last.ckpt) every epoch of step mode."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.csv_file = [f"CollectedData_{v}.csv" for v in TRAIN_VIEWS]
    cfg.data.view_names = list(TRAIN_VIEWS)
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.model_type = "heatmap_multiview_transformer"
    cfg.model.backbone = "vits_dino"
    cfg.model.model_name = name
    cfg.model.losses_to_use = []
    cfg.losses.supervised_pairwise_projections = {"log_weight": 1.0}
    cfg.losses.supervised_reprojection_heatmap_mse = {"log_weight": 3.0}
    t = cfg.training
    t.imgaug = "dlc"
    t.imgaug_3d = True
    t.train_batch_size = t.val_batch_size = t.test_batch_size = 4
    t.train_prob, t.val_prob = 0.5, 0.5
    t.max_epochs = t.min_epochs = t.unfreezing_epoch = None
    t.max_steps = t.min_steps = steps
    t.unfreezing_step = 0
    t.lr_scheduler_params.multisteplr.milestones = None
    t.lr_scheduler_params.multisteplr.milestone_steps = []
    t.check_val_every_n_epoch = 1
    t.log_every_n_steps = 1
    t.resume = resume
    cfg.eval.predict_vids_after_training = False
    return cfg


@pytest.fixture(scope="module")
def trained(tmp_path_factory) -> tuple[Path, Path, object]:
    """The port's train() of 2 steps (2 epochs of 1 step: 4 of the 8 frames
    train) on a calibrated 2-view set that the dataset discovers, with its
    evaluation."""
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.utils.synthetic import write_calibrated_multiview_dataset

    root = tmp_path_factory.mktemp("port_cal_train")
    data = write_calibrated_multiview_dataset(root / "data", 8, 100, 120, NAMES, TRAIN_VIEWS, seed=4)
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(pvit.VIT_CONFIGS, "vits", TINY_VIT)
        mp.setattr(trainer, "COMPUTE_DTYPE", torch.float32)
        result = trainer.train(_train_cfg(data, "caltrain", 2), root / "model", device="cpu")
    return data, root / "model", result


def test_calibrated_train_writes_the_model_directory(trained):
    """Both 3D losses logged, finite, in training and validation; the
    evaluation's predictions of every view; a -last.ckpt at step 2."""
    import pandas as pd

    _, model_dir, result = trained
    assert result.data_module.dataset.is_calibrated
    steps = [h for h in result.history if "total_loss" in h]
    vals = [h for h in result.history if "val_supervised_loss" in h]
    assert [h["step"] for h in steps] == [1, 2] and len(vals) == 2
    for stage, logs in (("train", steps), ("val", vals)):
        for h in logs:
            for name in ("supervised_pairwise_projections", "supervised_reprojection_heatmap_mse"):
                assert np.isfinite(h[f"{stage}_{name}_loss"]) and h[f"{stage}_{name}_loss"] > 0, (stage, name)
    for view in TRAIN_VIEWS:
        df = pd.read_csv(model_dir / "image_preds" / f"CollectedData_{view}.csv" / "predictions.csv",
                         header=[0, 1, 2], index_col=0)
        assert df.shape == (8, 3 * KEYPOINTS + 1) and np.isfinite(df.iloc[:, :-1].to_numpy(float)).all()
    lasts = list((model_dir / "tb_logs" / "caltrain" / "version_0" / "checkpoints").glob("*-last.ckpt"))
    assert [p.name for p in lasts] == ["epoch=1-step=2-last.ckpt"]


def test_the_jax_package_resumes_the_calibrated_last_ckpt(trained, tmp_path, monkeypatch):
    """The JAX package's train() with ``training.resume`` continues the
    port's -last.ckpt of the calibrated run (the 3D losses add no
    parameter, so the multiview transformer's bridge carries it): one more
    step from step 2 on the calibrated set, the parameters moved, the
    pairwise 3D loss finite. The resumed run leaves out the augmentation
    (and with it the reprojection loss, which needs the 3D augmentation), so
    that the JAX package compiles one step fewer."""
    from lightning_pose_tpu.config import Config as JaxConfig
    from lightning_pose_tpu.losses.losses import PairwiseProjectionsLoss as JaxPairwise
    from lightning_pose_tpu.train import trainer as jtrainer
    from lightning_pose_tpu.train.trainer import train as jax_train
    from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint

    monkeypatch.setitem(jvit.VIT_CONFIGS, "vits", TINY_VIT)
    jax_get_model = jtrainer.get_model
    monkeypatch.setattr(jtrainer, "get_model", lambda cfg, **kw: jax_get_model(cfg, compute_dtype=jnp.float32, **kw))
    traced, pairwise = [], JaxPairwise.__call__
    monkeypatch.setattr(JaxPairwise, "__call__", lambda self, *a, **kw: traced.append(kw.get("stage")) or pairwise(
        self, *a, **kw))
    data, model_dir, _ = trained
    resumed = Path(shutil.copytree(model_dir, tmp_path / "resumed"))
    (start,) = (resumed / "tb_logs" / "caltrain" / "version_0" / "checkpoints").glob("*-last.ckpt")
    start_params = load_checkpoint(str(start))["params"]
    cfg = _train_cfg(data, "caltrain", 3, resume=True)
    cfg.training.imgaug, cfg.training.imgaug_3d = "none", False
    cfg.losses.supervised_reprojection_heatmap_mse = {"log_weight": None}
    yaml_file = tmp_path / "jax_config.yaml"
    cfg.save(str(yaml_file))
    jax_train(JaxConfig.from_yaml(str(yaml_file)), model_dir=resumed, skip_evaluation=True)
    (last,) = (resumed / "tb_logs" / "caltrain" / "version_0" / "checkpoints").glob("*-last.ckpt")
    assert last.name == "epoch=2-step=3-last.ckpt"
    end = load_checkpoint(str(last))
    assert int(end["step"]) == 3
    moved = [float(np.abs(np.asarray(a) - np.asarray(b)).max()) for a, b in
             zip(jax.tree_util.tree_leaves(end["params"]), jax.tree_util.tree_leaves(start_params))]
    assert np.median(moved) > 1e-6 and all(np.isfinite(moved))
    assert json.loads((resumed / "train_status.json").read_text())["status"] == "COMPLETED"
    assert set(traced) == {"train", "val"}  # the JAX steps compiled the pairwise 3D loss
