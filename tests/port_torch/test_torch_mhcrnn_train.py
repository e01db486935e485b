"""Slice 6, the context model's training and serving against the JAX
package: the port's supervised and semi-supervised train steps in float64
against the JAX step's loss function, ``train()`` of both configurations
(adjacent supervised, repeat_center semi-supervised) writing the JAX
package's file names, and prediction from the directories, held to the JAX
package's ``Model`` on the same weights."""

from __future__ import annotations

import json
import shutil
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lightning_pose_tpu.api.model import Model as JaxModel
from lightning_pose_tpu.models import heatmap_tracker_mhcrnn as jtracker
from lightning_pose_tpu_torch.api.model import Model

IMAGE = 64
KEYPOINTS = 4
NAMES = ["nose", "tail", "paw_left", "paw_right"]
LABELED = 2
WINDOW = 8
SPE = 10
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


def _step_cfg():
    """resnet18 at 64 px, the context model, pca_singleview + temporal at
    weight 1/2 (log_weight 0), epsilons 0, the anneal weight 1 from epoch 0."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.model_type = "heatmap_mhcrnn"
    cfg.model.backbone = "resnet18"
    cfg.model.losses_to_use = ["pca_singleview", "temporal"]
    for name in ("pca_singleview", "temporal"):
        cfg.losses[name].log_weight = 0.0
        cfg.losses[name].epsilon = 0.0
    cfg.losses.pca_singleview.components_to_keep = 0.9
    cfg.losses.temporal.prob_threshold = 0.0
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.training.max_epochs = cfg.training.min_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
    return cfg


def _pca_data_module(seed: int = 0):
    """What the PCA fit reads of a data module: 40 rows of a rigid body."""
    rng = np.random.default_rng(seed)
    template = rng.uniform(-12, 12, (KEYPOINTS, 2))
    angles = rng.uniform(-0.5, 0.5, 40)
    rot = np.stack([np.stack([np.cos(angles), -np.sin(angles)], -1),
                    np.stack([np.sin(angles), np.cos(angles)], -1)], -2)
    kp = np.einsum("nij,kj->nki", rot, template) + rng.uniform(24, 40, (40, 1, 2)) + rng.normal(0, 1.0, (40, KEYPOINTS, 2))
    dataset = SimpleNamespace(keypoints_resized=lambda i: kp[i].astype(np.float32), num_keypoints=KEYPOINTS)
    return SimpleNamespace(dataset=dataset, train_dataset=SimpleNamespace(indices=np.arange(40)))


def _jax_softmax_heads(module, params, stats, images):
    """The JAX context model in train mode, float64 throughout: its heads cast
    to float32 before their softmax, so both heads' logits are rebuilt from
    the captured float64 layer outputs (the single-frame head's last
    deconv; the CRNN's last W_f, W_b and H_*_deconv calls, whose sums are
    the final states) and softmaxed here. Returns both heads' maps and the
    updated BatchNorm statistics."""
    from lightning_pose_tpu.ops.softargmax import spatial_softmax2d

    names = {"deconv1", "W_f", "W_b", "H_f_deconv", "H_b_deconv"}
    _, state = module.apply({"params": params, "batch_stats": stats}, images, train=True,
                            mutable=["batch_stats", "intermediates"],
                            capture_intermediates=lambda mdl, _: mdl.name in names)
    head = state["intermediates"]["head"]
    sf = head["head_sf"]["deconv1"]["__call__"][0]
    mf = head["head_mf"]
    x_f = mf["W_f"]["__call__"][-1] + mf["H_f_deconv"]["__call__"][-1]
    x_b = mf["W_b"]["__call__"][-1] + mf["H_b_deconv"]["__call__"][-1]
    assert sf.dtype == x_f.dtype == jnp.float64
    return (spatial_softmax2d(sf, temperature=1.0), spatial_softmax2d((x_f + x_b) / 2, temperature=1.0),
            state["batch_stats"])


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


@pytest.fixture(scope="module")
def float64_steps():
    """The port's train steps (supervised, then semi-supervised) in float64
    from one init, with dlc draws, and the JAX reference of both: loss,
    gradients and BatchNorm statistics. The port's step normalizes in fp32,
    as the JAX step does; the test casts its normalized images to float64
    (``trainer._to_nchw``), and hands the JAX reference the same augmented,
    normalized arrays."""
    from lightning_pose_tpu.data.bboxes import model_to_frame_batch as jax_model_to_frame
    from lightning_pose_tpu.data.heatmaps import generate_heatmaps as jax_generate_heatmaps
    from lightning_pose_tpu.data.video import undo_affine_transform_batch as jax_undo
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.models.factory import get_model as jax_get_model
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images
    from lightning_pose_tpu_torch.ops.video_augment import augment_video_sequence, sample_video_draws
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    cfg, dm = _step_cfg(), _pca_data_module()
    rng = np.random.default_rng(1)
    cache = {
        "images": torch.from_numpy(rng.integers(0, 256, (LABELED, 5, IMAGE, IMAGE, 3), dtype=np.uint8)),
        "keypoints": torch.from_numpy(rng.uniform(8, IMAGE - 8, (LABELED, KEYPOINTS, 2)).astype(np.float32)),
        "visibility": torch.full((LABELED, KEYPOINTS), 2, dtype=torch.int64),
        "bbox": torch.tensor([[0.0, 0.0, IMAGE, IMAGE]] * LABELED),
    }
    window = {"frames": torch.from_numpy(rng.integers(0, 256, (WINDOW, IMAGE, IMAGE, 3), dtype=np.uint8)),
              "bbox": torch.tensor([[0.0, 0.0, 60.0, 80.0]] * WINDOW)}
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    gen = torch.Generator().manual_seed(3)
    draws = engine.sample(gen, LABELED)
    video_draws = sample_video_draws(gen, WINDOW, IMAGE, IMAGE)

    # the arrays each step sees
    images, keypoints, vis = engine.apply(cache["images"], cache["keypoints"], cache["visibility"], draws)
    visibility = torch.where(torch.isnan(keypoints[..., 0]) & (vis == 2), 0, vis)
    frames, transforms = augment_video_sequence(window["frames"], video_draws, apply_geometric=True)
    images64 = normalize_images(images).double().numpy()
    frames64 = normalize_images(frames).double().numpy()

    module, _ = jax_get_model(cfg, num_keypoints=KEYPOINTS, compute_dtype=jnp.float64)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, 5, IMAGE, IMAGE, 3)), train=False)
    params = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables["params"])
    stats = jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), variables["batch_stats"])
    for layer in params["head"]["head_sf"].values():  # a peaked single-frame head
        layer["kernel"] = layer["kernel"] * 300.0

    with jax.enable_x64(True):
        targets = jax_generate_heatmaps(jnp.asarray(keypoints.numpy()), IMAGE, IMAGE, (16, 16),
                                        visibility=jnp.asarray(visibility.numpy())).astype(jnp.float64)
        factories = jax_factories(cfg, dm)
        p64, s64 = (jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), t) for t in (params, stats))
        ul_bbox = jnp.asarray(window["bbox"].numpy(), jnp.float64)[2:-2]
        ul_transforms = jnp.asarray(transforms.numpy(), jnp.float64)[2:-2]

        def jax_loss(p, unsup_weight):
            hm_sf, hm_mf, stats1 = _jax_softmax_heads(module, p, s64, jnp.asarray(images64))
            sup, _ = factories["supervised"](stage="train", anneal_weight=None,
                                             heatmaps_targ=jnp.concatenate([targets, targets]),
                                             heatmaps_pred=jnp.concatenate([hm_sf, hm_mf]))
            windows = jtracker.make_context_windows(jnp.asarray(frames64))
            ul_sf, ul_mf, stats2 = _jax_softmax_heads(module, p, stats1, windows)
            preds, confs = jtracker.merge_heads_by_confidence(*_jax_decode64(ul_sf), *_jax_decode64(ul_mf))
            preds = jax_model_to_frame(jax_undo(preds, ul_transforms), ul_bbox, IMAGE, IMAGE)
            unsup, logs = factories["unsupervised"](stage="train", anneal_weight=1.0, keypoints_pred=preds,
                                                    heatmaps_pred=ul_mf, confidences=confs)
            parts = {k: logs[k] for k in ("train_pca_singleview_loss", "train_temporal_loss")}
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
            model = build_model("heatmap_mhcrnn", "resnet18", KEYPOINTS)
            load_flax_variables(model, params, stats)
            model = model.double()
            optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, SPE, model)
            state = trainer.TrainState(model=model, optimizer=optimizer)
            step = trainer.make_step_fns({"model_type": "heatmap_mhcrnn", "downsample_factor": 2},
                                         get_loss_factories(cfg, dm), engine, cfg, head_sched, bb_sched, SPE,
                                         compute_dtype=torch.float64)[2]
            unlabeled = window if kind == "semi" else None
            logs = step(state, cache, torch.arange(LABELED), torch.ones(LABELED, dtype=torch.bool), draws,
                        unlabeled, video_draws if unlabeled else None)
            grads, out_stats = state_dict_to_flax(
                {**model.state_dict(), **{n: p.grad for n, p in model.named_parameters()}})
            out[kind] = {"logs": logs, "grads": grads, "stats": out_stats}
    return ref, out


@pytest.mark.parametrize("kind", ["supervised", "semi"])
def test_float64_train_step_matches_jax(float64_steps, kind):
    """The port's train step (supervised: both heads' maps against the
    targets twice, a batch of 2B; semi-supervised: plus the window's 4
    sliding windows through a second train-mode forward, both heads decoded
    with gradient and merged, the transforms and bboxes trimmed to the
    centers) against the JAX step's loss: the loss, the unsupervised terms,
    every parameter's gradient and the chained BatchNorm statistics."""
    ref, out = float64_steps
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
        if name.endswith("['head_sf']['deconv1']['bias']"):
            continue  # the last bias shifts every logit of a map: its gradient is 0 up to rounding
        np.testing.assert_allclose(o, r, rtol=0, atol=F64_RTOL * np.abs(r).max(), err_msg=name)
    np.testing.assert_allclose(_flat(out["stats"]), _flat(ref["stats"]), rtol=0, atol=1e-9)


# -- train() and prediction from its directories ------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    """14 consecutive labeled frames (real neighbours) and a 20-frame mp4."""
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    root = write_labeled_dataset(tmp_path_factory.mktemp("port_ctx_train") / "data", 14, 140, 150, NAMES, seed=5)
    write_unlabeled_video(root, "test_vid", 20, 140, 150, seed=6)
    return root


def _train_cfg(data_dir: Path, name: str, mode: str, semi: bool):
    """resnet18 at 128 px, batch 4 stacks, dlc, 2 steps in step mode, the
    test video predicted after training; 12-frame prediction sequences."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.model_type = "heatmap_mhcrnn"
    cfg.model.mhcrnn_context_mode = mode
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = name
    cfg.dali.context.predict.sequence_length = 12
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
    if semi:
        cfg.model.losses_to_use = ["pca_singleview", "temporal"]
        cfg.losses.temporal.prob_threshold = 0.0
        cfg.losses.temporal.epsilon = cfg.losses.pca_singleview.epsilon = 0.0
        cfg.callbacks.anneal_weight.init_val = 1.0
        cfg.callbacks.anneal_weight.freeze_until_epoch = 0
        cfg.dali.base.train.sequence_length = 6
        # every keypoint in the PCA: the evaluation writes the PCA metric CSVs
        cfg.data.columns_for_singleview_pca = list(range(KEYPOINTS))
    return cfg


@pytest.fixture(scope="module")
def trained_dirs(data_dir, tmp_path_factory) -> dict[str, tuple[Path, object]]:
    """The port's train() on the CPU of the supervised adjacent and the
    semi-supervised repeat_center configurations, with evaluation, its
    compute type set to fp32 so that the evaluation can be held to the JAX
    package's fp32 prediction."""
    from lightning_pose_tpu_torch.train import trainer

    root = tmp_path_factory.mktemp("port_ctx_trained")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(trainer, "COMPUTE_DTYPE", torch.float32)
        for name, mode, semi in (("ctxsup", "adjacent", False), ("ctxsemi", "repeat_center", True)):
            result = trainer.train(_train_cfg(data_dir, name, mode, semi), root / name, device="cpu")
            out[name] = (root / name, result)
    return out


def _files(model_dir: Path) -> list[str]:
    return sorted(str(p.relative_to(model_dir)) for p in model_dir.rglob("*") if p.is_file())


@pytest.mark.parametrize("name", ["ctxsup", "ctxsemi"])
def test_train_writes_the_jax_file_names(trained_dirs, name):
    """The JAX package's train() writes these for a single-view model with a
    test video (test_torch_evaluation.py holds the list to its train())."""
    model_dir, result = trained_dirs[name]
    files = [f for f in _files(model_dir) if not f.startswith("tb_logs") or f.endswith(".ckpt")]
    metrics = ["pixel_error"] + (["pca_singleview_error"] if name == "ctxsemi" else [])
    expected = ["CollectedData.csv", "config.yaml", "train_status.json",
                f"tb_logs/{name}/version_0/checkpoints/epoch=0-step=2-best.ckpt",
                f"tb_logs/{name}/version_0/checkpoints/epoch=0-step=2-last.ckpt",
                "image_preds/CollectedData.csv/predictions.csv", "predictions.csv",
                "video_preds/test_vid.csv", "video_preds/test_vid_temporal_norm.csv"]
    expected += [f"image_preds/CollectedData.csv/predictions_{m}.csv" for m in metrics]
    expected += [f"predictions_{m}.csv" for m in metrics]
    expected += ["video_preds/test_vid_pca_singleview_error.csv"] if name == "ctxsemi" else []
    assert files == sorted(expected)
    assert json.loads((model_dir / "train_status.json").read_text())["status"] == "COMPLETED"
    steps = [h for h in result.history if "total_loss" in h]
    assert [h["step"] for h in steps] == [1, 2] and all(np.isfinite(v) for h in steps for v in h.values())
    if name == "ctxsemi":
        assert all(h["train_unsupervised_loss"] > 0 for h in steps)
        assert not any(t.is_alive() for t in result.data_module.unlabeled_loader._threads)


def _read(path: Path) -> pd.DataFrame:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _assert_same_predictions(out: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert out.index.equals(ref.index) and list(out.columns) == list(ref.columns)
    coords = out.columns.get_level_values("coords")
    xy, conf = np.isin(coords, ["x", "y"]), coords == "likelihood"
    np.testing.assert_allclose(out.loc[:, xy].to_numpy(float), ref.loc[:, xy].to_numpy(float), rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(out.loc[:, conf].to_numpy(float), ref.loc[:, conf].to_numpy(float),
                               rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("name", ["ctxsup", "ctxsemi"])
def test_jax_package_reproduces_the_port_predictions(trained_dirs, data_dir, tmp_path, name):
    """The JAX package's Model.from_dir reads the port's context model
    directory: its video prediction reproduces the port's video CSV (20
    frames in 2 batches of 8 windows, rows moved to their frames), and its
    predict_frame of a 5-frame stack the port's, within 1e-3 px and 1e-4 in
    likelihood; for the supervised directory, its labeled-CSV prediction
    also reproduces the port's image_preds (the repeat_center stacks of the
    other are held bitwise to the JAX package's in
    test_torch_mhcrnn_data.py)."""
    model_dir, _ = trained_dirs[name]
    jax_model = JaxModel.from_dir(model_dir, precision="fp32")
    if name == "ctxsup":
        jax_model.predict_on_label_csv("CollectedData.csv", output_dir=tmp_path, add_train_val_test_set=True,
                                       compute_metrics=False)
        port_csv = _read(model_dir / "image_preds" / "CollectedData.csv" / "predictions.csv")
        _assert_same_predictions(port_csv.iloc[:, :-1], _read(tmp_path / "predictions.csv").iloc[:, :-1])
        assert (port_csv.iloc[:, -1] == _read(tmp_path / "predictions.csv").iloc[:, -1]).all()
    video = data_dir / "videos" / "test_vid.mp4"
    ref = jax_model.predict_on_video_file(video, output_dir=tmp_path / "jax", compute_metrics=False).predictions
    _assert_same_predictions(_read(model_dir / "video_preds" / "test_vid.csv"), ref)
    stack = np.random.default_rng(7).integers(0, 256, (5, 140, 150, 3), dtype=np.uint8)
    out = Model.from_dir(model_dir, precision="fp32", device="cpu").predict_frame(stack, bbox=(4, 6, 120, 110))
    ref = jax_model.predict_frame(stack, bbox=(4, 6, 120, 110))
    np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(out["confidence"], ref["confidence"], rtol=0, atol=CONF_TOL)


def test_the_port_reads_a_context_dir_the_jax_package_wrote(trained_dirs, data_dir, tmp_path):
    """The port-trained checkpoint read and written again by the JAX
    package's checkpoint code: the port predicts the video from it as from
    its own file."""
    from lightning_pose_tpu.train import checkpoints as jax_ckpt

    model_dir, _ = trained_dirs["ctxsup"]
    jax_dir = tmp_path / "jax_written"
    shutil.copytree(model_dir, jax_dir, ignore=shutil.ignore_patterns("*.ckpt", "*_preds", "predictions*"))
    src = sorted(model_dir.rglob("*-best.ckpt"))[0]
    ckpt = jax_ckpt.load_checkpoint(str(src))
    dst = jax_dir / src.relative_to(model_dir)
    jax_ckpt.save_checkpoint(str(dst), ckpt["params"], ckpt["batch_stats"], step=2, epoch=0)
    video = data_dir / "videos" / "test_vid.mp4"
    out = Model.from_dir(jax_dir, precision="fp32", device="cpu").predict_on_video_file(
        video, output_dir=tmp_path / "port", compute_metrics=False).predictions
    _assert_same_predictions(out, _read(model_dir / "video_preds" / "test_vid.csv"))
