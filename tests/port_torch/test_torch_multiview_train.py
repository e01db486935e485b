"""Slice 7, the multiview transformer's training and serving against the JAX
package: the port's supervised (patch-masked) and semi-supervised
(``pca_multiview`` + ``temporal`` over a frame-synchronized window) train
steps in float64 against the JAX step's loss function, ``train()`` of both
configurations writing the JAX package's file names, and prediction from
each package's directory by the other (labeled CSVs, a 2-view session,
``predict_frame``).

The ViTs are small (width 64, 2 heads, depth 2; a 4x4 token grid a view at
64 px, 8x8 at 128 px): ``VIT_CONFIGS["vits"]`` is set in both packages for
the test."""

from __future__ import annotations

import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lightning_pose_tpu.models.backbones import vit as jvit
from lightning_pose_tpu_torch.models.backbones import vit as pvit

SMALL_VIT = (64, 2, 2, 16)
IMAGE = 64
KEYPOINTS = 3
NAMES = ["nose", "ear", "tail"]
VIEWS = ["cam0", "cam1"]
LABELED = 2
WINDOW = 6
SPE = 10
# float64: the same loss and gradients, leaf by leaf, relative to each
# leaf's largest entry
F64_RTOL = 1e-6
# fp32 on the CPU in both packages, one checkpoint
PX_TOL = 1e-3
CONF_TOL = 1e-4


def _small_vits(mp) -> None:
    mp.setitem(jvit.VIT_CONFIGS, "vits", SMALL_VIT)
    mp.setitem(pvit.VIT_CONFIGS, "vits", SMALL_VIT)


@pytest.fixture(autouse=True)
def small_vits(monkeypatch):
    _small_vits(monkeypatch)


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


# -- the train steps in float64 ------------------------------------------------------------


def _step_cfg():
    """The multiview transformer at 64 px, the patch mask from step 0 at
    ratio 0.25 (4 of 16 patches), pca_multiview + temporal at weight 1/2,
    epsilons 0, the anneal weight 1 from epoch 0."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.view_names = list(VIEWS)
    cfg.data.mirrored_column_matches = list(range(KEYPOINTS))
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.model_type = "heatmap_multiview_transformer"
    cfg.model.backbone = "vits_dino"
    cfg.model.losses_to_use = ["pca_multiview", "temporal"]
    for name in ("pca_multiview", "temporal"):
        cfg.losses[name].log_weight = 0.0
        cfg.losses[name].epsilon = 0.0
    cfg.losses.temporal.prob_threshold = 0.0
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.training.patch_mask = {"init_step": 0, "final_step": 4, "init_ratio": 0.25, "final_ratio": 0.5}
    cfg.training.max_epochs = cfg.training.min_epochs = 2
    cfg.training.unfreezing_epoch = 0
    cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
    return cfg


def _pca_data_module(seed: int = 0):
    """What the PCA fit reads of a data module: 30 rows of 2 views of one
    rigid 3D body (orthographic cameras 90 degrees apart)."""
    from types import SimpleNamespace

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
    preds = preds - 1.5
    return preds.reshape(preds.shape[0], -1), confidences


@pytest.fixture(scope="module")
def float64_steps():
    """The port's train steps (supervised, then semi-supervised) in float64
    from one init, with dlc draws for each view image and the patch mask at
    step 0, and the JAX reference of both: loss and gradients. The JAX
    reference is handed the same augmented, masked, normalized arrays."""
    from lightning_pose_tpu.data.bboxes import model_to_frame_batch as jax_model_to_frame
    from lightning_pose_tpu.data.heatmaps import generate_heatmaps as jax_generate_heatmaps
    from lightning_pose_tpu.data.video import undo_affine_transform_batch as jax_undo
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.models.factory import get_model as jax_get_model
    from lightning_pose_tpu_torch.callbacks import apply_patch_mask
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images
    from lightning_pose_tpu_torch.ops.video_augment import augment_video_sequence, sample_video_draws
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    mp = pytest.MonkeyPatch()
    _small_vits(mp)
    cfg, dm = _step_cfg(), _pca_data_module()
    nv = len(VIEWS)
    rng = np.random.default_rng(1)
    cache = {
        "images": torch.from_numpy(rng.integers(0, 256, (LABELED, nv, IMAGE, IMAGE, 3), dtype=np.uint8)),
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
    scores = torch.rand((LABELED * nv, 16), generator=gen)

    # the arrays each step sees
    flat = cache["images"].reshape(LABELED * nv, IMAGE, IMAGE, 3)
    images, keypoints, vis = engine.apply(flat, cache["keypoints"].reshape(LABELED * nv, KEYPOINTS, 2),
                                          cache["visibility"].reshape(LABELED * nv, KEYPOINTS), draws)
    images = apply_patch_mask(images, 0.25, scores).reshape(LABELED, nv, IMAGE, IMAGE, 3)
    keypoints, vis = keypoints.reshape(LABELED, -1, 2), vis.reshape(LABELED, -1)
    assert int((images.reshape(LABELED * nv, 4, 16, 4, 16, 3) == 0).all(5).all(4).all(2).sum()) == 4 * LABELED * nv
    visibility = torch.where(torch.isnan(keypoints[..., 0]) & (vis == 2), 0, vis)
    frames, _ = augment_video_sequence(window["frames"].reshape(WINDOW * nv, IMAGE, IMAGE, 3), video_draws,
                                       apply_geometric=False)
    images64 = normalize_images(images).double().numpy()
    frames64 = normalize_images(frames.reshape(WINDOW, nv, IMAGE, IMAGE, 3)).double().numpy()

    module, _ = jax_get_model(cfg, num_keypoints=KEYPOINTS, compute_dtype=jnp.float64)
    variables = module.init(jax.random.PRNGKey(0), jnp.zeros((1, nv, IMAGE, IMAGE, 3)), train=False)
    params = jax.tree_util.tree_map(lambda a: np.array(a, np.float32), variables["params"])
    params["head"]["deconv0"]["kernel"] = params["head"]["deconv0"]["kernel"] * 300.0

    with jax.enable_x64(True):
        targets = jax_generate_heatmaps(jnp.asarray(keypoints.numpy()), IMAGE, IMAGE, (16, 16),
                                        visibility=jnp.asarray(visibility.numpy())).astype(jnp.float64)
        factories = jax_factories(cfg, dm)
        p64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), params)
        ul_bbox = jnp.asarray(window["bbox"].numpy(), jnp.float64)

        def jax_loss(p, unsup_weight):
            hm = _jax_softmax_maps(module, p, jnp.asarray(images64))
            sup, _ = factories["supervised"](stage="train", anneal_weight=None, heatmaps_targ=targets, heatmaps_pred=hm)
            ul = _jax_softmax_maps(module, p, jnp.asarray(frames64))
            preds, confs = _jax_decode64(ul)
            preds = jax_undo(preds, jnp.tile(jnp.eye(2, 3, dtype=jnp.float64), (WINDOW, 1, 1)))
            preds = jax_model_to_frame(preds, ul_bbox, IMAGE, IMAGE, num_views=nv)
            unsup, logs = factories["unsupervised"](stage="train", anneal_weight=1.0, keypoints_pred=preds,
                                                    heatmaps_pred=ul, confidences=confs)
            parts = {k: logs[k] for k in ("train_pca_multiview_loss", "train_temporal_loss")}
            return sup + unsup_weight * unsup, (unsup, parts)

        fn = jax.jit(jax.value_and_grad(jax_loss, has_aux=True))  # one compile for both steps
        ref = {}
        for kind, weight in (("supervised", 0.0), ("semi", 1.0)):
            (loss, (unsup, parts)), grads = fn(p64, jnp.asarray(weight, jnp.float64))
            ref[kind] = {"loss": float(loss), "grads": jax.tree_util.tree_map(np.asarray, grads),
                         "unsup": float(unsup), "parts": {k: float(v) for k, v in parts.items()}}

    out = {}
    to_nchw = trainer._to_nchw
    mp.setattr(trainer, "_to_nchw", lambda x: to_nchw(x).double())
    try:
        for kind in ("supervised", "semi"):
            model = build_model("heatmap_multiview", "vits_dino", KEYPOINTS, num_views=nv, image_size=IMAGE)
            load_flax_variables(model, params, {})
            model = model.double()
            optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, SPE, model)
            state = trainer.TrainState(model=model, optimizer=optimizer)
            meta = {"model_type": "heatmap_multiview", "downsample_factor": 2, "num_views": nv}
            step = trainer.make_step_fns(meta, get_loss_factories(cfg, dm), engine, cfg, head_sched, bb_sched, SPE,
                                         compute_dtype=torch.float64)[2]
            unlabeled = window if kind == "semi" else None
            logs = step(state, cache, torch.arange(LABELED), torch.ones(LABELED, dtype=torch.bool), draws,
                        unlabeled, video_draws if unlabeled else None, scores)
            grads = {n: p.grad if p.grad is not None else torch.zeros_like(p) for n, p in model.named_parameters()}
            out[kind] = {"logs": logs, "grads": state_dict_to_flax(grads)[0]}
    finally:
        mp.undo()
    return ref, out


@pytest.mark.parametrize("kind", ["supervised", "semi"])
def test_float64_train_step_matches_jax(float64_steps, kind):
    """The port's train step (the views folded into the batch for the
    engine, the patch mask before normalization, V*K maps against view-major
    targets; semi-supervised: plus the 2-view window's photometric-only
    augmentation, the V*K keypoints decoded with gradient and mapped to each
    view's frame) against the JAX step's loss: the loss, the unsupervised
    terms and every parameter's gradient."""
    ref, out = float64_steps
    ref, out = ref[kind], out[kind]
    np.testing.assert_allclose(float(out["logs"]["total_loss"]), ref["loss"], rtol=F64_RTOL)
    if kind == "semi":
        assert min(ref["parts"].values()) > 0
        np.testing.assert_allclose(float(out["logs"]["train_unsupervised_loss"]), ref["unsup"], rtol=F64_RTOL)
        for name, value in ref["parts"].items():
            np.testing.assert_allclose(float(out["logs"][name]), value, rtol=F64_RTOL, err_msg=name)
    flat_ref = jax.tree_util.tree_flatten_with_path(ref["grads"])[0]
    flat_out = dict(jax.tree_util.tree_flatten_with_path(out["grads"])[0])
    assert len(flat_ref) == len(flat_out)
    for path, r in flat_ref:
        name = jax.tree_util.keystr(path)
        if name.endswith(("['head']['deconv0']['bias']", "['attn']['key']['bias']")):
            # each shifts all the logits of one softmax alike (a map's; a
            # query's over the keys): its gradient is 0 up to rounding
            assert np.abs(flat_out[path]).max() < 1e-12 and np.abs(r).max() < 1e-12, name
            continue
        np.testing.assert_allclose(flat_out[path], r, rtol=0, atol=F64_RTOL * np.abs(r).max(), err_msg=name)


# -- train() and prediction from its directories ------------------------------------------


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    """14 labeled frames of 2 views, the same labels as ``_new`` label
    files, and a 2-view 20-frame session."""
    import shutil

    from lightning_pose_tpu_torch.utils.synthetic import write_multiview_dataset, write_multiview_videos

    root = write_multiview_dataset(tmp_path_factory.mktemp("port_mv_train") / "data", 14, 100, 120, NAMES, VIEWS,
                                   seed=5)
    for view in VIEWS:
        shutil.copy(root / f"CollectedData_{view}.csv", root / f"CollectedData_{view}_new.csv")
    write_multiview_videos(root, "test_vid", 20, 100, 120, VIEWS, seed=6)
    return root


def _train_cfg(data_dir: Path, name: str, semi: bool):
    """The small multiview transformer at 128 px, batch 4 of 2 views, dlc,
    the patch mask ramping over the 2 steps of step mode, the test session
    predicted after training in 8-frame batches."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.csv_file = [f"CollectedData_{v}.csv" for v in VIEWS]
    cfg.data.view_names = list(VIEWS)
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.mirrored_column_matches = list(range(KEYPOINTS))
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.model_type = "heatmap_multiview_transformer"
    cfg.model.backbone = "vits_dino"
    cfg.model.model_name = name
    cfg.training.imgaug = "dlc"
    cfg.training.patch_mask = {"init_step": 0, "final_step": 2, "init_ratio": 0.1, "final_ratio": 0.5}
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
    cfg.dali.base.predict.sequence_length = 8
    if semi:
        cfg.model.losses_to_use = ["pca_multiview", "temporal"]
        cfg.losses.temporal.prob_threshold = 0.0
        cfg.losses.temporal.epsilon = cfg.losses.pca_multiview.epsilon = 0.0
        cfg.callbacks.anneal_weight.init_val = 1.0
        cfg.callbacks.anneal_weight.freeze_until_epoch = 0
        cfg.dali.base.train.sequence_length = 6
    return cfg


@pytest.fixture(scope="module")
def trained_dirs(data_dir, tmp_path_factory) -> dict[str, tuple[Path, object]]:
    """The port's train() on the CPU of the supervised and the
    semi-supervised configurations, with evaluation, its compute type set to
    fp32 so that the evaluation can be held to the JAX package's fp32
    prediction."""
    from lightning_pose_tpu_torch.train import trainer

    root = tmp_path_factory.mktemp("port_mv_trained")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        _small_vits(mp)
        mp.setattr(trainer, "COMPUTE_DTYPE", torch.float32)
        for name, semi in (("mvsup", False), ("mvsemi", True)):
            result = trainer.train(_train_cfg(data_dir, name, semi), root / name, device="cpu")
            out[name] = (root / name, result)
    return out


def _files(model_dir: Path) -> list[str]:
    return sorted(str(p.relative_to(model_dir)) for p in model_dir.rglob("*") if p.is_file())


@pytest.mark.parametrize("name", ["mvsup", "mvsemi"])
def test_train_writes_the_jax_file_names(trained_dirs, name):
    """The JAX package's train() writes these for a multiview model with a
    test session and ``_new`` label files: one image_preds directory,
    legacy copy and video CSV a view, for the labeled frames and the
    ``_new`` files (no PCA metric on a true-multiview data module)."""
    model_dir, result = trained_dirs[name]
    files = [f for f in _files(model_dir) if not f.startswith("tb_logs") or f.endswith(".ckpt")]
    expected = ["config.yaml", "train_status.json",
                f"tb_logs/{name}/version_0/checkpoints/epoch=0-step=2-best.ckpt",
                f"tb_logs/{name}/version_0/checkpoints/epoch=0-step=2-last.ckpt"]
    for view in VIEWS:
        csv = f"CollectedData_{view}.csv"
        expected += [csv, f"image_preds/{csv}/predictions.csv", f"image_preds/{csv}/predictions_pixel_error.csv",
                     f"predictions_{view}.csv", f"predictions_{view}_pixel_error.csv",
                     f"video_preds/test_vid_{view}.csv", f"video_preds/test_vid_{view}_temporal_norm.csv"]
        new = f"CollectedData_{view}_new.csv"
        expected += [f"image_preds/{new}/predictions.csv", f"image_preds/{new}/predictions_pixel_error.csv",
                     f"predictions_{view}_new.csv", f"predictions_{view}_pixel_error_new.csv"]
    assert files == sorted(expected)
    assert json.loads((model_dir / "train_status.json").read_text())["status"] == "COMPLETED"
    steps = [h for h in result.history if "total_loss" in h]
    assert [h["step"] for h in steps] == [1, 2] and all(np.isfinite(v) for h in steps for v in h.values())
    if name == "mvsemi":
        assert all(h["train_unsupervised_loss"] > 0 for h in steps)
        assert not result.data_module.unlabeled_loader._thread.is_alive()


def _read(path: Path) -> pd.DataFrame:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _assert_same_predictions(out: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert out.index.equals(ref.index) and list(out.columns) == list(ref.columns)
    coords = out.columns.get_level_values("coords")
    xy, conf = np.isin(coords, ["x", "y"]), coords == "likelihood"
    np.testing.assert_allclose(out.loc[:, xy].to_numpy(float), ref.loc[:, xy].to_numpy(float), rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(out.loc[:, conf].to_numpy(float), ref.loc[:, conf].to_numpy(float),
                               rtol=0, atol=CONF_TOL)


def _predict_both(model_dir: Path, data_dir: Path, out_dir: Path):
    """The JAX package's and the port's fp32 predictions from one directory:
    the labeled CSVs, the test session and one frame a view, each package
    writing into its own copy of the directory."""
    import shutil

    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    results = {}
    frames = np.random.default_rng(7).integers(0, 256, (2, 100, 120, 3), dtype=np.uint8)
    videos = [data_dir / "videos" / f"test_vid_{v}.mp4" for v in VIEWS]
    for name in ("jax", "port"):
        copy = shutil.copytree(model_dir, out_dir / name, ignore=shutil.ignore_patterns("*_preds", "predictions*"))
        model = (JaxModel.from_dir(copy, precision="fp32") if name == "jax"
                 else Model.from_dir(copy, precision="fp32", device="cpu"))
        labeled = model.predict_on_label_csv_multiview([f"CollectedData_{v}.csv" for v in VIEWS],
                                                       data_dir=data_dir, compute_metrics=False)
        video = model.predict_on_video_file_multiview(videos, compute_metrics=False)
        results[name] = (labeled.predictions, video.predictions, model.predict_frame(frames, bbox=(4, 6, 110, 90)))
    return results


@pytest.mark.parametrize("name", ["mvsup", "mvsemi"])
def test_jax_package_reproduces_the_port_predictions(trained_dirs, data_dir, tmp_path, name):
    """The JAX package's Model.from_dir reads the port's directory: its
    labeled-CSV, session and one-frame-a-view predictions equal the port's
    within 1e-3 px and 1e-4 in likelihood, and so do the port's own
    evaluation files."""
    model_dir, _ = trained_dirs[name]
    with pytest.MonkeyPatch.context() as mp:
        _small_vits(mp)
        results = _predict_both(model_dir, data_dir, tmp_path)
    for view in VIEWS:
        _assert_same_predictions(results["port"][0][view], results["jax"][0][view])
        _assert_same_predictions(results["port"][1][view], results["jax"][1][view])
        _assert_same_predictions(_read(model_dir / "video_preds" / f"test_vid_{view}.csv"), results["jax"][1][view])
        image_preds = _read(model_dir / "image_preds" / f"CollectedData_{view}.csv" / "predictions.csv")
        _assert_same_predictions(image_preds.iloc[:, :-1], results["jax"][0][view].iloc[:, :-1])
    out, ref = results["port"][2], results["jax"][2]
    assert out["keypoints"].shape == (2 * KEYPOINTS, 2)
    np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(out["confidence"], ref["confidence"], rtol=0, atol=CONF_TOL)


@pytest.fixture(scope="module")
def jax_trained_dir(data_dir, tmp_path_factory) -> Path:
    """The JAX package's train() of the supervised configuration (no
    evaluation)."""
    from lightning_pose_tpu.train import train as jax_train

    model_dir = tmp_path_factory.mktemp("jax_mv_trained") / "model"
    with pytest.MonkeyPatch.context() as mp:
        _small_vits(mp)
        cfg = _train_cfg(data_dir, "jaxmv", semi=False)
        cfg.training.max_steps = cfg.training.min_steps = 1
        cfg.training.unfreezing_step = 0
        cfg.training.lr_scheduler_params.multisteplr.milestone_steps = []
        jax_train(cfg, model_dir, skip_evaluation=True)
    return model_dir


def test_the_port_reproduces_the_jax_package_predictions(jax_trained_dir, data_dir, tmp_path):
    """The port's Model.from_dir reads the JAX package's train() directory:
    the same labeled-CSV, session and one-frame-a-view predictions within
    1e-3 px and 1e-4 in likelihood."""
    with pytest.MonkeyPatch.context() as mp:
        _small_vits(mp)
        results = _predict_both(jax_trained_dir, data_dir, tmp_path)
    for view in VIEWS:
        _assert_same_predictions(results["port"][0][view], results["jax"][0][view])
        _assert_same_predictions(results["port"][1][view], results["jax"][1][view])
    np.testing.assert_allclose(results["port"][2]["keypoints"], results["jax"][2]["keypoints"], rtol=0, atol=PX_TOL)
