"""The regression model (``model_type: regression``) against the JAX
package: the tracker (ResNet and pooled EfficientNet backbones, no ViT),
both regression losses and the loss factory's branch, the dataset, and the
train step, supervised and with an unlabeled window (temporal +
pca_singleview acting on the outputs, no decode), in float64."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch


IMAGE = 64
KEYPOINTS = 4
NAMES = ["nose", "tail", "paw_left", "paw_right"]
WINDOW = 8
# fp32 eval on both sides: within this share of the largest output
OUT_TOL = 1e-4
# the losses in fp32: the same sums in another order
LOSS_TOL = 1e-6
# float64: the same loss and gradients, leaf by leaf, relative to each
# leaf's largest entry
F64_RTOL = 1e-6


def _nchw(x: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def _flat(tree) -> np.ndarray:
    return np.concatenate([np.asarray(x).ravel() for x in jax.tree_util.tree_leaves(tree)])


def _cfg(losses_to_use=()):
    """A resnet18 regression config at 64 px; with unsupervised losses at
    log weight -4 (weight 27: a random init's coordinate MSE is large),
    epsilons 0 and the anneal weight 1 from epoch 0."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.model_type = "regression"
    cfg.model.backbone = "resnet18"
    cfg.model.losses_to_use = list(losses_to_use)
    for name in losses_to_use:
        cfg.losses[name].log_weight = -4.0
        cfg.losses[name].epsilon = 0.0
    cfg.losses.pca_singleview.components_to_keep = 0.9
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    return cfg


@pytest.mark.parametrize("backbone", ["resnet18", "efficientnet_b0"])
def test_regression_tracker_matches_flax(backbone, seeded_jax_variables):
    from lightning_pose_tpu.models.regression_tracker import RegressionTracker as JaxTracker
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables

    jax_model = JaxTracker(backbone_arch=backbone, num_keypoints=KEYPOINTS, image_size=IMAGE, dtype=jnp.float32)
    x = np.random.default_rng(0).standard_normal((2, IMAGE, IMAGE, 3)).astype(np.float32)
    variables = seeded_jax_variables(jax_model, jnp.asarray(x), seed=1, train=False)
    ref = np.asarray(jax.jit(jax_model.apply)(variables, jnp.asarray(x)))

    model = build_model("regression", backbone, KEYPOINTS).eval()
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    with torch.no_grad():
        out = model(_nchw(x))
    assert out.dtype == torch.float32 and out.shape == ref.shape == (2, 2 * KEYPOINTS)
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=OUT_TOL * np.abs(ref).max())


def test_regression_tracker_rejects_a_vit_backbone_as_the_jax_package():
    from lightning_pose_tpu.models.regression_tracker import RegressionTracker as JaxTracker
    from lightning_pose_tpu_torch.models.factory import build_model

    with pytest.raises(NotImplementedError, match="ViT") as ref:
        JaxTracker(backbone_arch="vits_dino").init(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    with pytest.raises(NotImplementedError) as out:
        build_model("regression", "vits_dino", KEYPOINTS)
    assert str(out.value) == str(ref.value)


def test_regression_losses_match_jax():
    from lightning_pose_tpu.losses import losses as jlosses
    from lightning_pose_tpu_torch.losses import losses as plosses

    rng = np.random.default_rng(2)
    targ = rng.uniform(0, 64, (5, 2 * KEYPOINTS)).astype(np.float32)
    targ[1, 2:4] = np.nan
    targ[3, 0:2] = np.nan
    pred = rng.uniform(0, 64, (5, 2 * KEYPOINTS)).astype(np.float32)
    for jax_cls, port_cls in ((jlosses.RegressionMSELoss, plosses.RegressionMSELoss),
                              (jlosses.RegressionRMSELoss, plosses.RegressionRMSELoss)):
        ref, ref_logs = jax_cls()(keypoints_targ=jnp.asarray(targ), keypoints_pred=jnp.asarray(pred), stage="val")
        out, logs = port_cls()(keypoints_targ=torch.from_numpy(targ), keypoints_pred=torch.from_numpy(pred),
                               stage="val")
        np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL)
        assert set(logs) == set(ref_logs)


def test_regression_loss_factory_matches_jax():
    """Supervised: the coordinate MSE at log weight 0 (weight 1/2); a
    unimodal loss on a regression model raises in both packages."""
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories

    cfg = _cfg()
    rng = np.random.default_rng(3)
    targ = rng.uniform(0, 64, (3, 2 * KEYPOINTS)).astype(np.float32)
    pred = rng.uniform(0, 64, (3, 2 * KEYPOINTS)).astype(np.float32)
    ref, ref_logs = jax_factories(cfg)["supervised"](stage="train", anneal_weight=None,
                                                     keypoints_targ=jnp.asarray(targ), keypoints_pred=jnp.asarray(pred))
    sup = get_loss_factories(cfg)["supervised"]
    assert list(sup.loss_instance_dict) == ["regression"] and sup.loss_instance_dict["regression"].weight == 0.5
    out, logs = sup(stage="train", anneal_weight=None, keypoints_targ=torch.from_numpy(targ),
                    keypoints_pred=torch.from_numpy(pred))
    np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL)
    assert set(logs) == set(ref_logs)
    cfg.model.losses_to_use = ["unimodal_mse"]
    with pytest.raises(NotImplementedError, match="heatmap models"):
        jax_factories(cfg)
    with pytest.raises(NotImplementedError, match="heatmap models"):
        get_loss_factories(cfg)


def test_regression_dataset_is_the_base_dataset_and_multiview_raises(tmp_path):
    from lightning_pose_tpu.data.factory import get_dataset as jax_get_dataset
    from lightning_pose_tpu_torch.data.datasets import BaseTrackingDataset, HeatmapDataset
    from lightning_pose_tpu_torch.data.factory import get_dataset
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    data = write_labeled_dataset(tmp_path / "data", 4, 70, 80, NAMES, seed=0)
    cfg = _cfg()
    cfg.data.data_dir = str(data)
    dataset = get_dataset(cfg, str(data))
    assert type(dataset) is BaseTrackingDataset and not isinstance(dataset, HeatmapDataset)
    ref = jax_get_dataset(cfg, str(data))
    for i in range(len(dataset)):
        for key in ("images", "keypoints", "bbox"):
            np.testing.assert_array_equal(np.asarray(dataset[i][key]), np.asarray(ref[i][key]))
    cfg.data.view_names = ["top", "side"]
    cfg.data.csv_file = ["a.csv", "b.csv"]
    with pytest.raises(NotImplementedError) as ref_err:
        jax_get_dataset(cfg, str(data))
    with pytest.raises(NotImplementedError) as err:
        get_dataset(cfg, str(data))
    assert str(err.value) == str(ref_err.value)


def _jax_apply64(module, params, batch_stats, images):
    """The JAX regression model in train mode, float64 throughout: its head
    casts the linear layer's output to float32, so that output is taken as
    captured, in float64. Returns the keypoints and the updated statistics."""
    _, state = module.apply({"params": params, "batch_stats": batch_stats}, images, train=True,
                            mutable=["batch_stats", "intermediates"],
                            capture_intermediates=lambda mdl, _: mdl.name == "linear")
    preds = state["intermediates"]["head"]["linear"]["__call__"][0]
    assert preds.dtype == jnp.float64
    return preds, state["batch_stats"]


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


@pytest.mark.parametrize("semi", [False, True], ids=["supervised", "semi-supervised"])
def test_float64_regression_step_matches_jax(semi, seeded_jax_variables):
    """The JAX step's loss function of a regression model in float64 (the
    head's cast to float32 taken in float64): labeled forward and the
    coordinate MSE against labels with a NaN; with ``semi``, the window
    (augmented by the JAX package, geometric) through a second train-mode
    forward, the outputs as keypoints with confidences 1, the undo
    transform, model to frame and the unsupervised factory (temporal +
    pca_singleview). The port's step: the same model, its supervised
    factory and ``trainer.unsupervised_loss``. Loss, every gradient and the
    chained BatchNorm statistics."""
    from lightning_pose_tpu.data.bboxes import model_to_frame_batch as jax_model_to_frame
    from lightning_pose_tpu.data.video import undo_affine_transform_batch as jax_undo
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu.models.factory import get_model as jax_get_model
    from lightning_pose_tpu.ops.preprocess import normalize_images as jax_normalize
    from lightning_pose_tpu.ops.video_augment import augment_video_sequence as jax_augment
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax
    from lightning_pose_tpu_torch.train.trainer import unsupervised_loss

    rng = np.random.default_rng(4)
    images_u8 = rng.integers(0, 256, (4, IMAGE, IMAGE, 3), dtype=np.uint8)
    keypoints = rng.uniform(4, IMAGE - 4, (4, 2 * KEYPOINTS))
    keypoints[2, 2:4] = np.nan
    window = rng.integers(0, 256, (WINDOW, IMAGE, IMAGE, 3), dtype=np.uint8)
    ul_bbox = np.tile(np.array([0.0, 0.0, 60.0, 80.0]), (WINDOW, 1))
    frames, transforms = jax_augment(jax.random.PRNGKey(9), jnp.asarray(window), apply_geometric=True)
    transforms = np.asarray(transforms, np.float64)
    cfg = _cfg(["temporal", "pca_singleview"] if semi else [])
    cfg.losses.temporal.prob_threshold = 0.0
    dm = _data_module()
    with jax.enable_x64(True):
        module, _ = jax_get_model(cfg, num_keypoints=KEYPOINTS, compute_dtype=jnp.float64)
        variables = seeded_jax_variables(module, jnp.zeros((1, IMAGE, IMAGE, 3)), seed=5, train=False)
        images = np.asarray(jax_normalize(jnp.asarray(images_u8, jnp.float64)), np.float64)
        ul_images = np.asarray(jax_normalize(jnp.asarray(frames, jnp.float64)), np.float64)
        v64 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64), variables)
        factories = jax_factories(cfg, dm)

        def jax_loss(p):
            preds, stats = _jax_apply64(module, p, v64["batch_stats"], jnp.asarray(images))
            loss, _ = factories["supervised"](stage="train", anneal_weight=None,
                                              keypoints_targ=jnp.asarray(keypoints), keypoints_pred=preds)
            logs = {}
            if semi:
                ul_preds, stats = _jax_apply64(module, p, stats, jnp.asarray(ul_images))
                confs = jnp.ones((ul_preds.shape[0], ul_preds.shape[1] // 2), jnp.float64)
                ul_preds = jax_model_to_frame(jax_undo(ul_preds, jnp.asarray(transforms)),
                                              jnp.asarray(ul_bbox), IMAGE, IMAGE)
                unsup, logs = factories["unsupervised"](stage="train", anneal_weight=1.0, keypoints_pred=ul_preds,
                                                        heatmaps_pred=None, confidences=confs)
                loss = loss + unsup
            return loss, (stats, logs)

        (ref_loss, (ref_stats, ref_logs)), ref_grads = jax.jit(
            jax.value_and_grad(jax_loss, has_aux=True))(v64["params"])
        ref_loss = float(ref_loss)
        ref_parts = {k: float(v) for k, v in ref_logs.items() if k in ("train_pca_singleview_loss",
                                                                       "train_temporal_loss")}
        ref_grads, ref_stats = (jax.tree_util.tree_map(np.asarray, t) for t in (ref_grads, ref_stats))

    model = build_model("regression", "resnet18", KEYPOINTS)
    load_flax_variables(model, variables["params"], variables["batch_stats"])
    model = model.double().eval()
    with torch.no_grad():  # the head's cast, as the JAX package's
        assert model(torch.from_numpy(images[:1]).permute(0, 3, 1, 2)).dtype == torch.float32
    model.head.forward = lambda features: model.head.linear(features)  # left out, as on the JAX side
    model.train()
    pfactories = get_loss_factories(cfg, dm)
    preds = model(torch.from_numpy(images).permute(0, 3, 1, 2))
    loss, _ = pfactories["supervised"](stage="train", anneal_weight=None,
                                       keypoints_targ=torch.from_numpy(keypoints), keypoints_pred=preds)
    if semi:
        unsup, logs = unsupervised_loss(
            model, torch.from_numpy(ul_images).permute(0, 3, 1, 2), torch.from_numpy(transforms),
            torch.from_numpy(ul_bbox), pfactories["unsupervised"], 1.0, (IMAGE, IMAGE), compute_dtype=torch.float64,
        )
        assert min(ref_parts.values()) > 0 and float(unsup.detach()) > 0.1 * float(loss.detach())
        for name, value in ref_parts.items():
            np.testing.assert_allclose(float(logs[name]), value, rtol=F64_RTOL, err_msg=name)
        loss = loss + unsup
    loss.backward()
    np.testing.assert_allclose(float(loss), ref_loss, rtol=F64_RTOL)
    grads, out_stats = state_dict_to_flax({**model.state_dict(), **{n: p.grad for n, p in model.named_parameters()}})
    flat_ref = jax.tree_util.tree_flatten_with_path(ref_grads)[0]
    got = jax.tree_util.tree_leaves(grads)
    assert len(got) == len(flat_ref)
    for (path, ref), out in zip(flat_ref, got):
        np.testing.assert_allclose(out, ref, rtol=0, atol=F64_RTOL * np.abs(ref).max(), err_msg=jax.tree_util.keystr(path))
    np.testing.assert_allclose(_flat(out_stats), _flat(ref_stats), rtol=0, atol=1e-9)
