"""Supervised and semi-supervised training of the single-view heatmap and
regression models, of the temporal-context model and of the multiview
transformer (counterpart of ``lightning_pose_tpu/train/trainer.py``).

Each step gathers its batch from a device-resident copy of the labeled set, augments it on the device (``ops/augment.py``, with
the warp and CLAHE kernels), builds the target heatmaps, runs the model in
bf16 by autocast with fp32 parameters and BatchNorm statistics, and takes an
Adam step on two parameter groups (backbone and head), each with its
schedule read at the step count (``train/schedules.py``). Targets and losses
are fp32; the logged pixel RMSE decodes the predicted maps with the decode
kernel on the card (the plain decode on the CPU).

Across GPUs (``training.num_gpus`` above 1, or a process group that
``training.num_nodes`` or the ``LP_TPU_*`` variables name), each rank is
one process with one device and takes its rows of the global batch, which
every rank builds alike from the same seeds, with the global batch's
augmentation draws; ``parallel/mesh.py`` says how the group comes up. The
model's outputs, and the labels, are gathered from every rank before the
losses, so that each rank computes the single-device loss on the whole
batch; the gradients are averaged over the ranks after the backward, and
BatchNorm takes the global batch's statistics. Only rank 0 writes the model
directory and evaluates; the validation sums are all-reduced. ``n`` ranks
take the steps one device takes, to fp32 rounding.

With unsupervised losses (``model.losses_to_use``), each step also takes one
unlabeled video window from the data module's loader, copied to the device
through pinned memory. The window is augmented on the device
(``ops/video_augment.py``), run through the model in a second train-mode
forward (after the labeled one, so the BatchNorm statistics chain as in the
JAX package), decoded with gradient (the decode and its backward kernel on
the card), mapped back through the augmentation and to frame pixels, and
given to the unsupervised losses at the epoch's anneal weight. A window of
planar I420 frames (``training.video_transfer_format: yuv420``) is converted
to RGB by the I420 kernel before its augmentation.

The context model (``heatmap_mhcrnn``) trains on 5-frame stacks: one
augmentation draw per stack, applied to its 5 frames, and the single-frame
and multi-frame heads' maps concatenated into a batch of ``2B`` against the
targets twice. Its unlabeled window is tiled into sliding 5-frame windows
(or repeated centers), decoded twice with gradient, merged per keypoint by
confidence, and its transforms and bboxes trimmed to the window centers.

The multiview transformer (``heatmap_multiview``) trains on ``(B, V, H, W,
3)`` view batches: the views fold into the batch for the augmentation
engine (one draw per view image), the patch-mask curriculum
(``training.patch_mask``) zeroes patches of the augmented images before
normalization, and the model's ``V*K`` maps go against view-major targets.
Its unlabeled window is ``(T, V, H, W, 3)`` frame-synchronized views,
augmented photometrically only (so the views stay geometrically consistent);
keypoints map to each view's frame through that view's bbox columns.
``heatmap`` and ``heatmap_mhcrnn`` on multiview data (``meta["num_views"]``
above 1) train the same way with no patch mask, the model folding the views
into its batch: ``(B, V, H, W, 3)`` views, or ``(B, V, 5, H, W, 3)``
context stacks whose 5 frames take their view's one draw. The context
model tiles each view of its window into sliding windows, ``(T-4, V, 5,
...)``.

A calibrated multiview dataset (``intrinsic_matrix``, ``extrinsic_matrix``
and ``distortions`` in its samples, which the device cache and the
validation batches carry) adds two stages. Before the 2D augmentation, the
3D augmentation (``ops/augment3d.py``) scales and translates the labels'
triangulation and warps every view image to the reprojection, one warp
launch over the ``B*V`` images, from draws that follow the 2D draws on the
same host generator. With a supervised 3D loss configured
(``supervised_pairwise_projections``, ``supervised_reprojection_heatmap_mse``),
the maps are decoded with gradient (the decode and its backward kernel on
the card), mapped to frame pixels and triangulated for every camera pair;
the target is the median over pairs of the labels' triangulations, and the
reprojection loss takes the pairs' mean reprojected to model pixels. The
validation losses include the 3D terms.

The regression model (``regression``) outputs keypoints directly: its
supervised loss is the coordinate MSE against the augmented labels, its
confidences are ones, and its unlabeled window's outputs go to the
unsupervised losses with no decode.

``model.backbone_checkpoint`` (a local torch file, torchvision, MMPose or HF
layout) is loaded into the backbone after the model is built and before
``model.checkpoint``'s warm start (``models/backbones/pretrained.py``).
``training.resume`` continues the newest ``-last.ckpt`` of the newest
version directory in that directory: weights, BatchNorm statistics, the
optimizer's state, the step and epoch, the best validation loss and its
checkpoint, and the two generators of the augmentation draws, so that a
resumed run takes the steps an uninterrupted one takes. The unlabeled
stream starts afresh, as in the JAX package. ``training.profiler`` traces
the run with ``torch.profiler`` (host and CUDA activities) from the first
step to the last checkpoint into ``<version dir>/profiler_trace.json``.

``train(cfg, model_dir)`` writes the reference's model directory:
``config.yaml``, a copy of the label CSV, ``train_status.json``,
``tb_logs/<model_name>/version_N/checkpoints/epoch=E-step=S-best.ckpt``
(flax-msgpack, read by both packages; ``-last.ckpt`` with the optimizer's
state, refreshed at every validation) and, when ``tensorboardX`` imports,
its event files. ``Model.from_dir(model_dir)`` of either package predicts
from it. Unless ``skip_evaluation``, it then reloads the best checkpoint and
evaluates as the JAX package does: ``image_preds/<csv>/predictions.csv``
with its metric CSVs and legacy copies in the model directory (one a view,
``predictions_<view>*.csv``, for a multiview model), the same for the
``_new`` and ``_test`` label files where they exist, and the test videos (a
multiview model's sessions, one CSV a view) into ``video_preds/`` when
``eval.predict_vids_after_training`` is set. The evaluation decodes by
``eval.decode_method`` (soft-argmax, or DARK), as ``Model.from_dir`` then
does; the JAX package's evaluation decodes by soft-argmax whatever the
setting (``ROADMAP.md``, "Found in the reference").

Every backbone the JAX package takes trains here: the transformers'
position tables, tokens and LayerScale are parameters of the backbone
group. ``heatmap_mhcrnn`` with a stride-16 backbone (a ViT, DINOv2, DINOv3
or SAM) raises at its first step, where the JAX package's step fails too:
its multi-frame maps come out twice the size of its single-frame maps.
"""

from __future__ import annotations

import dataclasses
import logging
import math
import os
import shutil
import socket
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path
from typing import Callable

import numpy as np
import torch
from torch import nn

from lightning_pose_tpu_torch.api.model import PredictStep, decode_method_of, resolve_device
from lightning_pose_tpu_torch.callbacks import PATCH_SIZE, apply_patch_mask, patch_mask_ratio
from lightning_pose_tpu_torch.data.bboxes import frame_to_model_batch, frame_to_model_matrices, model_to_frame_batch
from lightning_pose_tpu_torch.data.cameras import nanmedian, project_3d_to_2d, project_camera_pairs_to_3d
from lightning_pose_tpu_torch.data.heatmaps import generate_heatmaps
from lightning_pose_tpu_torch.data.video import undo_affine_transform_batch
from lightning_pose_tpu_torch.losses.losses import RegressionRMSELoss
from lightning_pose_tpu_torch.models.backbones.pretrained import load_backbone_checkpoint
from lightning_pose_tpu_torch.models.heatmap_tracker_mhcrnn import HeatmapTrackerMHCRNN, make_context_windows
from lightning_pose_tpu_torch.models.regression_tracker import RegressionTracker
from lightning_pose_tpu_torch.ops import augment3d
from lightning_pose_tpu_torch.ops.augment import AugmentationEngine, Draws
from lightning_pose_tpu_torch.ops.preprocess import normalize_images
from lightning_pose_tpu_torch.ops.video_augment import VideoDraws, augment_video_sequence, sample_video_draws
from lightning_pose_tpu_torch.ops.yuv_kernel import i420_to_rgb
from lightning_pose_tpu_torch.parallel import mesh
from lightning_pose_tpu_torch.train import checkpoints as ckpt_utils
from lightning_pose_tpu_torch.train.schedules import anneal_weight, backbone_lr, multistep_lr

logger = logging.getLogger(__name__)

__all__ = [
    "TrainState",
    "TrainedModel",
    "calculate_steps_per_epoch",
    "make_optimizer",
    "make_step_fns",
    "run_validation_epoch",
    "sample_mask_scores",
    "supervised_3d_inputs",
    "train",
    "unsupervised_loss",
]

_CACHE_KEYS = ("images", "keypoints", "visibility", "bbox")
# a calibrated multiview dataset's camera arrays, carried beside them
_CALIBRATION_KEYS = ("intrinsic_matrix", "extrinsic_matrix", "distortions")
# the compute type of train() and of its evaluation, as in the JAX package
COMPUTE_DTYPE = torch.bfloat16


def calculate_steps_per_epoch(data_module) -> int:
    """``ceil(n_train / batch_size)``, at least 10 with an unlabeled stream
    (reference train.py:63-82)."""
    steps = math.ceil(len(data_module.train_dataset) / data_module.train_batch_size)
    if hasattr(data_module, "unlabeled_loader"):
        steps = max(10, steps)
    return steps


# ------------------------------------------------------------------------------
# optimizer
# ------------------------------------------------------------------------------


def _resolve_schedule_cfg(cfg, steps_per_epoch: int) -> dict:
    """Epoch-mode or step-mode training lengths and milestones."""
    tcfg = cfg.training
    multisteplr = tcfg.lr_scheduler_params.multisteplr
    if tcfg.get("max_steps") is not None:
        max_steps = int(tcfg.max_steps)
        max_epochs = math.ceil(max_steps / steps_per_epoch)
        milestones_steps = list(multisteplr.get("milestone_steps", []))
        unfreeze_step = tcfg.get("unfreezing_step", 0)
        unfreeze_epoch = None
    else:
        max_epochs = int(tcfg.max_epochs)
        max_steps = max_epochs * steps_per_epoch
        milestones_steps = [m * steps_per_epoch for m in multisteplr.get("milestones", [])]
        unfreeze_epoch = tcfg.get("unfreezing_epoch", 20)
        unfreeze_step = None
    return dict(
        max_steps=max_steps,
        max_epochs=max_epochs,
        milestones_steps=milestones_steps,
        gamma=float(multisteplr.get("gamma", 0.5)),
        unfreeze_epoch=unfreeze_epoch,
        unfreeze_step=unfreeze_step,
    )


def _patch_mask_schedule(cfg, steps_per_epoch: int) -> tuple[float, float, int, int] | None:
    """The patch-mask curriculum as ``(init_ratio, final_ratio, start_step,
    end_step)``, or None when absent or off (``final_ratio`` 0). The
    reference's ``training.patch_mask`` with ``init_epoch``/``final_epoch``
    (steps = ceil(epochs * steps_per_epoch)) or ``init_step``/``final_step``
    (defaults 700/5000); ``callbacks.patch_masking`` with
    ``start_epoch``/``end_epoch`` is the JAX package's older name."""
    pm = cfg.training.get("patch_mask", None)
    if pm is not None:
        init_ratio = float(pm.get("init_ratio", 0.1))
        final_ratio = float(pm.get("final_ratio", 0.5))
        if final_ratio == 0.0:
            return None
        if pm.get("init_epoch") is not None or pm.get("final_epoch") is not None:
            start = math.ceil(float(pm.get("init_epoch", 0)) * steps_per_epoch)
            end = math.ceil(float(pm.get("final_epoch", 1)) * steps_per_epoch)
        else:
            start = int(pm.get("init_step", 700))
            end = int(pm.get("final_step", 5000))
        return init_ratio, final_ratio, start, max(end, 1)
    legacy = cfg.callbacks.get("patch_masking", None)
    if legacy is not None:
        final_ratio = float(legacy.get("final_ratio", 0.5))
        if final_ratio == 0.0:
            return None
        return (
            float(legacy.get("init_ratio", 0.0)),
            final_ratio,
            int(legacy.get("start_epoch", 0)) * steps_per_epoch,
            max(int(legacy.get("end_epoch", 1)) * steps_per_epoch, 1),
        )
    return None


def make_optimizer(
    cfg, steps_per_epoch: int, model: nn.Module
) -> tuple[torch.optim.Optimizer, Callable[[int], float], Callable[[int], float]]:
    """Adam (or AdamW with optax's default decay of 1e-4) over two parameter
    groups, ``backbone.*`` and the rest; returns the optimizer and the head
    and backbone schedules. Set each group's ``lr`` with
    :func:`set_learning_rates` before every step."""
    sched = _resolve_schedule_cfg(cfg, steps_per_epoch)
    base_lr = float(cfg.training.optimizer_params.get("learning_rate", 1e-3))
    milestones_epochs = [math.ceil(m / steps_per_epoch) for m in sched["milestones_steps"]]
    head_sched = multistep_lr(base_lr, milestones_epochs, sched["gamma"], steps_per_epoch)
    bb_sched = backbone_lr(
        base_lr,
        milestones_epochs,
        sched["gamma"],
        steps_per_epoch,
        unfreezing_epoch=sched["unfreeze_epoch"],
        unfreezing_step=sched["unfreeze_step"],
    )
    backbone = [p for n, p in model.named_parameters() if n.startswith("backbone.")]
    head = [p for n, p in model.named_parameters() if not n.startswith("backbone.")]
    groups = [{"params": backbone, "name": "backbone"}, {"params": head, "name": "head"}]
    name = str(cfg.training.get("optimizer", "Adam")).lower()
    if name == "adam":
        optimizer = torch.optim.Adam(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    elif name == "adamw":
        optimizer = torch.optim.AdamW(groups, lr=0.0, betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)
    else:
        raise NotImplementedError(f"optimizer {cfg.training.optimizer} not supported")
    return optimizer, head_sched, bb_sched


def set_learning_rates(optimizer: torch.optim.Optimizer, step: int, head_sched, bb_sched) -> None:
    """Each group's ``lr`` at ``step``, the count of steps already taken."""
    for group in optimizer.param_groups:
        group["lr"] = bb_sched(step) if group["name"] == "backbone" else head_sched(step)


# ------------------------------------------------------------------------------
# step functions
# ------------------------------------------------------------------------------


@dataclass
class TrainState:
    """What a train step reads and updates: the model (parameters and
    BatchNorm statistics), the optimizer, and the count of steps taken."""

    model: nn.Module
    optimizer: torch.optim.Optimizer
    step: int = 0


def sample_mask_scores(generator: torch.Generator, n: int, image_hw: tuple[int, int]) -> torch.Tensor:
    """Uniform ``(n, patches)`` patch-mask scores for ``n`` images, on the
    generator's device."""
    num_patches = (image_hw[0] // PATCH_SIZE) * (image_hw[1] // PATCH_SIZE)
    return torch.rand((n, num_patches), generator=generator, device=generator.device)


def _effective_visibility(kp: torch.Tensor, visibility: torch.Tensor) -> torch.Tensor:
    """Keypoints that augmentation pushed out of the frame (NaN with
    visibility 2) drop to 0; labels that were NaN keep the dataset's flag."""
    return torch.where(torch.isnan(kp[..., 0]) & (visibility == 2), 0, visibility)


def _to_nchw(images: torch.Tensor) -> torch.Tensor:
    """Normalized ``(..., H, W, 3)`` -> ``(..., 3, H, W)``: ``(B, 3, H, W)``
    channels-last, context stacks and multiview views ``(B, T, 3, H, W)``,
    multiview context stacks ``(B, V, 5, 3, H, W)``."""
    return normalize_images(images).movedim(-1, -3)


def unsupervised_loss(
    model: nn.Module,
    images: torch.Tensor,
    transforms: torch.Tensor,
    bbox: torch.Tensor,
    factory,
    anneal_weight: float,
    image_hw: tuple[int, int],
    compute_dtype: torch.dtype = torch.bfloat16,
    num_views: int = 1,
) -> tuple[torch.Tensor, dict]:
    """The unsupervised term of a train step on one augmented window (the
    JAX step's unlabeled branch, reference trainer.py:470-577): normalized
    ``images (T, 3, H, W)`` through the model in its current mode, the maps
    decoded with gradient, the keypoints mapped back through the forward
    ``transforms (T, 2, 3)`` of the augmentation and from model to frame
    pixels by ``bbox (T, 4)``, then ``factory`` (the unsupervised losses) at
    ``anneal_weight``. Returns the loss and the factory's logs.

    The context model takes the window's ``T - 4`` sliding 5-frame windows
    (repeated centers under ``context_repeat``); both heads' maps are
    decoded with gradient and merged by confidence, so the gradient reaches
    each keypoint's chosen head only, and the multi-frame maps go to the
    losses. Transforms and bboxes are trimmed to the centers.

    On multiview data (``num_views`` views: the multiview transformer, or a
    heatmap model that folds the views into its batch) ``images`` is ``(T,
    V, 3, H, W)`` and ``bbox (T, 4V)``; the ``V*K`` keypoints map to each
    view's frame. The context model's windows are ``(T-4, V, 5, 3, H, W)``.

    The regression model's outputs are the keypoints, with confidences of
    ones and no maps.

    Under a process group of more than one rank, ``images`` are this rank's
    frames (a context model's: its windows' frames, with their 4 frames of
    halo) and the outputs of every rank are gathered before the losses, so
    that the temporal term takes its differences across the split; every
    rank returns the loss of the whole window."""
    height, width = image_hw
    is_context = isinstance(model, HeatmapTrackerMHCRNN)
    if is_context:
        images = make_context_windows(images, repeat_center=model.context_repeat)
        if num_views > 1:  # (T-4, 5, V, ...) -> (T-4, V, 5, ...)
            images = images.transpose(1, 2)
    with torch.autocast(images.device.type, dtype=torch.bfloat16, enabled=compute_dtype == torch.bfloat16):
        heatmaps = model(images)
    if is_context:
        preds, confidences = model.decode_heads(heatmaps)
        heatmaps = heatmaps[1]
        transforms, bbox = transforms[2:-2], bbox[2:-2]
    elif isinstance(model, RegressionTracker):
        preds, confidences, heatmaps = heatmaps, RegressionTracker.confidences(heatmaps), None
    else:
        preds, confidences = model.decode(heatmaps)
    if mesh.world_size() > 1:
        preds, confidences, transforms, bbox = (mesh.gather_rows(t) for t in (preds, confidences, transforms, bbox))
        heatmaps = None if heatmaps is None else mesh.gather_rows(heatmaps)
    preds = undo_affine_transform_batch(preds, transforms)
    preds = model_to_frame_batch(preds, bbox, width, height, num_views=num_views)
    return factory(
        stage="train", anneal_weight=anneal_weight,
        keypoints_pred=preds, heatmaps_pred=heatmaps, confidences=confidences,
    )


def supervised_3d_inputs(
    preds: torch.Tensor,
    keypoints: torch.Tensor,
    bbox: torch.Tensor,
    calibration: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    image_hw: tuple[int, int],
    reprojection: bool = True,
) -> dict[str, torch.Tensor]:
    """The supervised 3D losses' inputs (reference
    heatmap_tracker_multiview.py:259-323) from ``preds (B, 2VK)`` and the
    labels ``keypoints (B, VK, 2)`` in model pixels, ``bbox (B, 4V)`` and
    the cameras ``(intrinsics, extrinsics, distortions)``: every camera
    pair's triangulation of the predictions, the median over pairs of the
    labels' (no gradient) and, with ``reprojection``, the pairs' mean
    reprojected to model pixels."""
    height, width = image_hw
    b, num_views = preds.shape[0], calibration[0].shape[1]
    views = model_to_frame_batch(preds, bbox, width, height, num_views=num_views).reshape(b, num_views, -1, 2)
    out = {"keypoints_pred_3d": project_camera_pairs_to_3d(views, *calibration)}
    with torch.no_grad():
        targ = model_to_frame_batch(keypoints.reshape(b, -1), bbox, width, height, num_views=num_views)
        out["keypoints_targ_3d"] = nanmedian(
            project_camera_pairs_to_3d(targ.reshape(b, num_views, -1, 2), *calibration), dim=1
        )
    if reprojection:
        reprojected = project_3d_to_2d(out["keypoints_pred_3d"].mean(dim=1), *calibration)
        out["keypoints_pred_2d_reprojected"] = frame_to_model_batch(reprojected, bbox, width, height).reshape(b, -1, 2)
    return out


def make_step_fns(
    meta: dict,
    loss_factories: dict,
    augmenter: AugmentationEngine,
    cfg,
    head_sched,
    bb_sched,
    steps_per_epoch: int,
    compute_dtype: torch.dtype = torch.bfloat16,
):
    """``(train_step, eval_step, train_step_cached)`` of the single-view
    heatmap model, of the regression model when ``meta["model_type"]`` is
    ``regression``, of the context model when it is ``heatmap_mhcrnn``, or
    of the multiview transformer when it is ``heatmap_multiview``
    (``meta["num_views"]`` views); ``heatmap`` and ``heatmap_mhcrnn`` with
    ``meta["num_views"]`` above 1 train on multiview data, the views folded
    into the model's batch.

    - ``train_step(state, batch, draws, video_draws=None, mask_scores=None)
      -> logs``: augment with ``draws`` (``augmenter.sample``, one draw per
      image, per view image on multiview data; None for an identity
      pipeline), one optimizer step; ``state.step`` advances. With
      unsupervised losses and an ``unlabeled`` window in the batch, the
      window is augmented with ``video_draws``
      (``ops/video_augment.sample_video_draws``, one noise field per frame
      and view), geometric only with the ``dlc`` pipelines and never on
      multiview data, and its loss is added. The multiview model's
      patch mask, when the config sets one, takes ``mask_scores``: uniform
      ``(B*V, patches)`` scores (:func:`sample_mask_scores`). A calibrated
      multiview batch (with ``intrinsic_matrix``) under a non-identity
      pipeline takes ``draws_3d`` (``ops/augment3d.sample``, one draw a
      sample) for the 3D augmentation.
    - ``eval_step(state, batch, stage) -> (logs, preds, confidences)``.
    - ``train_step_cached(state, cache, idxs, valid, draws, unlabeled=None,
      video_draws=None, mask_scores=None, draws_3d=None) -> logs``: the
      batch is gathered from a device-resident labeled cache by index; rows
      with ``valid`` False are padding (visibility 0, NaN keypoints).

    Batches hold ``images (B, H, W, 3)`` (context stacks ``(B, 5, H, W,
    3)``, labeled at their center; multiview ``(B, V, H, W, 3)``, or ``(B,
    V, 5, H, W, 3)`` for the context model),
    ``keypoints (B, K, 2)``, ``visibility (B, K)`` and ``bbox (B, 4)``
    (multiview: ``K`` over all views, view-major, and ``bbox (B, 4V)``;
    calibrated: ``intrinsic_matrix (B, V, 3, 3)``, ``extrinsic_matrix (B, V,
    3, 4)``, ``distortions (B, V, 5)``) on the model's device; an unlabeled
    window holds ``frames (T, H, W, 3)`` and ``bbox (T, 4)`` (multiview
    ``(T, V, H, W, 3)`` and ``(T, 4V)``).
    Logs are 0-d tensors, read when the caller needs them.
    """
    height = int(cfg.data.image_resize_dims.height)
    width = int(cfg.data.image_resize_dims.width)
    df = meta["downsample_factor"]
    out_shape = (height // 2**df, width // 2**df)
    anneal_cfg = cfg.callbacks.anneal_weight
    rmse_loss = RegressionRMSELoss()
    supervised = loss_factories["supervised"]
    unsup = loss_factories.get("unsupervised")
    has_unsup = unsup is not None and len(unsup.loss_instance_dict) > 0
    is_context = meta["model_type"] == "heatmap_mhcrnn"
    is_multiview = meta["model_type"] == "heatmap_multiview"
    is_regression = meta["model_type"] == "regression"
    num_views = int(meta.get("num_views", 1) or 1)
    if num_views > 1 and augmenter.hflip:
        # the JAX package's step fails here: its multiview dataset's swap
        # indices span every view's keypoints, the folded images one view's
        raise ValueError(
            "Incompatible shapes for broadcasting: training.imgaug_hflip swaps keypoint identities over all "
            f"{num_views} views' keypoints, and a {meta['model_type']} model augments each view image alone"
        )
    patch_mask = _patch_mask_schedule(cfg, steps_per_epoch) if is_multiview else None
    supervised_3d = [n for n in supervised.loss_instance_dict if n.startswith("supervised_")]

    def inputs_3d(preds, keypoints, bbox, calibration) -> dict:
        """:func:`supervised_3d_inputs`; without a calibration they are
        None, and the losses raise."""
        if not is_multiview or calibration is None:
            return {"keypoints_targ_3d": None, "keypoints_pred_3d": None, "keypoints_pred_2d_reprojected": None}
        return supervised_3d_inputs(preds, keypoints, bbox, calibration, (height, width),
                                    "supervised_reprojection_heatmap_mse" in supervised_3d)

    def supervised_loss(model, images, keypoints, visibility, bbox, stage, calibration=None, gather=False):
        """The supervised loss, its logs, and the decoded keypoints in frame
        pixels. ``gather``: the outputs and labels of every rank, so that
        the loss is the whole batch's."""
        with torch.autocast(
            images.device.type, dtype=torch.bfloat16, enabled=compute_dtype == torch.bfloat16
        ):
            outputs = model(images)
        if gather and mesh.world_size() > 1:
            outputs = (tuple(mesh.gather_rows(o) for o in outputs) if isinstance(outputs, tuple)
                       else mesh.gather_rows(outputs))
            keypoints, visibility, bbox = (mesh.gather_rows(t) for t in (keypoints, visibility, bbox))
            if calibration is not None:
                calibration = tuple(mesh.gather_rows(t) for t in calibration)
        if is_regression:
            # the outputs are the keypoints: the coordinate MSE against the
            # augmented labels, confidences of ones
            loss, logs = supervised(stage=stage, anneal_weight=None,
                                    keypoints_targ=keypoints.reshape(keypoints.shape[0], -1), keypoints_pred=outputs)
            preds, confidences = outputs.detach(), RegressionTracker.confidences(outputs)
        else:
            targets = generate_heatmaps(
                keypoints, height=height, width=width, output_shape=out_shape, visibility=visibility
            )
            if is_context:
                # both heads against the same targets: a batch of 2B
                # (reference heatmap_tracker_mhcrnn.py:154-174)
                if outputs[0].shape != outputs[1].shape:
                    # the CRNN head upsamples as for a stride-32 backbone;
                    # the JAX package's step fails on these shapes too
                    raise ValueError(
                        f"the context model's single-frame maps are {tuple(outputs[0].shape[-2:])} and its "
                        f"multi-frame maps {tuple(outputs[1].shape[-2:])}: heatmap_mhcrnn trains only with a "
                        "stride-32 backbone"
                    )
                outputs = torch.cat(outputs, dim=0)
                targets = torch.cat([targets, targets], dim=0)
                keypoints = torch.cat([keypoints, keypoints], dim=0)
                bbox = torch.cat([bbox, bbox], dim=0)
            if supervised_3d:
                # the 3D losses take the keypoints with gradient: the decode's
                # backward runs in the step
                preds, confidences = model.decode(outputs)
                loss, logs = supervised(
                    stage=stage, anneal_weight=None, heatmaps_targ=targets, heatmaps_pred=outputs,
                    **inputs_3d(preds, keypoints, bbox, calibration),
                )
                preds, confidences = preds.detach(), confidences.detach()
            else:
                loss, logs = supervised(
                    stage=stage, anneal_weight=None, heatmaps_targ=targets, heatmaps_pred=outputs
                )
                with torch.no_grad():
                    preds, confidences = model.decode(outputs.detach())
        with torch.no_grad():
            preds = model_to_frame_batch(preds, bbox, width, height, num_views=num_views)
            kp_frame = model_to_frame_batch(
                keypoints.reshape(keypoints.shape[0], -1), bbox, width, height, num_views=num_views
            )
            rmse, _ = rmse_loss(keypoints_targ=kp_frame, keypoints_pred=preds)
        logs = {k: v.detach() for k, v in logs.items()}
        logs[f"{stage}_supervised_loss"] = loss.detach()
        logs[f"{stage}_supervised_rmse"] = rmse
        return loss, logs, preds, confidences

    def calibration_of(batch: dict) -> tuple[torch.Tensor, ...] | None:
        """A calibrated batch's camera arrays, fp32 (or None)."""
        if "intrinsic_matrix" not in batch:
            return None
        return tuple(batch[k].to(torch.float32) for k in _CALIBRATION_KEYS)

    def augment_3d(batch: dict, draws_3d: augment3d.Draws3D | None) -> tuple[torch.Tensor, torch.Tensor]:
        """The calibrated batch's 3D augmentation: the labels to frame
        pixels, and frame to model pixels by each view's bbox (reference
        datasets.py:825-1120); returns float32 images and model keypoints."""
        if draws_3d is None:
            raise ValueError("a calibrated batch needs its 3D draws (ops/augment3d.sample)")
        b = batch["images"].shape[0]
        kp_frame = model_to_frame_batch(
            batch["keypoints"].reshape(b, -1), batch["bbox"], width, height, num_views=num_views
        ).reshape(b, -1, 2)
        return augment3d.apply(batch["images"].to(torch.float32), kp_frame, *calibration_of(batch), draws_3d,
                               frame_to_model=frame_to_model_matrices(batch["bbox"], width, height))

    def augment_views(state: TrainState, batch: dict, draws: Draws | None, mask_scores: torch.Tensor | None,
                      draws_3d: augment3d.Draws3D | None):
        """The multiview batch's views (after the 3D augmentation when the
        multiview transformer's batch is calibrated) folded into the batch:
        augmented one draw a view image (a view's context stack under one
        draw), patch-masked, and unfolded again."""
        b = batch["images"].shape[0]
        images, keypoints = batch["images"], batch["keypoints"]
        if is_multiview and "intrinsic_matrix" in batch and not augmenter.identity:
            images, keypoints = augment_3d(batch, draws_3d)
        images, keypoints, vis = augmenter.apply(
            images.reshape(b * num_views, *images.shape[2:]),
            keypoints.reshape(b * num_views, -1, 2),
            batch["visibility"].reshape(b * num_views, -1),
            draws,
        )
        if patch_mask is not None:
            ratio = patch_mask_ratio(state.step, *patch_mask)
            if ratio > 0:
                if mask_scores is None:
                    raise ValueError("the patch mask needs its scores (trainer.sample_mask_scores)")
                images = apply_patch_mask(images, ratio, mask_scores)
        return (images.reshape(b, num_views, *images.shape[1:]), keypoints.reshape(b, -1, 2),
                vis.reshape(b, -1))

    def train_step(state: TrainState, batch: dict, draws: Draws | None, video_draws: VideoDraws | None = None,
                   mask_scores: torch.Tensor | None = None, draws_3d: augment3d.Draws3D | None = None) -> dict:
        aw = anneal_weight(
            state.step // steps_per_epoch,
            init_val=float(anneal_cfg.init_val),
            increase_factor=float(anneal_cfg.increase_factor),
            final_val=float(anneal_cfg.final_val),
            freeze_until_epoch=int(anneal_cfg.freeze_until_epoch),
        )
        if num_views > 1:
            images, keypoints, vis = augment_views(state, batch, draws, mask_scores, draws_3d)
        else:
            images, keypoints, vis = augmenter.apply(
                batch["images"], batch["keypoints"], batch["visibility"], draws
            )
        visibility = _effective_visibility(keypoints, vis)
        state.model.train()
        total, logs, _, _ = supervised_loss(
            state.model, _to_nchw(images), keypoints, visibility, batch["bbox"], "train", calibration_of(batch),
            gather=True,
        )
        if has_unsup and "unlabeled" in batch:
            if video_draws is None:
                raise ValueError("an unlabeled window needs its draws (ops/video_augment.sample_video_draws)")
            ul = batch["unlabeled"]
            if num_views > 1:
                # photometric only, one draw for all views and frames
                t = ul["frames"].shape[0]
                frames, transforms = augment_video_sequence(
                    ul["frames"].reshape(t * num_views, *ul["frames"].shape[2:]), video_draws, apply_geometric=False
                )
                frames, transforms = frames.reshape(t, num_views, *frames.shape[1:]), transforms[:t]
            else:
                frames = ul["frames"]
                if frames.ndim == 3:  # planar I420: to RGB in [0, 255] before the augmentation
                    frames = i420_to_rgb(frames)
                frames, transforms = augment_video_sequence(frames, video_draws, apply_geometric=augmenter.is_dlc)
            loss_unsup, logs_unsup = unsupervised_loss(
                state.model, _to_nchw(frames), transforms, ul["bbox"], unsup, aw, (height, width), compute_dtype,
                num_views,
            )
            total = total + loss_unsup
            logs.update({k: v.detach() for k, v in logs_unsup.items()})
            logs["train_unsupervised_loss"] = loss_unsup.detach()
        set_learning_rates(state.optimizer, state.step, head_sched, bb_sched)
        state.optimizer.zero_grad(set_to_none=True)
        world = mesh.world_size()
        # each rank's backward gives its rows' share of the whole batch's
        # gradient; the all-reduce averages, hence the factor
        (total * world if world > 1 else total).backward()
        mesh.all_reduce_gradients(state.model.parameters())
        state.optimizer.step()
        logs["total_loss"] = total.detach()
        logs["total_unsupervised_importance"] = torch.tensor(aw)
        state.step += 1
        return logs

    @torch.no_grad()
    def eval_step(state: TrainState, batch: dict, stage: str):
        state.model.eval()
        visibility = _effective_visibility(batch["keypoints"], batch["visibility"])
        _, logs, preds, confidences = supervised_loss(
            state.model, _to_nchw(batch["images"]), batch["keypoints"], visibility,
            batch["bbox"], stage, calibration_of(batch),
        )
        return logs, preds, confidences

    def train_step_cached(state, cache: dict, idxs: torch.Tensor, valid: torch.Tensor, draws,
                          unlabeled: dict | None = None, video_draws: VideoDraws | None = None,
                          mask_scores: torch.Tensor | None = None, draws_3d: augment3d.Draws3D | None = None):
        batch = {k: v.index_select(0, idxs) for k, v in cache.items()}
        batch["visibility"] = torch.where(valid[:, None], batch["visibility"], 0)
        # NaN pad-row labels so the logged pixel RMSE ignores them
        batch["keypoints"] = torch.where(valid[:, None, None], batch["keypoints"], float("nan"))
        if unlabeled is not None:
            batch["unlabeled"] = unlabeled
        return train_step(state, batch, draws, video_draws, mask_scores, draws_3d)

    return train_step, eval_step, train_step_cached


# ------------------------------------------------------------------------------
# orchestration
# ------------------------------------------------------------------------------


@dataclass
class TrainedModel:
    """Handle on a trained model (the checkpoint is on disk). ``history``
    holds what was logged: one dict per logging step and per validation,
    with ``step`` and ``epoch``. ``predict_fn(images_uint8, bbox)`` predicts
    with the model, in eval mode, on ``device``."""

    cfg: object
    model_dir: Path
    model: nn.Module
    data_module: object
    history: list[dict]
    device: torch.device
    predict_fn: PredictStep


def run_validation_epoch(batches, eval_logs_fn, device: torch.device | None = None) -> dict[str, float]:
    """Validation logs averaged over samples: each batch's logs weigh by its
    count of real (not padding) samples. Under a process group of more than
    one rank, rank ``r`` evaluates batches ``r, r + n, ...`` and the sums
    and counts are all-reduced (on ``device``), so that every rank gets the
    single-device averages."""
    world, rank = mesh.world_size(), mesh.rank()
    sums: dict[str, float] = {}
    n_total = 0
    for i, batch in enumerate(batches):
        if i % world != rank:
            continue
        n_real = int(np.sum(batch["valid"])) if "valid" in batch else len(batch["images"])
        for k, v in eval_logs_fn(batch).items():
            sums[k] = sums.get(k, 0.0) + float(v) * n_real
        n_total += n_real
    if world > 1:
        import torch.distributed as dist

        key_lists: list = [None] * world
        dist.all_gather_object(key_lists, sorted(sums))
        keys = sorted({k for ks in key_lists for k in ks})
        totals = torch.tensor([float(n_total)] + [sums.get(k, 0.0) for k in keys], dtype=torch.float64,
                              device=device)
        dist.all_reduce(totals)
        n_total, sums = int(totals[0]), dict(zip(keys, totals[1:].tolist()))
    return {k: v / max(n_total, 1) for k, v in sums.items()}


def _shard_draws(draws, rank: int, world: int):
    """This rank's rows of the global batch's draws (``Draws``, one a
    sample or view image; ``Draws3D``, one a sample); None stays None."""
    if draws is None or world == 1:
        return draws

    def rows(name: str, value):
        if value is None:
            return None
        if name == "dropout_low_rgb":  # (3, B, ...)
            return mesh.shard_rows(value.transpose(0, 1), rank, world).transpose(0, 1)
        return mesh.shard_rows(value, rank, world)

    return type(draws)(**{f.name: rows(f.name, getattr(draws, f.name)) for f in dataclasses.fields(draws)})


def _window_frames(t: int, context: bool, rank: int, world: int) -> tuple[int, int]:
    """``[start, stop)``, this rank's frames of a ``t``-frame window split
    over ``world`` ranks: equal runs of frames, or, for a context model, of
    its ``t - 4`` windows, each run with the 4 frames of halo its windows
    need. Raises when the frames (windows) do not divide."""
    n = t - 4 if context else t
    if n % world:
        raise ValueError(
            f"an unlabeled window of {t} frames ({n} {'context windows' if context else 'frames'}) does not divide "
            f"over {world} ranks"
        )
    per = n // world
    return rank * per, (rank + 1) * per + (4 if context else 0)


def _check_ported(cfg) -> None:
    """Raise, before anything is trained, on options not ported yet."""
    backend = str(cfg.training.get("checkpoint_backend", "msgpack"))
    if backend != "msgpack":
        raise NotImplementedError(
            f"checkpoint_backend {backend} is not ported (ROADMAP queue 1, item 4: the port writes and reads "
            "msgpack only)"
        )
    unimodal = [n for n in (cfg.model.get("losses_to_use") or []) if str(n).startswith("unimodal")]
    if unimodal:
        raise NotImplementedError(
            f"{unimodal} cannot train: the loss takes keypoints in augmented-image space, which the "
            "JAX package's train step does not pass (ROADMAP queue 1, item 4: the rest of training; queue 3)"
        )


def _device_cache(dataset, device: torch.device) -> dict[str, torch.Tensor]:
    """The whole labeled set on the device: uint8 images (``(N, 5, H, W,
    3)`` context stacks for the context model), keypoints, visibility flags
    and bboxes, by dataset index; a calibrated dataset's camera arrays too."""
    keys = _CACHE_KEYS + (_CALIBRATION_KEYS if getattr(dataset, "is_calibrated", False) else ())
    arrays: dict[str, list] = {k: [] for k in keys}
    for i in range(len(dataset)):
        sample = dataset[i]
        for k in keys:
            arrays[k].append(np.asarray(sample[k]))
    return {k: torch.from_numpy(np.stack(v)).to(device) for k, v in arrays.items()}


def _on_device(batch: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """A validation batch's arrays (its camera arrays when it has them) on ``device``."""
    keys = _CACHE_KEYS + tuple(k for k in _CALIBRATION_KEYS if k in batch)
    return {k: torch.from_numpy(np.asarray(batch[k])).to(device) for k in keys}


def _window_on_device(window: dict, device: torch.device) -> dict[str, torch.Tensor]:
    """An unlabeled window's frames and bbox on ``device``; to a card through
    pinned memory, without waiting for the copy."""
    out = {}
    for key in ("frames", "bbox"):
        host = torch.from_numpy(np.ascontiguousarray(window[key]))
        out[key] = host.pin_memory().to(device, non_blocking=True) if device.type == "cuda" else host
    return out


def _joins_group(cfg) -> bool:
    """Whether this process is one rank of a group it is given:
    ``training.num_nodes`` above 1, ``LP_TPU_COORDINATOR``, torchrun's
    ``WORLD_SIZE`` above 1, or a group the caller brought up."""
    import torch.distributed as dist

    return (int(cfg.training.get("num_nodes", 1) or 1) > 1 or bool(os.environ.get("LP_TPU_COORDINATOR"))
            or int(os.environ.get("WORLD_SIZE", "1") or 1) > 1 or dist.is_initialized())


def train(
    cfg,
    model_dir: str | Path | None = None,
    skip_evaluation: bool = False,
    device: str | torch.device = "cuda",
) -> TrainedModel:
    """Train the configured model on ``device``, write the model directory
    and, unless ``skip_evaluation``, evaluate the best checkpoint into it.
    There is no fallback to the CPU: a CUDA device without CUDA raises.

    Data parallel (reference train.py:411-428, JAX trainer.py:774-899):
    with ``training.num_nodes`` above 1 or ``LP_TPU_COORDINATOR`` (or under
    torchrun), this process joins the group and trains as one rank on its
    local GPU. Otherwise ``training.num_gpus`` above 1 starts one process a
    device, ``min(num_gpus, visible GPUs)`` on CUDA, or ``num_gpus`` CPU
    ranks over gloo with ``device="cpu"``; the processes are started with
    ``spawn`` and meet over a loopback store, a failing one makes this call
    raise with its traceback, and the returned model is rank 0's best
    checkpoint loaded on ``device``."""
    _check_ported(cfg)
    device = resolve_device(device)
    if _joins_group(cfg):
        num_nodes = int(cfg.training.get("num_nodes", 1) or 1)
        mesh.initialize_distributed(backend="nccl" if device.type == "cuda" else "gloo")
        if num_nodes > 1 and mesh.world_size() < num_nodes:
            # without this, each process would train a copy of its own and
            # race the others for the model directory
            raise RuntimeError(
                f"cfg.training.num_nodes={num_nodes} but the process group has {mesh.world_size()} rank(s): check "
                "the coordinator address and the LP_TPU_* variables"
            )
        device = mesh.local_device(device.type)
        if device.type == "cuda":
            torch.cuda.set_device(device)
        return _train(cfg, model_dir, skip_evaluation, device)
    ranks = int(cfg.training.get("num_gpus", 1) or 1)
    if device.type == "cuda":
        ranks = min(ranks, torch.cuda.device_count())
    if ranks > 1:
        return _spawn(cfg, Path(model_dir or os.getcwd()), skip_evaluation, device, ranks)
    return _train(cfg, model_dir, skip_evaluation, device)


def _free_port() -> int:
    """A TCP port of the loopback interface that the OS reports free."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn(cfg, model_dir: Path, skip_evaluation: bool, device: torch.device, ranks: int) -> TrainedModel:
    """Train on ``ranks`` spawned processes (one a GPU, or CPU ranks); then
    the :class:`TrainedModel` of rank 0's best checkpoint on ``device``."""
    import torch.multiprocessing as mp

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.data.factory import get_data_module, get_dataset
    from lightning_pose_tpu_torch.utils.io import return_absolute_data_paths

    model_dir.mkdir(parents=True, exist_ok=True)
    logger.info(f"training on {ranks} ranks ({device.type}), one process each")
    with tempfile.TemporaryDirectory() as tmp:
        history_file = Path(tmp) / "history.pt"
        # what the workers need goes as arguments: a spawned process imports
        # this module afresh (the compute dtype, the torch threads a rank)
        mp.start_processes(
            _train_worker,
            args=(ranks, _free_port(), cfg.to_dict(), str(model_dir), skip_evaluation, device.type, COMPUTE_DTYPE,
                  max(1, torch.get_num_threads() // ranks), str(history_file)),
            nprocs=ranks, join=True, start_method="spawn",
        )
        history = torch.load(history_file, weights_only=False)
    # the names rank 0 filled in from the dataset, as a one-process run
    # fills them into the caller's config
    written = type(cfg).from_yaml(str(model_dir / "config.yaml"))
    for key in ("keypoint_names", "num_keypoints"):
        cfg.data[key] = written.data.get(key)
    loaded = Model.from_dir(model_dir, precision="fp32" if COMPUTE_DTYPE == torch.float32 else "bf16",
                            device=device)
    loaded._load()
    data_dir, video_dir = return_absolute_data_paths(cfg.data)
    data_module = get_data_module(cfg, get_dataset(cfg, data_dir), video_dir)
    close = getattr(data_module, "close", None)
    if close is not None:
        close()
    step = loaded._predict_step
    return TrainedModel(cfg=cfg, model_dir=model_dir, model=step.model, data_module=data_module, history=history,
                        device=device, predict_fn=step)


def _train_worker(rank: int, world: int, port: int, cfg_dict: dict, model_dir: str, skip_evaluation: bool,
                  device_type: str, compute_dtype: torch.dtype, threads: int, history_file: str) -> None:
    """One spawned rank: join the group over the loopback store, train, and
    (rank 0) leave the history for the launcher."""
    global COMPUTE_DTYPE
    import torch.distributed as dist

    from lightning_pose_tpu_torch.config import Config

    COMPUTE_DTYPE = compute_dtype
    torch.set_num_threads(threads)
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh.initialize_distributed(f"tcp://127.0.0.1:{port}", world, rank,
                                backend="nccl" if device.type == "cuda" else "gloo", one_host=True)
    try:
        trained = _train(Config(cfg_dict), model_dir, skip_evaluation, device)
        if rank == 0:
            torch.save(trained.history, history_file)
    finally:
        dist.destroy_process_group()


def _train(cfg, model_dir: str | Path | None, skip_evaluation: bool, device: torch.device) -> TrainedModel:
    """:func:`train` on ``device``, as one rank of the process group when
    there is one."""
    from lightning_pose_tpu_torch.api.model_config import ModelConfig
    from lightning_pose_tpu_torch.callbacks import JSONTrainingProgressTracker, write_status
    from lightning_pose_tpu_torch.data.factory import get_data_module, get_dataset
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import get_model, model_meta
    from lightning_pose_tpu_torch.utils.io import return_absolute_data_paths

    # the evaluation decodes as Model.from_dir(model_dir) will
    decode_method = decode_method_of(cfg)
    rank, world = mesh.rank(), mesh.world_size()
    is_main = rank == 0
    model_dir = Path(model_dir or os.getcwd())
    if is_main:
        model_dir.mkdir(parents=True, exist_ok=True)
    status_file = model_dir / "train_status.json"
    t_start = time.time()

    seed = int(cfg.training.get("rng_seed_model_pt", 0))
    np.random.seed(seed)
    torch.manual_seed(seed)
    ModelConfig(cfg).validate()

    # -- data
    data_dir, video_dir = return_absolute_data_paths(cfg.data)
    dataset = get_dataset(cfg, data_dir)
    if cfg.data.get("keypoint_names", None) is None:
        cfg.data.keypoint_names = list(dataset.keypoint_names)
    if cfg.data.get("num_keypoints", None) is None:
        cfg.data.num_keypoints = dataset.num_keypoints
    data_module = get_data_module(cfg, dataset, video_dir)
    try:
        steps_per_epoch = calculate_steps_per_epoch(data_module)
        loss_factories = get_loss_factories(cfg, data_module)

        # -- model, optimizer, augmentation
        # a multiview model's head is shared by the views: it takes one
        # view's keypoint count
        model = get_model(cfg, num_keypoints=getattr(dataset, "num_keypoints_per_view", dataset.num_keypoints))
        meta = model_meta(cfg)
        height = int(cfg.data.image_resize_dims.height)
        width = int(cfg.data.image_resize_dims.width)
        # pretrained backbone weights from a local torch file; a ViT's
        # position embeddings are resized to the fine-tune grid
        bb_ckpt = cfg.model.get("backbone_checkpoint")
        if bb_ckpt and os.path.isfile(str(bb_ckpt)):
            load_backbone_checkpoint(model.backbone, str(cfg.model.backbone), str(bb_ckpt), image_size=height)
            logger.info(f"loaded pretrained backbone weights from {bb_ckpt}")
        elif bb_ckpt:
            logger.warning(f"backbone_checkpoint {bb_ckpt} is not a file; the backbone keeps its random init")
        if cfg.model.get("checkpoint"):
            if ckpt_utils.warm_start(model, str(cfg.model.checkpoint)):
                logger.info(f"warm-started from {cfg.model.checkpoint}")
            else:
                logger.warning(
                    f"checkpoint {cfg.model.checkpoint} does not match the model head; "
                    "warm-started the backbone only"
                )
        model = model.to(device, memory_format=torch.channels_last)
        mesh.replicate(model)
        optimizer, head_sched, bb_sched = make_optimizer(cfg, steps_per_epoch, model)
        state = TrainState(model=model, optimizer=optimizer)
        augmenter = AugmentationEngine(
            pipeline=dataset.imgaug_pipeline,
            image_height=height,
            image_width=width,
            hflip=bool(cfg.training.get("imgaug_hflip", False)),
            hflip_swap_indices=dataset.hflip_swap_indices,
        )
        num_views = meta["num_views"]
        masking = meta["model_type"] == "heatmap_multiview" and _patch_mask_schedule(cfg, steps_per_epoch) is not None
        # the 3D augmentation's draws (calibrated multiview, a non-identity pipeline)
        draws_3d_on = (meta["model_type"] == "heatmap_multiview" and getattr(dataset, "is_calibrated", False)
                       and not augmenter.identity)
        _, eval_step, train_step_cached = make_step_fns(
            meta, loss_factories, augmenter, cfg, head_sched, bb_sched, steps_per_epoch, COMPUTE_DTYPE
        )
        cache = _device_cache(dataset, device)
        logger.info(f"cached {len(dataset)} labeled samples on {device}")

        # -- model directory (rank 0 writes it; every rank reads the resume
        # checkpoint before anything is written)
        resume_path = None
        if cfg.training.get("resume", False):
            resume_path = ckpt_utils.find_resume_checkpoint(str(model_dir), cfg.model.model_name)
            if resume_path is None:
                logger.info("training.resume is set but no *-last.ckpt was found; starting afresh")
        mesh.sync_collectives()
        writer = version_dir = ckpt_dir = None
        if is_main:
            cfg.save(str(model_dir / "config.yaml"))
            csv_files = cfg.data.csv_file
            for csv_file in [csv_files] if isinstance(csv_files, str) else csv_files:
                src = Path(csv_file) if Path(csv_file).is_absolute() else Path(data_dir) / csv_file
                if src.exists():
                    shutil.copy(src, model_dir / src.name)
            if resume_path is not None:
                version_dir = str(Path(resume_path).parent.parent)
            else:
                version_dir = ckpt_utils.next_version_dir(str(model_dir), cfg.model.model_name)
            os.makedirs(version_dir, exist_ok=True)
            ckpt_dir = ckpt_utils.checkpoint_dir(version_dir)
            try:
                from tensorboardX import SummaryWriter
            except ImportError:
                logger.info("tensorboardX is not installed; no event files are written")
            else:
                writer = SummaryWriter(version_dir)
                writer.add_text("config", "```\n" + cfg.to_yaml() + "\n```")

        sched = _resolve_schedule_cfg(cfg, steps_per_epoch)
        max_epochs, max_steps = sched["max_epochs"], int(sched["max_steps"])
        min_epochs = int(cfg.training.get("min_epochs") or 0)
        check_val_every = int(cfg.training.get("check_val_every_n_epoch", 5) or 5)
        log_every = int(cfg.training.get("log_every_n_steps", 10) or 10)
        ckpt_every = cfg.training.get("ckpt_every_n_epochs", None)
        early_stopping = bool(cfg.training.get("early_stopping", False))
        patience = int(cfg.training.get("early_stop_patience", 3) or 3)

        if is_main:
            write_status(status_file, "TRAINING")
            progress = JSONTrainingProgressTracker(status_file, total_epochs=max_epochs)
        # per-image and per-window draws on the host, fields on the device,
        # both seeded; every rank draws the global batch's and keeps its rows
        data_seed = int(cfg.training.get("rng_seed_data_pt", 0))
        unlabeled_loader = getattr(data_module, "unlabeled_loader", None)
        draw_gen = torch.Generator().manual_seed(data_seed)
        field_gen = torch.Generator(device).manual_seed(data_seed)
        logger.info(
            f"training {meta['model_type']}/{cfg.model.backbone} for {max_epochs} epochs x "
            f"{steps_per_epoch} steps on {device}" + (f", rank {rank} of {world}" if world > 1 else "")
        )
        # this rank's unlabeled frames: its run of one stream's window (every
        # rank on this host), or the whole of its own shard's window
        _, num_shards = mesh.stream_shard()
        context = meta["model_type"] == "heatmap_mhcrnn"

        history: list[dict] = []
        best_val = float("inf")
        best_ckpt_path = last_ckpt_path = None
        bad_val_checks = start_epoch = 0
        if resume_path is not None:
            start_epoch, best_val, bad_val_checks, best_ckpt_path = _resume(
                resume_path, state, draw_gen, field_gen, data_seed
            )
            last_ckpt_path = resume_path
        profiler = _start_profiler(device) if cfg.training.get("profiler", False) and is_main else None
        for epoch in range(start_epoch, max_epochs):
            steps_this_epoch = min(steps_per_epoch, max_steps - state.step)
            if steps_this_epoch <= 0:
                break
            for idxs, valid in data_module.train_index_batches(epoch, steps=steps_this_epoch):
                n_images = len(idxs) * num_views
                draws = None if augmenter.identity else augmenter.sample(draw_gen, n_images, field_gen)
                draws_3d = augment3d.sample(draw_gen, len(idxs)) if draws_3d_on else None
                mask_scores = sample_mask_scores(field_gen, n_images, (height, width)) if masking else None
                if world > 1:
                    idxs, valid = mesh.shard_rows(idxs, rank, world), mesh.shard_rows(valid, rank, world)
                    draws, draws_3d = _shard_draws(draws, rank, world), _shard_draws(draws_3d, rank, world)
                    mask_scores = None if mask_scores is None else mesh.shard_rows(mask_scores, rank, world)
                unlabeled = video_draws = None
                if unlabeled_loader is not None:
                    window = next(unlabeled_loader)
                    t = window["frames"].shape[0]
                    # the global window's draws: one noise field a frame and view
                    video_draws = sample_video_draws(draw_gen, t * num_shards * num_views, height, width, field_gen)
                    if world > 1:
                        if num_shards > 1:
                            start, stop = rank * t, (rank + 1) * t
                        else:
                            start, stop = _window_frames(t, context, rank, world)
                            window = {k: v[start:stop] for k, v in window.items()}
                        video_draws = dataclasses.replace(
                            video_draws, noise=video_draws.noise[start * num_views:stop * num_views]
                        )
                    unlabeled = _window_on_device(window, device)
                logs = train_step_cached(
                    state,
                    cache,
                    torch.from_numpy(idxs).to(device, non_blocking=True),
                    torch.from_numpy(valid).to(device, non_blocking=True),
                    draws,
                    unlabeled,
                    video_draws,
                    mask_scores,
                    draws_3d,
                )
                if state.step % log_every == 0 and is_main:
                    record = {
                        **{k: float(v) for k, v in logs.items()},
                        "lr-head": head_sched(state.step),
                        "lr-backbone": bb_sched(state.step),
                    }
                    history.append({"step": state.step, "epoch": epoch, **record})
                    if writer is not None:
                        for k, v in record.items():
                            writer.add_scalar(k, v, state.step)
                        writer.add_scalar("epoch", epoch, state.step)

            if is_main:
                progress.update(epoch)
            run_val = (epoch + 1) % check_val_every == 0 or epoch == max_epochs - 1
            if not (run_val and len(data_module.val_dataset) > 0):
                continue
            val_logs = run_validation_epoch(
                data_module.val_batches(),
                lambda b: eval_step(state, _on_device(b, device), stage="val")[0],
                device,
            )
            history.append({"step": state.step, "epoch": epoch, **val_logs})
            if writer is not None:
                for k, v in val_logs.items():
                    writer.add_scalar(k, v, state.step)
            val_loss = val_logs.get("val_supervised_loss", float("inf"))
            if val_loss < best_val:
                best_val, bad_val_checks = val_loss, 0
                if is_main:
                    if best_ckpt_path:
                        ckpt_utils.remove_checkpoint(best_ckpt_path)
                    best_ckpt_path = os.path.join(ckpt_dir, f"epoch={epoch}-step={state.step}-best.ckpt")
                    ckpt_utils.save_module(best_ckpt_path, model, state.step, epoch)
            else:
                bad_val_checks += 1
            if is_main:
                if ckpt_every and (epoch + 1) % int(ckpt_every) == 0:
                    ckpt_utils.save_module(
                        os.path.join(ckpt_dir, f"epoch={epoch}-step={state.step}.ckpt"), model, state.step, epoch
                    )
                # the full training state, for training.resume: one a run,
                # refreshed at every validation
                prev_last = last_ckpt_path
                last_ckpt_path = os.path.join(ckpt_dir, f"epoch={epoch}-step={state.step}-last.ckpt")
                ckpt_utils.save_module(
                    last_ckpt_path, model, state.step, epoch,
                    extra={"best_val": float(best_val), "bad_val_checks": int(bad_val_checks),
                           "best_ckpt_path": best_ckpt_path or "",
                           "draw_generator": draw_gen.get_state().numpy(),
                           "field_generator": field_gen.get_state().cpu().numpy()},
                    optimizer=optimizer,
                )
                if prev_last and prev_last != last_ckpt_path:
                    ckpt_utils.remove_checkpoint(prev_last)
            if early_stopping and bad_val_checks >= patience and epoch + 1 >= min_epochs:
                logger.info(f"early stopping at epoch {epoch}")
                break

        if not is_main:
            # rank 0 writes the last checkpoint and evaluates (reference
            # train.py:435-436)
            logger.info(f"training finished in {time.time() - t_start:.1f}s")
            return TrainedModel(
                cfg=cfg, model_dir=model_dir, model=model, data_module=data_module, history=history,
                device=device, predict_fn=PredictStep(model, height, width, COMPUTE_DTYPE, decode_method, num_views),
            )
        if best_ckpt_path is None:  # always leave a checkpoint
            best_ckpt_path = os.path.join(
                ckpt_dir, f"epoch={max_epochs - 1}-step={state.step}-best.ckpt"
            )
            ckpt_utils.save_module(best_ckpt_path, model, state.step, max_epochs - 1)
        if profiler is not None:
            _stop_profiler(profiler, version_dir)
        if writer is not None:
            writer.close()
        logger.info(f"training finished in {time.time() - t_start:.1f}s")

        write_status(status_file, "EVALUATING")
        # evaluate the best checkpoint: what Model.from_dir later loads from
        # this directory (reference train.py:438)
        try:
            best = ckpt_utils.load_checkpoint(best_ckpt_path)
            ckpt_utils.load_flax_variables(model, best["params"], best.get("batch_stats", {}))
            logger.info(f"reloaded best checkpoint for evaluation: {best_ckpt_path}")
        except Exception as e:  # never fail the run over the choice of eval state
            logger.warning(f"could not reload best checkpoint ({e}); using final state")
        model.eval()
        trained = TrainedModel(
            cfg=cfg, model_dir=model_dir, model=model, data_module=data_module, history=history,
            device=device, predict_fn=PredictStep(model, height, width, COMPUTE_DTYPE, decode_method, num_views),
        )
        if not skip_evaluation:
            _evaluate_on_training_dataset(trained)
            # out-of-distribution label files, skipped where absent
            # (reference train.py:110-113)
            _evaluate_on_suffixed_csv(trained, suffix="_new")
            _evaluate_on_suffixed_csv(trained, suffix="_test")
            _predict_test_videos(trained)
        write_status(status_file, "COMPLETED")
        return trained
    finally:
        close = getattr(data_module, "close", None)
        if close is not None:  # the unlabeled stream's decode threads
            close()


def _resume(resume_path: str, state: TrainState, draw_gen: torch.Generator, field_gen: torch.Generator,
            data_seed: int) -> tuple[int, float, int, str | None]:
    """Restore a ``-last.ckpt`` (of either package) into ``state`` and the
    generators; returns ``(start epoch, best_val, bad_val_checks,
    best_ckpt_path)``. A checkpoint without generator states (the JAX
    package's) leaves the generators at their seed."""
    ckpt = ckpt_utils.load_checkpoint(resume_path)
    if "opt_state" not in ckpt:
        raise ValueError(f"{resume_path} holds no optimizer state; it cannot be resumed")
    ckpt_utils.load_flax_variables(state.model, ckpt["params"], ckpt.get("batch_stats") or {})
    count = ckpt_utils.load_optimizer_state_from_flax(state.model, state.optimizer, ckpt["opt_state"])
    state.step = int(ckpt["step"])
    if count != state.step:
        raise ValueError(f"{resume_path}: the optimizer took {count} steps, the checkpoint says {state.step}")
    extra = ckpt.get("extra") or {}
    if "draw_generator" in extra and "field_generator" in extra:
        draw_gen.set_state(torch.from_numpy(np.asarray(extra["draw_generator"], dtype=np.uint8)))
        field_gen.set_state(torch.from_numpy(np.asarray(extra["field_generator"], dtype=np.uint8)))
        streams = "the augmentation draws continue from the checkpoint's generator states"
    else:
        streams = (f"the checkpoint holds no generator states (the JAX package writes none): the augmentation "
                   f"draws start again from rng_seed_data_pt = {data_seed}")
    bp = extra.get("best_ckpt_path") or None
    logger.info(f"resumed from {resume_path}: epoch {int(ckpt['epoch']) + 1}, step {state.step}; {streams}; "
                "the unlabeled stream starts afresh")
    return (int(ckpt["epoch"]) + 1, float(extra.get("best_val", float("inf"))), int(extra.get("bad_val_checks", 0)),
            bp if bp and os.path.exists(bp) else None)


def _start_profiler(device: torch.device):
    """A started ``torch.profiler`` of host and (on a card) CUDA activity."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    profiler = profile(activities=activities)
    profiler.start()
    return profiler


def _stop_profiler(profiler, version_dir: str) -> None:
    """Stop ``profiler`` and write its Chrome trace into the version dir."""
    profiler.stop()
    path = os.path.join(version_dir, "profiler_trace.json")
    profiler.export_chrome_trace(path)
    logger.info(f"profiler trace written to {path}")


# ------------------------------------------------------------------------------
# evaluation after training
# ------------------------------------------------------------------------------


def _suffixed_csv_paths(cfg, suffix: str) -> list[Path] | None:
    """Absolute paths of the ``<stem><suffix>.csv`` label files, or None if
    the first one does not exist (reference train.py:146-200)."""
    csv_cfg = cfg.data.csv_file
    csv_files = [csv_cfg] if isinstance(csv_cfg, str) else list(csv_cfg)
    out = []
    for csv_file in csv_files:
        p = Path(csv_file)
        if not p.is_absolute():
            p = Path(cfg.data.data_dir) / p
        out.append(p.with_stem(p.stem + suffix))
    if not out[0].exists():
        return None
    return out


def _labels_files(cfg, csv_files) -> list[Path]:
    """Absolute paths of a ``csv_file`` setting, one a view."""
    paths = [Path(c) for c in ([csv_files] if isinstance(csv_files, (str, Path)) else csv_files)]
    return [p if p.is_absolute() else Path(cfg.data.data_dir) / p for p in paths]


def _write_image_preds(
    model: TrainedModel, cfg, data_module, labels_files: list[Path], suffix: str, what: str
) -> None:
    """Predict every frame of ``data_module``; for each view's labels file,
    write ``image_preds/<labels name>/predictions.csv`` and its metric CSVs,
    and copy them into the model directory as
    ``predictions[_<view>][_<metric>]<suffix>.csv``. A metrics failure is
    logged, as in the JAX package."""
    from lightning_pose_tpu_torch.metrics import compute_metrics_single
    from lightning_pose_tpu_torch.utils.predictions import predict_dataset

    # the set column stays: the metrics tell labeled from video predictions
    # by it (reference predictions.py:220-236)
    result = predict_dataset(cfg, data_module, model.predict_fn, model.device)
    views = list(result.items()) if isinstance(result, dict) else [(None, result)]
    for (view, df), labels_file in zip(views, labels_files):
        preds_dir = model.model_dir / "image_preds" / labels_file.name
        preds_dir.mkdir(parents=True, exist_ok=True)
        preds_file = preds_dir / "predictions.csv"
        df.to_csv(preds_file)
        try:
            compute_metrics_single(
                cfg=cfg, labels_file=str(labels_file), preds_file=str(preds_file), data_module=data_module
            )
        except Exception as e:
            logger.warning(f"metrics computation failed ({what}{f', {view}' if view else ''}): {e}")
        for p_file in preds_dir.glob("predictions*.csv"):
            view_part = f"_{view}" if view else ""
            name = f"predictions{view_part}{p_file.stem[len('predictions'):]}{suffix}.csv"
            shutil.copy(p_file, model.model_dir / name)


def _evaluate_on_suffixed_csv(model: TrainedModel, suffix: str) -> None:
    """Predict the ``<csv stem><suffix>.csv`` label files after training
    (the reference's ``_new``/``_test`` evaluation, train.py:110-113,146-246):
    ``image_preds/<name>/predictions*.csv`` and suffixed legacy copies in
    the model directory."""
    from lightning_pose_tpu_torch.data.datamodules import BaseDataModule
    from lightning_pose_tpu_torch.data.factory import get_dataset

    cfg = model.cfg
    csv_paths = _suffixed_csv_paths(cfg, suffix)
    if csv_paths is None:
        return
    logger.info(f"Predicting {suffix.lstrip('_')} images...")
    cfg2 = cfg.copy()
    multiview = not isinstance(cfg.data.csv_file, str)
    cfg2.data.csv_file = [str(p) for p in csv_paths] if multiview else str(csv_paths[0])
    try:
        dataset = get_dataset(cfg2, str(cfg.data.data_dir), imgaug_pipeline="default")
        data_module = BaseDataModule(
            dataset=dataset,
            train_batch_size=cfg.training.train_batch_size,
            val_batch_size=cfg.training.val_batch_size,
            test_batch_size=cfg.training.test_batch_size,
            train_probability=cfg.training.train_prob,
            val_probability=cfg.training.get("val_prob", None),
            torch_seed=cfg.training.get("rng_seed_data_pt", 42),
        )
    except Exception as e:
        logger.warning(f"could not load {suffix} label files ({e}); skipping")
        return
    _write_image_preds(model, cfg2, data_module, csv_paths, suffix, suffix)


def _evaluate_on_training_dataset(model: TrainedModel) -> None:
    """Predict all labeled frames; write ``predictions.csv`` and the metric
    CSVs, one set a view, and their legacy copies in the model directory
    (reference train.py:146-246)."""
    cfg = model.cfg
    _write_image_preds(
        model, cfg, model.data_module, _labels_files(cfg, cfg.data.csv_file), "", "labeled frames"
    )


def _predict_test_videos(model: TrainedModel) -> None:
    """Predict the videos of ``eval.test_videos_directory`` when
    ``eval.predict_vids_after_training`` is set (reference train.py:248-271);
    a multiview model predicts each session's views together. A failure is
    logged, as in the JAX package."""
    from lightning_pose_tpu_torch.utils.io import find_video_files_for_views, get_videos_in_dir
    from lightning_pose_tpu_torch.utils.video_predictions import predict_video, predict_video_multiview

    cfg = model.cfg
    if not cfg.eval.get("predict_vids_after_training", False):
        return
    video_dir = cfg.eval.get("test_videos_directory")
    if not video_dir or not os.path.isdir(str(video_dir)):
        return
    save_videos = bool(cfg.eval.get("save_vids_after_training", False))
    view_names = cfg.data.get("view_names", None)
    try:
        if view_names and len(view_names) > 1:
            for session in find_video_files_for_views(str(video_dir), list(view_names)):
                logger.info(f"predicting multiview session: {session}")
                predict_video_multiview(
                    video_file_per_view=[str(v) for v in session],
                    view_names=list(view_names),
                    cfg=cfg,
                    predict_fn=model.predict_fn,
                    model_dir=str(model.model_dir),
                    device=model.device,
                    generate_labeled_video=save_videos,
                )
            return
        for video_file in get_videos_in_dir(str(video_dir)):
            logger.info(f"predicting video: {video_file}")
            predict_video(
                video_file=video_file,
                cfg=cfg,
                predict_fn=model.predict_fn,
                model_dir=str(model.model_dir),
                device=model.device,
                data_module=model.data_module,
                generate_labeled_video=save_videos,
            )
    except Exception as e:
        logger.warning(f"video prediction failed: {e}")
