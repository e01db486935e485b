"""Dataset and data-module factories (counterpart of
``lightning_pose_tpu/data/factory.py``).

The dispatch on the config: the single-view ``heatmap`` model, the
``regression`` model (the base dataset, no heatmap geometry), the context
model ``heatmap_mhcrnn`` (5-frame stacks) and the multiview transformer
``heatmap_multiview`` (one label CSV a view), over the port's copies of the
datasets and the data module. ``heatmap`` and ``heatmap_mhcrnn`` with more
than one view take the multiview dataset too (context stacks for the
latter); ``regression`` with views raises the JAX package's
``NotImplementedError``.
"""

from __future__ import annotations

from lightning_pose_tpu_torch.data.datamodules import BaseDataModule
from lightning_pose_tpu_torch.data.datasets import BaseTrackingDataset, HeatmapDataset
from lightning_pose_tpu_torch.data.datasets_multiview import MultiviewHeatmapDataset
from lightning_pose_tpu_torch.models.factory import check_if_semi_supervised, normalize_model_type

__all__ = ["get_data_module", "get_dataset", "get_imgaug_pipeline"]


def get_imgaug_pipeline(cfg) -> str | dict:
    """Resolve the augmentation spec: a preset string or a per-transform dict
    (reference data/factory.py:47-100 + augmentations.py:109)."""
    aug = cfg.training.get("imgaug", "default")
    if isinstance(aug, str):
        allowed = ["default", "none", "dlc", "dlc-lr", "dlc-top-down", "dlc-mv"]
        if aug not in allowed:
            raise NotImplementedError(
                f"cfg.training.imgaug string {aug} must be in {allowed}"
            )
        return aug
    return aug.to_dict(resolve=True) if hasattr(aug, "to_dict") else dict(aug)


def get_dataset(cfg, data_dir: str, imgaug_pipeline=None) -> BaseTrackingDataset | MultiviewHeatmapDataset:
    """The labeled dataset of a ``heatmap``, ``regression`` or
    ``heatmap_mhcrnn`` config (the latter's samples are context stacks in
    the configured ``model.mhcrnn_context_mode``), or of a multiview
    transformer config; the heatmap models with more than one view in
    ``data.view_names`` take the multiview dataset (reference
    data/factory.py:152-185)."""
    model_type = normalize_model_type(cfg.model.model_type)
    view_names = cfg.data.get("view_names") or []
    if model_type == "heatmap_multiview" or (model_type != "regression" and len(view_names) > 1):
        return MultiviewHeatmapDataset(cfg, data_dir, imgaug_pipeline=imgaug_pipeline or get_imgaug_pipeline(cfg),
                                       do_context=model_type == "heatmap_mhcrnn")
    common = dict(
        root_directory=data_dir,
        csv_path=cfg.data.csv_file,
        image_resize_height=cfg.data.image_resize_dims.height,
        image_resize_width=cfg.data.image_resize_dims.width,
        imgaug_pipeline=imgaug_pipeline or get_imgaug_pipeline(cfg),
        imgaug_hflip=bool(cfg.training.get("imgaug_hflip", False)),
        bbox_path=cfg.data.get("bbox_file", None),
        uniform_heatmaps_for_nan_keypoints=bool(
            cfg.training.get("uniform_heatmaps_for_nan_keypoints", False)
        ),
    )
    if model_type == "regression":
        if len(view_names) > 1:
            # a limit of the JAX package too (its data/factory.py)
            raise NotImplementedError("Multi-view support only available for heatmap-based models")
        return BaseTrackingDataset(do_context=False, **common)
    return HeatmapDataset(
        **common,
        downsample_factor=int(cfg.data.get("downsample_factor", 2)),
        do_context=model_type == "heatmap_mhcrnn",
        context_mode=cfg.model.get("mhcrnn_context_mode", "adjacent"),
    )


def get_data_module(cfg, dataset, video_dir: str | None = None) -> BaseDataModule:
    """The data module: seeded splits and batch iterators; a semi-supervised
    config adds the unlabeled video stream from ``video_dir`` (reference
    data/factory.py:205-319)."""
    common = dict(
        dataset=dataset,
        train_batch_size=cfg.training.train_batch_size,
        val_batch_size=cfg.training.val_batch_size,
        test_batch_size=cfg.training.test_batch_size,
        train_probability=cfg.training.train_prob,
        val_probability=cfg.training.get("val_prob", None),
        train_frames=cfg.training.get("train_frames", None),
        torch_seed=cfg.training.get("rng_seed_data_pt", 42),
    )
    if not check_if_semi_supervised(cfg.model.get("losses_to_use")):
        return BaseDataModule(**common)
    from lightning_pose_tpu_torch.data.unlabeled import UnlabeledDataModule

    return UnlabeledDataModule(cfg=cfg, video_dir=video_dir, **common)
