"""Dataset and data-module factories (counterpart of
``lightning_pose_tpu/data/factory.py``).

The datasets and data modules are the JAX package's own: they are host code
with no JAX in them. Its ``get_dataset`` and ``get_data_module`` look the
model type up in the JAX model factory, which imports JAX, so the dispatch
for the ported model is here. Model types and data layouts not ported yet
raise ``NotImplementedError``.
"""

from __future__ import annotations

from lightning_pose_tpu.data.datamodules import BaseDataModule
from lightning_pose_tpu.data.datasets import HeatmapDataset
from lightning_pose_tpu.data.factory import get_imgaug_pipeline
from lightning_pose_tpu_torch.models.factory import (
    _NOT_PORTED,
    check_if_semi_supervised,
    normalize_model_type,
)

__all__ = ["get_data_module", "get_dataset"]


def get_dataset(cfg, data_dir: str, imgaug_pipeline=None) -> HeatmapDataset:
    """The labeled dataset of a single-view ``heatmap`` config."""
    model_type = normalize_model_type(cfg.model.model_type)
    if model_type in _NOT_PORTED:
        raise NotImplementedError(
            f"datasets of model_type {model_type} are not ported yet ({_NOT_PORTED[model_type]})"
        )
    view_names = cfg.data.get("view_names") or []
    if len(view_names) > 1:
        raise NotImplementedError(
            "multiview datasets are not ported yet (ROADMAP queue 1, item 12)"
        )
    return HeatmapDataset(
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
        do_context=False,
        downsample_factor=int(cfg.data.get("downsample_factor", 2)),
    )


def get_data_module(cfg, dataset, video_dir: str | None = None) -> BaseDataModule:
    """The supervised data module: seeded splits and batch iterators."""
    if check_if_semi_supervised(cfg.model.get("losses_to_use")):
        raise NotImplementedError(
            "semi-supervised data modules are not ported yet (ROADMAP queue 1, item 10)"
        )
    return BaseDataModule(
        dataset=dataset,
        train_batch_size=cfg.training.train_batch_size,
        val_batch_size=cfg.training.val_batch_size,
        test_batch_size=cfg.training.test_batch_size,
        train_probability=cfg.training.train_prob,
        val_probability=cfg.training.get("val_prob", None),
        train_frames=cfg.training.get("train_frames", None),
        torch_seed=cfg.training.get("rng_seed_data_pt", 42),
    )
