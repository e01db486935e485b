"""Multiview dataset, uncalibrated (counterpart of
``lightning_pose_tpu/data/datasets_multiview.py``).

One ``HeatmapDataset`` per view, each with its own label CSV (and bbox CSV),
checked against each other up front: the same keypoint names and the same
frame count. A sample fuses the views: images ``(V, H, W, 3)``, keypoints
``(V*K, 2)`` and visibility ``(V*K,)`` view-major (the model's channel
order), bboxes ``(4V,)``.

Camera calibration is not ported: a ``camera_params_file``, or the anipose
TOMLs that the JAX package discovers beside the labeled frames
(``calibrations/<session>.toml`` or ``calibration.toml``), raises
``NotImplementedError`` rather than train without the 3D stage the JAX
package would run.
"""

from __future__ import annotations

import os

import numpy as np

from lightning_pose_tpu_torch.data.datasets import HeatmapDataset

__all__ = ["MultiviewHeatmapDataset"]

_CALIBRATION_ITEM = "ROADMAP queue 1, item 6b: calibration, 3D and heatmap models on multiview data"


class MultiviewHeatmapDataset:
    """Fuses per-view ``HeatmapDataset``s; its length is the frame count."""

    def __init__(self, cfg, data_dir: str, imgaug_pipeline=None) -> None:
        view_names = list(cfg.data.view_names)
        csv_files = cfg.data.csv_file
        if isinstance(csv_files, str):
            raise ValueError("multiview datasets require one csv_file per view (a list)")
        csv_files = list(csv_files)
        if len(csv_files) != len(view_names):
            raise ValueError(f"{len(csv_files)} csv files != {len(view_names)} views")
        self.view_names = view_names
        self.cfg = cfg
        self.root_directory = data_dir
        bbox_files = cfg.data.get("bbox_file", None)
        self.view_datasets: dict[str, HeatmapDataset] = {
            view: HeatmapDataset(
                root_directory=data_dir,
                csv_path=csv_file,
                image_resize_height=cfg.data.image_resize_dims.height,
                image_resize_width=cfg.data.image_resize_dims.width,
                imgaug_pipeline=imgaug_pipeline,
                downsample_factor=int(cfg.data.get("downsample_factor", 2)),
                bbox_path=bbox_files[i] if bbox_files else None,
            )
            for i, (view, csv_file) in enumerate(zip(view_names, csv_files))
        }
        first = self.view_datasets[view_names[0]]
        for view in view_names[1:]:
            ds = self.view_datasets[view]
            if ds.keypoint_names != first.keypoint_names:
                raise ValueError(f"keypoint names differ between views {view_names[0]} and {view}")
            if len(ds) != len(first):
                raise ValueError(f"frame counts differ between views: {len(first)} vs {len(ds)}")

        self.keypoint_names = first.keypoint_names
        self.num_keypoints_per_view = first.num_keypoints
        self.num_keypoints = first.num_keypoints * len(view_names)
        self.num_targets = self.num_keypoints * 2
        self.do_context = False
        self.imgaug_pipeline = imgaug_pipeline
        # identity swaps over one view's keypoints: the engine augments each
        # view image on its own
        self.hflip_swap_indices = np.arange(self.num_keypoints_per_view, dtype=np.intp)
        self.downsample_factor = first.downsample_factor
        self.image_names_by_view = {view: self.view_datasets[view].image_names for view in view_names}
        self.image_names = first.image_names
        self._refuse_calibration()

    def _refuse_calibration(self) -> None:
        """Raise where the JAX package would load a calibration: a
        ``camera_params_file``, or every frame's
        ``labeled-data/<session>_<view>/`` path finding
        ``calibrations/<session>.toml`` or ``calibration.toml`` (where only
        some frames find one, the JAX package trains without 3D, and so does
        this). A path that does not follow that pattern raises
        ``ValueError``, as there."""
        cam_file = self.cfg.data.get("camera_params_file", None)
        if cam_file:
            raise NotImplementedError(f"camera_params_file {cam_file} needs the 3D stage ({_CALIBRATION_ITEM})")
        found = []
        for img_name in self.image_names:
            parts = img_name.replace("\\", "/").split("/")
            try:
                folder = parts[parts.index("labeled-data") + 1]
            except (ValueError, IndexError) as err:
                raise ValueError(
                    f"Image path '{img_name}' does not match expected pattern "
                    "labeled-data/<session>_<view>/img<frameidx>.ext"
                ) from err
            if "_" not in folder:
                raise ValueError(
                    f"Folder '{folder}' in image path '{img_name}' does not match expected pattern <session>_<view>"
                )
            session = folder.rsplit("_", 1)[0]
            for candidate in (os.path.join("calibrations", f"{session}.toml"), "calibration.toml"):
                if os.path.exists(os.path.join(self.root_directory, candidate)):
                    found.append(candidate)
                    break
        if found and len(found) == len(self.image_names):
            raise NotImplementedError(
                f"found anipose calibration {sorted(set(found))}, which needs the 3D stage ({_CALIBRATION_ITEM})"
            )

    def __len__(self) -> int:
        return len(self.view_datasets[self.view_names[0]])

    def keypoints_resized(self, idx: int) -> np.ndarray:
        """Fused ``(V*K, 2)`` view-major resized keypoints (for the PCA fit)."""
        return np.concatenate([self.view_datasets[v].keypoints_resized(idx) for v in self.view_names], axis=0)

    def __getitem__(self, idx: int) -> dict:
        samples = [self.view_datasets[view][idx] for view in self.view_names]
        return {
            "images": np.stack([s["images"] for s in samples]),  # (V, H, W, 3)
            "keypoints": np.concatenate([s["keypoints"] for s in samples], axis=0),  # (V*K, 2)
            "visibility": np.concatenate([s["visibility"] for s in samples], axis=0),
            "bbox": np.concatenate([s["bbox"] for s in samples], axis=0),  # (4V,)
            "idx": idx,
            "num_views": len(self.view_names),
        }
