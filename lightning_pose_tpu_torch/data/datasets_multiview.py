"""Multiview dataset (counterpart of
``lightning_pose_tpu/data/datasets_multiview.py``).

One ``HeatmapDataset`` per view, each with its own label CSV (and bbox CSV),
checked against each other up front: the same keypoint names and the same
frame count. A sample fuses the views: images ``(V, H, W, 3)`` (with
``do_context``, for a context model, ``(V, 5, H, W, 3)`` stacks in
``model.mhcrnn_context_mode``), keypoints ``(V*K, 2)`` and visibility
``(V*K,)`` view-major (the model's channel order), bboxes ``(4V,)``.

The optional camera calibration (``data.camera_params_file``: a single
anipose TOML, a frame-map CSV or the one-row-per-view CSV; or anipose TOMLs
discovered beside the labeled frames, ``calibrations/<session>.toml`` or
``calibration.toml``) adds ``intrinsic_matrix (V, 3, 3)``,
``extrinsic_matrix (V, 3, 4)`` and ``distortions (V, 5)`` to each sample;
the multiview transformer's trainer then runs the 3D augmentation and the
supervised 3D losses. A context dataset with a calibration raises
``ValueError``, as the JAX package's does: the 3D augmentation takes no
context stacks.
"""

from __future__ import annotations

import logging
import os

import numpy as np

from lightning_pose_tpu_torch.data.anipose import load_anipose_toml
from lightning_pose_tpu_torch.data.datasets import HeatmapDataset

logger = logging.getLogger(__name__)

__all__ = ["MultiviewHeatmapDataset"]


class MultiviewHeatmapDataset:
    """Fuses per-view ``HeatmapDataset``s; its length is the frame count."""

    def __init__(self, cfg, data_dir: str, imgaug_pipeline=None, do_context: bool = False) -> None:
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
                do_context=do_context,
                context_mode=cfg.model.get("mhcrnn_context_mode", "adjacent"),
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
        self.do_context = bool(do_context)
        self.imgaug_pipeline = imgaug_pipeline
        # identity swaps over one view's keypoints: the engine augments each
        # view image on its own
        self.hflip_swap_indices = np.arange(self.num_keypoints_per_view, dtype=np.intp)
        self.downsample_factor = first.downsample_factor
        self.image_names_by_view = {view: self.view_datasets[view].image_names for view in view_names}
        self.image_names = first.image_names
        self._load_calibration()

    # -- calibration ---------------------------------------------------------------

    def _load_calibration(self) -> None:
        """The optional camera calibration, from the three sources the JAX
        package reads, in its order (reference datasets.py:674-760):
        ``data.camera_params_file`` as a frame-map CSV (a ``file`` column
        naming an anipose TOML a frame), as a single anipose TOML, or as the
        one-row-per-view ``K``/``RT``/``d`` CSV; without it, discovery from
        ``labeled-data/<session>_<view>/`` to ``calibrations/<session>.toml``,
        else ``calibration.toml``."""
        self.camera_params = None  # one calibration shared by all frames
        self._calib_by_file: dict[str, dict] = {}
        self._calib_file_per_frame: list[str] | None = None
        cam_file = self.cfg.data.get("camera_params_file", None)
        if cam_file and self.do_context:
            # reference datasets.py:686,748
            raise ValueError(
                "3D augmentations (camera_params_file) are not supported for context (heatmap_mhcrnn) models"
            )
        if not cam_file:
            self._discover_calibration()
            return
        path = cam_file if os.path.isabs(cam_file) else os.path.join(self.root_directory, cam_file)
        if not os.path.exists(path):
            logger.warning(f"camera_params_file not found: {path}")
        elif str(path).endswith(".toml"):
            self.camera_params = self._load_calib_toml(str(path))
        else:
            import pandas as pd

            df = pd.read_csv(path, index_col=0)
            if "file" in df.columns:
                self._load_frame_map(df)
            else:
                self.camera_params = self._load_view_rows_csv(df)

    def _load_calib_toml(self, path: str) -> dict:
        """An anipose TOML whose camera names must be ``view_names`` in
        order (reference datasets.py:656-672)."""
        calib = load_anipose_toml(path)
        if calib["names"] != list(self.view_names):
            raise ValueError(
                "cfg.data.view_names must have same camera order as camera "
                f"calibration file; instead found {list(self.view_names)} and "
                f"{calib['names']} in {path}."
            )
        return calib

    def _load_frame_map(self, df) -> None:
        """One row a labeled frame, in the first view's order; its ``file``
        names the frame's TOML, relative to the data directory."""
        img_idxs_labels = [i.split("/")[-1] for i in self.image_names]
        img_idxs_calib = [str(i).split("/")[-1] for i in df.index]
        if img_idxs_labels != img_idxs_calib:
            raise ValueError("camera_params_file rows must match the label CSV frames (same order, same filenames)")
        files = [str(f) for f in df["file"]]
        for f in set(files):
            path = f if os.path.isabs(f) else os.path.join(self.root_directory, f)
            self._calib_by_file[f] = self._load_calib_toml(path)
        self._calib_file_per_frame = files

    def _discover_calibration(self) -> None:
        """A TOML a frame from its path; where only some frames find one,
        3D is off for the whole set, with a warning. A path that does not
        follow ``labeled-data/<session>_<view>/`` raises ``ValueError``."""
        files: list[str | None] = []
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
            by_session = os.path.join("calibrations", f"{session}.toml")
            if os.path.exists(os.path.join(self.root_directory, by_session)):
                files.append(by_session)
            elif os.path.exists(os.path.join(self.root_directory, "calibration.toml")):
                files.append("calibration.toml")
            else:
                files.append(None)
        found = {f for f in files if f is not None}
        if not found:
            return
        if None in files:
            logger.warning("calibration file not found for some frames; disabling 3D for entire dataset")
            return
        try:
            for f in found:
                self._calib_by_file[f] = self._load_calib_toml(os.path.join(self.root_directory, f))
        except ValueError as e:
            logger.warning(f"calibration load failed: {e}")
            self._calib_by_file = {}
            return
        self._calib_file_per_frame = files
        if self.do_context:
            raise ValueError(
                "found anipose calibration for this dataset, but 3D augmentations are not supported for context "
                "(heatmap_mhcrnn) models; remove the calibration files or use model_type "
                "heatmap_multiview_transformer"
            )
        logger.info(f"discovered anipose calibration for {len(files)} frames ({len(self._calib_by_file)} file(s))")

    def _load_view_rows_csv(self, df) -> dict:
        """The one-row-per-view CSV: ``K00..K22``, ``RT00..RT23``, ``d0..d4``."""
        intr, extr, dist = [], [], []
        for view in self.view_names:
            row = df.loc[view]
            intr.append(np.asarray(row[[f"K{i}{j}" for i in range(3) for j in range(3)]], np.float32).reshape(3, 3))
            extr.append(np.asarray(row[[f"RT{i}{j}" for i in range(3) for j in range(4)]], np.float32).reshape(3, 4))
            dist.append(np.asarray(row[[f"d{i}" for i in range(5)]], dtype=np.float32))
        return {"intrinsics": np.stack(intr), "extrinsics": np.stack(extr), "distortions": np.stack(dist)}

    @property
    def is_calibrated(self) -> bool:
        return self.camera_params is not None or self._calib_file_per_frame is not None

    def frame_calibration(self, idx: int) -> dict | None:
        """The camera arrays of frame ``idx`` (its TOML under a per-frame
        mapping, else the shared calibration), or None."""
        if self._calib_file_per_frame is not None:
            return self._calib_by_file[self._calib_file_per_frame[idx]]
        return self.camera_params

    def __len__(self) -> int:
        return len(self.view_datasets[self.view_names[0]])

    def keypoints_resized(self, idx: int) -> np.ndarray:
        """Fused ``(V*K, 2)`` view-major resized keypoints (for the PCA fit)."""
        return np.concatenate([self.view_datasets[v].keypoints_resized(idx) for v in self.view_names], axis=0)

    def __getitem__(self, idx: int) -> dict:
        samples = [self.view_datasets[view][idx] for view in self.view_names]
        sample = {
            "images": np.stack([s["images"] for s in samples]),  # (V, H, W, 3) or (V, 5, H, W, 3)
            "keypoints": np.concatenate([s["keypoints"] for s in samples], axis=0),  # (V*K, 2)
            "visibility": np.concatenate([s["visibility"] for s in samples], axis=0),
            "bbox": np.concatenate([s["bbox"] for s in samples], axis=0),  # (4V,)
            "idx": idx,
            "num_views": len(self.view_names),
        }
        calib = self.frame_calibration(idx)
        if calib is not None:
            sample["intrinsic_matrix"] = calib["intrinsics"]  # (V, 3, 3)
            sample["extrinsic_matrix"] = calib["extrinsics"]  # (V, 3, 4)
            sample["distortions"] = calib["distortions"]  # (V, 5)
        return sample
