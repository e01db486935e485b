"""Labeled-frame datasets, host-side numpy (the port's copy of what it uses
of ``lightning_pose_tpu/data/datasets.py``).

Images are decoded once on the host (cv2), resized to the model's size and
cached as uint8 arrays; keypoints are rescaled to resized coordinates.
Augmentation, normalization and the target heatmaps run on the device in
the train step. Horizontal-flip keypoint swapping (``_left``/``_right``
pairs) is an index array the augmentation engine consumes. With
``do_context`` (the context model), a sample's images are the 5-frame stack
of frames n-2..n+2 of its center frame.
"""

from __future__ import annotations

import logging
import os
from pathlib import Path

import cv2
import numpy as np

from lightning_pose_tpu_torch.data.datatypes import BaseLabeledExampleDict
from lightning_pose_tpu_torch.utils import io as io_utils

logger = logging.getLogger(__name__)

__all__ = ["BaseTrackingDataset", "HeatmapDataset", "build_hflip_swap_indices"]

def build_hflip_swap_indices(keypoint_names: list[str]) -> np.ndarray:
    """Index array swapping _left/_right keypoint pairs under horizontal flip
    (reference datasets.py:175-232)."""
    indices = list(range(len(keypoint_names)))
    left_map = {
        name[:-5]: i for i, name in enumerate(keypoint_names) if name.endswith("_left")
    }
    right_map = {
        name[:-6]: i for i, name in enumerate(keypoint_names) if name.endswith("_right")
    }
    unmatched_left = sorted(f"{b}_left" for b in set(left_map) - set(right_map))
    unmatched_right = sorted(f"{b}_right" for b in set(right_map) - set(left_map))
    if unmatched_left:
        raise ValueError(
            f"imgaug_hflip requires matching _left/_right pairs, "
            f"but found _left keypoints with no _right partner: {unmatched_left}"
        )
    if unmatched_right:
        raise ValueError(
            f"imgaug_hflip requires matching _left/_right pairs, "
            f"but found _right keypoints with no _left partner: {unmatched_right}"
        )
    for base, left_idx in left_map.items():
        right_idx = right_map[base]
        indices[left_idx] = right_idx
        indices[right_idx] = left_idx
    return np.asarray(indices, dtype=np.intp)


class BaseTrackingDataset:
    """Images + (x, y) keypoints, resized on host, cached as uint8."""

    def __init__(
        self,
        root_directory: str | Path,
        csv_path: str,
        image_resize_height: int,
        image_resize_width: int,
        header_rows: list[int] | None = None,
        imgaug_pipeline: str | dict | None = "default",
        bbox_path: str | None = None,
        imgaug_hflip: bool = False,
        cache_images: bool = True,
        uniform_heatmaps_for_nan_keypoints: bool = False,
        do_context: bool = False,
        context_mode: str = "adjacent",
    ) -> None:
        self.root_directory = Path(root_directory)
        self.image_resize_height = int(image_resize_height)
        self.image_resize_width = int(image_resize_width)
        self.do_context = do_context
        if context_mode not in ("adjacent", "repeat_center"):
            raise ValueError(f"context_mode must be 'adjacent' or 'repeat_center', got {context_mode!r}")
        self.context_mode = context_mode
        self.imgaug_pipeline = imgaug_pipeline
        self.imgaug_hflip = imgaug_hflip
        self.cache_images = cache_images
        self.uniform_heatmaps_for_nan_keypoints = uniform_heatmaps_for_nan_keypoints

        if os.path.isfile(csv_path):
            csv_file = csv_path
        else:
            csv_file = os.path.join(root_directory, csv_path)
        labeled = io_utils.parse_label_csv(csv_file, header_rows=header_rows or [0, 1, 2])
        self.keypoint_names = labeled.keypoint_names
        self.image_names = labeled.image_names
        self.raw_keypoints = labeled.keypoints  # native-resolution coords
        self.visibility = labeled.visibility

        if self.visibility is not None:
            occluded_with_coords = (self.visibility == 1) & ~np.isnan(
                self.raw_keypoints[:, :, 0]
            )
            if occluded_with_coords.any():
                logger.warning(
                    "found keypoints with visible=1 (occluded) that have non-NaN x,y "
                    "coordinates; the visibility flag takes precedence and a uniform "
                    "heatmap will be generated for these keypoints"
                )

        self.num_keypoints = self.raw_keypoints.shape[1]
        self.num_targets = self.num_keypoints * 2

        if imgaug_hflip:
            self.hflip_swap_indices = build_hflip_swap_indices(self.keypoint_names)
        else:
            self.hflip_swap_indices = np.arange(self.num_keypoints, dtype=np.intp)

        # bboxes: [x, y, h, w] per frame in original coords (reference
        # datasets.py:160-173); identity bbox when absent
        if bbox_path:
            bbox_file = (
                bbox_path
                if os.path.isfile(bbox_path)
                else os.path.join(root_directory, bbox_path)
            )
            if not os.path.exists(bbox_file):
                raise FileNotFoundError(f"Could not find bbox file at {bbox_file}!")
            import pandas as pd

            bboxes_df = pd.read_csv(bbox_file, header=[0], index_col=0)
            assert bboxes_df.index.tolist() == self.image_names
            self.bboxes = bboxes_df.to_numpy().astype(np.float32)
        else:
            self.bboxes = None  # filled per-image with (0, 0, img_h, img_w)

        self._image_cache: dict[int, np.ndarray] = {}
        self._resized_keypoints: np.ndarray | None = None
        self._orig_dims: np.ndarray | None = None

    def __len__(self) -> int:
        return len(self.image_names)

    # -- image loading -----------------------------------------------------------

    def _load_raw_image(self, path: Path) -> np.ndarray:
        img = cv2.imread(str(path), cv2.IMREAD_COLOR)
        if img is None:
            raise FileNotFoundError(f"could not read image {path}")
        return cv2.cvtColor(img, cv2.COLOR_BGR2RGB)

    def _load_resized(self, idx: int) -> tuple[np.ndarray, tuple[int, int]]:
        """Return (resized uint8 RGB image, (orig_h, orig_w))."""
        if idx in self._image_cache:
            return self._image_cache[idx]
        path = self.root_directory / self.image_names[idx]
        img = self._load_raw_image(path)
        orig_h, orig_w = img.shape[:2]
        if self.bboxes is not None:
            x, y, h, w = self.bboxes[idx]
            img = img[int(y):int(y + h), int(x):int(x + w)]
            orig_h, orig_w = img.shape[:2]
        resized = cv2.resize(
            img,
            (self.image_resize_width, self.image_resize_height),
            interpolation=cv2.INTER_LINEAR,
        )
        out = (resized, (orig_h, orig_w))
        if self.cache_images:
            self._image_cache[idx] = out
        return out

    def _load_context(self, idx: int) -> np.ndarray:
        """The ``(5, H, W, 3)`` uint8 context stack of a center frame: frames
        n-2..n+2, a missing neighbour replaced by the center. All five crop
        through the center frame's bbox, so the stack stays registered with
        the labels. ``context_mode="repeat_center"`` stacks 5 copies of the
        resized center instead."""
        if self.context_mode == "repeat_center":
            resized, _ = self._load_resized(idx)
            return np.repeat(resized[None], 5, axis=0)
        center = self.root_directory / self.image_names[idx]
        frames = []
        for path in io_utils.get_context_img_paths(center):
            img = self._load_raw_image(path if path.exists() else center)
            if self.bboxes is not None:
                x, y, h, w = self.bboxes[idx]
                img = img[int(y):int(y + h), int(x):int(x + w)]
            frames.append(
                cv2.resize(img, (self.image_resize_width, self.image_resize_height), interpolation=cv2.INTER_LINEAR)
            )
        return np.stack(frames, axis=0)

    # -- item access --------------------------------------------------------------

    def keypoints_resized(self, idx: int) -> np.ndarray:
        """Keypoints scaled to resized-image coordinates (K, 2)."""
        img, (orig_h, orig_w) = self._load_resized(idx)
        kp = self.raw_keypoints[idx].copy()
        if self.bboxes is not None:
            x, y, _, _ = self.bboxes[idx]
            kp[:, 0] -= x
            kp[:, 1] -= y
        kp[:, 0] *= self.image_resize_width / orig_w
        kp[:, 1] *= self.image_resize_height / orig_h
        return kp

    def __getitem__(self, idx: int) -> BaseLabeledExampleDict:
        """Return a sample dict with uint8 image(s) + resized keypoints.

        Normalization/augmentation happen on device; this returns raw
        resized pixels.
        """
        img, (orig_h, orig_w) = self._load_resized(idx)
        kp = self.keypoints_resized(idx)
        if self.visibility is not None:
            vis = self.visibility[idx]
        else:
            # NaN labels become uniform-heatmap targets when configured
            # (reference HeatmapDataset + cfg.training
            # uniform_heatmaps_for_nan_keypoints)
            nan_vis = 1 if self.uniform_heatmaps_for_nan_keypoints else 0
            vis = np.where(np.isnan(kp[:, 0]), nan_vis, 2).astype(np.int64)
        if self.bboxes is not None:
            bbox = self.bboxes[idx]
        else:
            bbox = np.array([0.0, 0.0, orig_h, orig_w], dtype=np.float32)
        sample = {
            "images": self._load_context(idx) if self.do_context else img,
            "keypoints": kp.astype(np.float32),
            "visibility": vis,
            "bbox": bbox.astype(np.float32),
            "idx": idx,
        }
        return sample


class HeatmapDataset(BaseTrackingDataset):
    """Adds heatmap geometry metadata; the target heatmaps themselves are
    made on the device (reference datasets.py:352-523 makes them on the CPU
    in ``__getitem__``)."""

    def __init__(self, *args, downsample_factor: int = 2, **kwargs) -> None:
        super().__init__(*args, **kwargs)
        self.downsample_factor = downsample_factor
        if (
            self.image_resize_height % 128 != 0
            or self.image_resize_width % 128 != 0
        ):
            raise ValueError("image_resize_dims must be a multiple of 128")

    @property
    def output_shape(self) -> tuple[int, int]:
        return (
            self.image_resize_height // (2**self.downsample_factor),
            self.image_resize_width // (2**self.downsample_factor),
        )
