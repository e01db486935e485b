"""DataExtractor: pull all labeled keypoints (optionally images) from a
split (counterpart of ``lightning_pose_tpu/data/extractor.py``; reference
lightning_pose/data/extractor.py:21-232).

The reference rebuilds the dataset with resize-only augmentation and
iterates the whole dataloader on CPU workers; here the dataset exposes
deterministically resized keypoints directly, so extraction is an array
gather — augmentation never touches this path by construction (device
augmentation runs only inside the train step).
"""

from __future__ import annotations

import numpy as np

__all__ = ["DataExtractor"]


class DataExtractor:
    """Extract keypoints (and optionally images) from a data-module split."""

    def __init__(
        self,
        data_module,
        cond: str = "train",
        extract_images: bool = False,
        remove_augmentations: bool = True,
    ) -> None:
        if cond not in ("train", "val", "test"):
            raise ValueError(f'cond must be "train", "val", or "test", got {cond!r}')
        self.data_module = data_module
        self.cond = cond
        self.extract_images = extract_images
        # remove_augmentations kept for API parity; extraction is always
        # augmentation-free here
        self.remove_augmentations = remove_augmentations

    @property
    def dataset_length(self) -> int:
        return len(getattr(self.data_module, f"{self.cond}_dataset"))

    def __call__(self) -> tuple[np.ndarray, np.ndarray | None]:
        """Returns ((num_examples, num_targets) keypoints, images or None)."""
        dataset = self.data_module.dataset
        split = getattr(self.data_module, f"{self.cond}_dataset")
        keypoints = np.stack(
            [dataset.keypoints_resized(int(i)).reshape(-1) for i in split.indices]
        ).astype(np.float32)
        images = None
        if self.extract_images:
            images = np.stack(
                [dataset[int(i)]["images"] for i in split.indices]
            )
        assert keypoints.shape[0] == self.dataset_length
        return keypoints, images
