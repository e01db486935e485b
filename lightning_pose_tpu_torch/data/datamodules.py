"""Data module: seeded splits and batch iterators (the port's copy of what
it uses of ``lightning_pose_tpu/data/datamodules.py``).

The reference's split semantics (reference
lightning_pose/data/datamodules.py:96-185): train/val/test fractions with a
seeded shuffle and ``train_frames`` subsampling; the validation split is not
augmented. Every batch has the same shape: a short last batch is padded
with repeated samples whose visibility is 0 and whose keypoints are NaN, so
they count in no loss or metric.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Iterator

import numpy as np

from lightning_pose_tpu_torch.data.datasets import BaseTrackingDataset
from lightning_pose_tpu_torch.data.datatypes import HeatmapLabeledBatchDict

__all__ = ["BaseDataModule", "collate_batch"]

def collate_batch(
    dataset: BaseTrackingDataset,
    indices: np.ndarray,
    batch_size: int,
) -> HeatmapLabeledBatchDict:
    """Assemble a padded, masked numpy batch from dataset indices."""
    samples = [dataset[int(i)] for i in indices]
    n = len(samples)
    pad = batch_size - n
    if pad > 0:
        samples = samples + [samples[-1]] * pad
    batch = {
        "idxs": np.array([s["idx"] for s in samples], dtype=np.int32),
        "valid": np.array([True] * n + [False] * pad),
    }
    # stack every array-valued sample key (images/keypoints/visibility/bbox
    # plus extras like camera matrices for calibrated multiview)
    for key in samples[0]:
        if key in ("idx", "num_views"):
            continue
        batch[key] = np.stack([np.asarray(s[key]) for s in samples])
    if pad > 0:
        batch["visibility"][n:] = 0  # padded samples drop out of masked losses
        # NaN the duplicated labels too so NaN-masked metrics (pixel RMSE)
        # don't count pad rows and bias logged val/test numbers
        batch["keypoints"] = batch["keypoints"].astype(np.float32, copy=True)
        batch["keypoints"][n:] = np.nan
    return batch


@dataclass
class Split:
    indices: np.ndarray

    def __len__(self) -> int:
        return len(self.indices)


def split_sizes_from_probabilities(
    total_number: int,
    train_probability: float,
    val_probability: float | None = None,
    test_probability: float | None = None,
) -> tuple[int, int, int]:
    """Train/val/test counts from probabilities (reference
    data/utils.py:17-73): remainder split 50/50 between val and test when
    only train_probability is given; <5 leftover frames go to train; at
    least one validation sample."""
    if test_probability is None and val_probability is None:
        remaining = 1.0 - train_probability
        val_probability = round(remaining / 2, 5)
        test_probability = round(remaining / 2, 5)
    elif test_probability is None:
        assert val_probability is not None
        test_probability = 1.0 - train_probability - val_probability
    assert val_probability is not None
    if abs(train_probability + val_probability + test_probability - 1.0) > 1e-6:
        raise ValueError("train/val/test probabilities must sum to 1")

    train_number = int(math.floor(train_probability * total_number))
    val_number = int(math.floor(val_probability * total_number))
    leftover = total_number - train_number - val_number
    if leftover < 5:
        train_number += leftover
        test_number = 0
    else:
        test_number = leftover
    if val_number == 0:
        train_number -= 1
        val_number += 1
        if train_number < 1:
            raise ValueError(
                "Must have at least two labeled frames, one train and one validation"
            )
    return train_number, val_number, test_number


class BaseDataModule:
    """Train/val/test split + batch iterators (reference datamodules.py:37-238)."""

    def __init__(
        self,
        dataset: BaseTrackingDataset,
        train_batch_size: int = 16,
        val_batch_size: int = 32,
        test_batch_size: int = 32,
        train_probability: float = 0.8,
        val_probability: float | None = None,
        test_probability: float | None = None,
        train_frames: float | int | None = None,
        torch_seed: int = 42,
    ) -> None:
        self.dataset = dataset
        self.train_batch_size = int(train_batch_size)
        self.val_batch_size = int(val_batch_size)
        self.test_batch_size = int(test_batch_size)
        self.train_probability = train_probability
        self.val_probability = val_probability
        self.test_probability = test_probability
        self.train_frames = train_frames
        self.torch_seed = int(torch_seed)
        self._setup()

    def _setup(self) -> None:
        n = len(self.dataset)
        train_n, val_n, test_n = split_sizes_from_probabilities(
            n,
            self.train_probability,
            self.val_probability,
            self.test_probability,
        )

        rng = np.random.default_rng(self.torch_seed)
        perm = rng.permutation(n)
        train_idx = perm[:train_n]
        val_idx = perm[train_n:train_n + val_n]
        test_idx = perm[train_n + val_n:]

        # train_frames subsampling (reference datamodules.py:171-185):
        # <=1 -> fraction of train frames; >1 -> absolute count
        if self.train_frames is not None:
            tf = self.train_frames
            if tf <= 0:
                raise ValueError(f"train_frames must be >0, got {tf}")
            if tf > len(train_idx):
                n_keep = len(train_idx)
            elif tf == 1:
                n_keep = len(train_idx)
            elif tf < 1:
                n_keep = max(1, int(math.floor(tf * len(train_idx))))
            else:
                n_keep = int(tf)
            train_idx = train_idx[:n_keep]

        self.train_dataset = Split(indices=np.asarray(train_idx))
        self.val_dataset = Split(indices=np.asarray(val_idx))
        self.test_dataset = Split(indices=np.asarray(test_idx))

    # -- iterators --------------------------------------------------------------

    def train_index_batches(
        self, epoch: int, steps: int | None = None
    ) -> Iterator[tuple[np.ndarray, np.ndarray]]:
        """Shuffled (dataset-index, valid-mask) batches; reshuffled each
        epoch (seeded). Padding rows repeat the last index with valid=False."""
        rng = np.random.default_rng(self.torch_seed + 1 + epoch)
        order = rng.permutation(self.train_dataset.indices)
        bs = self.train_batch_size
        n_batches = max(1, math.ceil(len(order) / bs))
        count = 0
        while True:
            for b in range(n_batches):
                if steps is not None and count >= steps:
                    return
                chunk = order[b * bs:(b + 1) * bs]
                if len(chunk) == 0:
                    chunk = order[:bs]
                n = len(chunk)
                if n < bs:
                    chunk = np.concatenate(
                        [chunk, np.repeat(chunk[-1:], bs - n)]
                    )
                valid = np.array([True] * n + [False] * (bs - n))
                yield chunk.astype(np.int32), valid
                count += 1
            if steps is None or count >= (steps or n_batches):
                return
            # more steps than batches: rewrap with a fresh shuffle
            order = rng.permutation(self.train_dataset.indices)

    def _eval_batches(self, split: Split, bs: int) -> Iterator[HeatmapLabeledBatchDict]:
        idx = split.indices
        for b in range(math.ceil(len(idx) / bs)):
            yield collate_batch(self.dataset, idx[b * bs:(b + 1) * bs], bs)

    def val_batches(self) -> Iterator[HeatmapLabeledBatchDict]:
        return self._eval_batches(self.val_dataset, self.val_batch_size)

    def full_batches(self, batch_size: int | None = None) -> Iterator[HeatmapLabeledBatchDict]:
        """Every frame in CSV order, padded like the other batches and marked
        by ``valid`` (for ``predict_dataset``)."""
        bs = batch_size or self.test_batch_size
        all_idx = np.arange(len(self.dataset))
        for b in range(math.ceil(len(all_idx) / bs)):
            yield collate_batch(self.dataset, all_idx[b * bs:(b + 1) * bs], bs)
