"""Unlabeled data module (counterpart of ``lightning_pose_tpu/data/unlabeled.py``).

The reference pairs labeled and unlabeled loaders with Lightning's
``CombinedLoader(mode="max_size_cycle")`` (reference
lightning_pose/data/datamodules.py:240-341): each training step takes one
labeled batch and one unlabeled video window. Here the labeled batches come
from the data module's index batches, as in supervised training, and the
train loop takes one window a step from :attr:`unlabeled_loader`; the
window's augmentation and normalization run on the device in the train
step. A multiview config (more than one name in ``data.view_names``,
whatever the model) reads frame-synchronized sessions, one video a view,
found by their view names in the video directory.

``training.video_transfer_format``: ``auto`` is ``rgb``, as in the JAX
package off the TPU; ``yuv420`` makes the single-view stream's windows
planar I420, which the train step converts with the I420 kernel (the JAX
multiview stream has no transfer format).

Across ranks (``parallel/mesh.py``): when every rank runs on this host, each
reads the same stream (shard 0 of 1) and the train step keeps its frames of
the window; a rank of a group it joined decodes its own shard, seeded by
its rank, with ``ceil(sequence_length / ranks)`` frames, so that the global
window keeps its configured size (the JAX package's per-host shards,
reference data/factory.py:252-291, dali.py:580-592).
"""

from __future__ import annotations

import logging

from lightning_pose_tpu_torch.data.datamodules import BaseDataModule
from lightning_pose_tpu_torch.parallel.mesh import stream_shard
from lightning_pose_tpu_torch.data.video import MultiviewUnlabeledVideoLoader, UnlabeledVideoLoader
from lightning_pose_tpu_torch.utils.io import check_video_paths, find_video_files_for_views

logger = logging.getLogger(__name__)

__all__ = ["UnlabeledDataModule"]


class UnlabeledDataModule(BaseDataModule):
    """:class:`BaseDataModule` plus a background unlabeled video stream of
    ``dali.base.train.sequence_length`` frames a window, seeded by
    ``training.rng_seed_data_pt``."""

    def __init__(self, cfg, video_dir: str, **kwargs) -> None:
        view_names = cfg.data.get("view_names", None)
        multiview = bool(view_names) and len(view_names) > 1
        super().__init__(**kwargs)
        self.cfg = cfg
        self.video_dir = video_dir
        seq_len = int(cfg.dali.base.train.sequence_length)
        seed = int(cfg.training.get("rng_seed_data_pt", 0)) + 123456
        height, width = int(cfg.data.image_resize_dims.height), int(cfg.data.image_resize_dims.width)
        shard_id, num_shards = stream_shard()
        if num_shards > 1:
            seq_len = max(1, -(-seq_len // num_shards))
        if multiview:
            sessions = find_video_files_for_views(video_dir, list(view_names))
            self.unlabeled_loader = MultiviewUnlabeledVideoLoader(
                sessions=sessions, sequence_length=seq_len, resize_height=height, resize_width=width, seed=seed,
                shard_id=shard_id,
            )
            logger.info(f"multiview unlabeled stream: {len(sessions)} session(s), sequence_length={seq_len}")
            return
        # auto: rgb, as in the JAX package off the TPU
        fmt = str(cfg.training.get("video_transfer_format", "auto")).lower()
        if fmt == "auto":
            fmt = "rgb"
        video_files = check_video_paths(video_dir)
        self.unlabeled_loader = UnlabeledVideoLoader(
            video_files=list(video_files),
            sequence_length=seq_len,
            resize_height=height,
            resize_width=width,
            seed=seed,
            shard_id=shard_id,
            transfer_format=fmt,
        )
        logger.info(f"unlabeled stream: {len(video_files)} video(s), sequence_length={seq_len}")

    def close(self) -> None:
        """Stop the unlabeled stream's decode threads."""
        self.unlabeled_loader.close()
