"""Video inference: decode -> batched forward on the device -> DLC CSV
(counterpart of ``lightning_pose_tpu/utils/video_predictions.py``).

Frames are decoded on the host by the reference's ``PredictVideoLoader``
into fixed-shape uint8 batches, copied to the device through pinned
buffers on a side stream, and predicted without a host sync per batch; the
results are fetched once at the end and written by the reference's
``PredictionHandler``.
"""

from __future__ import annotations

import logging
import os
import time
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

logger = logging.getLogger(__name__)

__all__ = ["predict_video"]

_PINNED_SLOTS = 2


def _device_batches(loader: Iterable[np.ndarray], device: torch.device) -> Iterator[torch.Tensor]:
    """Yield each uint8 batch of ``loader`` as a tensor on ``device``.

    On CUDA, batch t+1 is copied host -> device on a side stream from one of
    two pinned host buffers while the current stream computes on batch t.
    A pinned buffer is refilled only after its previous copy has finished;
    the current stream waits for each copy before it uses the batch.
    """
    if device.type != "cuda":
        for batch in loader:
            yield torch.from_numpy(batch).to(device)
        return
    copy_stream = torch.cuda.Stream(device)
    pinned: list[torch.Tensor | None] = [None] * _PINNED_SLOTS
    copied: list[torch.cuda.Event | None] = [None] * _PINNED_SLOTS
    for i, batch in enumerate(loader):
        slot = i % _PINNED_SLOTS
        host = torch.from_numpy(batch)
        if copied[slot] is not None:
            copied[slot].synchronize()
        if pinned[slot] is None or pinned[slot].shape != host.shape:
            pinned[slot] = torch.empty(host.shape, dtype=host.dtype, pin_memory=True)
        pinned[slot].copy_(host)
        with torch.cuda.stream(copy_stream):
            on_device = pinned[slot].to(device, non_blocking=True)
            copied[slot] = torch.cuda.Event()
            copied[slot].record(copy_stream)
        compute_stream = torch.cuda.current_stream(device)
        compute_stream.wait_event(copied[slot])
        # the tensor was allocated on the copy stream; keep its memory from
        # being reused until the compute stream is done with it
        on_device.record_stream(compute_stream)
        yield on_device


def predict_video(
    video_file: str,
    cfg,
    predict_fn: Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    model_dir: str,
    device: torch.device,
    preds_file: str | None = None,
    compute_metrics: bool = False,
):
    """Predict one video and write ``video_preds/<stem>.csv`` (or
    ``preds_file``). ``predict_fn(images_uint8, bbox)`` takes a ``(T, h, w,
    3)`` uint8 batch and ``(T, 4)`` full-frame bboxes on ``device``. Returns
    a ``PredictionResult``."""
    if compute_metrics:
        raise NotImplementedError(
            "video metrics need metrics.py, which is not ported yet "
            "(ROADMAP queue 1, item 10)"
        )
    import cv2

    from lightning_pose_tpu.data.datatypes import PredictionResult
    from lightning_pose_tpu.data.video import PredictVideoLoader
    from lightning_pose_tpu.utils.predictions import PredictionHandler

    seq_len = int(cfg.dali.base.predict.sequence_length)
    loader = PredictVideoLoader(
        video_file=video_file,
        sequence_length=seq_len,
        resize_height=int(cfg.data.image_resize_dims.height),
        resize_width=int(cfg.data.image_resize_dims.width),
        transfer_format="rgb",
    )
    # keypoints go back to the original resolution through a full-frame bbox
    cap = cv2.VideoCapture(str(video_file))
    orig_h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    orig_w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    cap.release()
    bbox = torch.tensor(
        [[0.0, 0.0, orig_h, orig_w]] * seq_len, dtype=torch.float32, device=device
    )

    t0 = time.time()
    device_preds = [predict_fn(batch, bbox) for batch in _device_batches(loader, device)]
    preds = [(kp.cpu().numpy(), conf.cpu().numpy()) for kp, conf in device_preds]
    elapsed = time.time() - t0
    logger.info(
        f"predicted {loader.frame_count} frames of {Path(video_file).name} in "
        f"{elapsed:.2f}s ({loader.frame_count / max(elapsed, 1e-9):.1f} frames/s)"
    )

    df = PredictionHandler(cfg=cfg, video_file=video_file)(preds)
    if preds_file is None:
        preds_file = str(Path(model_dir) / "video_preds" / (Path(video_file).stem + ".csv"))
    os.makedirs(os.path.dirname(preds_file), exist_ok=True)
    df.to_csv(preds_file)
    return PredictionResult(predictions=df, metrics=None)
