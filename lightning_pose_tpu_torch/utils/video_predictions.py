"""Video inference: decode -> batched forward on the device -> DLC CSV,
with the video's metric CSVs and an optional labeled mp4 (counterpart of
``lightning_pose_tpu/utils/video_predictions.py``).

Frames are decoded on the host by ``data/video.PredictVideoLoader`` into
fixed-shape uint8 batches (cropped to per-frame bboxes where given), copied
to the device through pinned buffers on a side stream, and predicted without
a host sync per batch; the results are fetched once at the end and written
by ``utils/predictions.PredictionHandler``. The labeled video is drawn with
OpenCV. A multiview model predicts a session's views together, from
frame-synchronized ``(T, V, h, w, 3)`` batches, into one CSV a view. With
``transfer_format="yuv420"`` the batches cross to the device as planar I420
(``(T, h*3/2, w)``, multiview ``(T, V, h*3/2, w)``), half the bytes, and the
predict step converts them with the I420 kernel.
"""

from __future__ import annotations

import itertools
import logging
import os
from pathlib import Path
from typing import Callable, Iterable, Iterator

import numpy as np
import torch

from lightning_pose_tpu_torch.utils import tracing

logger = logging.getLogger(__name__)

__all__ = ["generate_labeled_video", "predict_video", "predict_video_multiview"]

_PINNED_SLOTS = 2
# the loop thread's spans from the first batch to the last result
_LOOP_SPANS = ("lp.loader.next", "lp.copy.stage", "lp.predict.step", "lp.predict.fetch")


def _device_batches(loader: Iterable[np.ndarray], device: torch.device) -> Iterator[torch.Tensor]:
    """Yield each uint8 batch of ``loader`` as a tensor on ``device``.

    On CUDA, batch t+1 is copied host -> device on a side stream from one of
    two pinned host buffers while the current stream computes on batch t.
    A pinned buffer is refilled only after its previous copy has finished;
    the current stream waits for each copy before it uses the batch.

    Each batch's wait on the loader is the span ``lp.loader.next`` (the
    last one ends the loop), and the rest of its body ``lp.copy.stage``.
    """
    batches = iter(loader)
    cuda = device.type == "cuda"
    if cuda:
        copy_stream = torch.cuda.Stream(device)
        pinned: list[torch.Tensor | None] = [None] * _PINNED_SLOTS
        copied: list[torch.cuda.Event | None] = [None] * _PINNED_SLOTS
    for i in itertools.count():
        with tracing.span("lp.loader.next"):
            batch = next(batches, None)
        if batch is None:
            return
        with tracing.span("lp.copy.stage"):
            host = torch.from_numpy(batch)
            if not cuda:
                on_device = host.to(device)
            else:
                slot = i % _PINNED_SLOTS
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
                # the tensor was allocated on the copy stream; keep its
                # memory from being reused until the compute stream is done
                # with it
                on_device.record_stream(compute_stream)
        yield on_device


def _launch(predict_fn, batch: torch.Tensor, bbox: torch.Tensor):
    """``predict_fn(batch, bbox)``, the host's enqueue of one step timed as
    the span ``lp.predict.step``."""
    with tracing.span("lp.predict.step"):
        return predict_fn(batch, bbox)


def _fetch(device_preds: list, progress) -> list[tuple[np.ndarray, np.ndarray]]:
    """Each step's results on the host, in order (the span
    ``lp.predict.fetch``: the wait for the device, then the copies back).
    ``progress`` steps as each result arrives, so that it tracks finished
    work and not queued launches."""
    with tracing.span("lp.predict.fetch"):
        preds = []
        for kp, conf in device_preds:
            preds.append((kp.cpu().numpy(), conf.cpu().numpy()))
            if progress is not None:
                progress.step()
        return preds


def _log_call(before: dict[str, tuple[float, int]], frames: int, what: str) -> None:
    """One INFO line for a predict call: frames/s over the loop's spans
    (loader waits, copy staging, step launches, the fetch), and the seconds
    and count of every ``lp.`` span since ``before`` (a :func:`tracing.totals`
    snapshot), the decode workers' ``lp.loader.decode`` included. Spans of
    another call running at the same time in the process count here too."""
    spent = {}
    for name, (seconds, count) in tracing.totals().items():
        s0, c0 = before.get(name, (0.0, 0))
        if name.startswith("lp.") and count > c0:
            spent[name] = (seconds - s0, count - c0)
    loop = sum(spent.get(name, (0.0, 0))[0] for name in _LOOP_SPANS)
    parts = ", ".join(f"{name} {seconds:.3f}s/{count}" for name, (seconds, count) in sorted(spent.items()))
    logger.info(f"predicted {what} in {loop:.2f}s ({frames / max(loop, 1e-9):.1f} frames/s); spans: {parts}")


def predict_video(
    video_file: str,
    cfg,
    predict_fn: Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    model_dir: str,
    device: torch.device,
    data_module=None,
    preds_file: str | None = None,
    generate_labeled_video: bool = False,
    compute_metrics: bool = True,
    bbox_df=None,
    progress_file=None,
    transfer_format: str = "rgb",
):
    """Predict one video; write ``video_preds/<stem>.csv`` (or ``preds_file``),
    its metric side CSVs and, with ``generate_labeled_video``, a labeled mp4
    in ``labeled_videos/`` beside it. Returns a ``PredictionResult``.

    ``predict_fn(images_uint8, bbox)`` takes a ``(T, h, w, 3)`` uint8 batch
    and its ``(T, 4)`` [x, y, h, w] bboxes on ``device``; for a context
    model, ``T`` is ``dali.context.predict.sequence_length``, batches
    overlap by 4 frames, and ``predict_fn`` gives one row per window. ``bbox_df``: an
    optional per-frame [x, y, h, w] DataFrame: each frame is cropped to its
    box and the keypoints are mapped back through it (reference
    dali.py:332-396). ``progress_file``: JSON progress that steps as each
    batch's result is fetched. ``transfer_format``: ``rgb`` or ``yuv420``,
    the layout of the batches ``predict_fn`` takes (3-d I420 under
    ``yuv420``). A failure of the metrics or of the labeled video is logged
    and leaves the predictions written, as in the JAX package."""
    from lightning_pose_tpu_torch.data.datatypes import PredictionResult
    from lightning_pose_tpu_torch.data.video import PredictVideoLoader
    from lightning_pose_tpu_torch.utils.predictions import PredictionHandler

    before = tracing.totals()
    with tracing.span("lp.predict.open"):
        do_context = cfg.model.model_type == "heatmap_mhcrnn"
        seq_len = int(cfg.dali["context" if do_context else "base"].predict.sequence_length)
        loader = PredictVideoLoader(
            video_file=video_file,
            sequence_length=seq_len,
            resize_height=int(cfg.data.image_resize_dims.height),
            resize_width=int(cfg.data.image_resize_dims.width),
            bbox_df=bbox_df,
            do_context=do_context,
            transfer_format=transfer_format,
        )
        # keypoints go back to the original resolution through a full-frame
        # bbox, or through the per-frame crop bboxes
        orig_h, orig_w = _frame_size(video_file)
        full_bbox = torch.tensor([[0.0, 0.0, orig_h, orig_w]] * seq_len, dtype=torch.float32, device=device)
        bbox_rows = None if bbox_df is None else bbox_df[["x", "y", "h", "w"]].to_numpy().astype(np.float32)

        def batch_bbox(i: int) -> torch.Tensor:
            if bbox_rows is None:
                return full_bbox
            idx = np.minimum(np.arange(i * loader.step, i * loader.step + seq_len), len(bbox_rows) - 1)
            return torch.from_numpy(bbox_rows[idx]).to(device)

        progress = None
        if progress_file is not None:
            from lightning_pose_tpu_torch.callbacks import JSONInferenceProgressTracker

            progress = JSONInferenceProgressTracker(progress_file, total_batches=len(loader))

    device_preds = [_launch(predict_fn, batch, batch_bbox(i))
                    for i, batch in enumerate(_device_batches(loader, device))]
    preds = _fetch(device_preds, progress)

    with tracing.span("lp.predict.write"):
        df = PredictionHandler(cfg=cfg, data_module=data_module, video_file=video_file)(preds)
        if preds_file is None:
            preds_file = str(Path(model_dir) / "video_preds" / (Path(video_file).stem + ".csv"))
        os.makedirs(os.path.dirname(preds_file), exist_ok=True)
        df.to_csv(preds_file)

    metrics_result = None
    if compute_metrics:
        try:
            from lightning_pose_tpu_torch.metrics import compute_metrics_single

            with tracing.span("lp.predict.metrics"):
                metrics_result = compute_metrics_single(
                    cfg=cfg, labels_file=None, preds_file=preds_file, data_module=data_module
                )
        except Exception as e:
            logger.warning(f"video metrics computation failed: {e}")

    if generate_labeled_video:
        labeled_dir = Path(preds_file).parent / "labeled_videos"
        labeled_dir.mkdir(parents=True, exist_ok=True)
        try:
            with tracing.span("lp.predict.labeled_video"):
                _create_labeled_video(
                    video_file=video_file,
                    preds_df_file=preds_file,
                    output_mp4=str(labeled_dir / (Path(video_file).stem + "_labeled.mp4")),
                    confidence_thresh=float(cfg.eval.get("confidence_thresh_for_vid", 0.9)),
                    colormap=str(cfg.eval.get("colormap", "cool")),
                )
        except Exception as e:
            logger.warning(f"labeled video generation failed: {e}")

    _log_call(before, loader.frame_count, f"{loader.frame_count} frames of {Path(video_file).name}")
    return PredictionResult(predictions=df, metrics=metrics_result)


def _frame_size(video_file: str) -> tuple[int, int]:
    import cv2

    cap = cv2.VideoCapture(str(video_file))
    try:
        return int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)), int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    finally:
        cap.release()


def predict_video_multiview(
    video_file_per_view: list[str],
    view_names: list[str],
    cfg,
    predict_fn: Callable[[torch.Tensor, torch.Tensor], tuple[torch.Tensor, torch.Tensor]],
    model_dir: str,
    device: torch.device,
    generate_labeled_video: bool = False,
    compute_metrics: bool = True,
    output_dir: str | None = None,
    progress_file=None,
    transfer_format: str = "rgb",
):
    """Predict one session, one video a view, frame-synchronized; write
    ``video_preds/<stem>.csv`` for each view's video (or into
    ``output_dir``), its metric CSVs and, with ``generate_labeled_video``,
    a labeled mp4 a view (reference model.py:1225). Returns a
    ``MultiviewPredictionResult``.

    ``predict_fn(images_uint8, bbox)`` takes a ``(T, V, h, w, 3)`` batch and
    its ``(T, 4V)`` full-frame bboxes on ``device``; for a context model,
    ``T`` is ``dali.context.predict.sequence_length``, batches overlap by 4
    frames, and ``predict_fn`` gives one row per window. ``transfer_format``
    ``yuv420``: ``(T, V, h*3/2, w)`` I420 batches. A failure of the metrics
    or of a labeled video is logged, as in the JAX package."""
    from lightning_pose_tpu_torch.data.datatypes import MultiviewPredictionResult
    from lightning_pose_tpu_torch.data.video import MultiviewPredictVideoLoader
    from lightning_pose_tpu_torch.utils.predictions import PredictionHandler

    before = tracing.totals()
    with tracing.span("lp.predict.open"):
        do_context = cfg.model.model_type == "heatmap_mhcrnn"
        seq_len = int(cfg.dali["context" if do_context else "base"].predict.sequence_length)
        loader = MultiviewPredictVideoLoader(
            [str(v) for v in video_file_per_view],
            sequence_length=seq_len,
            resize_height=int(cfg.data.image_resize_dims.height),
            resize_width=int(cfg.data.image_resize_dims.width),
            do_context=do_context,
            transfer_format=transfer_format,
        )
        bbox = torch.tensor(
            [[c for v in video_file_per_view for c in (0.0, 0.0, *_frame_size(v))]] * seq_len,
            dtype=torch.float32, device=device,
        )
        progress = None
        if progress_file is not None:
            from lightning_pose_tpu_torch.callbacks import JSONInferenceProgressTracker

            progress = JSONInferenceProgressTracker(progress_file, total_batches=len(loader))

    device_preds = [_launch(predict_fn, batch, bbox) for batch in _device_batches(loader, device)]
    preds = _fetch(device_preds, progress)

    with tracing.span("lp.predict.write"):
        view_to_df = PredictionHandler(cfg=cfg, video_file=str(video_file_per_view[0]))(
            preds, is_multiview_video=True)
    preds_dir = Path(output_dir) if output_dir else Path(model_dir) / "video_preds"
    preds_dir.mkdir(parents=True, exist_ok=True)
    out, out_metrics = {}, {}
    for view, video_file in zip(view_names, video_file_per_view):
        df = view_to_df[view]
        preds_file = preds_dir / (Path(video_file).stem + ".csv")
        with tracing.span("lp.predict.write"):
            df.to_csv(preds_file)
        out[view] = df
        if compute_metrics:
            try:
                from lightning_pose_tpu_torch.metrics import compute_metrics_single

                with tracing.span("lp.predict.metrics"):
                    out_metrics[view] = compute_metrics_single(cfg=cfg, labels_file=None, preds_file=str(preds_file))
            except Exception as e:
                logger.warning(f"video metrics failed ({view}): {e}")
        if generate_labeled_video:
            labeled_dir = preds_dir / "labeled_videos"
            labeled_dir.mkdir(parents=True, exist_ok=True)
            try:
                with tracing.span("lp.predict.labeled_video"):
                    _create_labeled_video(
                        video_file=str(video_file),
                        preds_df_file=str(preds_file),
                        output_mp4=str(labeled_dir / (Path(video_file).stem + "_labeled.mp4")),
                        confidence_thresh=float(cfg.eval.get("confidence_thresh_for_vid", 0.9)),
                        colormap=str(cfg.eval.get("colormap", "cool")),
                    )
            except Exception as e:
                logger.warning(f"labeled video failed ({view}): {e}")
    _log_call(before, loader.frame_count, f"{loader.frame_count} frames x {len(view_names)} views")
    return MultiviewPredictionResult(predictions=out, metrics=out_metrics or None)


def generate_labeled_video(
    video_file: str,
    preds_df_file: str,
    output_mp4: str,
    confidence_thresh: float = 0.9,
    colormap: str = "cool",
    dotsize: int = 4,
) -> None:
    """Draw a predictions CSV's keypoints on its video (reference
    predictions.py:714)."""
    _create_labeled_video(
        video_file=video_file,
        preds_df_file=preds_df_file,
        output_mp4=output_mp4,
        confidence_thresh=confidence_thresh,
        colormap=colormap,
        dotsize=dotsize,
    )


def _make_cmap(n: int, cmap: str) -> np.ndarray:
    """``(n, 3)`` uint8 RGB colors evenly spaced over a colormap, as
    matplotlib's ``ScalarMappable(cmap=cmap).to_rgba(np.linspace(0, 1, n))``
    gives them (reference predictions.py:560-574).

    matplotlib is not a requirement of the port, so that the default
    labeled video works without it: ``cool`` (the default of
    ``eval.colormap``) is computed here as matplotlib does, a 256-entry
    table of the linear segments from cyan to magenta indexed by
    ``min(int(256 x), 255)``. Another colormap needs matplotlib."""
    if cmap != "cool":
        try:
            import matplotlib.pyplot as plt
        except ImportError:
            raise ValueError(f"colormap {cmap!r} needs matplotlib; 'cool' does not") from None
        colors = plt.cm.ScalarMappable(cmap=cmap).to_rgba(np.linspace(0, 1, n))
        return (colors[:, :3] * 255).astype(np.uint8)
    table = np.linspace(0.0, 1.0, 256)
    idx = np.minimum((np.linspace(0.0, 1.0, n) * 256).astype(int), 255)
    red = table[idx]
    rgb = np.stack([red, -red + 1.0, np.ones_like(red)], axis=1)
    return (rgb * 255).astype(np.uint8)


def _create_labeled_video(
    video_file: str,
    preds_df_file: str,
    output_mp4: str,
    confidence_thresh: float = 0.9,
    colormap: str = "cool",
    dotsize: int = 4,
    resize_dims: tuple[int, int] | None = None,
) -> None:
    """Draw the predicted keypoints above ``confidence_thresh`` on each frame
    with OpenCV and write an mp4 (the reference uses moviepy + cv2,
    reference predictions.py:576-713)."""
    import cv2
    import pandas as pd

    df = pd.read_csv(preds_df_file, header=[0, 1, 2], index_col=0)
    xyl_mask = df.columns.get_level_values("coords").isin(["x", "y", "likelihood"])
    arr = df.loc[:, xyl_mask].to_numpy().reshape(df.shape[0], -1, 3)
    n_keypoints = arr.shape[1]
    colors = _make_cmap(n_keypoints, colormap)

    cap = cv2.VideoCapture(str(video_file))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    orig_w = int(cap.get(cv2.CAP_PROP_FRAME_WIDTH))
    orig_h = int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT))
    writer = cv2.VideoWriter(output_mp4, cv2.VideoWriter_fourcc(*"mp4v"), fps, (orig_w, orig_h))
    # predictions in model-resize coordinates are scaled back to the video's
    if resize_dims is not None:
        sx, sy = orig_w / resize_dims[0], orig_h / resize_dims[1]
    else:
        sx = sy = 1.0
    frame_idx = 0
    while frame_idx < arr.shape[0]:
        ret, frame = cap.read()
        if not ret:
            break
        for k in range(n_keypoints):
            x, y, likelihood = arr[frame_idx, k]
            if np.isnan(x) or likelihood < confidence_thresh:
                continue
            color = tuple(int(c) for c in colors[k][::-1])  # BGR
            cv2.circle(frame, (int(x * sx), int(y * sy)), dotsize, color, -1)
        writer.write(frame)
        frame_idx += 1
    cap.release()
    writer.release()
