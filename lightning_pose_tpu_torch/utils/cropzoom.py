"""Cropzoom: the two-stage detector -> pose workflow (counterpart of
``lightning_pose_tpu/utils/cropzoom.py``; reference
lightning_pose/utils/cropzoom.py:40-489). Host code: pandas, numpy, cv2.

Pipeline: predict with a detector model -> ``generate_bbox`` (square bbox
from the anchor-keypoint span, crop_ratio or fixed size, even dims) ->
``smooth_bbox`` (rolling median) -> ``crop_video`` / ``crop_labeled_frames``
(cv2/PIL instead of the reference's moviepy) -> ``generate_cropped_csv_file``
(add/subtract coordinate remap).
"""

from __future__ import annotations

import json
import logging
from pathlib import Path

import cv2
import numpy as np
import pandas as pd

from lightning_pose_tpu_torch.utils import io

logger = logging.getLogger(__name__)

__all__ = [
    "generate_bbox",
    "smooth_bbox",
    "crop_video",
    "crop_labeled_frames",
    "generate_cropped_csv_file",
]


def _even(values):
    """Round up to even: many video players reject odd frame dimensions."""
    return values + values % 2


def _anchor_coords(pred_df: pd.DataFrame, anchor_keypoints: list[str]) -> np.ndarray:
    """(frames, keypoints, 2) coordinate array restricted to the anchor
    keypoints (all keypoints when the anchor list is empty)."""
    columns = pred_df.columns
    keep = columns.get_level_values("coords").isin(["x", "y"])
    if anchor_keypoints:
        known = set(columns.get_level_values("bodyparts"))
        invalid = set(anchor_keypoints) - known
        assert not invalid, f"Anchor keypoints not found in DataFrame: {invalid}"
        keep &= columns.get_level_values("bodyparts").isin(anchor_keypoints)
    return pred_df.loc[:, keep].to_numpy().reshape(len(pred_df), -1, 2)


def _compute_bbox_df(
    pred_df: pd.DataFrame,
    anchor_keypoints: list[str],
    crop_ratio: float | None = None,
    crop_height: int | None = None,
    crop_width: int | None = None,
) -> pd.DataFrame:
    """Per-frame [x, y, h, w] bbox table, centred on the anchor-keypoint
    centroid (behavioral contract: reference cropzoom.py:65-143).

    Sizing is one of two mutually exclusive modes: ``crop_ratio`` scales the
    larger per-frame keypoint extent into a square side (ceil, then even);
    ``crop_height``/``crop_width`` fix the size for every frame. NaN
    keypoints are ignored in the span/centroid (divergence: the reference
    propagates them into the box).
    """
    ratio_mode = crop_ratio is not None
    fixed_mode = crop_height is not None and crop_width is not None
    if ratio_mode and fixed_mode:
        raise ValueError(
            "provide either crop_ratio or (crop_height, crop_width), not both."
        )
    if not (ratio_mode or fixed_mode):
        raise ValueError(
            "one of crop_ratio or (crop_height, crop_width) must be provided."
        )

    coords = _anchor_coords(pred_df, anchor_keypoints)
    if ratio_mode:
        extent = np.nanmax(coords, axis=1) - np.nanmin(coords, axis=1)
        side = _even(np.ceil(extent.max(axis=1) * crop_ratio).astype(int))
        sizes = np.stack([side, side], axis=1)  # (frames, h|w), square
    else:
        sizes = np.broadcast_to(
            np.asarray([_even(crop_height), _even(crop_width)]),
            (len(pred_df), 2),
        )
    corner = (np.nanmean(coords, axis=1) - sizes // 2).astype(np.int64)
    return pd.DataFrame(
        np.concatenate([corner, sizes], axis=1),
        index=pred_df.index,
        columns=pd.Index(["x", "y", "h", "w"]),
    )


def generate_bbox(
    input_preds_file: Path,
    detector_cfg,
    output_bbox_file: Path,
) -> None:
    """Compute bboxes from predictions and save (reference cropzoom.py:328)."""
    preds = io.fix_empty_first_row(
        pd.read_csv(input_preds_file, header=[0, 1, 2], index_col=0)
    )
    boxes = _compute_bbox_df(
        preds,
        list(detector_cfg.anchor_keypoints),
        crop_ratio=detector_cfg.get("crop_ratio"),
        crop_height=detector_cfg.get("crop_height"),
        crop_width=detector_cfg.get("crop_width"),
    )
    Path(output_bbox_file).parent.mkdir(parents=True, exist_ok=True)
    boxes.to_csv(output_bbox_file)


def smooth_bbox(
    input_bbox_dir: Path,
    output_dir: Path,
    method: str = "median",
    window: int = 5,
) -> None:
    """Centered rolling-median smoothing of every ``*_bbox.csv`` in a
    directory (reference cropzoom.py:355); writes same-named files plus a
    metadata.json recording the parameters."""
    src_dir, dst_dir = Path(input_bbox_dir), Path(output_dir)
    if method not in ("median",):
        raise ValueError(f"unsupported method {method!r}; choose one of ('median',).")
    found = sorted(src_dir.glob("*_bbox.csv"))
    if not found:
        raise ValueError(f"no *_bbox.csv files found in {src_dir}.")
    dst_dir.mkdir(parents=True, exist_ok=True)
    for src in found:
        rolled = (
            pd.read_csv(src, index_col=0)
            .rolling(window=window, center=True, min_periods=1)
            .median()
            .round(0)
            .astype(int)
        )
        rolled.to_csv(dst_dir / src.name)
        logger.info(f"smoothed {src.name} -> {dst_dir / src.name}")
    (dst_dir / "metadata.json").write_text(json.dumps(
        {"method": method, "window": window, "source": str(src_dir.resolve())},
        indent=2,
    ))


def _crop_frame(frame: np.ndarray, x: int, y: int, h: int, w: int) -> np.ndarray:
    """Crop with zero padding when the bbox extends past the frame edges."""
    fh, fw = frame.shape[:2]
    out = np.zeros((h, w, frame.shape[2]), dtype=frame.dtype)
    x0, y0 = max(x, 0), max(y, 0)
    x1, y1 = min(x + w, fw), min(y + h, fh)
    if x1 > x0 and y1 > y0:
        out[y0 - y:y1 - y, x0 - x:x1 - x] = frame[y0:y1, x0:x1]
    return out


def crop_video(
    input_video_file: Path,
    input_bbox_file: Path,
    output_file: Path,
) -> None:
    """Crop a video to per-frame bboxes (cv2; reference cropzoom.py:405 uses
    moviepy)."""
    boxes_df = pd.read_csv(input_bbox_file, index_col=0)
    # access columns by NAME (not position) so a CSV ordered x,y,w,h — a
    # common external convention — can't silently swap height and width
    boxes = boxes_df[["x", "y", "h", "w"]].to_numpy(dtype=np.int64)
    Path(output_file).parent.mkdir(parents=True, exist_ok=True)
    cap = cv2.VideoCapture(str(input_video_file))
    fps = cap.get(cv2.CAP_PROP_FPS) or 30.0
    # the bbox CSV must be dense: one row per frame, no gaps
    # (reference cropzoom.py:_crop_video_moviepy raises on mismatch)
    n_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
    if len(boxes) != n_frames:
        cap.release()
        raise ValueError(
            f"{Path(input_video_file).name}: bbox CSV has {len(boxes)} rows "
            f"but video has {n_frames} frames. The video bbox CSV must be "
            f"dense: exactly one row per frame with no gaps. If your tracking "
            f"has missing frames, carry the last known bbox forward to fill "
            f"the gap."
        )
    # output size = median bbox dims rounded to nearest even integer
    # (reference cropzoom.py: h/w median, round(x/2)*2)
    out_h, out_w = (
        int(round(float(np.median(boxes[:, dim])) / 2) * 2) for dim in (2, 3)
    )
    writer = cv2.VideoWriter(
        str(output_file), cv2.VideoWriter_fourcc(*"mp4v"), fps, (out_w, out_h)
    )
    for x, y, h, w in boxes:
        ok, frame = cap.read()
        if not ok:
            break
        crop = _crop_frame(frame, x, y, h, w)
        if crop.shape[:2] != (out_h, out_w):
            crop = cv2.resize(crop, (out_w, out_h))
        writer.write(crop)
    cap.release()
    writer.release()


def crop_labeled_frames(
    input_data_dir: Path,
    input_csv_file: Path,
    input_bbox_file: Path,
    output_data_dir: Path,
    output_csv_file: Path,
    num_workers: int | None = None,
) -> None:
    """Crop labeled frames + remap the labels CSV (reference cropzoom.py:423).

    Frames crop in a thread pool (cv2 releases the GIL in imread/imwrite;
    the reference uses a multiprocessing pool, reference
    cropzoom.py:178-248). ``num_workers`` defaults to ``min(8, cores)``.
    """
    import concurrent.futures as cf
    import os

    src_root, dst_root = Path(input_data_dir), Path(output_data_dir)
    boxes = pd.read_csv(input_bbox_file, index_col=0)
    dst_root.mkdir(parents=True, exist_ok=True)
    jobs = [
        (str(rel), int(row["x"]), int(row["y"]), int(row["h"]), int(row["w"]))
        for rel, row in boxes.iterrows()
    ]

    def crop_one(job):
        rel, x, y, h, w = job
        img = cv2.imread(str(src_root / rel))
        if img is None:
            logger.warning(f"could not read {src_root / rel}; skipping")
            return
        dst = dst_root / rel
        dst.parent.mkdir(parents=True, exist_ok=True)
        cv2.imwrite(str(dst), _crop_frame(img, x, y, h, w))

    workers = num_workers or max(1, min(8, os.cpu_count() or 1))
    if workers <= 1:
        for job in jobs:
            crop_one(job)
    else:
        with cf.ThreadPoolExecutor(max_workers=workers) as pool:
            list(pool.map(crop_one, jobs))
    generate_cropped_csv_file(
        input_csv_file=input_csv_file,
        input_bbox_file=input_bbox_file,
        output_csv_file=output_csv_file,
    )


def generate_cropped_csv_file(
    input_csv_file: str | Path,
    input_bbox_file: str | Path,
    output_csv_file: str | Path,
    mode: str = "subtract",
) -> None:
    """Translate CSV coordinates between original-frame and cropped-frame
    spaces by the per-frame bbox corner: ``subtract`` maps original -> crop
    coords, ``add`` maps back (behavioral contract: reference
    cropzoom.py:450-489)."""
    if mode not in ("add", "subtract"):
        raise ValueError(f"{mode} is not a valid mode")
    labels = io.fix_empty_first_row(
        pd.read_csv(input_csv_file, header=[0, 1, 2], index_col=0)
    )
    corners = pd.read_csv(input_bbox_file, index_col=0)
    # align bbox rows to the label rows by frame index, NOT by position —
    # a re-sorted or regenerated bbox file must still shift each frame by
    # its own corner (the reference's per-column pandas subtraction aligns
    # on index; frames without a bbox row become NaN there too)
    corners = corners.reindex(labels.index)
    sign = -1.0 if mode == "subtract" else 1.0
    for axis in ("x", "y"):
        axis_cols = labels.columns.get_level_values(-1) == axis
        shift = sign * corners[axis].to_numpy()[:, None]
        labels.loc[:, axis_cols] = labels.loc[:, axis_cols].to_numpy() + shift
    out_path = Path(output_csv_file)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    labels.to_csv(out_path)
