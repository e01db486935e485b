"""Prediction handling: batch outputs -> DLC-format CSVs (the port's copy of
what it uses of ``lightning_pose_tpu/utils/predictions.py``, reference
lightning_pose/utils/predictions.py:39-327).

Output contract: 3-level (scorer/bodyparts/coords) MultiIndex columns with
x/y/likelihood per keypoint. A video gives one row per frame, the FILL
padding of the last batch trimmed and, for a context model, its rows
shifted to their center frames; a labeled dataset gives one row per image,
indexed by image name, with the train/validation/test ``set`` column.
Multiview outputs (a labeled multiview dataset, or a frame-synchronized
multiview video) give one dataframe a view: the rows' ``2K`` keypoint
columns per view side by side, in ``view_names`` order.
"""

from __future__ import annotations

import numpy as np
import pandas as pd
import torch

from lightning_pose_tpu_torch.data.video import count_frames
from lightning_pose_tpu_torch.utils.io import make_dlc_pandas_index

__all__ = ["PredictionHandler", "predict_dataset"]


def predict_dataset(
    cfg,
    data_module,
    predict_fn,
    device: torch.device,
    preds_file: str | None = None,
) -> pd.DataFrame | dict[str, pd.DataFrame]:
    """Predict every frame of a labeled dataset, in CSV order, and write the
    CSV where ``preds_file`` is given (reference predictions.py:330); a
    multiview dataset gives one dataframe a view, written by the caller.

    ``predict_fn(images_uint8, bbox)`` takes a ``(B, h, w, 3)`` uint8 batch,
    ``(B, 5, h, w, 3)`` context stacks, ``(B, V, h, w, 3)`` views or ``(B,
    V, 5, h, w, 3)`` view stacks, and its ``(B, 4)`` (``(B, 4V)``) bboxes on
    ``device``."""
    # every batch is launched before the first result is fetched
    device_preds, valids = [], []
    for batch in data_module.full_batches():
        images = torch.from_numpy(np.ascontiguousarray(batch["images"])).to(device)
        bbox = torch.from_numpy(np.asarray(batch["bbox"], dtype=np.float32)).to(device)
        device_preds.append(predict_fn(images, bbox))
        valids.append(batch["valid"])
    preds = [(kp.cpu().numpy()[valid], conf.cpu().numpy()[valid])
             for (kp, conf), valid in zip(device_preds, valids)]
    df = PredictionHandler(cfg=cfg, data_module=data_module)(preds)
    if preds_file is not None:
        if isinstance(df, dict):
            raise ValueError("a multiview dataset gives one dataframe a view; write them by view")
        df.to_csv(preds_file)
    return df


class PredictionHandler:
    """Convert stacked (keypoints, confidences) arrays of a video or of a
    labeled dataset into its prediction dataframe."""

    def __init__(self, cfg, data_module=None, video_file: str | None = None) -> None:
        if data_module is None and video_file is None:
            raise ValueError("must pass either data_module or video_file")
        if cfg.data.get("keypoint_names", None) is None:
            raise ValueError("must include `keypoint_names` field in cfg.data")
        self.cfg = cfg
        self.data_module = data_module
        self.video_file = video_file

    @property
    def frame_count(self) -> int:
        if self.video_file is not None:
            return count_frames(self.video_file)
        return len(self.data_module.dataset)

    @property
    def keypoint_names(self) -> list[str]:
        return list(self.cfg.data.keypoint_names)

    @property
    def do_context(self) -> bool:
        if self.data_module is not None:
            return bool(getattr(self.data_module.dataset, "do_context", False))
        return self.cfg.model.model_type == "heatmap_mhcrnn"

    def unpack_preds(
        self, preds: list[tuple[np.ndarray, np.ndarray]]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Stack per-batch (keypoints, confidences), trim the padding of a
        video's last batch and, for a context model, move each row to its
        center frame (reference predictions.py:95-142)."""
        keypoints = np.vstack([np.asarray(kp) for kp, _ in preds])
        confs = np.vstack([np.asarray(c) for _, c in preds])
        if self.video_file is None:
            return keypoints, confs
        n_frames = self.frame_count
        keypoints, confs = keypoints[:n_frames], confs[:n_frames]
        if self.do_context:
            # the context model keeps its edge confidences (reference
            # predictions.py:99-106)
            keypoints = self.fix_context_preds_confs(keypoints)
            confs = self.fix_context_preds_confs(confs)
        return keypoints, confs

    def fix_context_preds_confs(self, rows: np.ndarray) -> np.ndarray:
        """Move a context model's outputs to their frames (reference
        predictions.py:144-175). Window output i belongs to frame i + 2, so
        each frame takes the row two back, the first two frames row 0. With
        one row per frame, the last two frames reuse row n-3; with fewer rows
        than frames (a short video), the missing tail repeats row 0, the
        reference's quirk, kept."""
        n_frames = self.frame_count
        shifted = rows[np.maximum(np.arange(len(rows)) - 2, 0)]
        if len(shifted) == n_frames:
            shifted[-2:] = shifted[-3]
        else:
            shifted = np.concatenate(
                [shifted, np.broadcast_to(shifted[0], (n_frames - len(shifted), rows.shape[1]))]
            )
        return shifted

    @staticmethod
    def make_pred_arr_undo_resize(
        keypoints_np: np.ndarray, confidence_np: np.ndarray
    ) -> np.ndarray:
        """Interleave per-keypoint (x, y, likelihood) column triplets
        (reference predictions.py:177-204)."""
        n_frames, n_keypoints = confidence_np.shape
        assert keypoints_np.shape == (n_frames, n_keypoints * 2)
        triplets = np.concatenate(
            [
                keypoints_np.reshape(n_frames, n_keypoints, 2),
                confidence_np[:, :, None],
            ],
            axis=-1,
        )
        # float64 to match the reference's output dtype (CSV formatting)
        return triplets.reshape(n_frames, n_keypoints * 3).astype(np.float64)

    def add_split_indices_to_df(self, df: pd.DataFrame) -> pd.DataFrame:
        """Add the train/validation/test ``set`` column
        (reference predictions.py:220-236)."""
        membership = np.full(len(df), "unused", dtype=object)
        for split_name, attr in (("train", "train_dataset"), ("validation", "val_dataset"), ("test", "test_dataset")):
            membership[np.asarray(getattr(self.data_module, attr).indices, dtype=int)] = split_name
        df["set"] = membership
        return df

    def _assemble_df(self, keypoints: np.ndarray, confs: np.ndarray, image_names=None) -> pd.DataFrame:
        """One view's dataframe: interleaved columns and, for a labeled
        dataset, the ``set`` column and the image-name index."""
        df = pd.DataFrame(
            self.make_pred_arr_undo_resize(keypoints, confs),
            columns=make_dlc_pandas_index(cfg=self.cfg, keypoint_names=self.keypoint_names),
        )
        if self.video_file is None:
            df = self.add_split_indices_to_df(df)
            df.index = image_names
        return df

    def __call__(
        self, preds: list[tuple[np.ndarray, np.ndarray]], is_multiview_video: bool = False
    ) -> pd.DataFrame | dict[str, pd.DataFrame]:
        """The prediction dataframe, or one a view for multiview outputs
        (reference predictions.py:262-327)."""
        keypoints, confs = self.unpack_preds(preds)
        view_names = self.cfg.data.get("view_names", None)
        if not (view_names and len(view_names) > 1 and (self.video_file is None or is_multiview_video)):
            names = self.data_module.dataset.image_names if self.video_file is None else None
            return self._assemble_df(keypoints, confs, names)
        n_kp = len(self.keypoint_names)
        out = {}
        for i, view in enumerate(view_names):
            names = self.data_module.dataset.image_names_by_view[view] if self.video_file is None else None
            out[view] = self._assemble_df(
                keypoints[:, 2 * n_kp * i : 2 * n_kp * (i + 1)], confs[:, n_kp * i : n_kp * (i + 1)], names
            )
        return out
