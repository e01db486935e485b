"""Prediction handling: batch outputs -> DLC-format CSVs (the port's copy of
what it uses of ``lightning_pose_tpu/utils/predictions.py``, reference
lightning_pose/utils/predictions.py:39-327).

Output contract: 3-level (scorer/bodyparts/coords) MultiIndex columns with
x/y/likelihood per keypoint, one row per video frame, the FILL padding of
the last batch trimmed. Labeled datasets, context models and multiview
outputs are not ported yet.
"""

from __future__ import annotations

import numpy as np
import pandas as pd

from lightning_pose_tpu_torch.data.video import count_frames
from lightning_pose_tpu_torch.utils.io import make_dlc_pandas_index

__all__ = ["PredictionHandler"]


class PredictionHandler:
    """Convert stacked (keypoints, confidences) arrays of a video into its
    prediction dataframe."""

    def __init__(self, cfg, video_file: str) -> None:
        if cfg.data.get("keypoint_names", None) is None:
            raise ValueError("must include `keypoint_names` field in cfg.data")
        self.cfg = cfg
        self.video_file = video_file

    @property
    def frame_count(self) -> int:
        return count_frames(self.video_file)

    @property
    def keypoint_names(self) -> list[str]:
        return list(self.cfg.data.keypoint_names)

    def unpack_preds(
        self, preds: list[tuple[np.ndarray, np.ndarray]]
    ) -> tuple[np.ndarray, np.ndarray]:
        """Stack per-batch (keypoints, confidences) and trim the padding of
        the last batch (reference predictions.py:95-142)."""
        keypoints = np.vstack([np.asarray(kp) for kp, _ in preds])
        confs = np.vstack([np.asarray(c) for _, c in preds])
        n_frames = self.frame_count
        return keypoints[:n_frames], confs[:n_frames]

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

    def __call__(self, preds: list[tuple[np.ndarray, np.ndarray]]) -> pd.DataFrame:
        """The video's prediction dataframe (reference predictions.py:262-327)."""
        keypoints, confs = self.unpack_preds(preds)
        return pd.DataFrame(
            self.make_pred_arr_undo_resize(keypoints, confs),
            columns=make_dlc_pandas_index(cfg=self.cfg, keypoint_names=self.keypoint_names),
        )
