"""Typed batch contracts and the prediction result (the port's copy of what
it uses of ``lightning_pose_tpu/data/datatypes.py``).

The datasets return samples and the data module batches as plain dicts of
numpy arrays; these TypedDicts document their schema. Images are
channels-last (NHWC) uint8, as the datasets cache them.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TypedDict

import numpy as np
import pandas as pd

__all__ = ["BaseLabeledExampleDict", "HeatmapLabeledBatchDict", "MultiviewPredictionResult", "PredictionResult"]

class BaseLabeledExampleDict(TypedDict, total=False):
    """One labeled example (reference datatypes.py:112)."""

    images: np.ndarray  # (H, W, 3) uint8
    keypoints: np.ndarray  # (K, 2) float32, resized-image coords
    visibility: np.ndarray  # (K,) int64 in {0, 1, 2}
    bbox: np.ndarray  # (4,) [x, y, h, w] in original-frame coords
    idx: int


class HeatmapLabeledBatchDict(TypedDict, total=False):
    """Collated labeled batch (reference datatypes.py:124).

    Target heatmaps are not carried in the batch: the train step generates
    them on the device.
    """

    images: np.ndarray  # (B, H, W, 3) uint8
    keypoints: np.ndarray  # (B, K, 2)
    visibility: np.ndarray  # (B, K)
    bbox: np.ndarray  # (B, 4)
    idxs: np.ndarray  # (B,)
    valid: np.ndarray  # (B,) bool — False rows are padding


@dataclass
class PredictionResult:
    """Result of a prediction call (reference datatypes.py:34-76).

    ``metrics`` holds the metric dataframes (``metrics.py``), or None.
    """

    predictions: pd.DataFrame
    metrics: object | None = field(default=None)

    def to_dict(self) -> dict:
        """Predictions + metrics as a flat dict of named numpy arrays, all
        shaped ``(n_frames, n_keypoints)`` with shared row order (reference
        datatypes.py:40-76). Metric entries are None when not computed."""

        def _metric(df: pd.DataFrame | None) -> np.ndarray | None:
            if df is None:
                return None
            cols = [c for c in df.columns if c != "set"]
            return df[cols].to_numpy()

        m = self.metrics
        preds = self.predictions
        return {
            "keypoint_names": list(preds.columns.get_level_values(1).unique()),
            "index": list(preds.index),
            "x": preds.xs("x", level=2, axis=1).to_numpy(),
            "y": preds.xs("y", level=2, axis=1).to_numpy(),
            "confidence": preds.xs("likelihood", level=2, axis=1).to_numpy(),
            "pixel_error": _metric(getattr(m, "pixel_error_df", None)) if m else None,
            "temporal_norm": _metric(getattr(m, "temporal_norm_df", None)) if m else None,
            "pca_singleview_error": _metric(getattr(m, "pca_sv_df", None)) if m else None,
            "pca_multiview_error": _metric(getattr(m, "pca_mv_df", None)) if m else None,
        }


@dataclass
class MultiviewPredictionResult:
    """Per-view prediction dataframes (reference datatypes.py:79-100)."""

    predictions: dict[str, pd.DataFrame]
    metrics: dict[str, object] | None = field(default=None)

    def to_dict(self) -> dict:
        """Per-view :meth:`PredictionResult.to_dict` outputs, keyed by view
        name (reference datatypes.py:85-100)."""
        return {
            view: PredictionResult(
                predictions=df, metrics=self.metrics.get(view) if self.metrics else None
            ).to_dict()
            for view, df in self.predictions.items()
        }
