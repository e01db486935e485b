"""Evaluation metrics and the per-prediction-file metric CSVs (the port's
copy of ``lightning_pose_tpu/metrics.py``, reference
lightning_pose/metrics.py:47-327).

numpy and pandas over the port's ``utils/pca.KeypointPCA``. A predictions
CSV carries the 3-level (scorer/bodyparts/coords) header with x, y and
likelihood columns and, for labeled frames, a trailing ``set`` column; each
metric is written next to it as ``<stem>_<metric>.csv``.
"""

from __future__ import annotations

import logging
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np
import pandas as pd

from lightning_pose_tpu_torch.utils.io import fix_empty_first_row, get_keypoint_names
from lightning_pose_tpu_torch.utils.pca import KeypointPCA

logger = logging.getLogger(__name__)

__all__ = [
    "pixel_error",
    "temporal_norm",
    "pca_singleview_reprojection_error",
    "pca_multiview_reprojection_error",
    "compute_metrics_single",
    "ComputeMetricsSingleResult",
]


def pixel_error(keypoints_true: np.ndarray, keypoints_pred: np.ndarray) -> np.ndarray:
    """Euclidean distance per keypoint; (samples, K, 2) pairs -> (samples, K)
    (reference metrics.py:47)."""
    delta = np.asarray(keypoints_pred) - np.asarray(keypoints_true)
    return np.sqrt((delta**2).sum(axis=2))


def temporal_norm(keypoints_pred: np.ndarray) -> np.ndarray:
    """Per-keypoint jump size between consecutive frames; row 0 is NaN
    (no predecessor), matching the reference's convention
    (reference metrics.py:62)."""
    kp = np.asarray(keypoints_pred, dtype=np.float32).reshape(
        len(keypoints_pred), -1, 2
    )
    out = np.full((kp.shape[0], kp.shape[1]), np.nan, dtype=np.float32)
    step = kp[1:] - kp[:-1]
    out[1:] = np.sqrt((step**2).sum(axis=2))
    return out


def _pca_group_errors(
    keypoints_pred: np.ndarray,
    pca: KeypointPCA,
    column_groups: list[np.ndarray],
) -> np.ndarray:
    """Reproject through a fitted PCA subspace and scatter the per-keypoint
    errors back into full-width (samples, K) with NaN outside the groups.

    ``column_groups`` lists, per PCA data column block, the original
    keypoint indices it covers: the singleview metric passes ONE group (the
    selected pca columns); the mirrored-multiview metric passes one group
    per camera view (the pca data layout is view-blocked, reference
    metrics.py:134-185).

    Reference quirk preserved: the singleview error compares the
    reprojection against the RAW selected keypoints (reference
    metrics.py:122-124 — with a centering_method the reprojection lives in
    centered coordinates, and that offset counts as error), while the
    multiview error compares against the formatted/view-blocked keypoints
    (reference metrics.py:166-172).
    """
    kp = np.asarray(keypoints_pred, dtype=np.float32)
    n_samples, n_keypoints = kp.shape[0], kp.shape[1]
    flat = pca._format_data(kp.reshape(n_samples, -1))
    if len(column_groups) == 1:
        base = kp[:, column_groups[0], :]
    else:
        base = flat.reshape(n_samples, -1, 2)
    err_compact = pixel_error(
        base, pca.reproject(flat).reshape(n_samples, -1, 2)
    )
    full = np.full((n_samples, n_keypoints), np.nan)
    if len(column_groups) == 1:
        full[:, column_groups[0]] = err_compact
    else:
        # view-blocked layout: err_compact is (samples, kp_per_view * views)
        # with views as the FASTEST-varying axis of the pca keypoint dim
        per_view = err_compact.reshape(n_samples, len(column_groups[0]), -1)
        for view, cols in enumerate(column_groups):
            full[:, cols] = per_view[:, :, view]
    return full


def pca_singleview_reprojection_error(
    keypoints_pred: np.ndarray, pca: KeypointPCA
) -> np.ndarray:
    """(samples, K, 2) -> (samples, K); NaN for keypoints excluded from the
    PCA fit (reference metrics.py:92)."""
    cols = pca.columns_for_singleview_pca
    if cols is None:
        cols = range(np.asarray(keypoints_pred).shape[1])
    return _pca_group_errors(keypoints_pred, pca, [np.asarray(list(cols))])


def pca_multiview_reprojection_error(
    keypoints_pred: np.ndarray, pca: KeypointPCA
) -> np.ndarray:
    """(samples, K, 2) -> (samples, K); NaN for keypoints absent from the
    mirrored-column matches (reference metrics.py:134)."""
    assert pca.mirrored_column_matches is not None
    groups = [np.asarray(v) for v in pca.mirrored_column_matches]
    return _pca_group_errors(keypoints_pred, pca, groups)


@dataclass
class ComputeMetricsSingleResult:
    """Container for metric dataframes (reference data/datatypes.py)."""

    pixel_error_df: pd.DataFrame | None = field(default=None)
    temporal_norm_df: pd.DataFrame | None = field(default=None)
    pca_sv_df: pd.DataFrame | None = field(default=None)
    pca_mv_df: pd.DataFrame | None = field(default=None)


def _fit_pca_or_skip(**kwargs) -> KeypointPCA | None:
    """Fit a KeypointPCA; swallow only the 'cannot fit PCA' ValueError the
    fitter raises on degenerate data (reference metrics.py:258-266 does the
    same so video metrics still get written)."""
    try:
        pca = KeypointPCA(**kwargs)
        pca()
        return pca
    except ValueError as e:
        if "cannot fit PCA" in str(e):
            return None
        raise


def compute_metrics_single(
    cfg,
    labels_file: str | Path | None,
    preds_file: str | Path,
    data_module=None,
) -> ComputeMetricsSingleResult:
    """Compute metrics for one single-view predictions CSV and write the
    ``<stem>_<metric>.csv`` side files (reference metrics.py:187-327).

    Labeled files (detected by a trailing ``set`` column) get pixel error;
    video files get temporal norm; both get PCA reprojection errors when the
    config defines the corresponding subspace and the dataset isn't a true
    multiview one (reference gates identically)."""
    preds_path = Path(preds_file)
    pred_df = pd.read_csv(preds_path, header=[0, 1, 2], index_col=0)
    names = get_keypoint_names(cfg, csv_file=str(preds_path), header_rows=[0, 1, 2])

    has_set_col = pred_df.columns[-1][0] == "set"
    set_col = pred_df.iloc[:, -1].to_numpy() if has_set_col else None
    coord_cols = pred_df.columns.get_level_values("coords").isin(
        ["x", "y", "likelihood"]
    )
    kp_pred = (
        pred_df.loc[:, coord_cols]
        .to_numpy()
        .reshape(len(pred_df), -1, 3)[:, :, :2]
    )

    # which metrics apply (reference metrics.py:211-247): pixel error needs
    # labels; temporal norm is for videos; the PCA metrics require the
    # config's subspace definitions and a (non-true-multiview) data module
    metric_fns: list[tuple[str, str, object]] = []
    if has_set_col:
        def _pixel():
            assert labels_file is not None, '"pixel_error" metric requires labels_file'
            gt_df = fix_empty_first_row(
                pd.read_csv(labels_file, header=[0, 1, 2], index_col=0)
            )
            assert gt_df.index.equals(pred_df.index)
            xy = gt_df.columns.get_level_values("coords").isin(["x", "y"])
            gt = gt_df.loc[:, xy].to_numpy().reshape(len(gt_df), -1, 2)
            return pixel_error(gt, kp_pred)

        metric_fns.append(("pixel_error_df", "_pixel_error.csv", _pixel))
    else:
        metric_fns.append(
            ("temporal_norm_df", "_temporal_norm.csv", lambda: temporal_norm(kp_pred))
        )

    true_multiview = data_module is not None and getattr(
        data_module.dataset, "view_names", None
    ) is not None

    def _wants(key: str) -> bool:
        cols = cfg.data.get(key, None)
        return (
            data_module is not None
            and not true_multiview
            and cols is not None
            and len(cols) > 0
        )

    if _wants("columns_for_singleview_pca"):
        def _pca_sv():
            pca = _fit_pca_or_skip(
                loss_type="pca_singleview",
                data_module=data_module,
                components_to_keep=cfg.losses.pca_singleview.components_to_keep,
                empirical_epsilon_percentile=cfg.losses.pca_singleview.get(
                    "empirical_epsilon_percentile", 1.0
                ),
                columns_for_singleview_pca=cfg.data.columns_for_singleview_pca,
                centering_method=cfg.losses.pca_singleview.get(
                    "centering_method", None
                ),
            )
            return None if pca is None else pca_singleview_reprojection_error(
                kp_pred, pca
            )

        metric_fns.append(("pca_sv_df", "_pca_singleview_error.csv", _pca_sv))

    if _wants("mirrored_column_matches"):
        def _pca_mv():
            pca = _fit_pca_or_skip(
                loss_type="pca_multiview",
                data_module=data_module,
                components_to_keep=cfg.losses.pca_singleview.components_to_keep,
                empirical_epsilon_percentile=cfg.losses.pca_singleview.get(
                    "empirical_epsilon_percentile", 1.0
                ),
                mirrored_column_matches=cfg.data.mirrored_column_matches,
            )
            return None if pca is None else pca_multiview_reprojection_error(
                kp_pred, pca
            )

        metric_fns.append(("pca_mv_df", "_pca_multiview_error.csv", _pca_mv))

    result = ComputeMetricsSingleResult()
    for attr, suffix, build in metric_fns:
        values = build()
        if values is None:
            continue
        df = pd.DataFrame(values, index=pred_df.index, columns=pd.Index(names))
        if set_col is not None:
            df["set"] = set_col
        df.to_csv(preds_path.with_name(preds_path.stem + suffix))
        setattr(result, attr, df)
    return result
