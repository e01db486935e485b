"""Triangulate per-view prediction CSVs into 3D world coordinates, with the
PyTorch port (the counterpart of ``scripts/triangulate_predictions.py``).

The reference delegates 3D inference to the external EKS package
(reference docs/source/lightning_pose_3d.rst "3D inference"); the port's
camera machinery (``lightning_pose_tpu_torch/data/cameras.py``
``CameraGroup.triangulate_fast``: DLT over all camera pairs, nanmedian
consensus) does the geometric part:

    python scripts/torch_triangulate_predictions.py calibration.toml \
        preds_Cam-A.csv preds_Cam-B.csv [preds_Cam-C.csv ...] \
        [--output preds_3d.csv] [--confidence_thresh 0.9]

CSVs are matched to the calibration's cameras by filename substring (each
camera `name` from the TOML must appear in exactly one filename, the same
rule EKS uses); keypoints below --confidence_thresh in a view are dropped
from that view before triangulation (NaNs propagate into the pair
estimates and the nanmedian consensus ignores them). Output is a
DLC-style CSV with coords x/y/z (+ the number of views that contributed).
It imports nothing of JAX.
"""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np
import pandas as pd


def _read_preds(path: Path) -> tuple[pd.DataFrame, list[str]]:
    df = pd.read_csv(path, header=[0, 1, 2], index_col=0)
    keypoints = list(dict.fromkeys(df.columns.get_level_values("bodyparts")))
    keypoints = [k for k in keypoints if k != "set"]
    return df, keypoints


def _match_csvs_to_views(
    csv_files: list[Path], view_names: list[str]
) -> list[Path]:
    """Order csv_files by calibration camera name (substring match)."""
    ordered = []
    for name in view_names:
        hits = [p for p in csv_files if name in p.name]
        if len(hits) != 1:
            raise ValueError(
                f"camera {name!r} must match exactly one CSV filename, "
                f"matched {[p.name for p in hits]}"
            )
        ordered.append(hits[0])
    return ordered


def triangulate_csvs(
    calibration_file: str | Path,
    csv_files: list[str | Path],
    confidence_thresh: float = 0.0,
) -> pd.DataFrame:
    """Triangulate per-view DLC-format prediction CSVs to 3D.

    Returns a DataFrame with a 3-level header (scorer, bodyparts,
    coords in {x, y, z, num_views}).
    """
    from lightning_pose_tpu_torch.data.anipose import load_anipose_toml
    from lightning_pose_tpu_torch.data.cameras import CameraGroup

    calib = load_anipose_toml(str(calibration_file))
    cam_group = CameraGroup.from_dict(calib)
    csv_paths = _match_csvs_to_views(
        [Path(p) for p in csv_files], calib["names"]
    )

    dfs, keypoints = [], None
    for p in csv_paths:
        df, kps = _read_preds(p)
        if keypoints is None:
            keypoints = kps
        elif kps != keypoints:
            raise ValueError(
                f"keypoint sets differ between views: {keypoints} vs {kps} ({p})"
            )
        dfs.append(df)
    n_frames = min(len(df) for df in dfs)
    if any(len(df) != n_frames for df in dfs):
        raise ValueError(
            "per-view CSVs have different frame counts: "
            f"{[len(df) for df in dfs]}"
        )

    pts = np.full(
        (n_frames, len(dfs), len(keypoints), 2), np.nan, dtype=np.float32
    )
    for v, df in enumerate(dfs):
        for k, kp in enumerate(keypoints):
            sub = df.xs(kp, axis=1, level="bodyparts")
            xy = sub.loc[:, sub.columns.get_level_values("coords").isin(["x", "y"])]
            arr = xy.to_numpy(dtype=np.float32)[:n_frames]
            lik_cols = sub.columns.get_level_values("coords") == "likelihood"
            if confidence_thresh > 0 and lik_cols.any():
                lik = sub.loc[:, lik_cols].to_numpy(dtype=np.float32)[:n_frames, 0]
                arr = np.where(lik[:, None] >= confidence_thresh, arr, np.nan)
            pts[:, v, k, :] = arr

    pts3d = cam_group.triangulate_fast(pts)  # (frames, K, 3)
    views_used = (~np.isnan(pts).any(axis=-1)).sum(axis=1)  # (frames, K)

    cols = pd.MultiIndex.from_product(
        [["triangulated"], keypoints, ["x", "y", "z", "num_views"]],
        names=["scorer", "bodyparts", "coords"],
    )
    out = np.concatenate(
        [pts3d, views_used[..., None].astype(np.float32)], axis=-1
    ).reshape(n_frames, -1)
    return pd.DataFrame(out, index=dfs[0].index[:n_frames], columns=cols)


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("calibration_file", type=Path,
                        help="anipose-format calibration TOML")
    parser.add_argument("pred_files", type=Path, nargs="+",
                        help="one prediction CSV per camera view")
    parser.add_argument("--output", type=Path, default=None,
                        help="output CSV (default: <first_pred>_3d.csv)")
    parser.add_argument("--confidence_thresh", type=float, default=0.0,
                        help="drop per-view keypoints below this likelihood")
    args = parser.parse_args()

    df = triangulate_csvs(
        args.calibration_file, args.pred_files,
        confidence_thresh=args.confidence_thresh,
    )
    out = args.output or args.pred_files[0].with_name(
        args.pred_files[0].stem + "_3d.csv"
    )
    df.to_csv(out)
    print(f"wrote {out} ({df.shape[0]} frames x {df.shape[1] // 4} keypoints)")


if __name__ == "__main__":
    main()
