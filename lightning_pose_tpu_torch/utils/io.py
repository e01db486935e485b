"""Label-CSV parsing, path discovery and checkpoint discovery (the port's
copy of what it uses of ``lightning_pose_tpu/utils/io.py``).

DLC 3-row-header CSVs with an optional per-keypoint ``visible`` column
(values 0/1/2), video path discovery and multi-view grouping by filename,
the paths of a labeled frame's context frames, best-checkpoint discovery under
``tb_logs/<model_name>/version_*/checkpoints``, and the DLC column index of
prediction CSVs. All array outputs are numpy.
"""

from __future__ import annotations

import glob
import logging
import os
import re
from dataclasses import dataclass
from pathlib import Path

import numpy as np
import pandas as pd

logger = logging.getLogger(__name__)

__all__ = [
    "LabeledData",
    "check_video_paths",
    "collect_video_files_by_view",
    "ckpt_path_from_base_path",
    "find_video_files_for_views",
    "fix_empty_first_row",
    "get_context_img_paths",
    "get_keypoint_names",
    "get_videos_in_dir",
    "make_dlc_pandas_index",
    "parse_label_csv",
    "return_absolute_data_paths",
]

_TWO_ROW_HEADERS = ([1, 2], [0, 1])

_ALLOWED_VISIBILITY = frozenset({0.0, 1.0, 2.0})


def fix_empty_first_row(df: pd.DataFrame) -> pd.DataFrame:
    """Restore an all-NaN first data row that pandas absorbed as an index name.

    With a multi-row header, pandas cannot distinguish an index-name row from
    a data row of all NaNs and drops the latter into ``df.index.name``
    (pandas gh-21995; reference utils/io.py:529). If no index name is set the
    frame is returned untouched.
    """
    lost_row_label = df.index.name
    if lost_row_label is None:
        return df
    restored = pd.DataFrame(
        np.nan,
        index=pd.Index([lost_row_label]),
        columns=df.columns,
        dtype="float64",
    )
    df = pd.concat([restored, df])
    assert df.index.name is None
    return df


def _keypoint_level_names(columns: pd.MultiIndex, header_rows: list[int]) -> list[str]:
    """Ordered keypoint names from a label-CSV column MultiIndex.

    The name level sits directly above the coords level: level 0 for two-row
    headers, level 1 for the DLC scorer/bodyparts/coords layout. Order follows
    the file's column order (``columns.levels`` would sort alphabetically).
    """
    name_level = 0 if header_rows in _TWO_ROW_HEADERS else 1
    coord_level = name_level + 1
    return [col[name_level] for col in columns if col[coord_level] == "x"]


def get_keypoint_names(
    cfg=None,
    csv_file: str | None = None,
    header_rows: list[int] | None = None,
) -> list[str]:
    """Keypoint names from a label CSV's header, else from the config
    (reference utils/io.py:149)."""
    header_rows = header_rows or [0, 1, 2]
    if csv_file is not None and os.path.exists(csv_file):
        # only the header matters; a handful of rows is enough to build it
        preview = pd.read_csv(csv_file, header=header_rows, nrows=5)
        return _keypoint_level_names(preview.columns, header_rows)
    assert cfg is not None, "cfg must be provided when csv_file is not given"
    configured = cfg.data.get("keypoint_names", None)
    if configured:
        return list(configured)
    return [f"bp_{n}" for n in range(cfg.data.num_keypoints)]


def _split_visibility(table: pd.DataFrame) -> tuple[np.ndarray, np.ndarray]:
    """Split an (x, y, visible)-per-keypoint table into coords + flags.

    Returns ``(N, K, 2)`` float32 coordinates and ``(N, K)`` int64 visibility.
    Raises ValueError when flags stray outside {0, 1, 2}.
    """
    coord_level = table.columns.get_level_values(2)
    coords = (
        table.loc[:, coord_level.isin(("x", "y"))]
        .to_numpy(dtype=np.float32)
        .reshape(len(table), -1, 2)
    )
    flags = table.loc[:, coord_level == "visible"].to_numpy(dtype=np.float32)
    observed = set(np.unique(flags[~np.isnan(flags)]).tolist())
    invalid_vals = observed - _ALLOWED_VISIBILITY
    if invalid_vals:
        raise ValueError(
            f"visibility column contains invalid values {invalid_vals}; "
            "expected values in {0, 1, 2}"
        )
    return np.ascontiguousarray(coords), flags.astype(np.int64)


@dataclass
class LabeledData:
    """Parsed contents of a label CSV (reference utils/io.py:190).

    Attributes:
        keypoint_names: ordered keypoint names.
        image_names: ordered image paths (relative to the project root).
        keypoints: ``(N, K, 2)`` float32 array of (x, y); NaN where unlabeled.
        visibility: ``(N, K)`` int64 array of 0/1/2 flags, or None when the CSV
            has no ``visible`` column.
    """

    keypoint_names: list[str]
    image_names: list[str]
    keypoints: np.ndarray
    visibility: np.ndarray | None


def parse_label_csv(csv_file: str, header_rows: list[int] | None = None) -> LabeledData:
    """Parse a DLC-format label CSV in a single read (reference utils/io.py:208).

    Handles the optional per-keypoint ``visible`` column: when present, each
    keypoint contributes (x, y, visible) columns and visibility flags are
    returned; values outside {0, 1, 2} raise.
    """
    header_rows = header_rows or [0, 1, 2]
    if not os.path.exists(csv_file):
        raise FileNotFoundError(f"could not find csv file at {csv_file}")

    table = fix_empty_first_row(
        pd.read_csv(csv_file, header=header_rows, index_col=0)
    )
    names = _keypoint_level_names(table.columns, header_rows)

    carries_visibility = header_rows == [0, 1, 2] and any(
        col[2] == "visible" for col in table.columns
    )
    if carries_visibility:
        keypoints, visibility = _split_visibility(table)
    else:
        keypoints = table.to_numpy(dtype=np.float32).reshape(len(table), -1, 2)
        visibility = None

    return LabeledData(
        keypoint_names=names,
        image_names=list(table.index),
        keypoints=keypoints,
        visibility=visibility,
    )


def _ckpt_step(path: str) -> int:
    """Step count embedded in a checkpoint filename, or -1."""
    m = re.search(r"step=(\d+)", path)
    return int(m.group(1)) if m else -1


def ckpt_path_from_base_path(
    base_path: str,
    model_name: str,
    logging_dir_name: str = "tb_logs/",
) -> str | None:
    """Locate the checkpoint for a trained model directory (reference utils/io.py:38).

    Prioritizes ``*-best.ckpt`` in the highest ``version_*`` directory, falling
    back to the highest-step checkpoint. Returns None when nothing is found.
    """
    pattern = os.path.join(
        base_path,
        logging_dir_name,
        glob.escape(model_name),
        "version_*",
        "checkpoints",
        "*.ckpt",
    )
    by_version: dict[int, list[str]] = {}
    for path in glob.glob(pattern):
        m = re.search(r"version_(\d+)", path)
        if m:
            by_version.setdefault(int(m.group(1)), []).append(path)
    if not by_version:
        return None

    candidates = by_version[max(by_version)]
    best = [p for p in candidates if "-best.ckpt" in os.path.basename(p)]
    if best:
        if len(best) > 1:
            logger.warning(
                f"Multiple 'best' checkpoint files found: {best}. "
                "Selecting the one with the highest step count."
            )
        return max(best, key=_ckpt_step)

    logger.warning("No 'best' checkpoint found, falling back to latest checkpoint.")
    if len(candidates) == 1:
        return candidates[0]
    stepped = [p for p in candidates if _ckpt_step(p) >= 0]
    if not stepped:
        raise ValueError(
            "Multiple checkpoint files found but cannot determine which "
            f"to use: {candidates}. "
            "None are marked as 'best' and cannot parse step counts to determine latest. "
            "Please manually select the appropriate checkpoint."
        )
    return max(stepped, key=_ckpt_step)


def return_absolute_path(possibly_relative_path: str, n_dirs_back: int = 3) -> str:
    """Return an absolute path from a possibly relative path (reference utils/io.py:287).

    Relative paths resolve against the directory ``n_dirs_back`` levels above
    the cwd — the reference's convention for hydra run dirs, which nest runs
    ``outputs/YYYY-MM-DD/HH-MM-SS`` (one extra level under ``multirun``).
    """
    if os.path.isabs(possibly_relative_path):
        abs_path = possibly_relative_path
    else:
        root_parts = os.getcwd().split(os.path.sep)[:-n_dirs_back]
        if root_parts and root_parts[-1] == "multirun":
            root_parts = root_parts[:-1]
        abs_path = os.path.join(os.path.sep, *root_parts, possibly_relative_path)
    if not os.path.exists(abs_path):
        raise OSError(f"{abs_path} is not a valid path")
    return abs_path


def return_absolute_data_paths(data_cfg, n_dirs_back: int = 3) -> tuple[str, str]:
    """Return absolute (data_dir, video_dir) paths (reference utils/io.py:305).

    A relative ``video_dir`` is taken to live inside ``data_dir``.
    """
    data_dir = return_absolute_path(data_cfg.data_dir, n_dirs_back=n_dirs_back)
    video_dir = data_cfg.video_dir
    if not os.path.isabs(video_dir):
        video_dir = os.path.join(data_dir, video_dir)
    if not os.path.exists(video_dir):
        raise OSError(f"{video_dir} is not a valid path")
    return data_dir, video_dir


def _view_in_filename(filename: str, view_name: str) -> bool:
    """True when ``view_name`` appears in ``filename`` delimited by
    non-alphanumeric characters (e.g. ``mouse_top_3.mp4`` matches ``top``;
    ``mousetop3.mp4`` does not)."""
    return bool(
        re.search(
            rf"(?<![0-9a-zA-Z]){re.escape(view_name)}(?![0-9a-zA-Z])", filename
        )
    )


def get_videos_in_dir(
    video_dir: str, view_names: list[str] | None = None, return_mp4_only: bool = True
) -> list[str] | list[list[str]]:
    """Gather video files from a directory (reference utils/io.py:348).

    With ``view_names``, returns a list of per-view lists, validating that all
    views cover the same sessions (filenames ``<vid>_<view>.mp4``).
    """
    assert os.path.isdir(video_dir)
    extensions: tuple[str, ...] | str = (".mp4", ".avi", ".mov")
    if return_mp4_only:
        extensions = ".mp4"

    if not view_names:
        found = [
            os.path.join(video_dir, f)
            for f in os.listdir(video_dir)
            if f.endswith(extensions)
        ]
        if not found:
            raise OSError(f"Did not find any valid video files in {video_dir}")
        return found

    candidates = sorted(
        f for f in os.listdir(video_dir) if f.endswith(extensions)
    )
    per_view = {
        view: [f for f in candidates if _view_in_filename(f, view)]
        for view in view_names
    }
    for view, matches in per_view.items():
        if not matches:
            raise OSError(
                f"Did not find any video files for view '{view}' in {video_dir}. "
                "Video filenames must contain the view name delimited by "
                "non-alphanumeric characters, e.g. <vid_name>_<view_name>.mp4."
            )
    # every view must cover the same session set (<session>_<view>.mp4)
    sessions = {
        view: {f.split(f"_{view}")[0] for f in matches}
        for view, matches in per_view.items()
    }
    if len(set(map(frozenset, sessions.values()))) > 1:
        raise RuntimeError(
            "Mismatched video names across views! Please check your videos are "
            "in the format <vid_name>_<view_name[0]>, <vid_name>_<view_name[1]>, "
            "etc., where the `view_name` variable is defined in the config file."
        )
    return [
        [os.path.join(video_dir, f) for f in per_view[view]] for view in view_names
    ]


def check_video_paths(
    video_paths: list[str] | str, view_names: list[str] | None = None
) -> list[str] | list[list[str]]:
    """Validate/normalize video paths to a flat or per-view nested list
    (reference utils/io.py:423)."""
    if isinstance(video_paths, list):
        filenames = video_paths
    elif isinstance(video_paths, str) and os.path.isfile(video_paths):
        filenames = [video_paths]
    elif isinstance(video_paths, str) and os.path.isdir(video_paths):
        filenames = get_videos_in_dir(video_paths, view_names=view_names)
    else:
        raise ValueError(
            "`video_paths` must be a list of files, a single file, or a directory name"
        )
    flat = (
        f
        for entry in filenames
        for f in ([entry] if isinstance(entry, (str, Path)) else entry)
    )
    for f in flat:
        assert str(f).endswith(".mp4"), "video files must be mp4 format!"
    return filenames


def collect_video_files_by_view(
    video_files: list[Path], view_names: list[str]
) -> dict[str, Path]:
    """Match exactly one video file per view by filename (reference utils/io.py:467)."""
    assert len(video_files) == len(view_names), f"{len(video_files)} != {len(view_names)}"
    matched: dict[str, Path] = {}
    for view_name in view_names:
        hits = [
            Path(f) for f in video_files if _view_in_filename(Path(f).stem, view_name)
        ]
        if len(hits) > 1:
            raise ValueError(f"File matches multiple views: {hits[1]}")
        if not hits:
            raise ValueError(f"File not found for view: {view_name}")
        matched[view_name] = hits[0]
    return matched


def extract_view_name_from_video(
    video_filename: str, view_names: list[str]
) -> str | None:
    """Return the first view name contained in a video filename, or None."""
    stem = Path(video_filename).stem
    return next((v for v in view_names if v in stem), None)


def extract_session_name_from_video(video_filename: str, view_names: list[str]) -> str:
    """Strip the view name from a video filename (reference utils/io.py:557)."""
    stem = Path(video_filename).stem
    view = extract_view_name_from_video(video_filename, view_names)
    return stem.replace(f"_{view}", "") if view else stem


def split_video_files_by_view(
    video_paths: list[Path], view_names: list[str]
) -> list[list[Path]]:
    """Group videos into per-session lists ordered by view (reference utils/io.py:594).

    Sessions missing any view are silently skipped.
    """
    sessions: dict[str, dict[str, Path]] = {}
    for video_path in map(Path, video_paths):
        view = extract_view_name_from_video(video_path.name, view_names)
        if view is None:
            continue
        session = extract_session_name_from_video(video_path.name, view_names)
        sessions.setdefault(session, {})[view] = video_path

    return [
        [views[v] for v in view_names]
        for views in sessions.values()
        if all(v in views for v in view_names)
    ]


def find_video_files_for_views(video_dir: str, view_names: list[str]) -> list[list[Path]]:
    """Discover and group per-session/per-view videos in a directory
    (reference utils/io.py:635)."""
    video_dir_path = Path(video_dir)
    if not video_dir_path.exists():
        raise FileNotFoundError(f"Video directory not found: {video_dir}")
    all_video_files = list(video_dir_path.glob("*.mp4"))
    if not all_video_files:
        raise FileNotFoundError(f"No video files found in {video_dir}")
    return split_video_files_by_view(all_video_files, view_names)


def make_dlc_pandas_index(cfg, keypoint_names: list[str]) -> pd.MultiIndex:
    """Build the DLC 3-level (scorer, bodyparts, coords) column MultiIndex
    (reference utils/predictions.py:538)."""
    return pd.MultiIndex.from_product(
        [[f"{cfg.model.model_type}_tracker"], keypoint_names, ["x", "y", "likelihood"]],
        names=["scorer", "bodyparts", "coords"],
    )


def get_context_img_paths(center_img_path: Path) -> list[Path]:
    """The 5 context-frame paths of a center frame: frame indices n-2..n+2,
    floored at 0, written with the center's count of digits (reference
    utils/io.py:497). The index is the first run of digits in the file's
    stem; every occurrence of that run in the stem is replaced."""
    center_img_path = Path(center_img_path)
    match = re.search(r"(\d+)", center_img_path.stem)
    if match is None:
        raise ValueError(f"No frame index in filename, can't get context frames: {center_img_path.name}")
    digits = match.group()
    center = int(digits)
    paths = []
    for index in (max(center + d, 0) for d in range(-2, 3)):
        stem = center_img_path.stem.replace(digits, str(index).zfill(len(digits)))
        paths.append(center_img_path.with_name(stem + center_img_path.suffix))
    return paths
