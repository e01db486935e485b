"""The port's cropzoom (``lightning_pose_tpu_torch/utils/cropzoom.py``)
against the JAX package's on the same synthesized predictions, bboxes and
frames: the bbox math, the smoothing, the cropping and the CSV remap give
the same tables, images and videos, and the checks of the JAX package's
``tests/utils/test_cropzoom.py`` hold for the port."""

from __future__ import annotations

import json

import cv2
import numpy as np
import pandas as pd
import pytest

from lightning_pose_tpu.utils import cropzoom as jcz
from lightning_pose_tpu_torch.utils import cropzoom as cz


def _pred_df(n_frames=6, keypoints=("nose", "tail"), seed=0):
    rng = np.random.default_rng(seed)
    cols = pd.MultiIndex.from_tuples(
        [("scorer", kp, c) for kp in keypoints for c in ("x", "y", "likelihood")],
        names=["scorer", "bodyparts", "coords"],
    )
    data = np.where(cols.get_level_values("coords") == "likelihood", 0.99,
                    rng.uniform(50, 150, (n_frames, len(cols))))
    idx = [f"labeled-data/sess/img{i:03d}.png" for i in range(n_frames)]
    return pd.DataFrame(data, index=pd.Index(idx), columns=cols)


def _df_from_points(points):
    """One-frame prediction df from [(x, y), ...] keypoint coordinates."""
    names = [f"kp{i}" for i in range(len(points))]
    cols = pd.MultiIndex.from_tuples(
        [("scorer", kp, c) for kp in names for c in ("x", "y", "likelihood")],
        names=["scorer", "bodyparts", "coords"],
    )
    row = [v for (x, y) in points for v in (x, y, 0.99)]
    return pd.DataFrame([row], index=pd.Index(["img000.png"]), columns=cols)


def _write_video(path, n_frames=4, w=64, h=48, seed=5):
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 10, (w, h))
    for f in np.random.default_rng(seed).integers(0, 255, size=(n_frames, h, w, 3), dtype=np.uint8):
        writer.write(f)
    writer.release()


def _frames(path) -> np.ndarray:
    cap = cv2.VideoCapture(str(path))
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(frame)
    cap.release()
    return np.stack(frames)


def _bbox_csv(path, rows: dict, index) -> str:
    pd.DataFrame(rows, index=pd.Index(index)).to_csv(path)
    return path


# -- bbox size / bbox dataframe ---------------------------------------------

@pytest.mark.parametrize(
    "df, kwargs, hw",
    [
        (_df_from_points([(0.0, 0.0), (10.0, 21.0)]), {"crop_ratio": 1.0}, [[22, 22]]),  # 21 -> even 22
        (_df_from_points([(0.0, 0.0), (10.0, 21.0)]), {"crop_ratio": 2.0}, [[42, 42]]),
        (_df_from_points([(0.0, 0.0), (10.0, 10.0), (np.nan, np.nan)]), {"crop_ratio": 1.0}, [[10, 10]]),
        (_pred_df(), {"crop_height": 101, "crop_width": 64}, [[102, 64]] * 6),
    ],
    ids=["ratio-1", "ratio-2", "nan-ignored", "fixed-odd-evened"],
)
def test_bbox_size_matches_jax(df, kwargs, hw):
    bbox = cz._compute_bbox_df(df, anchor_keypoints=[], **kwargs)
    assert bbox[["h", "w"]].to_numpy().tolist() == hw
    pd.testing.assert_frame_equal(bbox, jcz._compute_bbox_df(df, anchor_keypoints=[], **kwargs))


@pytest.mark.parametrize("anchors", [[], ["nose"]])
def test_compute_bbox_df_centroid_and_size(anchors):
    df = _pred_df(n_frames=3, keypoints=("nose", "tail", "paw"))
    bbox = cz._compute_bbox_df(df, anchor_keypoints=anchors, crop_ratio=1.5)
    pd.testing.assert_frame_equal(bbox, jcz._compute_bbox_df(df, anchor_keypoints=anchors, crop_ratio=1.5))
    assert list(bbox.columns) == ["x", "y", "h", "w"] and (bbox.index == df.index).all()
    assert (bbox["h"] % 2 == 0).all() and (bbox["h"] == bbox["w"]).all()
    if anchors:  # one anchor: zero span, a zero-size bbox on it
        assert (bbox["h"] == 0).all()
        return
    coords = df.columns.get_level_values("coords")
    np.testing.assert_array_equal(
        bbox["x"].to_numpy(), np.int64(df.loc[:, coords == "x"].to_numpy().mean(axis=1) - bbox["w"] // 2))
    np.testing.assert_array_equal(
        bbox["y"].to_numpy(), np.int64(df.loc[:, coords == "y"].to_numpy().mean(axis=1) - bbox["h"] // 2))


@pytest.mark.parametrize(
    "kwargs, error, match",
    [
        ({"anchor_keypoints": ["unicorn"], "crop_ratio": 1.0}, AssertionError, "not found"),
        ({"anchor_keypoints": [], "crop_ratio": 1.0, "crop_height": 64, "crop_width": 64}, ValueError, "not both"),
        ({"anchor_keypoints": []}, ValueError, "must be provided"),
    ],
)
def test_compute_bbox_df_rejects_bad_arguments(kwargs, error, match):
    for module in (cz, jcz):
        with pytest.raises(error, match=match):
            module._compute_bbox_df(_pred_df(), **kwargs)


def test_generate_bbox_matches_jax(tmp_path):
    from lightning_pose_tpu_torch.config import Config

    preds = tmp_path / "preds.csv"
    _pred_df(n_frames=8).to_csv(preds)
    detector_cfg = Config({"crop_ratio": 1.5, "anchor_keypoints": ["nose", "tail"]})
    cz.generate_bbox(preds, detector_cfg, tmp_path / "port" / "bbox.csv")
    jcz.generate_bbox(preds, detector_cfg, tmp_path / "jax" / "bbox.csv")
    assert (tmp_path / "port" / "bbox.csv").read_text() == (tmp_path / "jax" / "bbox.csv").read_text()


# -- smoothing ---------------------------------------------------------------

def test_smooth_bbox_rolling_median(tmp_path):
    in_dir = tmp_path / "in"
    in_dir.mkdir()
    _bbox_csv(in_dir / "sess_bbox.csv", {"x": [0, 100, 0, 0, 0], "y": [5] * 5, "h": [10] * 5, "w": [10] * 5},
              [f"f{i}" for i in range(5)])
    cz.smooth_bbox(in_dir, tmp_path / "out", window=3)
    jcz.smooth_bbox(in_dir, tmp_path / "jax", window=3)
    sm = pd.read_csv(tmp_path / "out" / "sess_bbox.csv", index_col=0)
    # the spike is filtered away; the first row's centered window is [0, 100]
    assert (sm["x"].iloc[1:] == 0).all() and sm["x"].iloc[0] == 50 and (sm["y"] == 5).all()
    assert (tmp_path / "out" / "sess_bbox.csv").read_text() == (tmp_path / "jax" / "sess_bbox.csv").read_text()
    meta = json.loads((tmp_path / "out" / "metadata.json").read_text())
    assert meta == json.loads((tmp_path / "jax" / "metadata.json").read_text())
    assert meta["method"] == "median" and meta["window"] == 3


@pytest.mark.parametrize("method, match", [("median", "no .*bbox.csv"), ("mean", "unsupported method")])
def test_smooth_bbox_errors(tmp_path, method, match):
    empty = tmp_path / "empty"
    empty.mkdir()
    with pytest.raises(ValueError, match=match):
        cz.smooth_bbox(empty, tmp_path / "out", method=method)


# -- cropping ----------------------------------------------------------------

@pytest.mark.parametrize("x, y, h, w", [(4, 2, 6, 8), (-4, -4, 8, 8), (50, 50, 8, 8)])
def test_crop_frame_matches_jax(x, y, h, w):
    frame = np.arange(20 * 20 * 3, dtype=np.uint8).reshape(20, 20, 3)
    crop = cz._crop_frame(frame, x=x, y=y, h=h, w=w)
    np.testing.assert_array_equal(crop, jcz._crop_frame(frame, x=x, y=y, h=h, w=w))
    assert crop.shape == (h, w, 3)
    if x >= 0 and y >= 0 and x + w <= 20 and y + h <= 20:
        np.testing.assert_array_equal(crop, frame[y:y + h, x:x + w])
    elif x >= 20:
        assert (crop == 0).all()
    else:  # zero padding past the top-left edge
        assert (crop[:-y] == 0).all() and (crop[:, :-x] == 0).all()
        np.testing.assert_array_equal(crop[-y:, -x:], frame[: h + y, : w + x])


@pytest.mark.parametrize(
    "h, w, out_hw",
    [([16] * 4, [20] * 4, (16, 20)), ([14, 15, 15, 30], [18, 21, 21, 40], (16, 20))],
    ids=["fixed", "even-median"],
)
def test_crop_video_matches_jax(tmp_path, h, w, out_hw):
    """The output size is the median bbox rounded to even; every frame
    equals the JAX package's crop."""
    video = tmp_path / "in.mp4"
    _write_video(video)
    bbox_file = _bbox_csv(tmp_path / "bbox.csv", {"x": [10, 11, 9, 10], "y": [8] * 4, "h": h, "w": w},
                          [f"f{i}" for i in range(4)])
    cz.crop_video(video, bbox_file, tmp_path / "port.mp4")
    jcz.crop_video(video, bbox_file, tmp_path / "jax.mp4")
    port = _frames(tmp_path / "port.mp4")
    assert port.shape == (4, *out_hw, 3)
    np.testing.assert_array_equal(port, _frames(tmp_path / "jax.mp4"))


@pytest.mark.parametrize("n_rows", [3, 6])
def test_crop_video_raises_on_bbox_frame_count_mismatch(tmp_path, n_rows):
    video = tmp_path / "in.mp4"
    _write_video(video, n_frames=4)
    bbox_file = _bbox_csv(tmp_path / "bbox.csv", {"x": [10] * n_rows, "y": [8] * n_rows, "h": [16] * n_rows,
                                                  "w": [20] * n_rows}, [f"f{i}" for i in range(n_rows)])
    with pytest.raises(ValueError, match="dense"):
        cz.crop_video(video, bbox_file, tmp_path / "out.mp4")


def _labeled_set(tmp_path, n: int, seed: int):
    data_dir = tmp_path / "data"
    (data_dir / "labeled-data" / "sess").mkdir(parents=True)
    rng = np.random.default_rng(seed)
    rel_paths = [f"labeled-data/sess/img{i:03d}.png" for i in range(n)]
    for rel in rel_paths:
        cv2.imwrite(str(data_dir / rel), rng.integers(0, 255, size=(40, 56, 3), dtype=np.uint8))
    cols = pd.MultiIndex.from_tuples([("s", "nose", "x"), ("s", "nose", "y")],
                                     names=["scorer", "bodyparts", "coords"])
    labels = pd.DataFrame(rng.uniform(5, 35, size=(n, 2)), index=pd.Index(rel_paths), columns=cols)
    labels.to_csv(data_dir / "labels.csv")
    bbox = pd.DataFrame({"x": rng.integers(-4, 20, n), "y": rng.integers(-4, 16, n), "h": [18] * n, "w": [22] * n},
                        index=pd.Index(rel_paths))
    bbox.to_csv(tmp_path / "bbox.csv")
    return data_dir, labels, bbox, rel_paths


@pytest.mark.parametrize("workers", [1, 4])
def test_crop_labeled_frames_matches_jax(tmp_path, workers):
    """Serial and pooled crops give the JAX package's images and remapped
    CSV."""
    data_dir, labels, bbox, rel_paths = _labeled_set(tmp_path, 12, seed=11)
    for name, module in (("port", cz), ("jax", jcz)):
        module.crop_labeled_frames(data_dir, data_dir / "labels.csv", tmp_path / "bbox.csv", tmp_path / name,
                                   tmp_path / f"{name}.csv", num_workers=workers)
    for rel in rel_paths:
        img = cv2.imread(str(tmp_path / "port" / rel))
        assert img is not None and img.shape == (18, 22, 3)
        np.testing.assert_array_equal(img, cv2.imread(str(tmp_path / "jax" / rel)))
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "jax.csv").read_text()
    remapped = pd.read_csv(tmp_path / "port.csv", header=[0, 1, 2], index_col=0)
    for axis in ("x", "y"):
        np.testing.assert_allclose(remapped[("s", "nose", axis)].to_numpy(),
                                   labels[("s", "nose", axis)].to_numpy() - bbox[axis].to_numpy())


@pytest.mark.parametrize("order", ["same", "reversed"])
def test_generate_cropped_csv_roundtrip_and_alignment(tmp_path, order):
    """subtract then add restores the labels; the bbox rows align by frame,
    not by position; the likelihood is untouched; the files are the JAX
    package's."""
    rel_paths = [f"labeled-data/s/img{i}.png" for i in range(4)]
    cols = pd.MultiIndex.from_tuples([("s", "kp", "x"), ("s", "kp", "y"), ("s", "kp", "likelihood")],
                                     names=["scorer", "bodyparts", "coords"])
    labels = pd.DataFrame(np.random.default_rng(7).uniform(0, 100, size=(4, 3)), index=pd.Index(rel_paths),
                          columns=cols)
    bbox = pd.DataFrame({"x": [10, 20, 30, 40], "y": [1, 2, 3, 4], "h": [10] * 4, "w": [10] * 4},
                        index=pd.Index(rel_paths))
    labels.to_csv(tmp_path / "labels.csv")
    (bbox if order == "same" else bbox.iloc[::-1]).to_csv(tmp_path / "bbox.csv")
    for name, module in (("port", cz), ("jax", jcz)):
        module.generate_cropped_csv_file(tmp_path / "labels.csv", tmp_path / "bbox.csv", tmp_path / f"{name}_sub.csv")
        module.generate_cropped_csv_file(tmp_path / f"{name}_sub.csv", tmp_path / "bbox.csv",
                                         tmp_path / f"{name}_back.csv", mode="add")
    sub = pd.read_csv(tmp_path / "port_sub.csv", header=[0, 1, 2], index_col=0)
    np.testing.assert_allclose(sub[("s", "kp", "x")], labels[("s", "kp", "x")] - bbox["x"].to_numpy())
    np.testing.assert_allclose(sub[("s", "kp", "likelihood")], labels[("s", "kp", "likelihood")])
    back = pd.read_csv(tmp_path / "port_back.csv", header=[0, 1, 2], index_col=0)
    np.testing.assert_allclose(back.to_numpy(), labels.to_numpy(), atol=1e-9)
    for stage in ("sub", "back"):
        assert (tmp_path / f"port_{stage}.csv").read_text() == (tmp_path / f"jax_{stage}.csv").read_text()


def test_generate_cropped_csv_invalid_mode(tmp_path):
    with pytest.raises(ValueError, match="not a valid mode"):
        cz.generate_cropped_csv_file("a.csv", "b.csv", "c.csv", mode="multiply")
