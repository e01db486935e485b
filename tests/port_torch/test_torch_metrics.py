"""The port's ``metrics.py`` against the JAX package's: the same predictions
and labels CSVs through both ``compute_metrics_single`` give the same side
files (names, index, columns) and values, for pixel error, temporal norm,
singleview PCA with and without centering, and mirrored multiview PCA."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

# both packages run the same numpy over the same CSVs; the PCA fits are
# bitwise equal (test_torch_semisup.py), so only float rounding is left
METRIC_TOL = 1e-6

K = 6
NAMES = [f"kp{i}" for i in range(K)]
MIRRORED = [[0, 1, 2], [3, 4, 5]]


def _data_module(n: int = 40, seed: int = 0):
    """A data module as the PCA reads it: ``dataset.keypoints_resized(i)``
    and the train split's indices; a rigid body with noise, two NaN labels."""
    rng = np.random.default_rng(seed)
    template = rng.uniform(-20, 20, (K, 2))
    angles = rng.uniform(-0.5, 0.5, n)
    rot = np.stack([np.stack([np.cos(angles), -np.sin(angles)], -1),
                    np.stack([np.sin(angles), np.cos(angles)], -1)], -2)
    kp = np.einsum("nij,kj->nki", rot, template) + rng.uniform(20, 44, (n, 1, 2)) + rng.normal(0, 1.5, (n, K, 2))
    kp[3, 1] = np.nan
    kp[7, 4] = np.nan
    dataset = SimpleNamespace(keypoints_resized=lambda i: kp[i].astype(np.float32), num_keypoints=K)
    return SimpleNamespace(dataset=dataset, train_dataset=SimpleNamespace(indices=np.arange(3, n)))


def _cfgs(columns, centering, mirrored):
    from lightning_pose_tpu.config import load_config as jax_load_config
    from lightning_pose_tpu_torch.config import load_config

    out = []
    for cfg in (jax_load_config(), load_config()):
        cfg.data.keypoint_names = list(NAMES)
        cfg.data.num_keypoints = K
        cfg.data.columns_for_singleview_pca = columns
        cfg.data.mirrored_column_matches = mirrored
        cfg.losses.pca_singleview.components_to_keep = 0.9
        cfg.losses.pca_singleview.centering_method = centering
        out.append(cfg)
    return out


def _write_csvs(root: Path, labeled: bool, n: int = 12, seed: int = 1) -> tuple[Path, Path]:
    """A predictions CSV (with the ``set`` column when ``labeled``) and a
    labels CSV with the same index."""
    from lightning_pose_tpu_torch.utils.io import make_dlc_pandas_index

    rng = np.random.default_rng(seed)
    cfg = SimpleNamespace(model=SimpleNamespace(model_type="heatmap"))
    kp = rng.uniform(10, 60, (n, K, 2))
    conf = rng.uniform(0, 1, (n, K, 1))
    preds = pd.DataFrame(np.concatenate([kp, conf], -1).reshape(n, -1),
                         columns=make_dlc_pandas_index(cfg, NAMES))
    index = [f"labeled-data/v/img{i:03d}.png" for i in range(n)] if labeled else list(range(n))
    preds.index = index
    if labeled:
        preds["set"] = np.array(["train", "validation", "test", "unused"] * (n // 4), dtype=object)
    preds_file = root / "predictions.csv"
    preds.to_csv(preds_file)
    labels = kp + rng.normal(0, 2, kp.shape)
    labels[2, 3] = np.nan
    cols = pd.MultiIndex.from_product([["scorer"], NAMES, ["x", "y"]], names=["scorer", "bodyparts", "coords"])
    labels_file = root / "CollectedData.csv"
    pd.DataFrame(labels.reshape(n, -1), index=index, columns=cols).to_csv(labels_file)
    return preds_file, labels_file


def _side_files(root: Path) -> dict[str, pd.DataFrame]:
    return {p.name: pd.read_csv(p, index_col=0) for p in sorted(root.glob("predictions_*.csv"))}


def _run_both(tmp_path, labeled, data_module, columns=None, centering=None, mirrored=None):
    from lightning_pose_tpu.metrics import compute_metrics_single as jax_metrics
    from lightning_pose_tpu_torch.metrics import compute_metrics_single

    jax_cfg, cfg = _cfgs(columns, centering, mirrored)
    out = {}
    for name, fn, c in (("jax", jax_metrics, jax_cfg), ("port", compute_metrics_single, cfg)):
        root = tmp_path / name
        root.mkdir()
        preds_file, labels_file = _write_csvs(root, labeled)
        result = fn(cfg=c, labels_file=str(labels_file), preds_file=str(preds_file), data_module=data_module)
        out[name] = (result, _side_files(root))
    return out


def _assert_same(out):
    (ref_result, ref_files), (result, files) = out["jax"], out["port"]
    assert sorted(files) == sorted(ref_files) and files
    for name, ref in ref_files.items():
        df = files[name]
        assert df.index.equals(ref.index) and list(df.columns) == list(ref.columns), name
        numeric = [c for c in ref.columns if c != "set"]
        np.testing.assert_allclose(df[numeric].to_numpy(float), ref[numeric].to_numpy(float),
                                   rtol=0, atol=METRIC_TOL, err_msg=name)
        if "set" in ref.columns:
            assert (df["set"] == ref["set"]).all()
    for attr in ("pixel_error_df", "temporal_norm_df", "pca_sv_df", "pca_mv_df"):
        assert (getattr(result, attr) is None) == (getattr(ref_result, attr) is None), attr
    return files


@pytest.mark.parametrize("labeled", [True, False])
def test_metrics_without_a_data_module(tmp_path, labeled):
    files = _assert_same(_run_both(tmp_path, labeled, None, columns=list(range(K))))
    assert list(files) == (["predictions_pixel_error.csv"] if labeled else ["predictions_temporal_norm.csv"])


@pytest.mark.parametrize(
    "labeled, columns, centering",
    [
        (True, None, None),
        (True, [0, 2, 3, 5], "mean"),
        (False, [0, 1, 2, 3, 4, 5], "median"),
        (False, [1, 2, 4, 5], None),
    ],
)
def test_singleview_pca_metrics_match_jax(tmp_path, labeled, columns, centering):
    files = _assert_same(_run_both(tmp_path, labeled, _data_module(), columns=columns, centering=centering))
    if columns:
        pca = files["predictions_pca_singleview_error.csv"]
        excluded = [n for i, n in enumerate(NAMES) if i not in columns]
        assert pca[excluded].isna().all().all()


@pytest.mark.parametrize("labeled", [True, False])
def test_mirrored_multiview_pca_metric_matches_jax(tmp_path, labeled):
    files = _assert_same(_run_both(tmp_path, labeled, _data_module(seed=2), mirrored=MIRRORED))
    assert "predictions_pca_multiview_error.csv" in files


def test_pixel_error_and_temporal_norm_match_jax():
    from lightning_pose_tpu import metrics as jax_metrics
    from lightning_pose_tpu_torch import metrics

    rng = np.random.default_rng(3)
    a, b = rng.uniform(0, 50, (2, 9, K, 2))
    a[1, 2] = np.nan
    np.testing.assert_allclose(metrics.pixel_error(a, b), jax_metrics.pixel_error(a, b), rtol=0, atol=0)
    np.testing.assert_allclose(metrics.temporal_norm(b.reshape(9, -1)), jax_metrics.temporal_norm(b.reshape(9, -1)),
                               rtol=0, atol=0)


def test_get_keypoint_names_matches_jax(tmp_path):
    from lightning_pose_tpu.utils.io import get_keypoint_names as jax_names
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.utils.io import get_keypoint_names

    preds_file, labels_file = _write_csvs(tmp_path, True)
    for f in (preds_file, labels_file):
        assert get_keypoint_names(csv_file=str(f)) == jax_names(csv_file=str(f)) == NAMES
    cfg = load_config()
    cfg.data.keypoint_names = None
    cfg.data.num_keypoints = 3
    assert get_keypoint_names(cfg) == jax_names(cfg) == ["bp_0", "bp_1", "bp_2"]
