"""Slice 7, the multiview data path against the JAX package's: the fused
multiview samples, the dispatch of calibrated data, the multiview PCA subspace
and ``pca_multiview`` loss, the metrics on a true-multiview data module,
the frame-synchronized unlabeled and predict loaders (bitwise frames), and
the per-view prediction dataframes. Data from ``utils/synthetic.py``: two
views of one 3D keypoint set, uncalibrated."""

from __future__ import annotations

from pathlib import Path
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

VIEWS = ["cam0", "cam1"]
NAMES = ["nose", "ear", "tail"]
FRAMES = 24


@pytest.fixture(scope="module")
def mv_root(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_multiview_dataset, write_multiview_videos

    root = write_multiview_dataset(tmp_path_factory.mktemp("port_mv") / "data", FRAMES, 100, 120, NAMES, VIEWS,
                                   seed=3)
    write_multiview_videos(root, "sessA", 20, 100, 120, VIEWS, seed=4)
    write_multiview_videos(root, "sessB", 14, 90, 110, VIEWS, seed=5)
    return root


def _cfg(root: Path, losses=()):
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(root)
    cfg.data.video_dir = str(root / "videos")
    cfg.data.csv_file = [f"CollectedData_{v}.csv" for v in VIEWS]
    cfg.data.view_names = list(VIEWS)
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.mirrored_column_matches = [0, 1, 2]
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.model_type = "heatmap_multiview_transformer"
    cfg.model.backbone = "vits_dino"
    cfg.model.losses_to_use = list(losses)
    cfg.training.imgaug = "dlc"
    cfg.training.train_prob, cfg.training.val_prob = 0.8, 0.1
    cfg.dali.base.train.sequence_length = 6
    cfg.dali.base.predict.sequence_length = 8
    return cfg


def _modules(cfg, root):
    """Both packages' dataset and data module of the config."""
    from lightning_pose_tpu.data.factory import get_data_module as jax_dm
    from lightning_pose_tpu.data.factory import get_dataset as jax_ds
    from lightning_pose_tpu_torch.data.factory import get_data_module, get_dataset

    ref_ds, ds = jax_ds(cfg, str(root)), get_dataset(cfg, str(root))
    return (ref_ds, jax_dm(cfg, ref_ds, str(root / "videos"))), (ds, get_data_module(cfg, ds, str(root / "videos")))


def test_multiview_samples_match_jax(mv_root):
    """Images ``(V, H, W, 3)``, view-major keypoints and visibility, bboxes
    ``(4V,)``, and the PCA's resized keypoints, bitwise; the per-view image
    names; one view's keypoint count for the shared head."""
    (ref_ds, _), (ds, _) = _modules(_cfg(mv_root), mv_root)
    assert type(ds).__name__ == "MultiviewHeatmapDataset"
    assert (len(ds), ds.num_keypoints, ds.num_keypoints_per_view) == (FRAMES, 2 * len(NAMES), len(NAMES))
    assert ds.image_names_by_view == ref_ds.image_names_by_view
    for i in (0, 7, FRAMES - 1):
        out, ref = ds[i], ref_ds[i]
        assert out["images"].shape == (2, 128, 128, 3)
        for key in ("images", "keypoints", "visibility", "bbox"):
            np.testing.assert_array_equal(out[key], ref[key], err_msg=key)
        np.testing.assert_array_equal(ds.keypoints_resized(i), ref_ds.keypoints_resized(i))


def test_calibration_raises_not_implemented(mv_root, tmp_path):
    """Calibration is ported: a ``camera_params_file``, or a
    ``calibration.toml`` that every frame's session finds, calibrates the
    multiview transformer's dataset. A heatmap model on calibrated
    multiview data takes the calibrated multiview dataset, as in the JAX
    package, and its loss factory adds no supervised 3D loss (the JAX
    package gates them on the multiview transformer). A frame path without
    ``labeled-data/<session>_<view>/`` is a ValueError, as in the JAX
    package."""
    from lightning_pose_tpu.data.factory import get_dataset as jax_get_dataset
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    import shutil

    from lightning_pose_tpu_torch.data.factory import get_dataset
    from lightning_pose_tpu_torch.utils.synthetic import synthetic_cameras, write_anipose_toml

    root = tmp_path / "calibrated"
    shutil.copytree(mv_root, root, ignore=shutil.ignore_patterns("videos"))
    write_anipose_toml(root / "calibration.toml", synthetic_cameras(len(VIEWS), 100, 120), VIEWS, 100, 120)
    cfg = _cfg(root)
    cfg.data.camera_params_file = "calibration.toml"
    assert get_dataset(cfg, str(root)).is_calibrated
    assert get_dataset(_cfg(root), str(root)).is_calibrated  # found by discovery
    assert not get_dataset(_cfg(mv_root), str(mv_root)).is_calibrated
    cfg.model.model_type = "heatmap"
    cfg.losses.supervised_pairwise_projections = {"log_weight": 1.0}
    ds, ref_ds = get_dataset(cfg, str(root)), jax_get_dataset(cfg, str(root))
    assert type(ds).__name__ == type(ref_ds).__name__ == "MultiviewHeatmapDataset"
    assert ds.is_calibrated and ref_ds.is_calibrated and not ds.do_context
    np.testing.assert_array_equal(ds[0]["intrinsic_matrix"], ref_ds[0]["intrinsic_matrix"])
    dm = SimpleNamespace(dataset=ds)
    assert list(get_loss_factories(cfg, dm)["supervised"].loss_instance_dict) == ["heatmap_mse"]
    assert list(jax_factories(cfg, SimpleNamespace(dataset=ref_ds))["supervised"].loss_instance_dict) == [
        "heatmap_mse"]
    csv = root / "CollectedData_cam0.csv"
    df = pd.read_csv(csv, header=[0, 1, 2], index_col=0)
    df.index = [name.replace("synth_cam0/", "") for name in df.index]
    df.to_csv(csv)
    for name in df.index:
        shutil.copy(root / "labeled-data" / "synth_cam0" / Path(name).name, root / name)
    (root / "calibration.toml").unlink()
    with pytest.raises(ValueError, match="expected pattern"):
        get_dataset(_cfg(root), str(root))


def test_multiview_pca_and_loss_match_jax(mv_root):
    """The flat match list expands to one list a view, the subspace keeps 3
    components, its mean, eigenvectors and empirical epsilon equal the JAX
    package's, and the ``pca_multiview`` loss on predictions agrees within
    1e-5."""
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories

    cfg = _cfg(mv_root, ["pca_multiview"])
    cfg.losses.pca_multiview.log_weight = 0.0
    (_, ref_dm), (_, dm) = _modules(cfg, mv_root)
    try:
        ref = jax_factories(cfg, ref_dm)["unsupervised"]
        out = get_loss_factories(cfg, dm)["unsupervised"]
        pca, ref_pca = (f.loss_instance_dict["pca_multiview"].pca for f in (out, ref))
        assert pca.mirrored_column_matches == ref_pca.mirrored_column_matches == [[0, 1, 2], [3, 4, 5]]
        assert pca.parameters["kept_eigenvectors"].shape == (3, 4)
        for key in ("mean", "kept_eigenvectors", "discarded_eigenvectors"):
            np.testing.assert_allclose(pca.parameters[key], ref_pca.parameters[key], rtol=0, atol=1e-5, err_msg=key)
        assert float(pca.parameters["epsilon"]) == pytest.approx(float(ref_pca.parameters["epsilon"]), abs=1e-5)
        preds = np.random.default_rng(6).uniform(0, 128, (5, 2 * 2 * len(NAMES))).astype(np.float32)
        value, logs = out(stage="train", anneal_weight=1.0, keypoints_pred=torch.from_numpy(preds))
        ref_value, ref_logs = ref(stage="train", anneal_weight=1.0, keypoints_pred=jnp.asarray(preds))
        assert float(ref_value) > 0
        np.testing.assert_allclose(float(value), float(ref_value), rtol=1e-5)
        np.testing.assert_allclose(float(logs["train_pca_multiview_loss"]), float(ref_logs["train_pca_multiview_loss"]),
                                   rtol=1e-5)
    finally:
        dm.close()
        ref_dm.close()


def test_metrics_on_a_multiview_data_module_match_jax(mv_root, tmp_path):
    """Per view, the labeled predictions get pixel error and no PCA metric
    (a true-multiview data module), the same files and values as the JAX
    package's."""
    from lightning_pose_tpu.metrics import compute_metrics_single as jax_metrics
    from lightning_pose_tpu_torch.metrics import compute_metrics_single
    from lightning_pose_tpu_torch.utils.predictions import PredictionHandler

    cfg = _cfg(mv_root)
    (_, ref_dm), (_, dm) = _modules(cfg, mv_root)
    rng = np.random.default_rng(7)
    preds = [(rng.uniform(0, 100, (FRAMES, 12)).astype(np.float32), rng.uniform(0, 1, (FRAMES, 6)).astype(np.float32))]
    frames = PredictionHandler(cfg=cfg, data_module=dm)(preds)
    for view, csv in zip(VIEWS, cfg.data.csv_file):
        for name, fn, module in (("port", compute_metrics_single, dm), ("jax", jax_metrics, ref_dm)):
            d = tmp_path / name / view
            d.mkdir(parents=True)
            frames[view].to_csv(d / "predictions.csv")
            fn(cfg=cfg, labels_file=str(mv_root / csv), preds_file=str(d / "predictions.csv"), data_module=module)
        files = sorted(p.name for p in (tmp_path / "port" / view).iterdir())
        assert files == sorted(p.name for p in (tmp_path / "jax" / view).iterdir())
        assert files == ["predictions.csv", "predictions_pixel_error.csv"]
        out = pd.read_csv(tmp_path / "port" / view / files[1], index_col=0)
        ref = pd.read_csv(tmp_path / "jax" / view / files[1], index_col=0)
        pd.testing.assert_frame_equal(out, ref, rtol=1e-6)


def test_unlabeled_windows_match_jax_bitwise(mv_root):
    """The semi-supervised data modules' streams: the same sessions and
    starts from the same seed, ``(T, V, H, W, 3)`` frames bitwise and the
    per-view bboxes ``(T, 4V)``."""
    cfg = _cfg(mv_root, ["temporal"])
    (_, ref_dm), (_, dm) = _modules(cfg, mv_root)
    try:
        for _ in range(4):
            out, ref = next(dm.unlabeled_loader), next(ref_dm.unlabeled_loader)
            assert out["frames"].shape == (6, 2, 128, 128, 3)
            np.testing.assert_array_equal(out["frames"], ref["frames"])
            np.testing.assert_array_equal(out["bbox"], ref["bbox"])
    finally:
        dm.close()
        ref_dm.close()


def test_predict_loader_matches_jax_bitwise(mv_root):
    """20 frames in batches of 8, the last one FILL-padded, ``(T, V, h, w,
    3)``, bitwise; mismatched frame counts raise."""
    from lightning_pose_tpu.data.video import MultiviewPredictVideoLoader as JaxLoader
    from lightning_pose_tpu_torch.data.video import MultiviewPredictVideoLoader

    files = [str(mv_root / "videos" / f"sessA_{v}.mp4") for v in VIEWS]
    out = list(MultiviewPredictVideoLoader(files, 8, 128, 128))
    ref = list(JaxLoader(files, 8, 128, 128))
    assert len(out) == len(ref) == 3 and out[0].shape == (8, 2, 128, 128, 3)
    for a, b in zip(out, ref):
        np.testing.assert_array_equal(a, b)
    with pytest.raises(RuntimeError, match="mismatched frame counts"):
        MultiviewPredictVideoLoader([files[0], str(mv_root / "videos" / "sessB_cam1.mp4")], 8, 128, 128)


def test_per_view_prediction_frames_match_jax(mv_root):
    """A labeled multiview dataset's and a multiview video's stacked
    outputs split into one dataframe a view, as the JAX package splits
    them."""
    from lightning_pose_tpu.utils.predictions import PredictionHandler as JaxHandler
    from lightning_pose_tpu_torch.utils.predictions import PredictionHandler

    cfg = _cfg(mv_root)
    (_, ref_dm), (_, dm) = _modules(cfg, mv_root)
    rng = np.random.default_rng(8)
    preds = [(rng.uniform(0, 100, (FRAMES, 12)), rng.uniform(0, 1, (FRAMES, 6)))]
    out, ref = PredictionHandler(cfg=cfg, data_module=dm)(preds), JaxHandler(cfg=cfg, data_module=ref_dm)(preds)
    video = str(mv_root / "videos" / "sessA_cam0.mp4")
    vpreds = [(rng.uniform(0, 100, (24, 12)), rng.uniform(0, 1, (24, 6)))]
    vout = PredictionHandler(cfg=cfg, video_file=video)(vpreds, is_multiview_video=True)
    vref = JaxHandler(cfg=cfg, data_module=None, video_file=video)(vpreds, is_multiview_video=True)
    for view in VIEWS:
        pd.testing.assert_frame_equal(out[view], ref[view])
        pd.testing.assert_frame_equal(vout[view], vref[view])
        assert len(vout[view]) == 20
