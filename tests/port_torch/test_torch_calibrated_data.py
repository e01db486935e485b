"""Slice 10, the calibrated multiview dataset against the JAX package's
(``lightning_pose_tpu/data/datasets_multiview.py``): each calibration
source gives the JAX dataset's camera arrays in every sample, bit for bit
(a single anipose TOML, a frame-map CSV, the one-row-per-view CSV, and
discovery of ``calibrations/<session>.toml`` or ``calibration.toml``);
partial discovery turns 3D off with a warning, a camera-name order that
is not ``view_names`` raises ValueError in both packages, and a context
model with calibration is refused in both with the same ValueError. The loss factory adds the two
supervised 3D losses for a calibrated dataset, as the JAX package's does,
and the trainer's device cache and validation batches carry the cameras.
Data from ``utils/synthetic.write_calibrated_multiview_dataset``."""

from __future__ import annotations

import logging
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

VIEWS = ["top", "side", "front"]
NAMES = ["nose", "ear", "tail"]
FRAMES = 8
CAMERA_KEYS = ("intrinsic_matrix", "extrinsic_matrix", "distortions")


@pytest.fixture(scope="module")
def cal_root(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_calibrated_multiview_dataset

    return write_calibrated_multiview_dataset(tmp_path_factory.mktemp("port_cal") / "data", FRAMES, 100, 120, NAMES,
                                              VIEWS, seed=2, span_degrees=180.0, frame_map=True)


def _cfg(root: Path, camera_params_file=None, views=VIEWS):
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(root)
    cfg.data.video_dir = str(root / "videos")
    cfg.data.csv_file = [f"CollectedData_{v}.csv" for v in views]
    cfg.data.view_names = list(views)
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.data.camera_params_file = camera_params_file
    cfg.model.model_type = "heatmap_multiview_transformer"
    cfg.model.backbone = "vits_dino"
    cfg.model.losses_to_use = []
    cfg.training.imgaug = "dlc"
    cfg.training.imgaug_3d = True
    cfg.losses.supervised_reprojection_heatmap_mse = {"log_weight": 3.0}
    cfg.losses.supervised_pairwise_projections = {"log_weight": 1.0}
    return cfg


def _datasets(cfg, root: Path, **kwargs):
    from lightning_pose_tpu.data.datasets_multiview import MultiviewHeatmapDataset as JaxDataset
    from lightning_pose_tpu_torch.data.datasets_multiview import MultiviewHeatmapDataset

    return JaxDataset(cfg, str(root), **kwargs), MultiviewHeatmapDataset(cfg, str(root), **kwargs)


def _copy(root: Path, dest: Path) -> Path:
    """The labeled set without its calibrations."""
    return Path(shutil.copytree(root, dest, ignore=shutil.ignore_patterns("calibrations", "*.toml", "videos")))


def _view_rows_csv(root: Path, path: Path) -> None:
    """The calibration TOML written as the one-row-per-view CSV."""
    from lightning_pose_tpu_torch.data.anipose import load_anipose_toml

    calib = load_anipose_toml(str(root / "calibrations" / "synth.toml"))
    rows = {}
    for v, view in enumerate(VIEWS):
        row = {f"K{i}{j}": calib["intrinsics"][v, i, j] for i in range(3) for j in range(3)}
        row.update({f"RT{i}{j}": calib["extrinsics"][v, i, j] for i in range(3) for j in range(4)})
        row.update({f"d{i}": calib["distortions"][v, i] for i in range(5)})
        rows[view] = row
    pd.DataFrame.from_dict(rows, orient="index").to_csv(path)


@pytest.mark.parametrize("source", ["discovery", "fallback", "toml", "frame_map", "view_rows"])
def test_calibration_sources_match_jax(cal_root, tmp_path, source):
    """Every sample's images, keypoints and camera arrays equal the JAX
    dataset's; ``frame_calibration`` too."""
    root, cam_file = cal_root, None
    if source == "fallback":  # no per-session TOML: calibration.toml at the root
        root = _copy(cal_root, tmp_path / "fallback")
        shutil.copy(cal_root / "calibrations" / "synth.toml", root / "calibration.toml")
    elif source == "toml":
        cam_file = str(cal_root / "calibrations" / "synth.toml")
    elif source == "frame_map":
        cam_file = "calibration_frame_map.csv"
    elif source == "view_rows":
        _view_rows_csv(cal_root, tmp_path / "views.csv")
        cam_file = str(tmp_path / "views.csv")
    ref_ds, ds = _datasets(_cfg(root, cam_file), root)
    assert ds.is_calibrated and ref_ds.is_calibrated
    for i in range(FRAMES):
        out, ref = ds[i], ref_ds[i]
        assert set(out) == set(ref)
        for key in ("images", "keypoints", "visibility", "bbox") + CAMERA_KEYS:
            np.testing.assert_array_equal(out[key], ref[key], err_msg=f"{source} {key}")
        assert out["intrinsic_matrix"].shape == (3, 3, 3) and out["distortions"].dtype == np.float32
        for key in ("intrinsics", "extrinsics", "distortions"):
            np.testing.assert_array_equal(ds.frame_calibration(i)[key], ref_ds.frame_calibration(i)[key])


def test_partial_discovery_disables_3d(cal_root, tmp_path, caplog):
    """Half of the frames moved to a session without a TOML: both packages
    warn and train without 3D; with ``calibration.toml`` at the root as the
    fallback, every frame resolves again, to two files."""
    root = Path(shutil.copytree(cal_root, tmp_path / "partial", ignore=shutil.ignore_patterns("videos")))
    for view in VIEWS:
        csv = root / f"CollectedData_{view}.csv"
        df = pd.read_csv(csv, header=[0, 1, 2], index_col=0)
        (root / "labeled-data" / f"other_{view}").mkdir()
        moved = [name.replace(f"synth_{view}", f"other_{view}") if i % 2 else name for i, name in enumerate(df.index)]
        for old, new in zip(df.index, moved):
            if old != new:
                shutil.copy(root / old, root / new)
        df.index = moved
        df.to_csv(csv)
    with caplog.at_level(logging.WARNING):
        ref_ds, ds = _datasets(_cfg(root), root)
    assert not ds.is_calibrated and not ref_ds.is_calibrated
    assert "intrinsic_matrix" not in ds[0]
    port_warnings = [r for r in caplog.records if r.name.startswith("lightning_pose_tpu_torch")]
    assert any("disabling 3D" in r.getMessage() for r in port_warnings)
    shutil.copy(cal_root / "calibrations" / "synth.toml", root / "calibration.toml")
    ref_ds, ds = _datasets(_cfg(root), root)
    assert ds.is_calibrated and ds._calib_file_per_frame == ref_ds._calib_file_per_frame
    assert sorted(set(ds._calib_file_per_frame)) == ["calibration.toml", str(Path("calibrations") / "synth.toml")]


@pytest.mark.parametrize("case", ["order", "context", "context_discovered", "frame_map_rows"])
def test_calibration_refusals_match_jax(cal_root, tmp_path, case):
    """ValueError in both packages: the TOML's cameras in another order
    than ``view_names``, a frame map whose rows are not the label CSV's
    frames. A discovered TOML in another order turns 3D off instead. A
    context model with a ``camera_params_file`` or a discovered calibration
    is refused in both: each package's dataset raises ValueError, through
    the class and through the data factory."""
    from lightning_pose_tpu.data.datasets_multiview import MultiviewHeatmapDataset as JaxDataset
    from lightning_pose_tpu_torch.data.datasets_multiview import MultiviewHeatmapDataset
    from lightning_pose_tpu_torch.data.factory import get_dataset

    if case.startswith("context"):
        cfg = _cfg(cal_root, "calibration_frame_map.csv" if case == "context" else None)
        with pytest.raises(ValueError, match="context"):
            JaxDataset(cfg, str(cal_root), do_context=True)
        with pytest.raises(ValueError, match="context") as err:
            MultiviewHeatmapDataset(cfg, str(cal_root), do_context=True)
        with pytest.raises(ValueError, match="context") as ref_err:
            JaxDataset(cfg, str(cal_root), do_context=True)
        assert str(err.value) == str(ref_err.value)
        cfg.model.model_type = "heatmap_mhcrnn"
        with pytest.raises(ValueError, match="context"):
            get_dataset(cfg, str(cal_root))
        return
    if case == "order":
        views = [VIEWS[1], VIEWS[0], VIEWS[2]]
        cfg, match = _cfg(cal_root, str(cal_root / "calibrations" / "synth.toml"), views), "same camera order"
        ref_ds, ds = _datasets(_cfg(cal_root, views=views), cal_root)
        assert not ds.is_calibrated and not ref_ds.is_calibrated
    else:
        frame_map = pd.read_csv(cal_root / "calibration_frame_map.csv", index_col=0).iloc[::-1]
        frame_map.to_csv(tmp_path / "reversed.csv")
        cfg, match = _cfg(cal_root, str(tmp_path / "reversed.csv")), "must match the label CSV"
    for cls in (JaxDataset, MultiviewHeatmapDataset):
        with pytest.raises(ValueError, match=match):
            cls(cfg, str(cal_root))


def test_calibrated_losses_cache_and_batches(cal_root):
    """The loss factory of a calibrated dataset adds both supervised 3D
    losses with the JAX package's parameters (and none without a
    calibration); the device cache and a validation batch on the device
    carry the cameras."""
    import torch

    from lightning_pose_tpu.data.factory import get_data_module as jax_dm, get_dataset as jax_ds
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu_torch.data.factory import get_data_module, get_dataset
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.train import trainer

    cfg = _cfg(cal_root)
    ref_dm = jax_dm(cfg, jax_ds(cfg, str(cal_root)), str(cal_root / "videos"))
    dm = get_data_module(cfg, get_dataset(cfg, str(cal_root)), str(cal_root / "videos"))
    ref, out = jax_factories(cfg, ref_dm)["supervised"], get_loss_factories(cfg, dm)["supervised"]
    assert list(out.losses_params_dict) == list(ref.losses_params_dict) == [
        "heatmap_mse", "supervised_pairwise_projections", "supervised_reprojection_heatmap_mse"]
    assert out.losses_params_dict == ref.losses_params_dict
    for name, loss in out.loss_instance_dict.items():
        assert loss.weight == pytest.approx(ref.loss_instance_dict[name].weight, rel=1e-12), name

    uncal = _cfg(_copy(cal_root, cal_root.parent / "uncalibrated"))
    uncal_dm = get_data_module(uncal, get_dataset(uncal, uncal.data.data_dir), None)
    assert list(get_loss_factories(uncal, uncal_dm)["supervised"].losses_params_dict) == ["heatmap_mse"]

    cache = trainer._device_cache(dm.dataset, torch.device("cpu"))
    assert set(cache) == {"images", "keypoints", "visibility", "bbox", *CAMERA_KEYS}
    assert cache["intrinsic_matrix"].shape == (FRAMES, 3, 3, 3)
    batch = trainer._on_device(next(iter(dm.val_batches())), torch.device("cpu"))
    assert set(batch) == set(cache)
    np.testing.assert_array_equal(batch["extrinsic_matrix"][0].numpy(), dm.dataset[0]["extrinsic_matrix"])
    assert "intrinsic_matrix" not in trainer._device_cache(uncal_dm.dataset, torch.device("cpu"))
