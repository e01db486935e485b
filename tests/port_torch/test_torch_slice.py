"""Slice 1 end to end: ``Model.from_dir(dir).predict_on_video_file(video)``
and ``predict_frame`` in both packages, on one model directory written by
the JAX package (resnet18, 64 px, peaked random-init head)."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from lightning_pose_tpu.api.model import Model as JaxModel
from lightning_pose_tpu_torch.api.model import Model

# fp32 on the CPU in both packages: the convolutions sum in another order,
# and the temperature-1000 softmax of the decode magnifies that (measured:
# 2.3e-4 px and 1.5e-5); frame coordinates are model pixels scaled by 80/64
# and 60/64
PX_TOL = 5e-3
CONF_TOL = 2e-4


@pytest.fixture(scope="module")
def port_model(slice_model_dir) -> Model:
    return Model.from_dir(slice_model_dir, precision="fp32", device="cpu")


@pytest.fixture(scope="module")
def jax_model(slice_model_dir) -> JaxModel:
    return JaxModel.from_dir(slice_model_dir, precision="fp32")


def _read_csv(path: Path) -> pd.DataFrame:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _assert_close_predictions(port: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert port.shape == ref.shape
    assert list(port.columns) == list(ref.columns)
    coords = port.columns.get_level_values("coords")
    xy = np.isin(coords, ["x", "y"])
    np.testing.assert_allclose(port.loc[:, xy].to_numpy(), ref.loc[:, xy].to_numpy(), rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(
        port.loc[:, ~xy].to_numpy(), ref.loc[:, ~xy].to_numpy(), rtol=0, atol=CONF_TOL
    )


def test_predict_on_video_file_matches_jax(port_model, jax_model, slice_video, tmp_path):
    jax_model.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "jax")
    result = port_model.predict_on_video_file(slice_video, output_dir=tmp_path / "port")
    port_csv = _read_csv(tmp_path / "port" / "blobs.csv")
    ref_csv = _read_csv(tmp_path / "jax" / "blobs.csv")
    assert port_csv.shape == (20, 3 * 4)  # every frame of the video, padding trimmed
    assert result.predictions.shape == port_csv.shape
    _assert_close_predictions(port_csv, ref_csv)
    likelihood = port_csv.loc[:, port_csv.columns.get_level_values("coords") == "likelihood"]
    assert float(likelihood.to_numpy().mean()) > 0.1  # peaked maps


def test_predict_on_video_file_writes_video_preds_by_default(port_model, slice_video):
    port_model.predict_on_video_file(slice_video)
    assert (port_model.model_dir / "video_preds" / "blobs.csv").is_file()


@pytest.mark.parametrize("bbox", [None, (10, 5, 50, 40)])
def test_predict_frame_matches_jax(port_model, jax_model, bbox):
    rng = np.random.default_rng(0)
    frame = rng.integers(0, 256, (60, 80, 3), dtype=np.uint8)
    ref = jax_model.predict_frame(frame, bbox=bbox)
    out = port_model.predict_frame(frame, bbox=bbox)
    assert out["keypoints"].shape == (4, 2) and out["confidence"].shape == (4,)
    assert out["keypoints"].dtype == np.float32
    np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(out["confidence"], ref["confidence"], rtol=0, atol=CONF_TOL)


def test_predict_frame_bf16_agrees_loosely_with_fp32(slice_model_dir, port_model):
    """bf16 compute (the default precision) through autocast on the CPU."""
    frame = np.random.default_rng(1).integers(0, 256, (64, 64, 3), dtype=np.uint8)
    bf16 = Model.from_dir(slice_model_dir, device="cpu").predict_frame(frame)
    fp32 = port_model.predict_frame(frame)
    assert np.isfinite(bf16["keypoints"]).all()
    np.testing.assert_allclose(bf16["keypoints"], fp32["keypoints"], rtol=0, atol=0.25)


@pytest.mark.parametrize(
    "frame, bbox",
    [
        (np.zeros((8, 8, 3), dtype=np.float32), None),
        (np.zeros((8, 8), dtype=np.uint8), None),
        (np.zeros((8, 8, 3), dtype=np.uint8), (-1, 0, 4, 4)),
        (np.zeros((8, 8, 3), dtype=np.uint8), (0, 0, 0, 4)),
        (np.zeros((8, 8, 3), dtype=np.uint8), (20, 20, 4, 4)),
    ],
)
def test_predict_frame_rejects_bad_input(port_model, frame, bbox):
    with pytest.raises(ValueError):
        port_model.predict_frame(frame, bbox=bbox)


def _variant(model_dir: Path, tmp_path: Path, override: str) -> Path:
    from lightning_pose_tpu.config import Config

    out = tmp_path / "variant"
    shutil.copytree(model_dir, out)
    cfg = Config.from_yaml(str(out / "config.yaml"))
    cfg.apply_overrides([override])
    cfg.save(str(out / "config.yaml"))
    return out


@pytest.mark.parametrize(
    "override, call",
    [
        ("eval.video_transfer_format=yuv420", "video"),
        ("eval.decode_method=dark", "frame"),
        ("model.backbone=vits_dinov2", "frame"),
    ],
)
def test_unported_options_raise(slice_model_dir, slice_video, tmp_path, override, call):
    model = Model.from_dir(_variant(slice_model_dir, tmp_path, override), device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        if call == "video":
            model.predict_on_video_file(slice_video)
        else:
            model.predict_frame(np.zeros((64, 64, 3), dtype=np.uint8))


def test_unported_entry_points_raise(slice_model_dir, port_model, slice_video):
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        Model.from_dir(slice_model_dir, device="cpu", data_parallel=True)
    for method in (port_model.compile, port_model.export):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            method()


def test_cuda_device_without_cuda_raises(slice_model_dir):
    """The default device is CUDA, and there is no fallback to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        Model.from_dir(slice_model_dir)


def test_unknown_precision_raises(slice_model_dir):
    model = Model.from_dir(slice_model_dir, precision="int8", device="cpu")
    with pytest.raises(ValueError, match="precision"):
        model.predict_frame(np.zeros((64, 64, 3), dtype=np.uint8))


def test_missing_config_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        Model.from_dir(tmp_path, device="cpu")
