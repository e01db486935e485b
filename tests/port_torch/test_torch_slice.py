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
    ],
)
def test_unported_options_raise(slice_model_dir, slice_video, tmp_path, override, call):
    """The options that raised until they were ported: the yuv420 transfer
    now predicts every frame of the video, through the I420 route."""
    model = Model.from_dir(_variant(slice_model_dir, tmp_path, override), device="cpu")
    assert model._video_transfer_format() == "yuv420"
    df = model.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "out").predictions
    assert df.shape == (20, 12) and np.isfinite(df.to_numpy()).all()


def test_unported_entry_points_raise(slice_model_dir):
    """``data_parallel=True`` is ported: with one device it predicts as the
    plain route."""
    frame = np.random.default_rng(0).integers(0, 255, (60, 80, 3), dtype=np.uint8)
    plain = Model.from_dir(slice_model_dir, precision="fp32", device="cpu").predict_frame(frame)
    parallel = Model.from_dir(slice_model_dir, precision="fp32", device="cpu", data_parallel=True)
    assert parallel.data_parallel
    out = parallel.predict_frame(frame)
    np.testing.assert_array_equal(out["keypoints"], plain["keypoints"])


@pytest.mark.parametrize("method", ["compile", "export", "compile_exported"])
def test_compile_and_export_are_ported(slice_model_dir, tmp_path, monkeypatch, method):
    """Ported in slice 12. ``compile`` hands the step's forward to
    ``torch.compile`` with static shapes, runs it once at the canonical
    video batch and predicts through it (``torch.compile`` is stood in for
    by a recorder: inductor on the CPU is slow, and test_torch_export.py
    runs it once); ``export`` writes a ``.pt2`` whose graph calls both
    registered ops and predicts as the eager step; under the exported
    runtime ``compile`` only runs the exported program once, as the JAX
    package's compile() does."""
    model = Model.from_dir(slice_model_dir, precision="fp32", device="cpu")
    model._load()
    canonical, bbox = model._canonical_inputs()
    rng = np.random.default_rng(3)
    images = torch.from_numpy(rng.integers(0, 256, tuple(canonical.shape), dtype=np.uint8))
    compiled, runs = [], []

    def record(fn, **kwargs):
        compiled.append((fn, kwargs))

        def run(images_uint8, boxes):
            runs.append(tuple(images_uint8.shape))
            return fn(images_uint8, boxes)

        return run

    monkeypatch.setattr(torch, "compile", record)
    if method == "compile":
        model.compile()
        assert compiled == [(model._predict_step.forward, {"dynamic": False})]
        assert runs == [tuple(canonical.shape)]
    else:
        path = Path(model.export(tmp_path))
        assert path == tmp_path / "predict.pt2"
        program = torch.export.load(str(path))
        ops = {str(node.target) for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
               for node in gm.graph.nodes if str(node.target).startswith("lightning_pose_tpu_torch.")}
        assert ops == {"lightning_pose_tpu_torch.normalize.default", "lightning_pose_tpu_torch.decode.default"}
        model.use_exported_runtime(path)
        if method == "compile_exported":
            served = model._predict_fn
            model.compile()
            assert compiled == [] and model._predict_fn is served
    assert model._predict_fn is not model._predict_step
    kp, conf = model._predict_fn(images, bbox)
    kp_eager, conf_eager = model._predict_step(images, bbox)
    np.testing.assert_allclose(kp.numpy(), kp_eager.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), conf_eager.numpy(), rtol=0, atol=1e-6)


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
