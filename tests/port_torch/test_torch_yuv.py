"""The yuv420 transfer against the JAX package: the I420 conversions and
their kernel's CPU route, the native RGB -> I420 conversion, the loaders'
I420 batches, and video prediction through the I420 route (single-view and
multiview). Training on an I420 stream, on one rank and on two, is in
test_torch_parallel.py; the exported runtime's rgb there too.

Inputs are seeded RGB frames made with numpy and converted to I420 by
``cv2.COLOR_RGB2YUV_I420``."""

from __future__ import annotations

import shutil
from pathlib import Path

import cv2
import numpy as np
import pandas as pd
import pytest
import torch

# fp32 on the CPU in both packages: the same formula, XLA against PyTorch
# (measured: 3.1e-5 gray on [0, 255] values, 1.9e-7 normalized)
TWIN_TOL = 1e-4
# the JAX package's own limit against cv2's decode of the same I420 bytes
CV2_GRAY_TOL = 2.0
# video predictions of the two packages, fp32 on the CPU, as
# test_torch_slice.py (the decode's temperature-1000 softmax magnifies the
# convolutions' summation order)
PX_TOL = 5e-3
CONF_TOL = 2e-4


def _i420(rgb: np.ndarray) -> np.ndarray:
    return np.stack([cv2.cvtColor(f, cv2.COLOR_RGB2YUV_I420) for f in rgb])


@pytest.mark.parametrize("shape", [(2, 64, 64), (3, 32, 48)])
def test_i420_twins_match_jax_and_cv2(shape):
    """``i420_to_rgb`` and ``i420_to_normalized_rgb`` against the JAX
    package's, and the kernel's wrappers on a CPU tensor (the registered
    op's CPU route) against the twins, bitwise."""
    from lightning_pose_tpu.ops import yuv as jax_yuv
    from lightning_pose_tpu_torch.ops import yuv, yuv_kernel

    rgb = np.random.default_rng(sum(shape)).integers(0, 256, (*shape, 3), dtype=np.uint8)
    i420 = _i420(rgb)
    assert i420.shape == (shape[0], shape[1] * 3 // 2, shape[2])
    x = torch.from_numpy(i420)
    out = yuv.i420_to_rgb(x)
    ref = np.asarray(jax_yuv.i420_to_rgb(i420))
    np.testing.assert_allclose(out.numpy(), ref, rtol=0, atol=TWIN_TOL)
    golden = np.stack([cv2.cvtColor(f, cv2.COLOR_YUV2RGB_I420) for f in i420]).astype(np.float32)
    assert np.abs(out.numpy() - golden).max() <= CV2_GRAY_TOL
    norm = yuv.i420_to_normalized_rgb(x)
    np.testing.assert_allclose(norm.numpy(), np.asarray(jax_yuv.i420_to_normalized_rgb(i420)), rtol=0, atol=TWIN_TOL)
    assert yuv.i420_to_normalized_rgb(x, torch.bfloat16).dtype == torch.bfloat16
    assert torch.equal(yuv_kernel.i420_to_rgb(x), out)
    kernel_norm = yuv_kernel.i420_to_normalized(x, torch.float32)
    assert kernel_norm.shape == (shape[0], 3, shape[1], shape[2])
    assert torch.equal(kernel_norm.movedim(1, -1), norm)


def test_height_not_a_multiple_of_4_fails_in_both_packages():
    """H % 4 == 2 passes the loaders' even-dims check, but the U plane's
    H/4 rows do not hold it: the JAX function fails, the port raises
    ValueError up front."""
    from lightning_pose_tpu.ops import yuv as jax_yuv
    from lightning_pose_tpu_torch.ops import yuv, yuv_kernel

    rgb = np.random.default_rng(0).integers(0, 256, (1, 10, 8, 3), dtype=np.uint8)
    i420 = _i420(rgb)
    assert i420.shape == (1, 15, 8)
    with pytest.raises(Exception):
        np.asarray(jax_yuv.i420_to_rgb(i420))
    for fn in (yuv.i420_to_rgb, yuv.i420_to_normalized_rgb, yuv_kernel.i420_to_rgb, yuv_kernel.i420_to_normalized):
        with pytest.raises(ValueError, match="multiple of 4"):
            fn(torch.from_numpy(i420))


def test_native_rgb_to_i420_bitwise_jax_library():
    """The port's C++ conversion against the JAX package's library, bitwise,
    and within one level of cv2's."""
    from lightning_pose_tpu import native as jax_native
    from lightning_pose_tpu_torch import native

    rgb = np.random.default_rng(1).integers(0, 256, (5, 48, 64, 3), dtype=np.uint8)
    out = native.batch_rgb_to_i420(rgb)
    assert out.shape == (5, 72, 64) and out.dtype == np.uint8
    np.testing.assert_array_equal(out, jax_native.batch_rgb_to_i420(rgb))
    assert np.abs(out.astype(np.int16) - _i420(rgb)).max() <= 1
    with pytest.raises(ValueError, match="even"):
        native.batch_rgb_to_i420(rgb[:, :47])


def test_loaders_yuv420_batches_bitwise_jax(slice_video):
    """The predict loader's and the unlabeled loader's I420 batches against
    the JAX loaders', bitwise (20 frames of 60x80 at 64x64: three batches
    of 8)."""
    from lightning_pose_tpu.data.video import PredictVideoLoader as JaxPredict
    from lightning_pose_tpu.data.video import UnlabeledVideoLoader as JaxUnlabeled
    from lightning_pose_tpu_torch.data.video import PredictVideoLoader, UnlabeledVideoLoader

    port = list(PredictVideoLoader(str(slice_video), 8, 64, 64, transfer_format="yuv420"))
    ref = list(JaxPredict(str(slice_video), 8, 64, 64, transfer_format="yuv420"))
    assert len(port) == len(ref) == 3
    for a, b in zip(port, ref):
        assert a.shape == (8, 96, 64) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    out = UnlabeledVideoLoader([str(slice_video)], 8, 64, 64, seed=7, transfer_format="yuv420")
    jax_out = JaxUnlabeled([str(slice_video)], 8, 64, 64, seed=7, transfer_format="yuv420")
    try:
        for _ in range(2):
            a, b = next(out), next(jax_out)
            assert a["frames"].shape == (8, 96, 64)
            np.testing.assert_array_equal(a["frames"], b["frames"])
            np.testing.assert_array_equal(a["bbox"], b["bbox"])
    finally:
        out.close()
        jax_out.close()
    with pytest.raises(ValueError, match="even"):
        PredictVideoLoader(str(slice_video), 8, 63, 64, transfer_format="yuv420")
    with pytest.raises(ValueError, match="transfer_format"):
        PredictVideoLoader(str(slice_video), 8, 64, 64, transfer_format="nv12")


def _read(path: Path) -> pd.DataFrame:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _assert_close(port: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert port.shape == ref.shape and list(port.columns) == list(ref.columns)
    xy = np.isin(port.columns.get_level_values("coords"), ["x", "y"])
    np.testing.assert_allclose(port.loc[:, xy].to_numpy(), ref.loc[:, xy].to_numpy(), rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(port.loc[:, ~xy].to_numpy(), ref.loc[:, ~xy].to_numpy(), rtol=0, atol=CONF_TOL)


def _with(model_dir: Path, dest: Path, overrides: list[str]) -> Path:
    from lightning_pose_tpu_torch.config import Config

    out = Path(shutil.copytree(model_dir, dest))
    cfg = Config.from_yaml(str(out / "config.yaml"))
    cfg.apply_overrides(overrides)
    cfg.save(str(out / "config.yaml"))
    return out


def test_predict_on_video_file_yuv420_matches_jax(slice_model_dir, slice_video, tmp_path):
    """``eval.video_transfer_format: yuv420`` in both packages, fp32: the
    same predictions within the slice's tolerance; the I420 route stays
    within a pixel of the port's own rgb route on these peaked maps."""
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    model_dir = _with(slice_model_dir, tmp_path / "m", ["eval.video_transfer_format=yuv420"])
    port = Model.from_dir(model_dir, precision="fp32", device="cpu")
    assert port._video_transfer_format() == "yuv420"
    port.cfg.eval.video_transfer_format = "nv12"
    with pytest.raises(ValueError, match="rgb\\|yuv420\\|auto"):
        port._video_transfer_format()
    port.cfg.eval.video_transfer_format = "yuv420"
    port.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "port")
    JaxModel.from_dir(model_dir, precision="fp32").predict_on_video_file(
        slice_video, compute_metrics=False, output_dir=tmp_path / "jax")
    yuv = _read(tmp_path / "port" / "blobs.csv")
    assert yuv.shape == (20, 12)
    _assert_close(yuv, _read(tmp_path / "jax" / "blobs.csv"))
    port.cfg.eval.video_transfer_format = "rgb"
    rgb = port.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "rgb").predictions
    xy = np.isin(yuv.columns.get_level_values("coords"), ["x", "y"])
    dev = np.abs(yuv.loc[:, xy].to_numpy() - rgb.loc[:, xy].to_numpy())
    assert np.median(dev) < 1.0 and np.quantile(dev, 0.95) < 3.0


def test_multiview_video_yuv420_matches_jax(slice_model_dir, tmp_path):
    """A heatmap model on two views (the views folded into its batch)
    predicts a session through the I420 route, ``(T, V, h*3/2, w)`` batches,
    as the JAX package does."""
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.utils.synthetic import write_multiview_videos

    model_dir = _with(slice_model_dir, tmp_path / "mv", [
        "data.view_names=[top,bot]", "data.csv_file=[top.csv,bot.csv]", "eval.video_transfer_format=yuv420",
    ])
    write_multiview_videos(tmp_path / "data", "s0", 10, 48, 64, ["top", "bot"], n_blobs=2, seed=0)
    videos = [str(tmp_path / "data" / "videos" / f"s0_{v}.mp4") for v in ("top", "bot")]
    port = Model.from_dir(model_dir, precision="fp32", device="cpu").predict_on_video_file_multiview(
        videos, compute_metrics=False, output_dir=tmp_path / "port")
    ref = JaxModel.from_dir(model_dir, precision="fp32").predict_on_video_file_multiview(
        videos, compute_metrics=False, output_dir=tmp_path / "jax")
    for view in ("top", "bot"):
        assert port.predictions[view].shape == (10, 12)
        _assert_close(_read(tmp_path / "port" / f"s0_{view}.csv"), _read(tmp_path / "jax" / f"s0_{view}.csv"))
        assert ref.predictions[view].shape == (10, 12)
