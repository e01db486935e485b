"""Slice 9, the DARK decode (``eval.decode_method: dark``) against the JAX
package's ``run_dark_decode``: peaked maps with sub-pixel peaks, a peak on
the border (the raw argmax, no offset), a flat map (whose modulated plateau
holds equal maxima: the first index in both) and maps with two equal raw
peaks, at df 2 and 3; then the whole prediction
path, ``Model.from_dir`` of one JAX-written directory set to DARK in both
packages (``predict_frame``, ``predict_on_video_file``), where the
soft-argmax decode must not be called. ``predict_on_label_csv`` and
``train()``'s evaluation with DARK: ``test_torch_transformer_train.py``."""

from __future__ import annotations

import shutil
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lightning_pose_tpu.ops.dark import run_dark_decode as jax_dark
from lightning_pose_tpu_torch.ops.dark import run_dark_decode

# float32 in both: the same terms, the Gaussian convolutions summed in
# another order
PX_TOL = 1e-4
CONF_TOL = 1e-5
# the models' maps differ by the order of their convolutions' sums (fp32 on
# the CPU in both packages); keypoints in frame pixels
MODEL_PX_TOL = 5e-3
MODEL_CONF_TOL = 2e-4


def _maps(case: str, seed: int = 0) -> np.ndarray:
    """``(3, 16, 16, 4)`` NHWC maps of one kind; a flat map is no longer flat
    once modulated (the zero padding lowers its edges), and its plateau
    holds equal maxima."""
    rng = np.random.default_rng(seed)
    b, h, w, k = 3, 16, 16, 4
    yy, xx = np.mgrid[0:h, 0:w]
    if case == "flat":
        return np.full((b, h, w, k), 1.0 / (h * w), np.float32)
    centers = rng.uniform(2.5, 12.5, (b, k, 2))
    maps = np.exp(-((xx[None, None] - centers[..., 0, None, None]) ** 2
                    + (yy[None, None] - centers[..., 1, None, None]) ** 2) / (2 * 1.25**2))
    if case == "border":  # steep ramps: peaks that stay on the border after the modulation
        gauss = lambda d: np.exp(-(d**2) / (2 * 1.25**2))  # noqa: E731
        maps[:, 0] = np.exp(-2.0 * yy) * gauss(xx - 7.3)  # the top row
        maps[:, 1] = np.exp(2.0 * (xx - 15)) * gauss(yy - 4.6)  # the right column
        maps[:, 2] = np.exp(-2.0 * xx) * gauss(yy - 9.2)  # the left column
        maps[:, 3] = np.exp(2.0 * (xx + yy - 30))  # the bottom-right corner
    maps = maps + 1e-3 * rng.uniform(0, 1, maps.shape)
    if case == "ties":  # two equal raw peaks a map
        maps = np.round(maps, 2)
        maps[..., 3, 3] = maps[..., 12, 10] = maps.max(axis=(2, 3)) + 0.1
    maps = maps / maps.sum(axis=(2, 3), keepdims=True)
    return maps.transpose(0, 2, 3, 1).astype(np.float32)


@pytest.mark.parametrize("df", [2, 3])
@pytest.mark.parametrize("case", ["peaked", "border", "flat", "ties"])
def test_dark_decode_matches_jax(case, df):
    maps = _maps(case)
    ref_kp, ref_conf = (np.asarray(a) for a in jax_dark(jnp.asarray(maps), downsample_factor=df))
    kp, conf = run_dark_decode(torch.from_numpy(maps).permute(0, 3, 1, 2), downsample_factor=df)
    assert kp.shape == (3, 8) and conf.shape == (3, 4) and kp.dtype == conf.dtype == torch.float32
    np.testing.assert_allclose(kp.numpy(), ref_kp, rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(conf.numpy(), ref_conf, rtol=0, atol=CONF_TOL)
    if case == "border":  # the raw argmax on the border, scaled: no offset
        xy = kp.numpy().reshape(3, 4, 2) / 2**df
        assert (xy[:, 0, 1] == 0).all() and (xy[:, 1, 0] == 15).all() and (xy[:, 2, 0] == 0).all()
        assert (xy[:, 3] == 15).all()


# -- the prediction path ---------------------------------------------------------------


@pytest.fixture(scope="module")
def dark_dir(slice_model_dir, tmp_path_factory) -> Path:
    from lightning_pose_tpu.config import Config

    out = tmp_path_factory.mktemp("dark") / "model"
    shutil.copytree(slice_model_dir, out)
    cfg = Config.from_yaml(str(out / "config.yaml"))
    cfg.apply_overrides(["eval.decode_method=dark"])
    cfg.save(str(out / "config.yaml"))
    return out


@pytest.fixture()
def no_decode_kernel(monkeypatch):
    """The soft-argmax decode raises: DARK must not reach it."""
    from lightning_pose_tpu_torch.models.heatmap_tracker import HeatmapTracker

    def refuse(self, heatmaps):
        raise AssertionError("the soft-argmax decode ran on a DARK prediction")

    monkeypatch.setattr(HeatmapTracker, "decode", refuse)


def _read_csv(path: Path) -> np.ndarray:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0).to_numpy()


def _close(port: np.ndarray, ref: np.ndarray) -> None:
    assert port.shape == ref.shape
    np.testing.assert_allclose(port[:, 0::3], ref[:, 0::3], rtol=0, atol=MODEL_PX_TOL)
    np.testing.assert_allclose(port[:, 1::3], ref[:, 1::3], rtol=0, atol=MODEL_PX_TOL)
    np.testing.assert_allclose(port[:, 2::3], ref[:, 2::3], rtol=0, atol=MODEL_CONF_TOL)


def test_dark_prediction_paths_match_jax(dark_dir, slice_video, tmp_path, no_decode_kernel):
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    port = Model.from_dir(dark_dir, precision="fp32", device="cpu")
    ref = JaxModel.from_dir(dark_dir, precision="fp32")
    frame = np.random.default_rng(2).integers(0, 256, (60, 80, 3), dtype=np.uint8)
    out, expected = (m.predict_frame(frame, bbox=(10, 5, 50, 40)) for m in (port, ref))
    np.testing.assert_allclose(out["keypoints"], expected["keypoints"], rtol=0, atol=MODEL_PX_TOL)
    np.testing.assert_allclose(out["confidence"], expected["confidence"], rtol=0, atol=MODEL_CONF_TOL)

    port.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "port")
    ref.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "jax")
    video = _read_csv(tmp_path / "port" / "blobs.csv")
    assert video.shape == (20, 12) and np.isfinite(video).all()
    _close(video, _read_csv(tmp_path / "jax" / "blobs.csv"))
