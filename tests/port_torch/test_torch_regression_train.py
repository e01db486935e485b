"""``train()`` of the regression model end to end in both packages: each
package predicts the other's model directory (the same keypoints within
1e-3 px at fp32), every likelihood the port writes is 1.0 (labeled frames
and a video), and semi-supervised training with the temporal loss acting on
the outputs runs."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import pandas as pd
import pytest

pytestmark = pytest.mark.usefixtures("few_torch_threads")

IMAGE = 128
NAMES = ["nose", "tail", "paw_left", "paw_right"]
# the two packages' fp32 predictions from one checkpoint
E2E_PX_TOL = 1e-3


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    data = write_labeled_dataset(tmp_path_factory.mktemp("port_regression") / "data", 10, 130, 140, NAMES, seed=5)
    write_unlabeled_video(data, "session0", 12, 120, 160, seed=0)
    return data


def _cfg(data_dir: Path, name: str):
    """resnet18 regression at 128 px, batch 4, 3 steps, the test videos
    predicted after training."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.model_type = "regression"
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = name
    cfg.dali.base.predict.sequence_length = 8
    cfg.eval.test_videos_directory = str(data_dir / "videos")
    t = cfg.training
    t.train_batch_size = t.val_batch_size = 4
    t.max_epochs = t.min_epochs = t.unfreezing_epoch = None
    t.max_steps = t.min_steps = 3
    t.unfreezing_step = 1
    t.lr_scheduler_params.multisteplr.milestones = None
    t.lr_scheduler_params.multisteplr.milestone_steps = [2]
    t.log_every_n_steps = 1
    return cfg


@pytest.fixture(scope="module")
def port_dir(data_dir, tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.train.trainer import train

    model_dir = tmp_path_factory.mktemp("port_regression_model") / "model"
    result = train(_cfg(data_dir, "portreg"), model_dir, device="cpu")
    assert all(np.isfinite(h["train_regression_loss"]) for h in result.history if "train_regression_loss" in h)
    return model_dir


@pytest.fixture(scope="module")
def jax_dir(data_dir, tmp_path_factory) -> Path:
    from lightning_pose_tpu.config import Config as JaxConfig
    from lightning_pose_tpu.train.trainer import train as jax_train

    root = tmp_path_factory.mktemp("jax_regression_model")
    _cfg(data_dir, "jaxreg").save(str(root / "config.yaml"))
    jax_train(JaxConfig.from_yaml(str(root / "config.yaml")), root / "model", skip_evaluation=True)
    return root / "model"


@pytest.mark.parametrize("which", ["port", "jax"])
def test_each_package_predicts_the_others_regression_dir(which, port_dir, jax_dir):
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    model_dir = port_dir if which == "port" else jax_dir
    frame = np.random.default_rng(7).integers(0, 256, (130, 140, 3), dtype=np.uint8)
    ref = JaxModel.from_dir(model_dir, precision="fp32").predict_frame(frame)
    out = Model.from_dir(model_dir, precision="fp32", device="cpu").predict_frame(frame)
    assert np.isfinite(out["keypoints"]).all() and out["keypoints"].shape == (len(NAMES), 2)
    np.testing.assert_allclose(out["keypoints"], ref["keypoints"], rtol=0, atol=E2E_PX_TOL)
    np.testing.assert_array_equal(out["confidence"], np.ones(len(NAMES), np.float32))
    np.testing.assert_array_equal(ref["confidence"], out["confidence"])


def _likelihoods(csv: Path) -> np.ndarray:
    df = pd.read_csv(csv, header=[0, 1, 2], index_col=0)
    return df.loc[:, df.columns.get_level_values(2) == "likelihood"].to_numpy(float)


def test_the_port_writes_likelihoods_of_one(port_dir, data_dir):
    """train()'s evaluation (labeled frames and the test video), and
    predict_on_label_csv and predict_on_video_file of the directory."""
    from lightning_pose_tpu_torch.api.model import Model

    labeled = port_dir / "image_preds" / "CollectedData.csv" / "predictions.csv"
    video_csv = port_dir / "video_preds" / "session0.csv"
    for csv in (labeled, video_csv):
        values = _likelihoods(csv)
        assert values.size and (values == 1.0).all(), csv
    model = Model.from_dir(port_dir, device="cpu")
    labeled = model.predict_on_label_csv("CollectedData.csv", output_dir=port_dir / "label_csv").predictions
    assert (labeled.loc[:, labeled.columns.get_level_values(2) == "likelihood"].to_numpy(float) == 1.0).all()
    result = model.predict_on_video_file(data_dir / "videos" / "session0.mp4")
    assert result.predictions.shape == (12, 3 * len(NAMES))
    assert (result.predictions.to_numpy()[:, 2::3] == 1.0).all()
    assert result.metrics is not None and result.metrics.temporal_norm_df is not None


def test_semisupervised_regression_train_runs(data_dir, tmp_path):
    from lightning_pose_tpu_torch.train.trainer import train

    cfg = _cfg(data_dir, "portregsemi")
    cfg.model.losses_to_use = ["temporal"]
    cfg.losses.temporal.epsilon = 0.0
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    cfg.dali.base.train.sequence_length = 4
    result = train(cfg, tmp_path, skip_evaluation=True, device="cpu")
    temporal = [h["train_temporal_loss"] for h in result.history if "train_temporal_loss" in h]
    assert len(temporal) == 3 and all(np.isfinite(temporal)) and max(temporal) > 0
