"""The port's ``Model`` against the JAX package's on one model directory:
``from_dir2`` applies Hydra-style overrides to the loaded config, and the
output-directory helpers give the JAX package's paths (mirrors
``tests/api/test_model.py``'s ``test_from_dir2_applies_overrides`` and
``test_output_dir_conventions``)."""

from __future__ import annotations

from pathlib import Path

import pytest


@pytest.fixture()
def model_dir(tmp_path) -> Path:
    """A model directory's ``config.yaml`` (the defaults, 4 keypoints): what
    ``from_dir`` reads before any prediction loads a checkpoint."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.num_keypoints = 4
    cfg.data.keypoint_names = [f"kp{i}" for i in range(4)]
    cfg.model.model_name = "dirs"
    cfg.save(str(tmp_path / "config.yaml"))
    return tmp_path


def test_from_dir2_applies_overrides(model_dir):
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    overrides = ["training.train_batch_size=7", "eval.confidence_thresh_for_vid=0.5", "+model.model_name=renamed"]
    out = Model.from_dir2(model_dir, hydra_overrides=overrides, precision="fp32", device="cpu")
    ref = JaxModel.from_dir2(model_dir, hydra_overrides=overrides, precision="fp32")
    assert int(out.cfg.training.train_batch_size) == int(ref.cfg.training.train_batch_size) == 7
    assert float(out.cfg.eval.confidence_thresh_for_vid) == 0.5
    assert out.cfg.model.model_name == ref.cfg.model.model_name == "renamed"
    assert out.cfg.to_dict() == ref.cfg.to_dict()
    plain = Model.from_dir2(model_dir, device="cpu")
    assert plain.cfg.to_dict() == Model.from_dir(model_dir, device="cpu").cfg.to_dict()
    parallel = Model.from_dir2(model_dir, hydra_overrides=overrides, device="cpu", data_parallel=True)
    assert parallel.data_parallel and parallel.cfg.to_dict() == out.cfg.to_dict()


def test_output_dir_conventions(model_dir):
    """``image_preds``, ``video_preds``, ``video_preds/labeled_videos``,
    ``cropped_images``, ``cropped_videos`` and
    ``image_preds/<csv>/cropped_<csv>``, as the JAX package's."""
    from lightning_pose_tpu.api.model import Model as JaxModel
    from lightning_pose_tpu_torch.api.model import Model

    out = Model.from_dir(model_dir, device="cpu")
    ref = JaxModel.from_dir(model_dir)
    root = Path(model_dir)
    for name, expected in (("image_preds_dir", root / "image_preds"), ("video_preds_dir", root / "video_preds"),
                           ("labeled_videos_dir", root / "video_preds" / "labeled_videos"),
                           ("cropped_data_dir", root / "cropped_images"),
                           ("cropped_videos_dir", root / "cropped_videos")):
        assert getattr(out, name)() == getattr(ref, name)() == expected, name
    for csv in ("CollectedData.csv", "labels/CollectedData_new.csv", Path("/elsewhere/x.csv")):
        assert out.cropped_csv_file_path(csv) == ref.cropped_csv_file_path(csv)
    assert out.cropped_csv_file_path("a/b.csv") == root / "image_preds" / "b.csv" / "cropped_b.csv"
