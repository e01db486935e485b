"""``training.resume`` and ``training.profiler`` in the port's ``train()``:
a run of 2 epochs resumed to 4 equals an uninterrupted 4-epoch run bit for
bit on the CPU, with the ``dlc`` augmentation (its draws continue from the
generator states the ``-last.ckpt`` holds); the resumed run stays in its
version directory and keeps one ``-last.ckpt``; the profiler writes its
trace into the version directory."""

from __future__ import annotations

import json
from pathlib import Path

import pytest


IMAGE = 128
NAMES = ["nose", "tail", "paw_left", "paw_right"]


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    return write_labeled_dataset(tmp_path_factory.mktemp("port_resume") / "data", 5, 130, 140, NAMES, seed=2)


def _cfg(data_dir: Path, epochs: int, resume: bool = False):
    """resnet18 at 128 px, 4 train frames in a batch of 4 (1 step an
    epoch), dlc, Adam with the backbone unfrozen at epoch 1 and a milestone
    at epoch 2, validation (and a -last.ckpt) every 2 epochs and at the
    last, logs every step."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = list(NAMES)
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = "portresume"
    t = cfg.training
    assert t.imgaug == "dlc"
    t.train_batch_size = t.val_batch_size = 4
    t.train_prob, t.val_prob = 0.8, 0.2
    t.max_epochs = t.min_epochs = epochs
    t.unfreezing_epoch = 1
    t.lr_scheduler_params.multisteplr.milestones = [min(2, epochs)]
    t.check_val_every_n_epoch = 2
    t.log_every_n_steps = 1
    t.resume = resume
    return cfg


def _last(model_dir: Path) -> Path:
    lasts = list((model_dir / "tb_logs" / "portresume" / "version_0" / "checkpoints").glob("*-last.ckpt"))
    assert len(lasts) == 1  # older ones are pruned
    return lasts[0]


def test_a_resumed_run_equals_an_uninterrupted_one_bitwise(data_dir, tmp_path):
    from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint
    from lightning_pose_tpu_torch.train.trainer import train

    full = train(_cfg(data_dir, 4), tmp_path / "a", skip_evaluation=True, device="cpu")
    train(_cfg(data_dir, 2), tmp_path / "b", skip_evaluation=True, device="cpu")
    assert "epoch=1" in _last(tmp_path / "b").name
    half_ckpt = load_checkpoint(str(_last(tmp_path / "b")))
    assert {"opt_state", "extra"} <= set(half_ckpt) and "draw_generator" in half_ckpt["extra"]
    resumed = train(_cfg(data_dir, 4, resume=True), tmp_path / "b", skip_evaluation=True, device="cpu")
    assert not (tmp_path / "b" / "tb_logs" / "portresume" / "version_1").exists()

    a, b = load_checkpoint(str(_last(tmp_path / "a"))), load_checkpoint(str(_last(tmp_path / "b")))
    assert a["epoch"] == b["epoch"] == 3 and a["step"] == b["step"] == 4
    for group in ("params", "batch_stats", "opt_state"):
        flat_a, flat_b = _flatten(a[group]), _flatten(b[group])
        assert flat_a.keys() == flat_b.keys()
        for key, value in flat_a.items():
            assert value.dtype == flat_b[key].dtype and (value == flat_b[key]).all(), (group, key)
    # the same learning rates and losses at each step of the resumed epochs
    steps = {h["step"]: h for h in full.history if "lr-head" in h}
    resumed_steps = [h for h in resumed.history if "lr-head" in h]
    assert [h["step"] for h in resumed_steps] == [3, 4]
    for h in resumed_steps:
        for key in ("lr-head", "lr-backbone", "train_heatmap_mse_loss"):
            assert h[key] == steps[h["step"]][key], (h["step"], key)
    assert a["extra"]["best_val"] == b["extra"]["best_val"]
    assert Path(b["extra"]["best_ckpt_path"]).is_file()


def _flatten(tree, prefix=()) -> dict:
    out = {}
    for key, value in tree.items():
        if isinstance(value, dict):
            out.update(_flatten(value, prefix + (key,)))
        else:
            out[prefix + (key,)] = value
    return out


def test_resume_without_a_last_ckpt_starts_afresh(data_dir, tmp_path):
    from lightning_pose_tpu_torch.train.trainer import train

    result = train(_cfg(data_dir, 1, resume=True), tmp_path, skip_evaluation=True, device="cpu")
    assert [h["step"] for h in result.history if "lr-head" in h] == [1]
    assert "epoch=0" in _last(tmp_path).name


def test_the_profiler_writes_a_trace_into_the_version_dir(data_dir, tmp_path):
    from lightning_pose_tpu_torch.train.trainer import train

    cfg = _cfg(data_dir, 1)
    cfg.training.profiler = True
    train(cfg, tmp_path, skip_evaluation=True, device="cpu")
    trace = tmp_path / "tb_logs" / "portresume" / "version_0" / "profiler_trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    names = {e.get("name", "") for e in events}
    assert any(n.startswith("aten::convolution") for n in names)
    assert any("Optimizer.step" in n for n in names)
