"""The port's checkpoint reader/writer and flax parameter bridge
(train/checkpoints.py) against files written by the JAX package."""

from __future__ import annotations

import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from lightning_pose_tpu.train import checkpoints as jax_checkpoints
from lightning_pose_tpu_torch.models.factory import build_model
from lightning_pose_tpu_torch.train.checkpoints import (
    load_checkpoint,
    load_flax_variables,
    save_checkpoint,
    state_dict_from_flax,
    state_dict_to_flax,
)


def _tree_equal(a, b) -> bool:
    la, ta = jax.tree_util.tree_flatten(a)
    lb, tb = jax.tree_util.tree_flatten(b)
    return ta == tb and all(
        np.asarray(x).dtype == np.asarray(y).dtype and np.array_equal(x, y) for x, y in zip(la, lb)
    )


@pytest.fixture(scope="module")
def flax_variables():
    from lightning_pose_tpu.models.heatmap_tracker import HeatmapTracker

    module = HeatmapTracker(backbone_arch="resnet18", num_keypoints=3, image_size=64)
    variables = module.init(jax.random.PRNGKey(0), jax.numpy.zeros((1, 64, 64, 3)), train=False)
    params = jax.tree_util.tree_map(np.asarray, variables["params"])
    stats = jax.tree_util.tree_map(np.asarray, variables["batch_stats"])
    return params, stats


def test_reads_a_file_written_by_the_jax_package(tmp_path, flax_variables):
    params, stats = flax_variables
    path = str(tmp_path / "epoch=3-step=7-best.ckpt")
    jax_checkpoints.save_checkpoint(path, params, stats, step=7, epoch=3)
    ckpt = load_checkpoint(path)
    assert ckpt["step"] == 7 and ckpt["epoch"] == 3
    assert _tree_equal(ckpt["params"], params)
    assert _tree_equal(ckpt["batch_stats"], stats)


def test_reader_needs_no_flax(tmp_path, flax_variables):
    params, stats = flax_variables
    path = tmp_path / "model.ckpt"
    jax_checkpoints.save_checkpoint(str(path), params, stats, step=1, epoch=1)
    code = f"""
import sys
class Block:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "flax"):
            raise ImportError("blocked: " + name)
sys.meta_path.insert(0, Block())
from lightning_pose_tpu_torch.train.checkpoints import load_checkpoint
ckpt = load_checkpoint({str(path)!r})
print(ckpt["params"]["backbone"]["conv1"]["kernel"].shape, ckpt["step"])
"""
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, timeout=120,
        cwd=Path(__file__).resolve().parents[2],
    )
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["(7,", "7,", "3,", "64)", "1"]


def test_jax_package_reads_a_file_written_by_the_port(tmp_path, flax_variables):
    params, stats = flax_variables
    path = str(tmp_path / "port.ckpt")
    save_checkpoint(path, params, stats, step=5, epoch=2)
    ckpt = jax_checkpoints.load_checkpoint(path)
    assert ckpt["step"] == 5 and ckpt["epoch"] == 2
    assert _tree_equal(ckpt["params"], params)
    assert _tree_equal(ckpt["batch_stats"], stats)


def test_bridge_round_trip_covers_every_key(flax_variables):
    params, stats = flax_variables
    model = build_model("heatmap", "resnet18", 3)
    state = state_dict_from_flax(params, stats)
    assert set(state) == set(model.state_dict())
    n_leaves = len(jax.tree_util.tree_leaves(params)) + len(jax.tree_util.tree_leaves(stats))
    n_bn = sum(k.endswith("num_batches_tracked") for k in state)
    assert len(state) == n_leaves + n_bn
    load_flax_variables(model, params, stats)
    back_params, back_stats = state_dict_to_flax(model.state_dict())
    assert _tree_equal(back_params, params)
    assert _tree_equal(back_stats, stats)


def test_bridge_rejects_missing_and_unexpected_keys(flax_variables):
    params, stats = flax_variables
    model = build_model("heatmap", "resnet18", 3)
    missing = {**params, "head": {"deconv0": params["head"]["deconv0"]}}
    with pytest.raises(RuntimeError, match="Missing key"):
        load_flax_variables(model, missing, stats)
    extra = {**params, "head": {**params["head"], "deconv9": params["head"]["deconv0"]}}
    with pytest.raises(RuntimeError, match="Unexpected key"):
        load_flax_variables(model, extra, stats)
    with pytest.raises(ValueError, match="unknown flax parameter"):
        state_dict_from_flax({"conv": {"gamma": np.ones(3)}}, {})


def test_bridge_rejects_wrong_shapes(flax_variables):
    params, stats = flax_variables
    model = build_model("heatmap", "resnet18", 5)  # head has 5 keypoints, checkpoint 3
    with pytest.raises(RuntimeError, match="size mismatch"):
        load_flax_variables(model, params, stats)


def test_loaded_parameters_are_fp32_tensors(flax_variables):
    params, stats = flax_variables
    model = build_model("heatmap", "resnet18", 3)
    load_flax_variables(model, params, stats)
    assert all(p.dtype == torch.float32 for p in model.parameters())
    assert model.head.deconv0.weight.shape == (128, 3, 3, 3)
