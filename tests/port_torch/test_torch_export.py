"""``Model.export``/``load_exported``/``use_exported_runtime``/``compile`` of
the port against the JAX package's ``jax.export`` on the same model
directory (resnet18, 64 px, peaked random-init head, written by the JAX
package), on the CPU in fp32: the port's ``.pt2`` runs its registered ops
through their plain versions."""

from __future__ import annotations

import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch

from lightning_pose_tpu.api.model import Model as JaxModel
from lightning_pose_tpu_torch.api.model import Model

# slice 1's limits (test_torch_slice.py): fp32 on the CPU in both packages,
# the convolutions sum in another order and the temperature-1000 softmax of
# the decode magnifies that
PX_TOL = 5e-3
CONF_TOL = 2e-4
SEQ_LEN = 8  # dali.base.predict.sequence_length of the slice's config
IMAGE = 64


def _copy(model_dir: Path, dest: Path, overrides: list[str] = ()) -> Path:
    """A copy of a model directory, with config overrides."""
    from lightning_pose_tpu_torch.config import Config

    shutil.copytree(model_dir, dest)
    if overrides:
        cfg = Config.from_yaml(str(dest / "config.yaml"))
        cfg.apply_overrides(list(overrides))
        cfg.save(str(dest / "config.yaml"))
    return dest


def _inputs(views: int = 1, seed: int = 4) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    shape = (SEQ_LEN, views, IMAGE, IMAGE, 3) if views > 1 else (SEQ_LEN, IMAGE, IMAGE, 3)
    images = rng.integers(0, 256, shape, dtype=np.uint8)
    bbox = np.tile(np.array([3.0, 5.0, 60.0, 80.0] * views, dtype=np.float32), (SEQ_LEN, 1))
    return images, bbox


def _exported_ops(path: Path) -> set[str]:
    """The port's ops named anywhere in a saved program's graphs (the
    autocast region is a graph of its own)."""
    program = torch.export.load(str(path))
    return {
        str(node.target)
        for gm in program.graph_module.modules() if isinstance(gm, torch.fx.GraphModule)
        for node in gm.graph.nodes
        if node.op == "call_function" and str(node.target).startswith("lightning_pose_tpu_torch.")
    }


@pytest.fixture(scope="module")
def model_dir(slice_model_dir, tmp_path_factory) -> Path:
    return _copy(slice_model_dir, tmp_path_factory.mktemp("export") / "model")


@pytest.fixture(scope="module")
def exported(model_dir) -> tuple[Model, Path]:
    model = Model.from_dir(model_dir, precision="fp32", device="cpu")
    return model, Path(model.export())


def test_export_writes_a_pt2_under_exports_torch(exported, model_dir):
    _, path = exported
    assert path == model_dir / "exports_torch" / "predict.pt2"
    assert path.is_file()


def test_load_exported_matches_the_eager_step(exported):
    model, path = exported
    fn = Model.load_exported(path)
    images, bbox = (torch.from_numpy(a) for a in _inputs())
    with torch.inference_mode():
        kp, conf = fn(images, bbox)
    kp_eager, conf_eager = model._predict_step(images, bbox)
    assert kp.shape == (SEQ_LEN, 8) and conf.shape == (SEQ_LEN, 4)
    np.testing.assert_allclose(kp.numpy(), kp_eager.numpy(), rtol=0, atol=1e-5)
    np.testing.assert_allclose(conf.numpy(), conf_eager.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("views", [1, 2])
def test_exported_program_matches_the_jax_export(exported, model_dir, tmp_path, views):
    """The port's ``.pt2`` and the JAX package's ``.jax_export`` of the same
    weights, on the same frames and bboxes; 2 views: the same weights as a
    heatmap model on a 2-view set (views folded into the batch)."""
    if views == 1:
        directory, path = model_dir, exported[1]
    else:
        directory = _copy(model_dir, tmp_path / "mv", ["data.view_names=[top,bot]",
                                                        "data.csv_file=[top.csv,bot.csv]"])
        path = Path(Model.from_dir(directory, precision="fp32", device="cpu").export(tmp_path / "port"))
    jax_fn = JaxModel.load_exported(JaxModel.from_dir(directory, precision="fp32").export(tmp_path / "jax"))
    images, bbox = _inputs(views)
    kp_ref, conf_ref = (np.asarray(a) for a in jax_fn(images, bbox))
    with torch.inference_mode():
        kp, conf = Model.load_exported(path)(torch.from_numpy(images), torch.from_numpy(bbox))
    assert kp.shape == (SEQ_LEN, 8 * views) and conf.shape == (SEQ_LEN, 4 * views)
    np.testing.assert_allclose(kp.numpy(), kp_ref, rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(conf.numpy(), conf_ref, rtol=0, atol=CONF_TOL)
    assert _exported_ops(path) == {"lightning_pose_tpu_torch.normalize.default",
                                   "lightning_pose_tpu_torch.decode.default"}


def test_exported_runtime_predicts_a_video_as_eager(exported, model_dir, slice_video, tmp_path):
    """``use_exported_runtime()`` finds the one ``.pt2``; the video path
    runs through it (RGB transfer whatever the config says) and writes the
    eager CSV."""
    eager, _ = exported
    eager.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "eager")
    model = Model.from_dir(model_dir, precision="fp32", device="cpu")
    model.use_exported_runtime()
    model.cfg.eval.video_transfer_format = "yuv420"
    assert model._video_transfer_format() == "rgb"
    model.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "exported")
    read = [pd.read_csv(tmp_path / d / "blobs.csv", header=[0, 1, 2], index_col=0) for d in ("eager", "exported")]
    assert read[1].shape == (20, 12)
    np.testing.assert_allclose(read[1].to_numpy(), read[0].to_numpy(), rtol=0, atol=1e-5)


def test_exported_runtime_rejects_other_shapes(exported, model_dir):
    model = Model.from_dir(model_dir, precision="fp32", device="cpu")
    model.use_exported_runtime(exported[1])
    with pytest.raises(ValueError, match="exported program expects"):
        model._predict_fn(torch.zeros((3, IMAGE, IMAGE, 3), dtype=torch.uint8), torch.zeros((3, 4)))


@pytest.mark.parametrize("exports", [0, 2])
def test_exported_runtime_needs_exactly_one_export(slice_model_dir, tmp_path, exports):
    directory = _copy(slice_model_dir, tmp_path / "model")
    (directory / "exports_torch").mkdir()
    for name in ("a", "b")[:exports]:
        (directory / "exports_torch" / f"{name}.pt2").write_bytes(b"x")
    with pytest.raises(FileNotFoundError, match="exactly one"):
        Model.from_dir(directory, device="cpu").use_exported_runtime()


def test_compile_predicts_a_video_as_eager(exported, slice_video, tmp_path):
    """``compile()`` (torch.compile, static shapes) runs the canonical
    batch, twice as it may be called, then serves the video path."""
    eager, _ = exported
    eager.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "eager")
    model = Model.from_dir(eager.model_dir, precision="fp32", device="cpu")
    model.compile()
    model.compile()
    model.predict_on_video_file(slice_video, compute_metrics=False, output_dir=tmp_path / "compiled")
    read = [pd.read_csv(tmp_path / d / "blobs.csv", header=[0, 1, 2], index_col=0) for d in ("eager", "compiled")]
    np.testing.assert_allclose(read[1].to_numpy(), read[0].to_numpy(), rtol=0, atol=1e-3)


@pytest.mark.parametrize("op", ["normalize", "decode"])
def test_registered_ops_on_the_cpu(op):
    """The ops' fake implementations give the CPU implementations' (the
    plain versions') shapes, dtypes and strides, and the CPU
    implementations are the plain versions."""
    from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel

    rng = np.random.default_rng(0)
    if op == "normalize":
        args = (torch.from_numpy(rng.integers(0, 256, (2, 8, 12, 3), dtype=np.uint8)), torch.bfloat16)
        ref = (normalize_kernel.normalize_plain(*args).movedim(-3, -1),)
    else:
        args = (torch.from_numpy(rng.random((2, 3, 16, 16), dtype=np.float32)), 2, 1000.0)
        ref = decode_kernel.decode_plain(*args)
    overload = getattr(torch.ops.lightning_pose_tpu_torch, op).default
    torch.library.opcheck(overload, args, test_utils=("test_schema", "test_faketensor"))
    out = overload(*args)
    for a, b in zip(out if isinstance(out, tuple) else (out,), ref):
        assert torch.equal(a, b) and a.stride() == b.contiguous().stride()
