"""The port imports no JAX, nothing of the JAX package and not
``transformers``: its whole package, its predict path, its supervised and
semi-supervised training paths, a pretrained backbone load, a resume run,
a transformer backbone's train() with a DARK prediction, the heatmap
models' train() and prediction on multiview data, and the calibrated
multiview train() with the host triangulation run in a
subprocess where importing jax, jaxlib, flax, optax, transformers or
``lightning_pose_tpu`` raises, and no module of the port names one of them
in an import."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "transformers", "lightning_pose_tpu")

_BLOCK_JAX = """
import sys

BLOCKED = {BLOCKED!r}

class BlockJax:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{{name}} is blocked in this test")

sys.meta_path.insert(0, BlockJax())
""".format(BLOCKED=BLOCKED)


def _run(code: str) -> str:
    out = subprocess.run(
        [sys.executable, "-c", _BLOCK_JAX + code],
        capture_output=True, text=True, timeout=300, cwd=REPO,
    )
    assert out.returncode == 0, out.stderr[-4000:]
    return out.stdout


def _imported_modules(path: Path) -> set[str]:
    """Every module an ``import`` statement of ``path`` names, at any depth;
    a relative import counts as the port's own."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names.update(alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add("lightning_pose_tpu_torch" if node.level else node.module)
    return names


def test_chip_smoke_imports_only_the_port():
    """``chip_smoke.py`` names no module of JAX or of the JAX package."""
    names = _imported_modules(REPO / "chip_smoke.py")
    tops = {name.split(".")[0] for name in names}
    assert "lightning_pose_tpu_torch" in tops
    assert not tops & set(BLOCKED), sorted(names)


def test_no_port_module_names_jax_or_the_jax_package():
    """No ``.py`` file of the port imports jax, jaxlib, flax or
    ``lightning_pose_tpu``, at the top or inside a function; the scan covers
    the semi-supervised modules and the backward kernel's wrapper."""
    files = sorted((REPO / "lightning_pose_tpu_torch").rglob("*.py"))
    assert len(files) >= 30
    names = {str(f.relative_to(REPO / "lightning_pose_tpu_torch")) for f in files}
    assert {"data/unlabeled.py", "utils/pca.py", "ops/video_augment.py", "ops/decode_kernel.py"} <= names
    assert {"models/backbones/vit.py", "models/heatmap_tracker_multiview.py", "data/datasets_multiview.py",
            "ops/interpolate.py"} <= names
    assert {"models/backbones/pretrained.py", "models/backbones/efficientnet.py", "models/regression_tracker.py",
            "models/heads/regression.py"} <= names
    assert {"models/backbones/vit_dino.py", "models/backbones/vit_sam.py", "models/backbones/hiera.py",
            "ops/dark.py"} <= names
    assert {"data/anipose.py", "data/cameras.py", "ops/augment3d.py"} <= names
    assert {"cli/main.py", "cli/commands/predict.py", "migrations/migrations.py", "utils/cropzoom.py",
            "data/extractor.py"} <= names
    assert "decode_grad.cu" in _imported_sources(REPO / "lightning_pose_tpu_torch" / "ops" / "decode_kernel.py")
    found = {
        str(f.relative_to(REPO)): sorted(n for n in _imported_modules(f) if n.split(".")[0] in BLOCKED)
        for f in files
    }
    assert not {f: names for f, names in found.items() if names}


def _imported_sources(path: Path) -> set[str]:
    """The CUDA sources a wrapper loads: string arguments of
    ``load_library`` calls."""
    return {
        node.args[0].value
        for node in ast.walk(ast.parse(path.read_text()))
        if isinstance(node, ast.Call) and getattr(node.func, "id", None) == "load_library"
        and node.args and isinstance(node.args[0], ast.Constant)
    }


def test_every_port_module_imports_without_jax():
    out = _run("""
import importlib, pkgutil, sys
import lightning_pose_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
blocked = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
new = {"backbones.vit", "heatmap_tracker_multiview", "datasets_multiview", "ops.interpolate",
       "backbones.pretrained", "backbones.efficientnet", "regression_tracker", "heads.regression",
       "backbones.vit_dino", "backbones.vit_sam", "backbones.hiera", "ops.dark",
       "data.anipose", "data.cameras", "ops.augment3d",
       "cli.main", "cli.friendly", "cli.types", "cli.commands.train", "cli.commands.predict", "cli.commands.export",
       "cli.commands.create_bbox", "cli.commands.smooth_bbox", "cli.commands.crop", "cli.commands.remap",
       "cli.commands.run_app", "migrations.migrations", "utils.cropzoom", "data.extractor",
       "ops.yuv", "ops.yuv_kernel", "torch.parallel", "parallel.mesh"}
print(len(names), len(blocked), sum(any(name.endswith(n) for name in names) for n in new))
""")
    count, n_blocked, n_new = out.split()
    assert int(count) >= 30 and n_blocked == "0" and n_new == "33"


def test_predict_path_runs_without_jax(slice_model_dir, slice_video, tmp_path):
    """Video and frame prediction; the yuv420 transfer, and data-parallel
    prediction over two (patched) CPU replicas."""
    out = _run(f"""
import json, sys
import numpy as np
import torch
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.parallel import mesh
model = Model.from_dir({str(slice_model_dir)!r}, precision="fp32", device="cpu")
result = model.predict_on_video_file({str(slice_video)!r}, output_dir={str(tmp_path)!r})
frame = model.predict_frame(np.zeros((60, 80, 3), dtype=np.uint8))
model.cfg.eval.video_transfer_format = "yuv420"
yuv = model.predict_on_video_file({str(slice_video)!r}, compute_metrics=False, output_dir={str(tmp_path / "yuv")!r})
mesh.devices = lambda num_devices=None: [torch.device("cpu")] * 2
parallel = Model.from_dir({str(slice_model_dir)!r}, precision="fp32", device="cpu", data_parallel=True)
split = parallel.predict_frame(np.zeros((60, 80, 3), dtype=np.uint8))
print(json.dumps({{
    "shape": list(result.predictions.shape),
    "finite": bool(np.isfinite(result.predictions.to_numpy()).all()),
    "frame": list(frame["keypoints"].shape),
    "yuv": list(yuv.predictions.shape),
    "split": bool(np.abs(split["keypoints"] - frame["keypoints"]).max() < 1e-3),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"shape": [20, 12], "finite": True, "frame": [4, 2], "yuv": [20, 12], "split": True, "jax": []}
    assert (tmp_path / "blobs.csv").is_file()


def test_cli_runs_without_jax(slice_model_dir, slice_video, tmp_path):
    """``litpose-torch`` (``python -m lightning_pose_tpu_torch.cli.main``):
    predict, export, predict with the exported runtime, and the cropzoom
    commands on the predictions (create_bbox, smooth_bbox, crop, remap)."""
    model_dir = tmp_path / "model"
    out = _run(f"""
import json, shutil, sys
shutil.copytree({str(slice_model_dir)!r}, {str(model_dir)!r})
from lightning_pose_tpu_torch.cli.main import main
model, video = {str(model_dir)!r}, {str(slice_video)!r}
assert main(["predict", model, video, "--skip_viz", "--device", "cpu"]) == 0
assert main(["export", model, "--device", "cpu"]) == 0
assert main(["predict", model, video, "--skip_viz", "--runtime", "exported", "--overwrite", "--device", "cpu",
             "--output_dir", {str(tmp_path / "exported")!r}]) == 0
assert main(["create_bbox", model, video, "--device", "cpu"]) == 0
assert main(["smooth_bbox", model + "/video_preds", "--output_dir", {str(tmp_path / "smoothed")!r}]) == 0
assert main(["crop", model, video, "--bbox_dir", {str(tmp_path / "smoothed")!r}, "--device", "cpu"]) == 0
assert main(["remap", model + "/video_preds/blobs.csv", {str(tmp_path / "smoothed" / "blobs_bbox.csv")!r}]) == 0
print(json.dumps({{"jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED]}}))
""")
    assert json.loads(out.strip().splitlines()[-1]) == {"jax": []}
    for path in ("exports_torch/predict.pt2", "video_preds/blobs_bbox.csv", "cropped_videos/cropped_blobs.mp4",
                 "video_preds/remapped_blobs.csv"):
        assert (model_dir / path).is_file(), path
    assert (tmp_path / "exported" / "blobs.csv").is_file()


def test_training_path_runs_without_jax(tmp_path):
    """train() on a synthetic labeled set (dlc augmentation, step mode), then
    prediction from the directory it wrote."""
    out = _run(f"""
import json, sys
import numpy as np
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.train.trainer import train
from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

names = ["a", "b", "c"]
data = write_labeled_dataset({str(tmp_path / "data")!r}, 8, 130, 140, names, seed=1)
cfg = load_config()
cfg.data.data_dir = str(data)
cfg.data.video_dir = "videos"
cfg.data.num_keypoints = 3
cfg.data.keypoint_names = names
cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
cfg.model.backbone = "resnet18"
cfg.model.model_name = "nojax"
cfg.training.train_batch_size = 4
cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
cfg.training.max_steps = cfg.training.min_steps = 2
cfg.training.unfreezing_step = 1
cfg.training.lr_scheduler_params.multisteplr.milestones = None
cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
train(cfg, {str(tmp_path / "model")!r}, skip_evaluation=True, device="cpu")
frame = Model.from_dir({str(tmp_path / "model")!r}, precision="fp32", device="cpu").predict_frame(
    np.zeros((130, 140, 3), dtype=np.uint8))
print(json.dumps({{
    "finite": bool(np.isfinite(frame["keypoints"]).all()),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"finite": True, "jax": []}


def test_semisupervised_training_path_runs_without_jax(tmp_path):
    """train() with pca_singleview + temporal on a synthetic labeled set and
    two synthetic mp4s streamed as I420 (yuv420), then prediction from the
    directory it wrote."""
    out = _run(f"""
import json, sys
import numpy as np
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.train.trainer import train
from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

names = ["a", "b", "c"]
data = write_labeled_dataset({str(tmp_path / "data")!r}, 12, 130, 140, names, seed=1)
for i in range(2):
    write_unlabeled_video(data, f"session{{i}}", 8, 96, 128, n_blobs=3, seed=i)
cfg = load_config()
cfg.data.data_dir = str(data)
cfg.data.video_dir = "videos"
cfg.data.num_keypoints = 3
cfg.data.keypoint_names = names
cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
cfg.model.backbone = "resnet18"
cfg.model.model_name = "nojaxsemi"
cfg.model.losses_to_use = ["pca_singleview", "temporal"]
cfg.dali.base.train.sequence_length = 4
cfg.training.train_batch_size = 4
cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
cfg.training.max_steps = cfg.training.min_steps = 2
cfg.training.unfreezing_step = 1
cfg.training.log_every_n_steps = 1
cfg.training.lr_scheduler_params.multisteplr.milestones = None
cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
cfg.training.video_transfer_format = "yuv420"
result = train(cfg, {str(tmp_path / "model")!r}, skip_evaluation=True, device="cpu")
frame = Model.from_dir({str(tmp_path / "model")!r}, precision="fp32", device="cpu").predict_frame(
    np.zeros((130, 140, 3), dtype=np.uint8))
print(json.dumps({{
    "finite": bool(np.isfinite(frame["keypoints"]).all()),
    "unsupervised_logged": sum("train_unsupervised_loss" in h for h in result.history),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"finite": True, "unsupervised_logged": 2, "jax": []}


def test_context_model_paths_run_without_jax(tmp_path):
    """The context model (heatmap_mhcrnn): semi-supervised train() in
    repeat_center mode with its evaluation (the labeled stacks, a test
    video), then, from the directory, in adjacent mode, the video, the
    labeled CSV and a 5-frame stack."""
    out = _run(f"""
import json, sys
import numpy as np
from lightning_pose_tpu_torch.config import Config, load_config
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.train.trainer import train
from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

names = ["a", "b", "c"]
data = write_labeled_dataset({str(tmp_path / "data")!r}, 10, 130, 140, names, seed=1)
video = write_unlabeled_video(data, "session0", 9, 96, 128, n_blobs=3, seed=0)
cfg = load_config()
cfg.data.data_dir = str(data)
cfg.data.video_dir = "videos"
cfg.data.num_keypoints = 3
cfg.data.keypoint_names = names
cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
cfg.model.model_type = "heatmap_mhcrnn"
cfg.model.mhcrnn_context_mode = "repeat_center"
cfg.model.backbone = "resnet18"
cfg.model.model_name = "nojaxctx"
cfg.model.losses_to_use = ["pca_singleview", "temporal"]
cfg.dali.base.train.sequence_length = 6
cfg.dali.context.predict.sequence_length = 8
cfg.training.train_batch_size = 4
cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
cfg.training.max_steps = cfg.training.min_steps = 2
cfg.training.unfreezing_step = 1
cfg.training.log_every_n_steps = 1
cfg.training.lr_scheduler_params.multisteplr.milestones = None
cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
cfg.eval.test_videos_directory = str(data / "videos")
model_dir = {str(tmp_path / "model")!r}
result = train(cfg, model_dir, device="cpu")
saved = Config.from_yaml(model_dir + "/config.yaml")
saved.model.mhcrnn_context_mode = "adjacent"
saved.save(model_dir + "/config.yaml")
model = Model.from_dir(model_dir, precision="fp32", device="cpu")
csv = model.predict_on_video_file(str(video), output_dir={str(tmp_path / "preds")!r}).predictions
labeled = model.predict_on_label_csv("CollectedData.csv", compute_metrics=False).predictions
frame = model.predict_frame(np.zeros((5, 130, 140, 3), dtype=np.uint8))
print(json.dumps({{
    "video": list(csv.shape),
    "labeled": list(labeled.shape),
    "finite": bool(np.isfinite(frame["keypoints"]).all() and np.isfinite(csv.to_numpy()).all()),
    "unsupervised_logged": sum("train_unsupervised_loss" in h for h in result.history),
    "evaluated": sorted(p.split("/")[-1] for p in ["image_preds/CollectedData.csv/predictions.csv",
                                                    "video_preds/session0.csv"]
                        if (result.model_dir / p).is_file()),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"video": [9, 9], "labeled": [10, 10], "finite": True, "unsupervised_logged": 2,
                      "evaluated": ["predictions.csv", "session0.csv"], "jax": []}


def test_multiview_paths_run_without_jax(tmp_path):
    """The multiview transformer (a small ViT through ``VIT_CONFIGS``):
    semi-supervised train() with pca_multiview + temporal and the patch
    mask, with its evaluation (the labeled views, a 2-view test session),
    then, from the directory, the session, the labeled CSVs and one frame a
    view."""
    out = _run(f"""
import json, sys
import numpy as np
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.models.backbones import vit
from lightning_pose_tpu_torch.train.trainer import train
from lightning_pose_tpu_torch.utils.synthetic import write_multiview_dataset, write_multiview_videos

vit.VIT_CONFIGS["vits"] = (64, 2, 2, 16)
names, views = ["a", "b", "c"], ["top", "side"]
data = write_multiview_dataset({str(tmp_path / "data")!r}, 10, 100, 120, names, views, seed=1)
videos = write_multiview_videos(data, "session0", 9, 96, 128, views, n_blobs=3, seed=0)
cfg = load_config()
cfg.data.data_dir = str(data)
cfg.data.video_dir = "videos"
cfg.data.csv_file = [f"CollectedData_{{v}}.csv" for v in views]
cfg.data.view_names = views
cfg.data.num_keypoints = 3
cfg.data.keypoint_names = names
cfg.data.mirrored_column_matches = [0, 1, 2]
cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
cfg.model.model_type = "heatmap_multiview_transformer"
cfg.model.backbone = "vits_dino"
cfg.model.model_name = "nojaxmv"
cfg.model.losses_to_use = ["pca_multiview", "temporal"]
cfg.dali.base.train.sequence_length = 4
cfg.dali.base.predict.sequence_length = 8
cfg.training.train_batch_size = 4
cfg.training.patch_mask = {{"init_step": 0, "final_step": 2, "init_ratio": 0.1, "final_ratio": 0.5}}
cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
cfg.training.max_steps = cfg.training.min_steps = 2
cfg.training.unfreezing_step = 1
cfg.training.log_every_n_steps = 1
cfg.training.lr_scheduler_params.multisteplr.milestones = None
cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
cfg.eval.test_videos_directory = str(data / "videos")
model_dir = {str(tmp_path / "model")!r}
result = train(cfg, model_dir, device="cpu")
model = Model.from_dir(model_dir, precision="fp32", device="cpu")
session = model.predict_on_video_file_multiview([str(v) for v in videos], output_dir={str(tmp_path / "preds")!r})
labeled = model.predict_on_label_csv_multiview(cfg.data.csv_file, compute_metrics=False).predictions
frame = model.predict_frame(np.zeros((2, 100, 120, 3), dtype=np.uint8))
print(json.dumps({{
    "video": {{v: list(df.shape) for v, df in session.predictions.items()}},
    "labeled": {{v: list(df.shape) for v, df in labeled.items()}},
    "frame": list(frame["keypoints"].shape),
    "finite": bool(np.isfinite(frame["keypoints"]).all()),
    "unsupervised_logged": sum("train_unsupervised_loss" in h for h in result.history),
    "evaluated": sorted(p for p in ["image_preds/CollectedData_top.csv/predictions.csv",
                                    "image_preds/CollectedData_side.csv/predictions.csv",
                                    "video_preds/session0_top.csv", "video_preds/session0_side.csv"]
                        if (result.model_dir / p).is_file()),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {
        "video": {"top": [9, 9], "side": [9, 9]},
        "labeled": {"top": [10, 10], "side": [10, 10]},
        "frame": [6, 2],
        "finite": True,
        "unsupervised_logged": 2,
        "evaluated": ["image_preds/CollectedData_side.csv/predictions.csv",
                      "image_preds/CollectedData_top.csv/predictions.csv",
                      "video_preds/session0_side.csv", "video_preds/session0_top.csv"],
        "jax": [],
    }


def test_heatmap_models_on_multiview_data_run_without_jax(tmp_path):
    """``heatmap`` and ``heatmap_mhcrnn`` (resnet18) on the split layout of a
    2-view set: semi-supervised train() with pca_multiview over the
    synchronized window, with its evaluation (the labeled views, a 2-view
    test session), then, from each directory, the session, the labeled CSVs
    and predict_frame."""
    out = _run(f"""
import json, sys
import numpy as np
import torch
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.train.trainer import train
from lightning_pose_tpu_torch.utils.synthetic import write_multiview_dataset, write_multiview_videos

torch.set_num_threads(2)
names, views = ["a", "b", "c"], ["top", "bot"]
data = write_multiview_dataset({str(tmp_path / "data")!r}, 10, 100, 120, names, views, seed=1, csv_name="{{view}}.csv")
videos = write_multiview_videos(data, "session0", 9, 96, 128, views, n_blobs=3, seed=0)
report = {{"jax": []}}
for model_type, frame_shape in (("heatmap", (2, 100, 120, 3)), ("heatmap_mhcrnn", (2, 5, 100, 120, 3))):
    cfg = load_config()
    cfg.data.data_dir = str(data)
    cfg.data.video_dir = "videos"
    cfg.data.csv_file = [f"{{v}}.csv" for v in views]
    cfg.data.view_names = views
    cfg.data.num_keypoints = 3
    cfg.data.keypoint_names = names
    cfg.data.mirrored_column_matches = [0, 1, 2]
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.model_type = model_type
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = model_type
    cfg.model.losses_to_use = ["pca_multiview"]
    cfg.dali.base.train.sequence_length = 6
    cfg.dali.base.predict.sequence_length = cfg.dali.context.predict.sequence_length = 8
    cfg.training.train_batch_size = 4
    cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
    cfg.training.max_steps = cfg.training.min_steps = 2
    cfg.training.unfreezing_step = 1
    cfg.training.log_every_n_steps = 1
    cfg.training.lr_scheduler_params.multisteplr.milestones = None
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
    cfg.eval.test_videos_directory = str(data / "videos")
    model_dir = {str(tmp_path)!r} + "/" + model_type
    result = train(cfg, model_dir, device="cpu")
    model = Model.from_dir(model_dir, precision="fp32", device="cpu")
    session = model.predict_on_video_file_multiview([str(v) for v in videos],
                                                    output_dir={str(tmp_path)!r} + "/preds_" + model_type)
    labeled = model.predict_on_label_csv_multiview(cfg.data.csv_file, compute_metrics=False).predictions
    frame = model.predict_frame(np.zeros(frame_shape, dtype=np.uint8))
    report[model_type] = {{
        "video": {{v: list(df.shape) for v, df in session.predictions.items()}},
        "labeled": {{v: list(df.shape) for v, df in labeled.items()}},
        "frame": list(frame["keypoints"].shape),
        "finite": bool(np.isfinite(frame["keypoints"]).all()),
        "unsupervised_logged": sum("train_unsupervised_loss" in h for h in result.history),
        "evaluated": sorted(p for p in ["image_preds/top.csv/predictions.csv", "image_preds/bot.csv/predictions.csv",
                                        "video_preds/session0_top.csv", "video_preds/session0_bot.csv"]
                            if (result.model_dir / p).is_file()),
    }}
report["jax"] = [m for m in sys.modules if m.split(".")[0] in BLOCKED]
print(json.dumps(report))
""")
    report = json.loads(out.strip().splitlines()[-1])
    expected = {
        "video": {"top": [9, 9], "bot": [9, 9]},
        "labeled": {"top": [10, 10], "bot": [10, 10]},
        "frame": [6, 2],
        "finite": True,
        "unsupervised_logged": 2,
        "evaluated": ["image_preds/bot.csv/predictions.csv", "image_preds/top.csv/predictions.csv",
                      "video_preds/session0_bot.csv", "video_preds/session0_top.csv"],
    }
    assert report == {"jax": [], "heatmap": expected, "heatmap_mhcrnn": expected}


def test_calibrated_multiview_path_runs_without_jax(tmp_path):
    """The calibrated multiview transformer (a small ViT): train() on a
    synthetic 2-view set whose anipose TOML the dataset discovers, with the
    3D augmentation and both supervised 3D losses, then the directory
    through ``Model.from_dir2`` with an override, one frame a view, and the
    host triangulation of the predictions with the discovered cameras."""
    out = _run(f"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.data.anipose import load_anipose_toml
from lightning_pose_tpu_torch.data.cameras import CameraGroup
from lightning_pose_tpu_torch.models.backbones import vit
from lightning_pose_tpu_torch.train.trainer import train
from lightning_pose_tpu_torch.utils.synthetic import write_calibrated_multiview_dataset

vit.VIT_CONFIGS["vits"] = (32, 1, 2, 16)
names, views = ["a", "b", "c"], ["top", "side"]
data = write_calibrated_multiview_dataset({str(tmp_path / "data")!r}, 6, 100, 120, names, views, seed=1)
cfg = load_config()
cfg.data.data_dir = str(data)
cfg.data.video_dir = "videos"
cfg.data.csv_file = [f"CollectedData_{{v}}.csv" for v in views]
cfg.data.view_names = views
cfg.data.num_keypoints = 3
cfg.data.keypoint_names = names
cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
cfg.model.model_type = "heatmap_multiview_transformer"
cfg.model.backbone = "vits_dino"
cfg.model.model_name = "nojaxcal"
cfg.losses.supervised_reprojection_heatmap_mse = {{"log_weight": 3.0}}
cfg.losses.supervised_pairwise_projections = {{"log_weight": 3.0}}
cfg.training.imgaug = "dlc"
cfg.training.imgaug_3d = True
cfg.training.train_batch_size = 4
cfg.training.max_epochs = cfg.training.min_epochs = cfg.training.unfreezing_epoch = None
cfg.training.max_steps = cfg.training.min_steps = 2
cfg.training.unfreezing_step = 1
cfg.training.log_every_n_steps = 1
cfg.training.lr_scheduler_params.multisteplr.milestones = None
cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [1]
model_dir = {str(tmp_path / "model")!r}
result = train(cfg, model_dir, skip_evaluation=True, device="cpu")
model = Model.from_dir2(model_dir, ["training.test_batch_size=3"], precision="fp32", device="cpu")
frame = model.predict_frame(np.zeros((2, 100, 120, 3), dtype=np.uint8))
cameras = CameraGroup.from_dict(load_anipose_toml(str(data / "calibrations" / "synth.toml")))
points = cameras.triangulate_fast(frame["keypoints"].reshape(1, 2, 3, 2).astype(np.float64))
print(json.dumps({{
    "logged_3d": sum("train_supervised_pairwise_projections_loss" in h for h in result.history),
    "batch": int(model.cfg.training.test_batch_size),
    "video_preds": str(model.video_preds_dir()) == model_dir + "/video_preds",
    "points": list(points.shape),
    "finite": bool(np.isfinite(frame["keypoints"]).all() and np.isfinite(points).all()),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"logged_3d": 2, "batch": 3, "video_preds": True, "points": [1, 3, 3], "finite": True, "jax": []}


def test_pretrained_backbone_and_resume_run_without_jax(tmp_path):
    """train() of a regression model from a torchvision-layout backbone
    file, then a resumed train() of it with the profiler on, then
    prediction from the directory."""
    out = _run(f"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.train.trainer import train
from lightning_pose_tpu_torch.utils.synthetic import torchvision_resnet_state_dict, write_labeled_dataset

names = ["a", "b", "c"]
data = write_labeled_dataset({str(tmp_path / "data")!r}, 5, 130, 140, names, seed=1)
torch.save(torchvision_resnet_state_dict("resnet18", seed=2), {str(tmp_path / "r18.pth")!r})
cfg = load_config()
cfg.data.data_dir = str(data)
cfg.data.video_dir = "videos"
cfg.data.num_keypoints = 3
cfg.data.keypoint_names = names
cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
cfg.model.model_type = "regression"
cfg.model.backbone = "resnet18"
cfg.model.backbone_checkpoint = {str(tmp_path / "r18.pth")!r}
cfg.model.model_name = "nojaxpre"
cfg.training.train_batch_size = 4
cfg.training.max_epochs = cfg.training.min_epochs = 1
cfg.training.unfreezing_epoch = 0
cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
train(cfg.copy(), {str(tmp_path / "model")!r}, skip_evaluation=True, device="cpu")
cfg.training.max_epochs = cfg.training.min_epochs = 2
cfg.training.resume = True
cfg.training.profiler = True
result = train(cfg, {str(tmp_path / "model")!r}, skip_evaluation=True, device="cpu")
frame = Model.from_dir({str(tmp_path / "model")!r}, precision="fp32", device="cpu").predict_frame(
    np.zeros((130, 140, 3), dtype=np.uint8))
print(json.dumps({{
    "finite": bool(np.isfinite(frame["keypoints"]).all()),
    "confidence": frame["confidence"].tolist(),
    "epochs": sorted({{h["epoch"] for h in result.history}}),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"finite": True, "confidence": [1.0, 1.0, 1.0], "epochs": [1], "jax": []}
    assert (tmp_path / "model" / "tb_logs" / "nojaxpre" / "version_0" / "profiler_trace.json").is_file()


def test_transformer_training_and_dark_prediction_run_without_jax(tmp_path):
    """train() of a single-view heatmap model with a SAM2 Hiera trunk (width
    cut to 16) from a file in the published key layout, then DARK
    prediction from the directory it wrote."""
    out = _run(f"""
import json, sys
import numpy as np
import torch
torch.set_num_threads(2)
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.api.model import Model
from lightning_pose_tpu_torch.models.backbones import hiera
from lightning_pose_tpu_torch.train.trainer import train
from lightning_pose_tpu_torch.utils.synthetic import hf_sam2_hiera_state_dict, write_labeled_dataset

hiera.HIERA_CONFIGS["vitt_sam2"] = dict(hiera.HIERA_CONFIGS["vitt_sam2"], embed_dim=16)
names = ["a", "b", "c"]
data = write_labeled_dataset({str(tmp_path / "data")!r}, 5, 130, 140, names, seed=1)
torch.save(hf_sam2_hiera_state_dict("vitt_sam2", seed=2), {str(tmp_path / "hiera.pt")!r})
cfg = load_config()
cfg.data.data_dir = str(data)
cfg.data.video_dir = "videos"
cfg.data.num_keypoints = 3
cfg.data.keypoint_names = names
cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
cfg.model.backbone = "vitt_sam2"
cfg.model.backbone_checkpoint = {str(tmp_path / "hiera.pt")!r}
cfg.model.model_name = "nojaxvit"
cfg.eval.decode_method = "dark"
cfg.training.train_batch_size = 4
cfg.training.max_epochs = cfg.training.min_epochs = 1
cfg.training.unfreezing_epoch = 0
cfg.training.lr_scheduler_params.multisteplr.milestones = [1]
train(cfg, {str(tmp_path / "model")!r}, skip_evaluation=True, device="cpu")
frame = Model.from_dir({str(tmp_path / "model")!r}, precision="fp32", device="cpu").predict_frame(
    np.zeros((130, 140, 3), dtype=np.uint8))
print(json.dumps({{
    "finite": bool(np.isfinite(frame["keypoints"]).all()),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"finite": True, "jax": []}
