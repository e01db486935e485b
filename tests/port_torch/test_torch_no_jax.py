"""The port imports no JAX and nothing of the JAX package: its whole
package, its predict path, its supervised and semi-supervised training
paths, a pretrained backbone load and a resume run in a subprocess where
importing jax, jaxlib, flax, optax or ``lightning_pose_tpu`` raises, and no
module of the port names one of them in an import."""

from __future__ import annotations

import ast
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[2]
BLOCKED = ("jax", "jaxlib", "flax", "optax", "lightning_pose_tpu")

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
       "backbones.pretrained", "backbones.efficientnet", "regression_tracker", "heads.regression"}
print(len(names), len(blocked), sum(any(name.endswith(n) for name in names) for n in new))
""")
    count, n_blocked, n_new = out.split()
    assert int(count) >= 30 and n_blocked == "0" and n_new == "8"


def test_predict_path_runs_without_jax(slice_model_dir, slice_video, tmp_path):
    out = _run(f"""
import json, sys
import numpy as np
from lightning_pose_tpu_torch.api.model import Model
model = Model.from_dir({str(slice_model_dir)!r}, precision="fp32", device="cpu")
result = model.predict_on_video_file({str(slice_video)!r}, output_dir={str(tmp_path)!r})
frame = model.predict_frame(np.zeros((60, 80, 3), dtype=np.uint8))
print(json.dumps({{
    "shape": list(result.predictions.shape),
    "finite": bool(np.isfinite(result.predictions.to_numpy()).all()),
    "frame": list(frame["keypoints"].shape),
    "jax": [m for m in sys.modules if m.split(".")[0] in BLOCKED],
}}))
""")
    report = json.loads(out.strip().splitlines()[-1])
    assert report == {"shape": [20, 12], "finite": True, "frame": [4, 2], "jax": []}
    assert (tmp_path / "blobs.csv").is_file()


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
    two synthetic mp4s, then prediction from the directory it wrote."""
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
