"""``litpose-torch`` (``lightning_pose_tpu_torch/cli``) against the JAX
package's ``litpose`` (``tests/cli/test_cli.py``): the parser, its
validators and banner, ``train --detector_model``'s redirect, ``predict`` of
a video and of a labeled CSV on one model directory (the port with
``--device cpu``), the cropzoom commands on the same inputs, the exported
runtime, the migrations and ``run_app``."""

from __future__ import annotations

import argparse
import json
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from lightning_pose_tpu.cli.main import main as jax_main
from lightning_pose_tpu_torch.cli.main import build_parser, main

COMMANDS = ["train", "predict", "export", "create_bbox", "smooth_bbox", "crop", "remap", "run_app"]
# slice 1's limits: fp32 on the CPU in both packages (test_torch_slice.py)
PX_TOL = 5e-3
CONF_TOL = 2e-4
NAMES = ["a", "b", "c"]
IMAGE = 128
HEAD_SCALE = 300.0  # as the port tests' conftest: a peaked random-init head


def _minimal_args(cmd: str, tmp_path: Path) -> list[str]:
    d = str(tmp_path)
    return {
        "train": [f"{d}/cfg.yaml"],
        "predict": [d, "video.mp4"],
        "export": [d],
        "create_bbox": [d, "video.mp4"],
        "smooth_bbox": ["in_dir", "--output_dir", "out_dir"],
        "crop": [d, "video.mp4"],
        "remap": ["preds.csv", "bbox.csv"],
        "run_app": [],
    }[cmd]


@pytest.mark.parametrize("cmd", COMMANDS)
def test_all_commands_registered(tmp_path, cmd):
    (tmp_path / "cfg.yaml").write_text("a: 1")
    args = build_parser().parse_args([cmd, *_minimal_args(cmd, tmp_path)])
    assert args.command == cmd
    # the commands that build a model run on the card unless asked
    assert getattr(args, "device", "cuda") == "cuda"


def test_version_flag_exits_zero(capsys):
    import lightning_pose_tpu_torch

    with pytest.raises(SystemExit) as exc:
        build_parser().parse_args(["--version"])
    assert exc.value.code == 0
    assert lightning_pose_tpu_torch.__version__ in capsys.readouterr().out


def test_cli_type_validators(tmp_path):
    from lightning_pose_tpu_torch.cli import types as cli_types

    yaml_file = tmp_path / "c.yaml"
    yaml_file.write_text("a: 1")
    assert cli_types.config_file(str(yaml_file)) == yaml_file
    (tmp_path / "c.txt").write_text("x")
    for bad, match in ((tmp_path / "missing.yaml", "File not found"), (tmp_path / "c.txt", "must be a yaml")):
        with pytest.raises(argparse.ArgumentTypeError, match=match):
            cli_types.config_file(str(bad))
    assert cli_types.existing_model_dir(str(tmp_path)) == tmp_path
    with pytest.raises(argparse.ArgumentTypeError, match="does not exist"):
        cli_types.existing_model_dir(str(tmp_path / "missing"))


def test_friendly_parser_welcome_and_error(capsys):
    parser = build_parser()
    with pytest.raises(SystemExit) as exc:
        parser.parse_args(["--help"])
    assert exc.value.code == 0
    out = capsys.readouterr().out
    assert "Welcome to lightning-pose-tpu" in out and "train" in out and "predict" in out
    with pytest.raises(SystemExit) as exc:
        parser.parse_args(["not-a-command"])
    assert exc.value.code == 2
    err = capsys.readouterr().err
    assert "usage:" in err and "error:" in err
    with pytest.raises(SystemExit):
        parser.parse_args(["predict", "--help"])
    assert "Welcome" not in capsys.readouterr().out


def test_train_detector_model_redirect(tmp_path, monkeypatch):
    """``--detector_model`` points the data at the detector's cropped
    outputs, as the JAX command does; ``--device`` reaches train()."""
    import lightning_pose_tpu.train as jax_train_mod
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.train import trainer

    config_file = tmp_path / "config.yaml"
    cfg = load_config()
    cfg.data.csv_file = "CollectedData.csv"
    cfg.save(str(config_file))
    captured = {}
    monkeypatch.setattr(trainer, "train", lambda c, model_dir=None, device="cuda": captured.update(port=c, device=device))
    monkeypatch.setattr(jax_train_mod, "train", lambda c, model_dir=None, **kw: captured.update(jax=c))
    detector = tmp_path / "detector"
    args = ["train", str(config_file), "--detector_model", str(detector), "--output_dir", str(tmp_path / "out")]
    assert main([*args, "--device", "cpu"]) == 0 and jax_main(args) == 0
    got = captured["port"].data
    assert got.data_dir == str(detector / "cropped_images")
    assert got.video_dir == str(detector / "cropped_videos")
    assert got.csv_file == str(detector / "image_preds" / "CollectedData.csv" / "cropped_CollectedData.csv")
    assert (got.data_dir, got.video_dir, got.csv_file) == tuple(
        captured["jax"].data[k] for k in ("data_dir", "video_dir", "csv_file"))
    assert captured["device"] == "cpu"


# -- predict on one model directory ------------------------------------------

@pytest.fixture(scope="module")
def cli_model_dir(tmp_path_factory, seeded_jax_variables) -> Path:
    """A labeled set of 6 frames (100 x 120) with a 12-frame video, and a
    model directory on it written by the JAX package: resnet18 at 128 px,
    seeded weights, the head scaled so that its maps are peaked."""
    import jax.numpy as jnp

    from lightning_pose_tpu.models.factory import get_model
    from lightning_pose_tpu.train import checkpoints as ckpt_utils
    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    root = tmp_path_factory.mktemp("cli")
    data = write_labeled_dataset(root / "data", 6, 100, 120, NAMES, seed=1)
    write_unlabeled_video(data, "session0", 12, 100, 120, n_blobs=3, seed=0)
    cfg = load_config()
    cfg.data.data_dir = str(data)
    cfg.data.video_dir = "videos"
    cfg.data.csv_file = "CollectedData.csv"
    cfg.data.num_keypoints = len(NAMES)
    cfg.data.keypoint_names = NAMES
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = IMAGE
    cfg.model.backbone = "resnet18"
    cfg.model.model_name = "clitest"
    cfg.model.losses_to_use = []
    cfg.dali.base.predict.sequence_length = 8
    module, _ = get_model(cfg)
    variables = seeded_jax_variables(module, jnp.zeros((1, IMAGE, IMAGE, 3)), train=False, seed=2)
    for name, layer in variables["params"]["head"].items():
        if name.startswith("deconv"):
            layer["kernel"] = layer["kernel"] * HEAD_SCALE
    model_dir = root / "model"
    ckpt_dir = Path(ckpt_utils.checkpoint_dir(ckpt_utils.next_version_dir(str(model_dir), "clitest")))
    ckpt_utils.save_checkpoint(str(ckpt_dir / "epoch=1-step=10-best.ckpt"), params=variables["params"],
                               batch_stats=variables["batch_stats"], step=10, epoch=1)
    ckpt_utils.wait_for_saves()
    cfg.save(str(model_dir / "config.yaml"))
    return model_dir


def _copy(model_dir: Path, dest: Path) -> Path:
    return Path(shutil.copytree(model_dir, dest))


def _read(path: Path) -> pd.DataFrame:
    return pd.read_csv(path, header=[0, 1, 2], index_col=0)


def _assert_close(port: pd.DataFrame, ref: pd.DataFrame) -> None:
    assert port.shape == ref.shape and list(port.columns) == list(ref.columns)
    xy = np.isin(port.columns.get_level_values("coords"), ["x", "y"])
    assert float(port.loc[:, ~xy].select_dtypes("number").to_numpy().mean()) > 0.1  # peaked maps
    np.testing.assert_allclose(port.loc[:, xy].to_numpy(), ref.loc[:, xy].to_numpy(), rtol=0, atol=PX_TOL)
    np.testing.assert_allclose(port.loc[:, ~xy].select_dtypes("number").to_numpy(),
                               ref.loc[:, ~xy].select_dtypes("number").to_numpy(), rtol=0, atol=CONF_TOL)


@pytest.mark.parametrize("kind", ["video", "csv"])
def test_predict_matches_litpose_predict(cli_model_dir, tmp_path, kind):
    """``predict`` of a video and of a labeled CSV at fp32 writes the JAX
    ``litpose predict``'s files, with its numbers within slice 1's limits."""
    data = Path(_read_config(cli_model_dir)["data_dir"])
    source = data / "videos" / "session0.mp4" if kind == "video" else data / "CollectedData.csv"
    dirs = {name: _copy(cli_model_dir, tmp_path / name) for name in ("port", "jax")}
    assert main(["predict", str(dirs["port"]), str(source), "--skip_viz", "--precision", "fp32",
                 "--device", "cpu"]) == 0
    assert jax_main(["predict", str(dirs["jax"]), str(source), "--skip_viz", "--precision", "fp32"]) == 0
    out = {"video": Path("video_preds"), "csv": Path("image_preds") / "CollectedData.csv"}[kind]
    written = {name: sorted(p.name for p in (d / out).iterdir() if p.is_file()) for name, d in dirs.items()}
    assert written["port"] == written["jax"]
    preds = "session0.csv" if kind == "video" else "predictions.csv"
    assert preds in written["port"]
    port = _read(dirs["port"] / out / preds)
    assert len(port) == (12 if kind == "video" else 6)
    _assert_close(port, _read(dirs["jax"] / out / preds))


def _read_config(model_dir: Path) -> dict:
    import yaml

    return yaml.safe_load((model_dir / "config.yaml").read_text())["data"]


def test_export_then_exported_runtime_predicts_as_eager(cli_model_dir, tmp_path):
    """``export`` then ``predict --runtime exported`` (with the hidden
    progress file) writes the eager CSV; a CSV input is refused."""
    video = Path(_read_config(cli_model_dir)["data_dir"]) / "videos" / "session0.mp4"
    model_dir = _copy(cli_model_dir, tmp_path / "model")
    assert main(["predict", str(model_dir), str(video), "--skip_viz", "--device", "cpu",
                 "--output_dir", str(tmp_path / "eager")]) == 0
    assert main(["export", str(model_dir), "--device", "cpu"]) == 0
    assert (model_dir / "exports_torch" / "predict.pt2").is_file()
    progress = tmp_path / "progress.json"
    assert main(["predict", str(model_dir), str(video), "--runtime", "exported", "--skip_viz", "--device", "cpu",
                 "--progress_file", str(progress)]) == 0
    np.testing.assert_allclose(_read(model_dir / "video_preds" / "session0.csv").to_numpy(),
                               _read(tmp_path / "eager" / "session0.csv").to_numpy(), rtol=0, atol=1e-5)
    payload = json.loads(progress.read_text())
    assert payload["completed"] == payload["total"] == 2  # 12 frames in batches of 8
    with pytest.raises(ValueError, match="video inputs only"):
        main(["predict", str(model_dir), str(video.parent.parent / "CollectedData.csv"), "--runtime", "exported",
              "--device", "cpu"])


@pytest.mark.parametrize(
    "extra, max_px",
    [(["--data_parallel"], 1e-3), (["--overrides", "eval.video_transfer_format=yuv420"], 3.0)],
    ids=["data_parallel", "yuv420"],
)
def test_predict_unported_options_raise(cli_model_dir, tmp_path, monkeypatch, extra, max_px):
    """The options that raised until they were ported now run:
    ``--data_parallel`` (two patched CPU replicas) gives the plain CSV, and
    the yuv420 transfer stays within a few pixels of the rgb one (the
    chroma of 2x2 blocks is shared)."""
    import torch

    from lightning_pose_tpu_torch.parallel import mesh

    monkeypatch.setattr(mesh, "devices", lambda num_devices=None: [torch.device("cpu")] * 2)
    video = Path(_read_config(cli_model_dir)["data_dir"]) / "videos" / "session0.mp4"
    for name, flags in (("plain", []), ("option", extra)):
        assert main(["predict", str(cli_model_dir), str(video), "--skip_viz", "--device", "cpu",
                     "--output_dir", str(tmp_path / name), *flags]) == 0
    plain, option = _read(tmp_path / "plain" / "session0.csv"), _read(tmp_path / "option" / "session0.csv")
    assert option.shape == plain.shape == (12, 3 * len(NAMES))
    xy = np.isin(plain.columns.get_level_values("coords"), ["x", "y"])
    assert np.abs(option.loc[:, xy].to_numpy() - plain.loc[:, xy].to_numpy()).max() <= max_px


def test_predict_runs_on_the_card_unless_asked(cli_model_dir, tmp_path):
    """No CLI default of the CPU: without ``--device`` the model asks for
    CUDA, which raises where there is none."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["predict", str(cli_model_dir), "video.mp4", "--output_dir", str(tmp_path)])


def test_predict_multiview_session_directory(slice_model_dir, tmp_path):
    """A directory of per-view videos goes through the multiview session
    grouping: one CSV a view, as the JAX command writes."""
    from lightning_pose_tpu_torch.config import Config
    from lightning_pose_tpu_torch.utils.synthetic import write_multiview_videos

    model_dir = _copy(slice_model_dir, tmp_path / "mv")
    cfg = Config.from_yaml(str(model_dir / "config.yaml"))
    cfg.apply_overrides(["data.view_names=[top,bot]", "data.csv_file=[top.csv,bot.csv]"])
    cfg.save(str(model_dir / "config.yaml"))
    write_multiview_videos(tmp_path / "data", "session0", 10, 48, 64, ["top", "bot"], n_blobs=2, seed=0)
    assert main(["predict", str(model_dir), str(tmp_path / "data" / "videos"), "--skip_viz",
                 "--device", "cpu"]) == 0
    for view in ("top", "bot"):
        df = _read(model_dir / "video_preds" / f"session0_{view}.csv")
        assert df.shape == (10, 12) and np.isfinite(df.to_numpy()).all()


# -- the cropzoom commands ------------------------------------------------------

def _fake_model_dir(root: Path, data_dir: Path | None = None) -> Path:
    """A model directory holding only config.yaml: the cropzoom commands use
    its directory conventions, not a checkpoint."""
    model_dir = root / "detector_model"
    model_dir.mkdir(parents=True, exist_ok=True)
    (model_dir / "config.yaml").write_text(
        f"data:\n  data_dir: {data_dir or root}\nmodel:\n  model_name: detector\n  model_type: heatmap\n"
    )
    return model_dir


def _write_preds_csv(path: Path, n: int = 20, keypoints=("a", "b"), index=None) -> None:
    cols = pd.MultiIndex.from_product([["t"], list(keypoints), ["x", "y", "likelihood"]],
                                      names=["scorer", "bodyparts", "coords"])
    values = np.random.default_rng(0).uniform(50, 150, size=(n, len(keypoints) * 3))
    pd.DataFrame(values, columns=cols, index=index).to_csv(path)


def _cropzoom_inputs(root: Path) -> tuple[Path, Path, Path]:
    """A 20-frame 160 x 200 video, a 3-frame labeled set, and a detector
    directory holding the predictions of both."""
    import cv2

    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    data = write_labeled_dataset(root / "proj", 3, 160, 200, ["a", "b"], seed=3, nan_fraction=0.0)
    video = write_unlabeled_video(data, "vid", 20, 160, 200, n_blobs=2, seed=1)
    assert int(cv2.VideoCapture(str(video)).get(cv2.CAP_PROP_FRAME_COUNT)) == 20
    model_dir = _fake_model_dir(root, data)
    (model_dir / "video_preds").mkdir()
    _write_preds_csv(model_dir / "video_preds" / "vid.csv")
    labels = pd.read_csv(data / "CollectedData.csv", header=[0, 1, 2], index_col=0)
    (model_dir / "image_preds" / "CollectedData.csv").mkdir(parents=True)
    _write_preds_csv(model_dir / "image_preds" / "CollectedData.csv" / "predictions.csv", n=3, index=labels.index)
    return model_dir, video, data / "CollectedData.csv"


def test_cropzoom_commands_write_the_jax_files(tmp_path):
    """create_bbox (a video, a CSV), smooth_bbox, crop (the video with the
    smoothed boxes, the labeled frames) and remap, through both command
    lines on copies of the same inputs: the same files, byte for byte (the
    cropped video frame for frame)."""
    import cv2

    runs = {}
    for name, run, device in (("port", main, ["--device", "cpu"]), ("jax", jax_main, [])):
        model_dir, video, csv = _cropzoom_inputs(tmp_path / name)
        assert run(["create_bbox", str(model_dir), str(video), str(csv), "--crop_ratio", "1.5", *device]) == 0
        smoothed = tmp_path / name / "smoothed"
        assert run(["smooth_bbox", str(model_dir / "video_preds"), "--output_dir", str(smoothed)]) == 0
        assert run(["crop", str(model_dir), str(video), "--bbox_dir", str(smoothed), *device]) == 0
        assert run(["crop", str(model_dir), str(csv), *device]) == 0
        assert run(["remap", str(model_dir / "video_preds" / "vid.csv"), str(smoothed / "vid_bbox.csv"),
                    "--output_file", str(tmp_path / name / "remapped.csv")]) == 0
        runs[name] = (model_dir, smoothed)
    files = {}
    for name, (model_dir, smoothed) in runs.items():
        files[name] = {
            "video_bbox": (model_dir / "video_preds" / "vid_bbox.csv").read_text(),
            "csv_bbox": (model_dir / "image_preds" / "CollectedData.csv" / "bbox.csv").read_text(),
            "smoothed": (smoothed / "vid_bbox.csv").read_text(),
            "cropped_csv": (model_dir / "image_preds" / "CollectedData.csv" / "cropped_CollectedData.csv").read_text(),
            "remapped": (tmp_path / name / "remapped.csv").read_text(),
            "images": {p.relative_to(model_dir / "cropped_images").as_posix(): cv2.imread(str(p)).tobytes()
                       for p in sorted((model_dir / "cropped_images").rglob("*.png"))},
        }
    assert files["port"] == files["jax"]
    assert len(files["port"]["images"]) == 3
    bbox = pd.read_csv(runs["port"][1] / "vid_bbox.csv", index_col=0)
    assert list(bbox.columns) == ["x", "y", "h", "w"] and (bbox["h"] % 2 == 0).all()
    frames = [_video_frames(runs[name][0] / "cropped_videos" / "cropped_vid.mp4") for name in ("port", "jax")]
    assert frames[0].shape[0] == 20 and frames[0].shape[1:3] == tuple(int(v) for v in bbox[["h", "w"]].median())
    np.testing.assert_array_equal(frames[0], frames[1])


def _video_frames(path: Path) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(str(path))
    frames = []
    while (read := cap.read())[0]:
        frames.append(read[1])
    cap.release()
    return np.stack(frames)


@pytest.mark.parametrize(
    "flags, match",
    [
        (["--crop_ratio", "2.0", "--crop_size", "64"], "mutually exclusive"),
        (["--crop_ratio", "0.5"], "greater than 1"),
        (["--crop_size", "-4"], "positive"),
        ([], None),  # neither flag: the default crop_ratio 2.0
    ],
)
def test_create_bbox_flag_validation(tmp_path, flags, match):
    model_dir = _fake_model_dir(tmp_path)
    (model_dir / "video_preds").mkdir()
    _write_preds_csv(model_dir / "video_preds" / "v.csv")
    args = ["create_bbox", str(model_dir), "v.mp4", *flags, "--device", "cpu"]
    if match is None:
        assert main(args) == 0 and (model_dir / "video_preds" / "v_bbox.csv").is_file()
    else:
        with pytest.raises(ValueError, match=match):
            main(args)


def test_run_app_without_litpose_app(monkeypatch, capsys):
    """Without ``litpose_app`` the command exits with the JAX command's
    message; nothing gets installed."""
    import sys

    monkeypatch.setitem(sys.modules, "litpose_app", None)  # importing it raises ImportError
    messages = []
    for run in (main, jax_main):
        with pytest.raises(SystemExit) as exc:
            run(["run_app"])
        messages.append(str(exc.value.code))
    assert messages[0] == messages[1] and "lightning-pose-app" in messages[0]


# -- migrations ---------------------------------------------------------------------

def test_migrations_match_jax_and_run_before_dispatch(tmp_path, monkeypatch):
    """``rename_time_directories`` renames ``HH:MM:SS`` directories as the
    JAX package's does, and ``main`` runs the migrations in the working
    directory's ``outputs/`` before any command."""
    from lightning_pose_tpu.migrations.migrations import rename_time_directories as jax_rename
    from lightning_pose_tpu_torch.migrations import rename_time_directories

    trees = {}
    for name, fn in (("port", rename_time_directories), ("jax", jax_rename)):
        root = tmp_path / name
        for d in ("2024-01-01/12:30:45/sub", "2024-01-02/01:02:03", "keep/1:2:3", "keep/12:30:45_model"):
            (root / d).mkdir(parents=True)
        assert fn(root) == 2
        assert fn(tmp_path / "missing") == 0
        trees[name] = sorted(p.relative_to(root).as_posix() for p in root.rglob("*"))
    assert trees["port"] == trees["jax"]
    assert {"2024-01-01/12-30-45/sub", "2024-01-02/01-02-03", "keep/1:2:3", "keep/12:30:45_model"} <= set(trees["port"])

    (tmp_path / "cwd" / "outputs" / "2024-02-02" / "11:22:33").mkdir(parents=True)
    monkeypatch.chdir(tmp_path / "cwd")
    _write_preds_csv(tmp_path / "preds.csv", n=2)
    pd.DataFrame({"x": [1, 2], "y": [3, 4], "h": [8, 8], "w": [8, 8]}).to_csv(tmp_path / "bbox.csv")
    assert main(["remap", str(tmp_path / "preds.csv"), str(tmp_path / "bbox.csv")]) == 0
    assert (tmp_path / "cwd" / "outputs" / "2024-02-02" / "11-22-33").is_dir()
    assert (tmp_path / "remapped_preds.csv").is_file()
