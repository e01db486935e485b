"""Slice 6, the context model's host layer and augmentation against the JAX
package's: context-frame paths, 5-frame context stacks from the labeled
dataset, the overlapping video windows of the predict loader, the shift of
a context model's video rows to their frames, and the engine on context
stacks with the JAX engine's draws replayed."""

from __future__ import annotations

from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pandas as pd
import pytest
import torch

from lightning_pose_tpu.data.datasets import HeatmapDataset as JaxDataset
from lightning_pose_tpu.data.video import PredictVideoLoader as JaxLoader
from lightning_pose_tpu.ops import augment as jaug
from lightning_pose_tpu.utils import io as jax_io
from lightning_pose_tpu.utils.predictions import PredictionHandler as JaxHandler
from lightning_pose_tpu_torch.config import load_config
from lightning_pose_tpu_torch.data.datasets import HeatmapDataset
from lightning_pose_tpu_torch.data.video import PredictVideoLoader
from lightning_pose_tpu_torch.ops import augment as paug
from lightning_pose_tpu_torch.utils import io
from lightning_pose_tpu_torch.utils.predictions import PredictionHandler
from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

NAMES = ["nose", "tail", "paw_left", "paw_right"]
FRAMES = 6
# the whole engine: as in test_torch_augment.py
KP_TOL = 1e-3
IMG_TOL = 1.0
IMG_OFF_SHARE = 2e-3


@pytest.mark.parametrize("name", ["labeled-data/img0000.png", "labeled-data/img0001.png", "labeled-data/img0063.png",
                                  "s/frame_07.jpg", "a1/cam1_img0010_cam1.png"])
def test_get_context_img_paths_matches_jax(name):
    out = io.get_context_img_paths(Path(name))
    assert out == jax_io.get_context_img_paths(Path(name))
    assert len(out) == 5 and out[2] == Path(name)


def test_get_context_img_paths_floors_at_0_and_keeps_the_digits():
    assert [p.name for p in io.get_context_img_paths(Path("img0001.png"))] == [
        "img0000.png", "img0000.png", "img0001.png", "img0002.png", "img0003.png"]
    with pytest.raises(ValueError, match="frame index"):
        io.get_context_img_paths(Path("frame.png"))


@pytest.fixture(scope="module")
def data_dir(tmp_path_factory) -> Path:
    """6 consecutive labeled frames (img0000-img0005) and a bbox file."""
    root = write_labeled_dataset(tmp_path_factory.mktemp("port_ctx_data") / "data", FRAMES, 140, 150, NAMES, seed=2)
    names = pd.read_csv(root / "CollectedData.csv", header=[0, 1, 2], index_col=0).index
    rng = np.random.default_rng(3)
    boxes = np.stack([rng.integers(0, 20, FRAMES), rng.integers(0, 20, FRAMES),
                      rng.integers(100, 120, FRAMES), rng.integers(100, 130, FRAMES)], -1)
    pd.DataFrame(boxes.astype(float), index=names, columns=["x", "y", "h", "w"]).to_csv(root / "bbox.csv")
    return root


@pytest.mark.parametrize("context_mode", ["adjacent", "repeat_center"])
@pytest.mark.parametrize("bbox", [False, True])
def test_context_stacks_match_jax(data_dir, context_mode, bbox):
    """The first, second and last frames' stacks: neighbours past the ends
    repeat the center, all five crop through the center's bbox, and
    repeat_center stacks 5 copies of the resized center."""
    kwargs = dict(root_directory=str(data_dir), csv_path="CollectedData.csv", image_resize_height=128,
                  image_resize_width=128, imgaug_pipeline="default", do_context=True, context_mode=context_mode,
                  bbox_path="bbox.csv" if bbox else None)
    port, ref = HeatmapDataset(**kwargs), JaxDataset(**kwargs)
    for i in (0, 1, FRAMES - 1):
        a, b = port[i], ref[i]
        assert a["images"].shape == (5, 128, 128, 3) and a["images"].dtype == np.uint8
        for key in ("images", "keypoints", "visibility", "bbox"):
            np.testing.assert_array_equal(a[key], b[key], err_msg=f"{key} of frame {i}")
        center = port._load_resized(i)[0]
        np.testing.assert_array_equal(a["images"][2], center)
        if context_mode == "repeat_center":
            assert all(np.array_equal(f, center) for f in a["images"])
    if context_mode == "adjacent":
        last = port[FRAMES - 1]["images"]  # frames 6 and 7 are missing
        np.testing.assert_array_equal(last[3], last[2])
        assert not np.array_equal(last[1], last[2])
    with pytest.raises(ValueError, match="context_mode"):
        HeatmapDataset(**{**kwargs, "context_mode": "random"})


@pytest.fixture(scope="module")
def videos(tmp_path_factory) -> dict[int, Path]:
    root = tmp_path_factory.mktemp("port_ctx_videos")
    return {n: write_unlabeled_video(root, f"v{n}", n, 40, 56, seed=n) for n in (5, 7, 12, 100)}


@pytest.mark.parametrize("n_frames", [5, 7, 12, 100])
@pytest.mark.parametrize("decode_threads", [1, 3])
def test_context_video_windows_match_jax(videos, n_frames, decode_threads):
    """Windows of 8 frames stepping by 4, the tail FILL-padded with the last
    frame, from the serial producer and the threaded seek path."""
    args = (str(videos[n_frames]), 8, 32, 48)
    port_loader = PredictVideoLoader(*args, decode_threads=decode_threads, do_context=True)
    port = list(port_loader)
    ref = list(JaxLoader(*args, do_context=True, decode_threads=decode_threads))
    assert len(port) == len(port_loader) == len(ref) == int(np.ceil(max(n_frames - 4, 1) / 4))
    for a, b in zip(port, ref):
        assert a.shape == (8, 32, 48, 3)
        np.testing.assert_array_equal(a, b)
    if len(port) > 1:  # each window starts 4 frames after the last
        np.testing.assert_array_equal(port[1][:4], port[0][4:])
    serial = list(PredictVideoLoader(*args, decode_threads=1, do_context=True))
    for a, b in zip(port, serial):
        np.testing.assert_array_equal(a, b)


def test_context_video_loader_refuses_short_sequences(videos):
    with pytest.raises(ValueError, match="at least 5"):
        PredictVideoLoader(str(videos[12]), 4, 32, 48, do_context=True)


def _context_cfg():
    cfg = load_config()
    cfg.model.model_type = "heatmap_mhcrnn"
    cfg.data.keypoint_names = ["a", "b", "c"]
    return cfg


@pytest.mark.parametrize("n_frames, n_rows", [(12, 8), (100, 96), (5, 4), (7, 4)])
def test_context_rows_move_to_their_frames_as_in_jax(videos, tmp_path, n_frames, n_rows):
    """The loader's windows give ``n_rows`` rows (8-frame batches, 4 windows
    each); the handler trims them to the frame count, moves row i to frame
    i+2, patches the edges, and pads a short video's tail with row 0."""
    rng = np.random.default_rng(n_frames)
    preds = [(rng.uniform(0, 80, (4, 6)).astype(np.float32), rng.uniform(0, 1, (4, 3)).astype(np.float32))
             for _ in range(n_rows // 4)]
    video = str(videos[n_frames])
    port = PredictionHandler(cfg=_context_cfg(), video_file=video)
    ref = JaxHandler(cfg=_context_cfg(), video_file=video)
    kp, conf = port.unpack_preds(preds)
    ref_kp, ref_conf = ref.unpack_preds(preds)
    assert kp.shape == (n_frames, 6) and port.do_context
    np.testing.assert_array_equal(kp, ref_kp)
    np.testing.assert_array_equal(conf, ref_conf)
    rows = np.vstack([p[0] for p in preds])
    np.testing.assert_array_equal(kp[2], rows[0])
    if n_rows >= n_frames:
        np.testing.assert_array_equal(kp[-1], rows[n_frames - 3])
    else:
        np.testing.assert_array_equal(kp[-1], rows[0])
    port(preds).to_csv(tmp_path / "port.csv")
    ref(preds).to_csv(tmp_path / "ref.csv")
    assert (tmp_path / "port.csv").read_text() == (tmp_path / "ref.csv").read_text()


# -- the engine on context stacks --------------------------------------------------------

B, T, H, W, K = 4, 5, 128, 128, 6


def _stacks(rng) -> np.ndarray:
    yy, xx = np.mgrid[0:H, 0:W] / H
    base = 127.5 + 100 * np.sin(6 * xx + rng.uniform(0, 6, (B, T, 1, 1)))[..., None] * np.cos(4 * yy)[..., None]
    return np.clip(base + rng.normal(0, 20, (B, T, H, W, 3)), 0, 255).round().astype(np.uint8)


def _firing_seed(jax_engine, jax_draws) -> int:
    """A seed whose draws fire histeq, CLAHE and emboss on some stacks,
    never histeq and CLAHE on one (test_torch_augment.py)."""
    for seed in range(400):
        d = jax_draws(jax_engine, jax.random.PRNGKey(seed), B)
        he, cl, em = (d.histeq_u < 0.1), (d.clahe_u < 0.1), (d.emboss_u < 0.1)
        if he.any() and cl.any() and em.any() and not (he & cl).any():
            return seed
    raise AssertionError("no seed fires histeq, CLAHE and emboss apart")


@pytest.mark.parametrize("pipeline", ["dlc-top-down"])
def test_engine_on_context_stacks_matches_jax(pipeline, jax_draws):
    rng = np.random.default_rng(11)
    stacks = _stacks(rng)
    keypoints = rng.uniform(-4, 132, (B, K, 2)).astype(np.float32)
    visibility = rng.integers(0, 3, (B, K)).astype(np.int32)
    jax_engine = jaug.AugmentationEngine(pipeline, H, W)
    key = jax.random.PRNGKey(_firing_seed(jax_engine, jax_draws))
    ref_img, ref_kp, ref_vis = (np.asarray(a) for a in jax_engine(
        key, jnp.asarray(stacks), jnp.asarray(keypoints), jnp.asarray(visibility)))
    out_img, out_kp, out_vis = paug.AugmentationEngine(pipeline, H, W).apply(
        torch.from_numpy(stacks), torch.from_numpy(keypoints), torch.from_numpy(visibility),
        jax_draws(jax_engine, key, B))
    out_img, out_kp = out_img.numpy(), out_kp.numpy()
    assert out_img.shape == ref_img.shape == (B, T, H, W, 3)
    np.testing.assert_array_equal(np.isnan(out_kp), np.isnan(ref_kp))
    np.testing.assert_allclose(out_kp[~np.isnan(out_kp)], ref_kp[~np.isnan(ref_kp)], rtol=0, atol=KP_TOL)
    np.testing.assert_array_equal(out_vis.numpy(), ref_vis)
    off = float((np.abs(out_img - ref_img) > IMG_TOL).mean())
    assert off <= IMG_OFF_SHARE, f"{off:.2e} of pixels differ by more than {IMG_TOL}"


def test_engine_gives_every_frame_of_a_stack_the_same_transform():
    """Stacks of 5 copies of one image come out as 5 copies of one
    augmented image, which is that image augmented alone with the same
    draws; the fired rare ops cover every frame of a fired stack."""
    rng = np.random.default_rng(12)
    images = _stacks(rng)[:, 0]
    stacks = np.repeat(images[:, None], T, axis=1)
    keypoints = torch.from_numpy(rng.uniform(0, 128, (B, K, 2)).astype(np.float32))
    engine = paug.AugmentationEngine("dlc", H, W)
    draws = engine.sample(torch.Generator().manual_seed(0), B)
    draws.histeq_u[0] = draws.clahe_u[1] = draws.emboss_u[2] = 0.0
    draws.histeq_u[1:] = draws.clahe_u[[0, 2, 3]] = draws.emboss_u[[0, 1, 3]] = 1.0
    out, kp = engine.apply(torch.from_numpy(stacks), keypoints, None, draws)
    single, kp_single = engine.apply(torch.from_numpy(images), keypoints, None, draws)
    np.testing.assert_array_equal(kp.numpy(), kp_single.numpy())
    for t in range(T):
        np.testing.assert_array_equal(out[:, t].numpy(), single.numpy())
