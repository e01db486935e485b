"""Slice 4, semi-supervised training, module by module against the JAX
package: the unlabeled video loader, the video augmentation with the JAX
draws replayed, the undo transform, the keypoint PCA, the four unsupervised
losses and their gradients, the differentiable decode, and the factories."""

from __future__ import annotations

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lightning_pose_tpu.losses import losses as jlosses
from lightning_pose_tpu_torch.losses import losses as plosses

# the video augmentation, JAX's draws replayed: fp32 against fp32 (cos, sin
# and the 3x3 inverse in another library), on 0-255 gray levels
VIDEO_GRAY_TOL = 1e-3
VIDEO_TRANSFORM_TOL = 1e-6
UNDO_PX_TOL = 1e-4
PCA_ERR_TOL = 1e-5
LOSS_TOL = 1e-6
# float64 decode: the same function, summed in another order; the logits
# are 1000 times the upsampled maps, so the keypoints keep about 1e-10 of
# their size (tens of pixels)
GRAD64_RTOL = 1e-8
KP64_TOL_PX = 1e-7
# fp32 decode gradients, relative to the largest entry: the softmax at a
# temperature of 1000 multiplies the upsampled maps' rounding (about 1e-8
# of a value near 0.1) by 1000
GRAD32_RTOL = 1e-3


def _np(x) -> np.ndarray:
    return np.asarray(x.detach().cpu() if isinstance(x, torch.Tensor) else x)


# -- the unlabeled video loader ------------------------------------------------------


@pytest.fixture(scope="module")
def two_videos(slice_video, tmp_path_factory):
    """The conftest's mp4 and one of another size and length, made by the
    port's writer."""
    from lightning_pose_tpu_torch.utils.synthetic import write_unlabeled_video

    second = write_unlabeled_video(tmp_path_factory.mktemp("port_unlabeled"), "drift", 13, 48, 64, seed=3)
    return [str(slice_video), str(second)]


def test_unlabeled_loader_matches_jax(two_videos):
    """The same (video, start) windows, frames and bboxes bitwise; two decode
    threads in the port against one in the JAX package."""
    from lightning_pose_tpu.data.video import UnlabeledVideoLoader as JaxLoader
    from lightning_pose_tpu_torch.data.video import UnlabeledVideoLoader

    ref = JaxLoader(two_videos, 8, 32, 40, seed=7, decode_threads=1)
    out = UnlabeledVideoLoader(two_videos, 8, 32, 40, seed=7, decode_threads=2)
    try:
        assert out.frame_counts == ref.frame_counts == [20, 13]
        assert [out._window_params(k) for k in range(30)] == [ref._window_params(k) for k in range(30)]
        videos = set()
        for k in range(6):
            a, b = next(ref), next(out)
            assert b["frames"].shape == (8, 32, 40, 3) and b["frames"].dtype == np.uint8
            np.testing.assert_array_equal(b["frames"], a["frames"])
            np.testing.assert_array_equal(b["bbox"], a["bbox"])
            videos.add(tuple(b["bbox"][0]))
        assert videos == {(0.0, 0.0, 60.0, 80.0), (0.0, 0.0, 48.0, 64.0)}
    finally:
        ref.close()
        out.close()
    assert not any(t.is_alive() for t in out._threads)


def test_unlabeled_loader_pads_and_refuses(two_videos, tmp_path):
    """A window past a short video's end repeats its last frame; a yuv420
    window is planar I420 (even dims only); missing files raise."""
    from lightning_pose_tpu_torch.data.video import UnlabeledVideoLoader, VideoFrameDecoder

    loader = UnlabeledVideoLoader([two_videos[1]], 16, 24, 32, decode_threads=1)
    try:
        window = next(loader)
        np.testing.assert_array_equal(window["frames"][13:], np.repeat(window["frames"][12:13], 3, axis=0))
    finally:
        loader.close()
    loader = UnlabeledVideoLoader(two_videos, 8, 32, 32, transfer_format="yuv420")
    try:
        assert next(loader)["frames"].shape == (8, 48, 32)
    finally:
        loader.close()
    with pytest.raises(ValueError, match="even"):
        UnlabeledVideoLoader(two_videos, 8, 31, 32, transfer_format="yuv420")
    with pytest.raises(FileNotFoundError):
        UnlabeledVideoLoader([str(tmp_path / "none.mp4")], 8, 32, 32)
    with pytest.raises(ValueError):
        VideoFrameDecoder(two_videos[0]).read()


# -- the video augmentation ------------------------------------------------------------


def _jax_video_draws(rng, t: int, h: int, w: int):
    """The draws ``augment_video_sequence`` of the JAX package makes from
    ``rng``, as the port's ``VideoDraws``."""
    from lightning_pose_tpu_torch.ops.video_augment import VideoDraws

    k_rot, k_scale, k_bright, k_contrast, k_shot, k_noise = jax.random.split(rng, 6)

    def t_(x):
        return torch.from_numpy(np.array(x))

    return VideoDraws(
        angle_deg=t_(jax.random.uniform(k_rot, (), minval=-10.0, maxval=10.0)),
        scale=t_(jax.random.uniform(k_scale, (2,), minval=0.8, maxval=1.2)),
        brightness=t_(jax.random.uniform(k_bright, (), minval=0.75, maxval=1.25)),
        contrast=t_(jax.random.uniform(k_contrast, (), minval=0.75, maxval=1.25)),
        shot_factor=t_(jax.random.uniform(k_shot, (), minval=0.0, maxval=10.0)),
        noise=t_(jax.random.normal(k_noise, (t, h, w, 3), dtype=jnp.float32)),
    )


@pytest.mark.parametrize("apply_geometric", [True, False])
def test_video_augmentation_matches_jax(apply_geometric):
    from lightning_pose_tpu.ops.video_augment import augment_video_sequence as jax_augment
    from lightning_pose_tpu_torch.ops import warp_kernel
    from lightning_pose_tpu_torch.ops.video_augment import augment_video_sequence

    frames = np.random.default_rng(1).integers(0, 256, (6, 40, 56, 3), dtype=np.uint8)
    key = jax.random.fold_in(jax.random.PRNGKey(3), 1)
    ref, ref_m = jax_augment(key, jnp.asarray(frames), apply_geometric=apply_geometric)
    draws = _jax_video_draws(key, 6, 40, 56)
    assert 0.8 <= float(draws.scale.min()) and float(draws.scale.max()) <= 1.2
    before = warp_kernel.launches
    out, m = augment_video_sequence(torch.from_numpy(frames), draws, apply_geometric)
    assert warp_kernel.launches == before  # the CPU runs the plain warp
    assert out.shape == (6, 40, 56, 3) and m.shape == (6, 2, 3)
    np.testing.assert_allclose(_np(m), np.asarray(ref_m), rtol=0, atol=VIDEO_TRANSFORM_TOL)
    np.testing.assert_allclose(_np(out), np.asarray(ref), rtol=0, atol=VIDEO_GRAY_TOL)
    if apply_geometric:  # the warp moved pixels and zero-padded some
        assert not np.allclose(_np(m)[0, :, :2], np.eye(2))


def test_sample_video_draws_ranges_and_devices():
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws

    draws = sample_video_draws(torch.Generator().manual_seed(0), 5, 8, 12)
    assert draws.noise.shape == (5, 8, 12, 3) and draws.scale.shape == (2,)
    assert -10 <= float(draws.angle_deg) <= 10 and 0 <= float(draws.shot_factor) <= 10
    assert 0.75 <= float(draws.brightness) <= 1.25 and 0.75 <= float(draws.contrast) <= 1.25
    again = sample_video_draws(torch.Generator().manual_seed(0), 5, 8, 12)
    assert torch.equal(draws.noise, again.noise) and torch.equal(draws.scale, again.scale)


def test_undo_affine_transform_matches_jax():
    from lightning_pose_tpu.data.video import undo_affine_transform_batch as jax_undo
    from lightning_pose_tpu.ops.video_augment import augment_video_sequence as jax_augment
    from lightning_pose_tpu_torch.data.video import undo_affine_transform_batch

    rng = np.random.default_rng(2)
    _, m = jax_augment(jax.random.PRNGKey(4), jnp.zeros((5, 32, 32, 3)), apply_geometric=True)
    transforms = np.asarray(m).copy()
    transforms[1:3] = np.asarray(jax_augment(jax.random.PRNGKey(5), jnp.zeros((2, 32, 32, 3)))[1])
    kp = rng.uniform(-5, 40, (5, 8)).astype(np.float32)
    ref = np.asarray(jax_undo(jnp.asarray(kp), jnp.asarray(transforms)))
    x = torch.from_numpy(kp).requires_grad_()
    out = undo_affine_transform_batch(x, torch.from_numpy(transforms))
    np.testing.assert_allclose(_np(out), ref, rtol=0, atol=UNDO_PX_TOL)
    out.sum().backward()  # differentiable in the keypoints
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    eye = torch.eye(2, 3).expand(5, 2, 3)
    torch.testing.assert_close(undo_affine_transform_batch(torch.from_numpy(kp), eye), torch.from_numpy(kp))


# -- the keypoint PCA --------------------------------------------------------------------


def _fake_data_module(n: int = 40, k: int = 5, seed: int = 0):
    """A data module as the PCA reads it: ``dataset.keypoints_resized(i)``
    and the train split's indices. Keypoints of a rigid body with noise and
    a few NaN labels."""
    rng = np.random.default_rng(seed)
    template = rng.uniform(-20, 20, (k, 2))
    angles = rng.uniform(-0.5, 0.5, n)
    rot = np.stack([np.stack([np.cos(angles), -np.sin(angles)], -1),
                    np.stack([np.sin(angles), np.cos(angles)], -1)], -2)
    kp = np.einsum("nij,kj->nki", rot, template) + rng.uniform(20, 44, (n, 1, 2)) + rng.normal(0, 1.5, (n, k, 2))
    kp[3, 1] = np.nan
    kp[7, 4] = np.nan
    dataset = SimpleNamespace(keypoints_resized=lambda i: kp[i].astype(np.float32), num_keypoints=k)
    return SimpleNamespace(dataset=dataset, train_dataset=SimpleNamespace(indices=np.arange(3, n)))


@pytest.mark.parametrize(
    "columns, centering",
    [(None, None), ([0, 2, 3, 4], "mean"), (None, "median")],
)
def test_keypoint_pca_matches_jax(columns, centering):
    from lightning_pose_tpu.utils.pca import KeypointPCA as JaxPCA
    from lightning_pose_tpu_torch.utils.pca import KeypointPCA

    dm = _fake_data_module()
    kwargs = dict(loss_type="pca_singleview", data_module=dm, components_to_keep=0.9,
                  columns_for_singleview_pca=columns, centering_method=centering)
    ref, out = JaxPCA(**kwargs), KeypointPCA(**kwargs)
    ref()
    out()
    assert out._n_components_kept == ref._n_components_kept < out.data_arr.shape[1]
    for name in ("mean", "kept_eigenvectors", "discarded_eigenvectors", "epsilon"):
        np.testing.assert_array_equal(np.asarray(out.parameters[name]), np.asarray(ref.parameters[name]), err_msg=name)
    preds = np.random.default_rng(1).uniform(0, 64, (6, 10)).astype(np.float32)
    ref_err = ref.reprojection_error_jax(ref.format_data_jax(jnp.asarray(preds)))
    err = out.reprojection_error_torch(out.format_data_torch(torch.from_numpy(preds)))
    assert err.shape == tuple(ref_err.shape)
    np.testing.assert_allclose(_np(err), np.asarray(ref_err), rtol=0, atol=PCA_ERR_TOL)
    mean, _ = out.device_parameters(torch.device("cpu"), torch.float64)
    assert out.device_parameters(torch.device("cpu"), torch.float64)[0] is mean


def test_multiview_pca_formatting_matches_jax():
    """The torch formatting of keypoints for a multiview PCA (one row per
    keypoint across views) against the JAX package's."""
    from lightning_pose_tpu.utils.pca import KeypointPCA as JaxPCA
    from lightning_pose_tpu_torch.utils.pca import KeypointPCA

    matches = [[0, 1, 2], [3, 4, 5]]
    kp = np.random.default_rng(9).uniform(0, 64, (5, 12)).astype(np.float32)
    ref = JaxPCA("pca_multiview", None, mirrored_column_matches=matches).format_data_jax(jnp.asarray(kp))
    out = KeypointPCA("pca_multiview", None, mirrored_column_matches=matches).format_data_torch(torch.from_numpy(kp))
    np.testing.assert_array_equal(_np(out), np.asarray(ref))


def test_pca_fit_refuses_too_few_samples():
    from lightning_pose_tpu_torch.utils.pca import ComponentChooser, KeypointPCA

    with pytest.raises(ValueError, match="samples"):
        KeypointPCA("pca_singleview", _fake_data_module(n=8))()
    assert ComponentChooser(np.array([0.5, 0.3, 0.2]), 0.75)() == 2
    with pytest.raises(ValueError):
        ComponentChooser(np.array([0.5, 0.5]), 3)


# -- the unsupervised losses -------------------------------------------------------------


@pytest.fixture(scope="module")
def fitted_pcas():
    """The same fit in both packages."""
    from lightning_pose_tpu.utils.pca import KeypointPCA as JaxPCA
    from lightning_pose_tpu_torch.utils.pca import KeypointPCA

    dm = _fake_data_module()
    ref = JaxPCA("pca_singleview", dm, components_to_keep=0.9)
    out = KeypointPCA("pca_singleview", dm, components_to_keep=0.9)
    ref()
    out()
    return ref, out


def _window_keypoints(rng, t=7, k=5):
    kp = np.cumsum(rng.normal(0, 3, (t, k, 2)), axis=0) + 32
    kp[2, 1] = np.nan
    return kp.reshape(t, 2 * k).astype(np.float32)


@pytest.mark.parametrize("epsilon", [0.0, None, 3.0])
def test_pca_loss_and_gradient_match_jax(fitted_pcas, epsilon):
    ref_pca, pca = fitted_pcas
    kp = _window_keypoints(np.random.default_rng(3))
    ref_loss_fn = jlosses.PCALoss("pca_singleview", ref_pca, epsilon=epsilon, log_weight=0.5)
    loss_fn = plosses.PCALoss("pca_singleview", pca, epsilon=epsilon, log_weight=0.5)
    assert loss_fn.weight == ref_loss_fn.weight
    (ref, logs_ref), grad_ref = jax.value_and_grad(
        lambda x: ref_loss_fn(x, stage="train"), has_aux=True)(jnp.asarray(kp))
    x = torch.from_numpy(kp).requires_grad_()
    out, logs = loss_fn(x, stage="train")
    out.backward()
    assert set(logs) == set(logs_ref) and float(out.detach()) > 0
    np.testing.assert_allclose(float(out.detach()), float(ref), rtol=LOSS_TOL, atol=LOSS_TOL)
    # the NaN keypoint's row: NaN gradients in both, at the same entries
    np.testing.assert_allclose(_np(x.grad), np.asarray(grad_ref), rtol=0, atol=LOSS_TOL)


@pytest.mark.parametrize("epsilon, threshold", [(0.0, 0.0), (2.0, 0.3), ([0.0, 1.0, 2.0, 3.0, 4.0], 0.3)])
def test_temporal_loss_and_gradient_match_jax(epsilon, threshold):
    rng = np.random.default_rng(4)
    kp = _window_keypoints(rng)
    kp[4] = np.nan_to_num(kp[4])
    kp = np.nan_to_num(kp, nan=30.0)
    conf = rng.uniform(0, 1, (7, 5)).astype(np.float32)
    ref_fn = jlosses.TemporalLoss(epsilon=epsilon, prob_threshold=threshold)
    fn = plosses.TemporalLoss(epsilon=epsilon, prob_threshold=threshold)
    (ref, _), grad_ref = jax.value_and_grad(
        lambda x: ref_fn(x, jnp.asarray(conf), stage="train"), has_aux=True)(jnp.asarray(kp))
    x = torch.from_numpy(kp).requires_grad_()
    out, logs = fn(x, torch.from_numpy(conf), stage="train")
    out.backward()
    assert set(logs) == {"train_temporal_loss", "temporal_weight"} and float(out.detach()) > 0
    np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL, atol=LOSS_TOL)
    np.testing.assert_allclose(_np(x.grad), np.asarray(grad_ref), rtol=0, atol=LOSS_TOL)
    out_none, _ = fn(torch.from_numpy(kp))  # no confidences: nothing masked
    ref_none, _ = ref_fn(jnp.asarray(kp))
    np.testing.assert_allclose(float(out_none), float(ref_none), rtol=LOSS_TOL)


def _softmaxed_maps(rng, b, k, h, w) -> np.ndarray:
    z = rng.standard_normal((b, k, h * w)) * 2
    e = np.exp(z - z.max(-1, keepdims=True))
    return (e / e.sum(-1, keepdims=True)).reshape(b, k, h, w).astype(np.float32)


@pytest.mark.parametrize("name", ["temporal_heatmap_mse", "temporal_heatmap_kl"])
def test_temporal_heatmap_loss_matches_jax(name):
    rng = np.random.default_rng(5)
    maps = _softmaxed_maps(rng, 6, 4, 16, 16)
    conf = rng.uniform(0, 1, (6, 4)).astype(np.float32)
    ref, ref_logs = jlosses.TemporalHeatmapLoss(name, prob_threshold=0.3)(
        jnp.asarray(maps.transpose(0, 2, 3, 1)), jnp.asarray(conf), stage="train")
    out, logs = plosses.TemporalHeatmapLoss(name, prob_threshold=0.3)(
        torch.from_numpy(maps), torch.from_numpy(conf), stage="train")
    assert set(logs) == set(ref_logs)
    np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL, atol=1e-9)
    with pytest.raises(ValueError):
        plosses.TemporalHeatmapLoss("temporal")


@pytest.mark.parametrize("name", ["unimodal_mse", "unimodal_kl", "unimodal_js"])
def test_unimodal_loss_matches_jax(name):
    rng = np.random.default_rng(6)
    maps = _softmaxed_maps(rng, 3, 4, 16, 16)
    kp = rng.uniform(0, 64, (3, 8)).astype(np.float32)
    kp[0, 2:4] = np.nan
    conf = rng.uniform(0, 1, (3, 4)).astype(np.float32)
    args = dict(loss_name=name, original_image_height=64, original_image_width=64,
                downsampled_image_height=16, downsampled_image_width=16, prob_threshold=0.4)
    ref, ref_logs = jlosses.UnimodalLoss(**args)(
        jnp.asarray(kp), jnp.asarray(maps.transpose(0, 2, 3, 1)), jnp.asarray(conf), stage="train")
    out, logs = plosses.UnimodalLoss(**args)(torch.from_numpy(kp), torch.from_numpy(maps), torch.from_numpy(conf),
                                             stage="train")
    assert set(logs) == set(ref_logs)
    np.testing.assert_allclose(float(out), float(ref), rtol=LOSS_TOL, atol=1e-9)


# -- the differentiable decode -------------------------------------------------------------


def _jax_decode64(heatmaps_nhwc, df: int):
    """The JAX package's XLA decode (``run_subpixelmaxima``, fast=False) in
    float64: its own pieces, with the upsample in float64 where the JAX
    function casts the maps to float32."""
    from lightning_pose_tpu.data.heatmaps import evaluate_heatmaps_at_location
    from lightning_pose_tpu.ops.pallas_decode import upsample_matrix
    from lightning_pose_tpu.ops.softargmax import spatial_expectation2d, spatial_softmax2d

    h, w = heatmaps_nhwc.shape[1:3]
    if df > 0:
        mh = jnp.asarray(upsample_matrix(h, df), jnp.float64)
        mw = jnp.asarray(upsample_matrix(w, df), jnp.float64)
        heatmaps_nhwc = jnp.einsum("ph,bhwk,qw->bpqk", mh, heatmaps_nhwc, mw)
    softmaxes = spatial_softmax2d(heatmaps_nhwc, temperature=1000.0)
    preds = spatial_expectation2d(softmaxes)
    confidences = evaluate_heatmaps_at_location(softmaxes, preds)
    preds = preds - {0: 0.0, 1: 0.5, 2: 1.5, 3: 2.5}[df]
    return preds.reshape(preds.shape[0], -1), confidences


@pytest.mark.parametrize("df, h, w", [(2, 12, 20), (0, 16, 16), (1, 10, 8)])
def test_decode_gradient_float64_matches_jax(df, h, w):
    """The port's CPU decode differentiated by autograd against jax.grad of
    the JAX decode, float64 in both (at df 0, ``run_subpixelmaxima`` itself,
    which casts nothing there)."""
    from lightning_pose_tpu.ops.softargmax import run_subpixelmaxima as jax_decode
    from lightning_pose_tpu_torch.ops.softargmax import run_subpixelmaxima

    rng = np.random.default_rng(7 + df)
    maps = _softmaxed_maps(rng, 3, 4, h, w).astype(np.float64)
    g = rng.standard_normal((3, 8))
    with jax.enable_x64(True):
        fn = (lambda x: jax_decode(x, df)) if df == 0 else (lambda x: _jax_decode64(x, df))
        kp_ref = np.asarray(fn(jnp.asarray(maps.transpose(0, 2, 3, 1)))[0])
        grad_ref = np.asarray(jax.grad(lambda x: jnp.sum(fn(x)[0] * g))(jnp.asarray(maps.transpose(0, 2, 3, 1))))
    x = torch.from_numpy(maps).requires_grad_()
    kp, _ = run_subpixelmaxima(x, df)
    assert kp.dtype == torch.float64
    (kp * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(_np(kp), kp_ref, rtol=0, atol=KP64_TOL_PX)
    scale = np.abs(grad_ref).max()
    np.testing.assert_allclose(_np(x.grad), grad_ref.transpose(0, 3, 1, 2), rtol=0, atol=GRAD64_RTOL * scale)


def test_decode_gradient_fp32_matches_jax():
    """fp32 in both, ``run_subpixelmaxima(fast=False)`` itself at df 2,
    through the model's ``decode``."""
    from lightning_pose_tpu.ops.softargmax import run_subpixelmaxima as jax_decode
    from lightning_pose_tpu_torch.models.heatmap_tracker import HeatmapTracker

    rng = np.random.default_rng(8)
    maps = _softmaxed_maps(rng, 4, 3, 16, 16)
    g = rng.standard_normal((4, 6)).astype(np.float32)
    grad_ref = np.asarray(jax.grad(lambda x: jnp.sum(jax_decode(x, 2)[0] * g))(jnp.asarray(maps.transpose(0, 2, 3, 1))))
    model = HeatmapTracker("resnet18", num_keypoints=3)
    x = torch.from_numpy(maps).requires_grad_()
    kp, _ = model.decode(x)
    (kp * torch.from_numpy(g)).sum().backward()
    scale = np.abs(grad_ref).max()
    np.testing.assert_allclose(_np(x.grad), grad_ref.transpose(0, 3, 1, 2), rtol=0, atol=GRAD32_RTOL * scale)
    with torch.no_grad():  # the forward-only path: no graph
        assert model.decode(x)[0].grad_fn is None


# -- factories ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def semisup_data(tmp_path_factory):
    """A small labeled set with two unlabeled mp4s in its videos/."""
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    root = write_labeled_dataset(tmp_path_factory.mktemp("port_semisup") / "data", 24, 70, 80,
                                 ["a", "b", "c", "d"], seed=2)
    for i in range(2):
        write_unlabeled_video(root, f"session{i}", 12, 60, 80, seed=i)
    return root


def _semisup_cfg(root):
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(root)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = 4
    cfg.data.keypoint_names = ["a", "b", "c", "d"]
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = 128
    cfg.model.losses_to_use = ["pca_singleview", "temporal"]
    cfg.dali.base.train.sequence_length = 6
    cfg.training.train_batch_size = 8
    cfg.training.train_prob = 0.9
    cfg.training.val_prob = 0.1
    return cfg


def test_factories_build_the_semisupervised_module(semisup_data):
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu_torch.data.datamodules import BaseDataModule
    from lightning_pose_tpu_torch.data.factory import get_data_module, get_dataset
    from lightning_pose_tpu_torch.data.unlabeled import UnlabeledDataModule
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.train.trainer import calculate_steps_per_epoch

    cfg = _semisup_cfg(semisup_data)
    dataset = get_dataset(cfg, str(semisup_data))
    dm = get_data_module(cfg, dataset, str(semisup_data / "videos"))
    try:
        assert isinstance(dm, UnlabeledDataModule)
        assert calculate_steps_per_epoch(dm) == 10  # ceil(21 / 8) = 3, raised to 10
        window = next(dm.unlabeled_loader)
        assert window["frames"].shape == (6, 128, 128, 3) and window["bbox"].shape == (6, 4)
        factories = get_loss_factories(cfg, dm)
        ref = jax_factories(cfg, dm)
        unsup = factories["unsupervised"].loss_instance_dict
        assert list(unsup) == list(ref["unsupervised"].loss_instance_dict) == ["pca_singleview", "temporal"]
        assert unsup["temporal"].epsilon == 20.0 and unsup["temporal"].prob_threshold == 0.05
        np.testing.assert_array_equal(unsup["pca_singleview"].pca.parameters["kept_eigenvectors"],
                                      ref["unsupervised"].loss_instance_dict["pca_singleview"].pca.parameters[
                                          "kept_eigenvectors"])
        assert unsup["pca_singleview"].epsilon == pytest.approx(
            float(ref["unsupervised"].loss_instance_dict["pca_singleview"].epsilon))
    finally:
        dm.close()
    cfg.model.losses_to_use = []
    assert type(get_data_module(cfg, dataset, str(semisup_data / "videos"))) is BaseDataModule


@pytest.mark.parametrize(
    "change, error, match",
    [
        ({"losses_to_use": ["pca_singleview"], "view_names": ["top", "bot"]}, NotImplementedError,
         "not implemented for multiview data"),
        ({"losses_to_use": ["unimodal_mse"], "model_type": "regression"}, NotImplementedError,
         "only be used with heatmap models"),
        ({"view_names": ["top", "bot"], "model_type": "regression"}, NotImplementedError, "heatmap-based models"),
    ],
)
def test_factories_refuse_what_is_not_ported(semisup_data, change, error, match):
    """What the port refuses, as the JAX package does (pca_singleview on
    multiview data, a unimodal loss on the regression model, a regression
    model on multiview data)."""
    from lightning_pose_tpu.data.factory import get_dataset as jax_get_dataset
    from lightning_pose_tpu.losses.factory import get_loss_factories as jax_factories
    from lightning_pose_tpu_torch.data.factory import get_data_module
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories

    from lightning_pose_tpu_torch.data.factory import get_dataset

    cfg = _semisup_cfg(semisup_data)
    if "view_names" in change:
        cfg.data.view_names = change["view_names"]
    if "model_type" in change:
        cfg.model.model_type = change["model_type"]
    with pytest.raises(error, match=match):
        if "losses_to_use" in change:
            cfg.model.losses_to_use = change["losses_to_use"]
            get_loss_factories(cfg)
        else:
            get_dataset(cfg, str(semisup_data))
    with pytest.raises(error, match=match):  # the JAX package's own refusals
        if "losses_to_use" in change:
            jax_factories(cfg)
        else:
            jax_get_dataset(cfg, str(semisup_data))


def test_data_module_streams_yuv420_as_the_jax_package(semisup_data):
    """``training.video_transfer_format: yuv420`` makes the single-view
    stream's windows planar I420, the JAX data module's windows bitwise."""
    from lightning_pose_tpu.data.factory import get_data_module as jax_get_data_module
    from lightning_pose_tpu_torch.data.factory import get_data_module, get_dataset

    cfg = _semisup_cfg(semisup_data)
    cfg.training.video_transfer_format = "yuv420"
    dataset = get_dataset(cfg, str(semisup_data))
    dm = get_data_module(cfg, dataset, str(semisup_data / "videos"))
    ref = jax_get_data_module(cfg, dataset, str(semisup_data / "videos"))
    try:
        for _ in range(2):
            window, expected = next(dm.unlabeled_loader), next(ref.unlabeled_loader)
            assert window["frames"].shape == (6, 192, 128) and window["frames"].dtype == np.uint8
            np.testing.assert_array_equal(window["frames"], expected["frames"])
            np.testing.assert_array_equal(window["bbox"], expected["bbox"])
    finally:
        dm.close()
        ref.close()


def test_empty_loss_factory_total_lies_on_the_inputs_device():
    from lightning_pose_tpu_torch.losses.factory import LossFactory

    total, logs = LossFactory({})(stage="train", keypoints_pred=torch.zeros(3, 4, dtype=torch.float64))
    assert float(total) == 0.0 and total.device.type == "cpu" and logs == {}
    with pytest.raises(ValueError, match="data_module"):
        LossFactory({"pca_singleview": {"loss_name": "pca_singleview"}})
