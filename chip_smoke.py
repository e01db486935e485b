#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: CUDA must be available (there is no CPU path); prints the
     ``nvidia-smi`` name and power limit.
  2. build: every kernel from the sources in the checkout, the CUDA sources
     (decode, its backward, warp, CLAHE) by one nvcc each, started together,
     then the Triton kernel (normalize) by its first call.
  3. kernel vs plain PyTorch version on the card, at the product shapes;
     the decode's backward kernel against autograd of the plain decode (544
     maps, 64 -> 256; a rectangular shape; df 3), and the decode forward
     with its log-sum-exp output on against off, bitwise; then the
     augmentation engine on the card against the same call on the CPU
     (plain versions), with the same draws.
  4. inference path: a ResNet-50 heatmap model (256 px, 17 keypoints, df 2,
     bf16) with seeded weights loaded through the flax bridge predicts 4
     batches of 96 frames; normalize and decode launch once per batch.
  5. the same model at fp32 on the card and on the CPU (plain versions).
  6. file path: Model.from_dir(dir).predict_on_video_file(video) on a
     written config, checkpoint and synthetic mp4 (timed without metrics),
     then with its defaults (the temporal-norm CSV) and
     generate_labeled_video=True (the labeled mp4); whether the native
     frame ops loaded.
  7. times of each kernel, its plain version and, for the warp, the one
     PyTorch call that computes the same function (F.grid_sample), with the
     least time the card could take (bound) and the share of it reached;
     CLAHE also at 6 image-channels (a train step's fired subset); the
     predict step's frames/s at batch 96. The memory-bound kernels
     (normalize, warp, CLAHE) are timed one launch at a time with the L2
     flushed before each; the decode, bound by FP32 operations, back to
     back. The warp kernel and F.grid_sample alternate over 5 rounds and
     each reports its median round.
  8. training path: train(cfg, dir) of the default model (ResNet-50, 256 px,
     batch 16, dlc augmentation, Adam with the multistep and unfreeze
     schedules) for 20 steps on a synthetic labeled set, with its
     evaluation (image_preds/<csv>/predictions.csv, the pixel-error CSV, the
     legacy copies); the warp kernel launches once per step, CLAHE at least
     once, the decode once per train step, validation batch and evaluation
     batch, the normalize once per evaluation batch; then
     Model.from_dir(dir).predict_on_video_file(video) from what it wrote.
 8b. labeled-CSV path: Model.from_dir(dir).predict_on_label_csv(csv) of the
     trained directory at bf16 (normalize and decode once per batch), then
     at fp32 on the card against the port on the CPU.
  9. times of the train step (and of its augmentation) at batch 16, and the
     training path's peak device memory.
 10. semi-supervised step, card against CPU: resnet18, 128 px, 4 labeled
     frames and an 8-frame window, fp32 with TF32 off, the same draws, the
     unsupervised losses at weight 1/2 and epsilons 0: parameter gradients.
 11. semi-supervised training path: train(cfg, dir) of the default model
     with losses_to_use [pca_singleview, temporal] (batch 16 with dlc, one
     32-frame window a step from two synthetic mp4s) for 20 steps, with its
     evaluation: the labeled frames (pixel-error and PCA CSVs) and the two
     mp4s as test videos (temporal-norm CSVs, labeled mp4s); the warp
     launches twice a step, the decode's backward once, its forward twice a
     step and once per validation and evaluation batch; then prediction
     from the directory. Times: the step at full width, the device's busy share and
     the backward kernel's share of it (torch.profiler), peak memory, the
     backward kernel beside its plain version, its bound and the time
     PERF.md records for its first design (BACKWARD_FIRST_DESIGN_MS), and the warp at
     the window's shape (32, 256, 256, 3) with the L2 flushed.
 12. the context model (heatmap_mhcrnn: 5-frame stacks, single-frame and
     CRNN multi-frame heads), ResNet-50, 256 px, 17 keypoints, bf16:
     a. train(cfg, dir) supervised, 10 steps of 16 stacks with dlc, with its
        evaluation; launches of the warp (once a step over 80 images), CLAHE
        (once a step whose seeded draws fire it) and the decode (once a step
        over both heads' 32 maps, once a validation batch, twice an
        evaluation batch) each against that count; then the step's ms,
        frames/s, device busy share (torch.profiler) and peak memory;
     b. from its directory: predict_on_video_file of a 1000-frame mp4 (11
        batches of 92 windows; normalize once and decode twice a batch, one
        finite row per frame), run 3 times: frames/s of the first (cold) run
        and of the two after it; predict_on_label_csv, predict_frame of a
        (5, H, W, 3) stack, and fp32 card (TF32 off) vs CPU;
     c. the directory with mhcrnn_context_mode repeat_center: the backbone
        takes one image a window (counted by a hook), and the outputs equal
        adjacent mode's on repeated stacks;
     d. train(cfg, dir) semi-supervised (pca_singleview + temporal; 16
        stacks and the 28 windows of a 32-frame window a step), 10 steps:
        the decode's backward twice a step; the step's ms, busy share and
        the backward's share of device time;
     e. each kernel at the shapes of the path whose launches the JSON
        summary counts, beside its plain version and bound: the warp over
        a step's 80 stack images (and F.grid_sample), CLAHE at each of 12a's
        fired steps, the decode at a video batch's 92 windows and its
        backward at an unlabeled window's 28.
     Phase 3 also holds the warp over 80 stack images (each stack's field
     repeated over its 5 frames), CLAHE at 12a's fired steps' planes, and
     the decode and its backward on a random-init context model's
     multi-frame maps (28, 17, 64, 64), against their plain versions.
 13. the multiview transformer (heatmap_multiview: vits_dino, ViT-S/16, 2
     views of 17 keypoints, 256 px, bf16; the repo's multiview config
     uncalibrated), on a synthetic 2-view set and sessions:
     a. train(cfg, dir) supervised, 10 steps of 16 samples x 2 views with
        dlc and the patch mask from step 0 (0.1 -> 0.5), with its
        evaluation (one image_preds directory and legacy copy a view);
        launches of the warp (once a step over 32 view images), CLAHE (once
        a step whose draws fire it) and the decode (once a step, validation
        batch and evaluation batch, 34 maps a sample) against that count;
        the step's ms, device busy share, peak memory and largest
        device-time entries (torch.profiler over 5 steps);
     b. train(cfg, dir) semi-supervised (pca_multiview + temporal; one
        32-frame 2-view window a step, photometric augmentation only), 10
        steps, with the 2-view test session predicted in its evaluation:
        the decode's backward once a step; the step's ms, busy share, the
        backward's share and the largest entries;
     c. from 13a's directory: predict_on_video_file_multiview of a 2-view
        1000-frame 320x240 session (11 batches of (96, 2, 256, 256, 3);
        normalize and decode once a batch), run 3 times, the first cold;
     d. predict_on_label_csv_multiview, and predict_frame of one frame a
        view at fp32 on the card (TF32 off) against the CPU;
     e. each kernel at the multiview shapes beside its plain version and
        bound: normalize (96, 2, 256, 256, 3), the warp over 32 view images
        (and F.grid_sample), CLAHE at 13a's fired steps, the decode at
        (96, 34, 64, 64) and its backward at (32, 34, 64, 64).
     Phase 3 also holds the normalize on a (96, 2, 256, 256, 3) batch, the
     warp over 32 view images, CLAHE at 13a's fired planes, and the decode
     and its backward on a random-init multiview model's maps against
     their plain versions.
 14. the rest of single-view training, at full width (256 px, 17
     keypoints, batch 16, dlc, bf16), from files in the published key
     layouts with seeded random values (torchvision ResNet-50, the same in
     an MMPose container, torchvision EfficientNet-B0, HF ViT-S/16 with a
     14 x 14 position grid):
     a. the MMPose file loaded into resnet50_animal_ap10k on the card and
        held to the file tensor by tensor; train() of RESUME_STEPS steps
        from it, twice (the run-to-run spread, cuDNN deterministic), and
        of half as many steps resumed with training.resume to RESUME_STEPS
        in the same version directory: the same step, epoch and LRs, the
        largest parameter difference (bitwise, or within twice the
        spread); the -last.ckpt's size and write times; train() with
        training.profiler, whose trace must name the warp and CLAHE
        kernels, the backbone frozen so that its conv kernels stay the
        file's;
     b. EfficientNet-B0 heatmap train() from the torchvision file with its
        evaluation (launches of the warp, CLAHE and the decode against
        what the code implies), the step's ms, busy share and memory,
        predict_on_video_file of a 1000-frame mp4 (11 batches of 96) in 2
        runs, and predict_frame fp32 card vs CPU;
     c. the regression model (ResNet-50): supervised train() (no decode;
        every likelihood 1.0), semi-supervised train() with temporal on
        the outputs (the warp twice a step), the steps' ms and busy
        shares, predict_on_video_file (likelihoods 1.0) and predict_frame
        fp32 card vs CPU;
     d. the multiview transformer (vits_dino, 2 views) from the HF file:
        the position grid resized 14 -> 16, 4 steps of train();
     e. each kernel at phase 14's shapes beside its plain version and
        bound: normalize (96, 256, 256, 3), the warp over 16 images (and
        F.grid_sample), CLAHE at 14b's fired steps, the decode on
        EfficientNet-B0 maps (96, 17, 64, 64).
     Phase 3 also holds CLAHE at 14b's fired planes, the warp at a 16-image
     batch and the decode on a random-init EfficientNet-B0 model's maps
     against their plain versions. Each kernel's entry in the JSON summary
     names the path whose launches it counts (14b's; the decode's
     backward runs on no path of phase 14 and keeps 13b's) and the shape
     its times were taken at.
The last lines are a JSON summary of the kernels, the nvidia-smi line, and
``{"ok": true, "device": {...}}``. The script imports nothing of JAX or of
the JAX package ``lightning_pose_tpu`` and fails if any was loaded.
"""

from __future__ import annotations

import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

SEED = 0
BATCH = 96  # dali.base.predict.sequence_length
IMAGE = 256
KEYPOINTS = 17
DOWNSAMPLE = 2
MAIN_PATH_BATCHES = 4
# Xavier gain of the last deconv: the reference's 0.01 gives near-uniform
# maps whose decode lands at the centre whatever the backbone computed
HEAD_GAIN = 3.0

# published peaks of one H100 SXM (at its full 700 W power limit): device
# memory and FP32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
FP32_FLOPS_PER_S = 67e12
# reading this much between timed launches evicts the 50 MB L2 (with clean
# lines: written ones would be written back during the timed launch) and
# keeps the card busy while the host enqueues the next launch
FLUSH_BYTES = 512 * 2**20

NORMALIZE_MAX_ULP = 1  # bf16 ulps, kernel (one FMA) vs plain ((x/255 - mean)/std)
DECODE_KP_TOL_PX = 0.05
DECODE_CONF_TOL = 1e-3
DECODE_MAX_WINDOW_FLIPS = 2  # maps (of 1632) whose keypoint floors across a pixel edge
CARD_VS_CPU_TOL_PX = 0.05
# warp and CLAHE kernels vs their plain versions: fp32 against fp32, the
# same terms summed in another order, on 0-255 gray levels
GRAY_TOL = 1e-3
# the engine on the card vs the CPU, same draws: keypoints within 1e-3 px;
# pixels within 0.01 gray but for those (at most 0.1%) whose value lies
# within rounding of an integer and truncates into another histogram bin
ENGINE_KP_TOL_PX = 1e-3
ENGINE_GRAY_TOL = 0.01
ENGINE_OFF_SHARE = 1e-3
TRAIN_BATCH = 16  # training.train_batch_size
TRAIN_STEPS = 20
UNFREEZE_STEP = 5
TRAIN_FRAMES = 64
TRAIN_SEED = 3  # rng_seed_data_pt: its draws fire CLAHE in the 20 steps
WINDOW = 32  # dali.base.train.sequence_length: unlabeled frames a step
# the decode's backward kernel against autograd of the plain decode, both
# fp32 with TF32 off: the largest error within 1e-3 of the largest entry
# (the temperature of 1000 multiplies the upsampled maps' rounding)
DECODE_GRAD_REL_TOL = 1e-3
# the backward's first design (one block of 256 threads a map) at the
# window's shape, as PERF.md records it (H100 80GB HBM3, 700 W); this run
# does not time that design, it only prints the recorded time beside its own
BACKWARD_FIRST_DESIGN_MS = 0.7364
# the context model (heatmap_mhcrnn): train() steps of each configuration,
# the unlabeled window's 5-frame windows, the frames of the synthetic video
# (11 batches of 92 windows, not a multiple of 92: the first batch's
# warm-up a small share) and the runs over it (the first cold, the others
# warm), the limits of fp32 on
# the card against the CPU and of repeat_center against adjacent on
# repeated stacks (fp32, TF32 off: the backbone sees 1 image or 5 copies,
# the same per-image sums in another cuDNN plan)
CONTEXT_STEPS = 10
CONTEXT_FRAMES = 5
CONTEXT_WINDOWS = WINDOW - 4
CONTEXT_VIDEO_FRAMES = 1000
CONTEXT_VIDEO_RUNS = 3
CONTEXT_SEED = 4
CONTEXT_TOL_PX = 0.05
CONTEXT_CONF_TOL = 1e-3
# one semi-supervised step, card against CPU, fp32, TF32 off: the gradient
# through the temperature-1000 decode is ill-conditioned in fp32 (on the
# CPU the port's fp32 gradients are up to 0.7% of a leaf's largest entry
# off float64), so each leaf within 10% of its largest entry and all the
# parameters' gradient within 1% in the 2-norm
SEMI_LEAF_REL_TOL = 0.1
SEMI_NORM_REL_TOL = 1e-2
# the multiview transformer (heatmap_multiview, the repo's multiview config:
# ViT-S/16 vits_dino, 2 views, dlc, the patch-mask curriculum, Adam 5e-5):
# train() steps of each configuration, the patch mask ramping 0.1 -> 0.5
# over them from step 0, the frames of each view of the synthetic session
# (11 batches of 96) and the runs over it (the first cold), the limit of
# fp32 on the card against the CPU
MV_VIEWS = ["cam0", "cam1"]
MV_BACKBONE = "vits_dino"
MV_STEPS = 10
MV_SEED = 5
MV_LR = 5e-5
MV_VIDEO_FRAMES = 1000
MV_VIDEO_RUNS = 3
MV_TOL_PX = 0.05

# the rest of single-view training (phase 14): train() steps of the resume
# comparison (4 an epoch; the interrupted run stops at half of them) and of
# the EfficientNet and regression configurations, the frames of their
# synthetic video and the runs over it (the first cold), the limit of fp32
# on the card against the CPU
RESUME_STEPS = 16
SV_STEPS = 10
SV_VIDEO_FRAMES = 1000
SV_VIDEO_RUNS = 2
SV_TOL_PX = 0.05
# the device of phase 14's paths (the checks of phase 3 are the card's)
DEVICE = "cuda"

KERNELS = {
    "normalize": {
        "route": "triton",
        "source": "lightning_pose_tpu_torch/ops/normalize_kernel.py",
        "replaces": "lightning_pose_tpu/ops/pallas_preprocess.py:59",
    },
    "decode": {
        "route": "cuda",
        "source": "lightning_pose_tpu_torch/csrc/decode.cu",
        "replaces": "lightning_pose_tpu/ops/pallas_decode.py:108",
    },
    "warp": {
        "route": "cuda",
        "source": "lightning_pose_tpu_torch/csrc/warp.cu",
        "replaces": "lightning_pose_tpu/ops/pallas_warp.py:126",
    },
    "clahe": {
        "route": "cuda",
        "source": "lightning_pose_tpu_torch/csrc/clahe.cu",
        "replaces": "lightning_pose_tpu/ops/pallas_clahe.py:121",
    },
    "decode_grad": {
        "route": "cuda",
        "source": "lightning_pose_tpu_torch/csrc/decode_grad.cu",
        "replaces": "none: the gradient of lightning_pose_tpu/ops/softargmax.py:123-147, XLA autodiff",
    },
}


def check(ok, what) -> None:
    if not ok:
        raise RuntimeError(f"chip_smoke check failed: {what}")


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` in ms, by CUDA events around ``iters`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def flushed_ms(fn, iters: int = 50, warmup: int = 3) -> float:
    """Mean device time of one ``fn()`` in ms, by CUDA events around each
    call alone, with the L2 evicted before each (a sum over FLUSH_BYTES)."""
    import torch

    scratch = torch.ones(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    total = torch.empty((), dtype=torch.float32, device="cuda")
    for _ in range(warmup):
        fn()
    pairs = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)) for _ in range(iters)]
    torch.cuda.synchronize()
    for start, end in pairs:
        torch.sum(scratch, dim=0, out=total)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in pairs) / iters


def flushed_rounds(fns: dict, rounds: int = 5) -> dict[str, list[float]]:
    """``flushed_ms`` of each of ``fns`` in each of ``rounds`` rounds, the
    functions alternating within a round, after a round that is not kept:
    the spread of two times that differ by about a percent."""
    for fn in fns.values():
        flushed_ms(fn)
    out = {name: [] for name in fns}
    for r in range(rounds):
        names = list(fns)[r % len(fns):] + list(fns)[: r % len(fns)]
        for name in names:
            out[name].append(flushed_ms(fns[name]))
    return out


def decode_flops(n_maps: int, h: int, w: int, df: int) -> int:
    """FP32 operations of the banded decode: 2 per FMA of T = hm @ Mw^T and
    up = Mh @ T over the non-zeros of the upsample matrices."""
    from lightning_pose_tpu_torch.ops.decode_kernel import upsample_matrix

    m_h, m_w = upsample_matrix(h, df), upsample_matrix(w, df)
    fmas = h * int((m_w != 0).sum()) + m_w.shape[0] * int((m_h != 0).sum())
    return 2 * fmas * n_maps


def decode_grad_flops(n_maps: int, h: int, w: int, df: int) -> int:
    """FP32 operations of the banded backward: 2 per FMA of T and up
    recomputed as the forward has them, of u = dup @ Mw and of Mh^T @ u,
    over the non-zeros of the upsample matrices."""
    from lightning_pose_tpu_torch.ops.decode_kernel import upsample_matrix

    m_h, m_w = upsample_matrix(h, df), upsample_matrix(w, df)
    nnz_h, nnz_w = int((m_h != 0).sum()), int((m_w != 0).sum())
    fmas = h * nnz_w + m_w.shape[0] * nnz_h + m_h.shape[0] * nnz_w + w * nnz_h
    return 2 * fmas * n_maps


def decode_grads(hm, df: int, seed: int):
    """The maps' gradient of ``sum(g * keypoints)`` for seeded ``g`` through
    the kernels and through autograd of the plain decode."""
    import torch

    from lightning_pose_tpu_torch.ops import decode_kernel

    g = torch.from_numpy(np.random.default_rng(seed).standard_normal((hm.shape[0], 2 * hm.shape[1])))
    g = g.to(hm.device, torch.float32)
    x = hm.clone().requires_grad_()
    kp, _ = decode_kernel.decode(x, df)
    (kp * g).sum().backward()
    x_ref = hm.clone().requires_grad_()
    kp_ref, _ = decode_kernel.decode_plain(x_ref, df)
    (kp_ref * g).sum().backward()
    torch.cuda.synchronize()
    return x.grad, x_ref.grad


def peaked_heatmaps(rng, b: int, k: int, h: int, w: int, sigma: float = 1.25) -> np.ndarray:
    """Normalized Gaussian maps at random keypoints, as
    ``data/heatmaps.generate_heatmaps`` makes them; ``(B, K, h, w)``."""
    x = rng.uniform(0, w, (b, k, 1, 1))
    y = rng.uniform(0, h, (b, k, 1, 1))
    yy = np.arange(h)[None, None, :, None]
    xx = np.arange(w)[None, None, None, :]
    maps = np.exp(-((yy - y) ** 2 + (xx - x) ** 2) / (2 * sigma**2))
    return (maps / maps.sum(axis=(2, 3), keepdims=True)).astype(np.float32)


def softmaxed_heatmaps(rng, b: int, k: int, h: int, w: int) -> np.ndarray:
    z = rng.standard_normal((b, k, h * w)) * 3.0
    e = np.exp(z - z.max(axis=-1, keepdims=True))
    return (e / e.sum(axis=-1, keepdims=True)).reshape(b, k, h, w).astype(np.float32)


def seeded_flax_variables(tree: dict, rng, path: tuple = ()) -> dict:
    """Seeded numpy leaves of the same shapes as ``tree`` (flax layout):
    He-normal conv kernels, BatchNorm near identity with the residual
    branch's last scale at 0.2, Xavier-uniform head kernels at HEAD_GAIN."""
    out = {}
    for key, value in tree.items():
        p = path + (key,)
        if isinstance(value, dict):
            out[key] = seeded_flax_variables(value, rng, p)
            continue
        s = value.shape
        module = p[-2]
        if key == "kernel" and module.startswith("deconv"):
            limit = HEAD_GAIN * np.sqrt(6.0 / (s[0] * s[1] * (s[2] + s[3])))
            leaf = rng.uniform(-limit, limit, s)
        elif key == "kernel":
            leaf = rng.standard_normal(s) * np.sqrt(2.0 / (s[0] * s[1] * s[2]))
        elif key == "scale":
            leaf = np.full(s, 0.2 if module == "bn3" else 1.0)
        elif key == "bias":
            leaf = np.zeros(s) if module.startswith("deconv") else rng.standard_normal(s) * 0.05
        elif key == "mean":
            leaf = rng.standard_normal(s) * 0.05
        elif key == "var":
            leaf = rng.uniform(0.8, 1.2, s)
        else:
            raise ValueError(f"unexpected flax leaf {'/'.join(p)}")
        out[key] = leaf.astype(np.float32)
    return out


def decode_errors(kp, conf, kp_ref, conf_ref, offset: float) -> tuple[float, float, int]:
    """Largest keypoint error; largest confidence error over the maps whose
    confidence window (the floored keypoint) is the same in both; and the
    number of maps whose window differs. A keypoint within rounding of a
    pixel edge floors to either side, and its window's mass then differs
    by a shift of one pixel."""
    import torch

    kp_err = float((kp - kp_ref).abs().max())
    same = (torch.floor(kp + offset) == torch.floor(kp_ref + offset)).reshape(conf.shape + (2,))
    same = same.all(dim=-1)
    conf_err = float((conf - conf_ref).abs()[same].max()) if bool(same.any()) else 0.0
    return kp_err, conf_err, int((~same).sum())


def bf16_ulps(a, b) -> int:
    """Largest distance in bf16 units in the last place between two bf16
    tensors of the same signs."""
    import torch

    ia = a.contiguous().view(torch.int16).to(torch.int32)
    ib = b.contiguous().view(torch.int16).to(torch.int32)
    if bool(((ia < 0) != (ib < 0)).any()):
        return 1 << 16
    return int((ia - ib).abs().max())


def timed(fn) -> float:
    """Seconds ``fn()`` takes, to the end of the device's work."""
    import torch

    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def forced_draws(engine, b: int, seed: int):
    """dlc draws for ``b`` images (fields on the card) in which every
    geometric op fires, and histeq, CLAHE and emboss fire on some images."""
    import torch

    draws = engine.sample(torch.Generator().manual_seed(seed), b, torch.Generator(device="cuda").manual_seed(seed))
    for name in ("affine_u", "croppad_u", "elastic_u"):
        getattr(draws, name).zero_()
    draws.elastic_alpha.fill_(10.0)
    draws.histeq_u[0:2] = 0.0
    draws.clahe_u[2:5] = 0.0
    draws.emboss_u[5:7] = 0.0
    return draws


def check_warp(engine, images, draws, label: str) -> float:
    """The warp kernel against its plain version on the engine's sampling
    coordinates for ``draws``, and on the clamped ones of the motion-blur
    path; returns the largest error."""
    import torch

    from lightning_pose_tpu_torch.ops import warp_kernel

    _, coords, _, _ = engine.sampling_grid(draws, images.shape[0], images.device)
    h, w = images.shape[1:3]
    clamped = torch.cat([coords[..., 0:1].clamp(0, w - 1), coords[..., 1:2].clamp(0, h - 1)], dim=-1)
    err = 0.0
    for name, c in (("dlc grid", coords.contiguous()), ("clamped", clamped.contiguous())):
        out = warp_kernel.warp(images, c)
        ref = warp_kernel.warp_plain(images, c)
        torch.cuda.synchronize()
        e = float((out - ref).abs().max())
        outside = float(((c[..., 0] < 0) | (c[..., 0] > w - 1) | (c[..., 1] < 0) | (c[..., 1] > h - 1)).float().mean())
        log(f"phase 3 warp {label} {name} {tuple(images.shape)}: max abs err {e:.3e} gray (limit {GRAY_TOL}); "
            f"{outside:.1%} of the taps' pixels outside the frame")
        check(bool(torch.isfinite(out).all()), f"warp {label} {name}: non-finite output")
        check(e <= GRAY_TOL, f"warp {label} {name} disagrees with its plain version")
        err = max(err, e)
    return err


def check_clahe(images, clip, g: int) -> tuple[float, tuple]:
    """The CLAHE kernel against its plain version on LUTs that the port's
    ``_clahe_lut_grid`` builds from ``images (B, 3, H, W)``."""
    import torch

    from lightning_pose_tpu_torch.ops import clahe_kernel
    from lightning_pose_tpu_torch.ops.augment import _clahe_lut_grid

    b, c, h, w = images.shape
    lut = _clahe_lut_grid(images.clamp(0, 255).to(torch.int64), clip, g).reshape(b * c, g, g, 256).contiguous()
    x = images.reshape(b * c, h, w).contiguous()
    out = clahe_kernel.clahe_apply(x, lut, g)
    ref = clahe_kernel.clahe_apply_plain(x, lut, g)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    log(f"phase 3 clahe {tuple(x.shape)} g={g}: max abs err {err:.3e} gray (limit {GRAY_TOL}); "
        f"{clahe_kernel.blend_plan(b * c, h, w, g, True, torch.cuda.get_device_properties(0).multi_processor_count)}")
    check(bool(torch.isfinite(out).all()), "clahe: non-finite output")
    check(err <= GRAY_TOL, f"clahe g={g} disagrees with its plain version")
    return err, (x, lut)


def train_config(data_dir: Path, keypoint_names: list[str]):
    """The repo's default config (ResNet-50 heatmap, batch 16, dlc, Adam
    1e-3 with the multistep and unfreeze schedules) at 256 px in step mode,
    on the synthetic labeled set."""
    from lightning_pose_tpu_torch.config import load_config

    cfg = load_config()
    cfg.data.data_dir = str(data_dir)
    cfg.data.video_dir = "videos"
    cfg.data.num_keypoints = KEYPOINTS
    cfg.data.keypoint_names = keypoint_names
    cfg.data.image_resize_dims.height = IMAGE
    cfg.data.image_resize_dims.width = IMAGE
    cfg.data.downsample_factor = DOWNSAMPLE
    cfg.model.model_name = "smoke"
    cfg.dali.base.predict.sequence_length = BATCH
    tcfg = cfg.training
    check(tcfg.train_batch_size == TRAIN_BATCH and tcfg.imgaug == "dlc", "the defaults changed")
    tcfg.max_epochs = tcfg.min_epochs = tcfg.unfreezing_epoch = None
    tcfg.max_steps = tcfg.min_steps = TRAIN_STEPS
    tcfg.unfreezing_step = UNFREEZE_STEP
    tcfg.lr_scheduler_params.multisteplr.milestones = None
    tcfg.lr_scheduler_params.multisteplr.milestone_steps = [10, 15]
    tcfg.check_val_every_n_epoch = 1
    tcfg.log_every_n_steps = 1
    tcfg.rng_seed_data_pt = TRAIN_SEED
    return cfg


def write_video(path: Path, rng, n_frames: int, height: int, width: int) -> Path:
    import cv2

    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (width, height))
    for _ in range(n_frames):
        writer.write(rng.integers(0, 256, (height, width, 3), dtype=np.uint8))
    writer.release()
    return path


def semisup_config(data_dir: Path, keypoint_names: list[str]):
    """The default config with losses_to_use [pca_singleview, temporal] on
    the synthetic labeled set and its two mp4s. So that the unsupervised
    term carries gradient in 20 steps from random weights: the anneal
    weight is 1 from epoch 0 (init_val 1, freeze_until_epoch 0), the
    epsilons are 0, and the temporal loss's confidence threshold is 0 (the
    random head's near-uniform maps have confidences far below 0.05)."""
    cfg = train_config(data_dir, keypoint_names)
    cfg.model.model_name = "smokesemi"
    cfg.model.losses_to_use = ["pca_singleview", "temporal"]
    check(int(cfg.dali.base.train.sequence_length) == WINDOW, "the defaults changed")
    cfg.losses.pca_singleview.epsilon = 0.0
    cfg.losses.temporal.epsilon = 0.0
    cfg.losses.temporal.prob_threshold = 0.0
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    return cfg


def fake_data_module(n: int, k: int, size: int, seed: int):
    """What the PCA fit reads of a data module: ``n`` keypoint rows of a
    rigid body of ``k`` points in a ``size`` px frame, with noise."""
    from types import SimpleNamespace

    rng = np.random.default_rng(seed)
    template = rng.uniform(-0.2, 0.2, (k, 2)) * size
    angles = rng.uniform(-0.5, 0.5, n)
    rot = np.stack([np.stack([np.cos(angles), -np.sin(angles)], -1),
                    np.stack([np.sin(angles), np.cos(angles)], -1)], -2)
    kp = np.einsum("nij,kj->nki", rot, template) + rng.uniform(0.4, 0.6, (n, 1, 2)) * size
    kp = (kp + rng.normal(0, 1.0, (n, k, 2))).astype(np.float32)
    dataset = SimpleNamespace(keypoints_resized=lambda i: kp[i], num_keypoints=k)
    return SimpleNamespace(dataset=dataset, train_dataset=SimpleNamespace(indices=np.arange(n)))


def semisup_card_vs_cpu(card: str) -> tuple[float, float]:
    """Phase 10: one semi-supervised step (resnet18, 128 px, 4 labeled
    frames with dlc, an 8-frame window, fp32, TF32 off) on the card and on
    the CPU from the same weights and draws; the parameters' gradients.
    Returns the largest leaf error (relative to the leaf's largest entry)
    and the 2-norm error of all gradients."""
    import copy

    import torch

    from lightning_pose_tpu_torch.config import load_config
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.train.checkpoints import load_flax_variables, state_dict_to_flax

    dev = torch.device("cuda", 0)
    size, n_lab, n_win = 128, 4, 8
    cfg = load_config()
    cfg.data.image_resize_dims.height = cfg.data.image_resize_dims.width = size
    cfg.model.losses_to_use = ["pca_singleview", "temporal"]
    for name in ("pca_singleview", "temporal"):
        cfg.losses[name].log_weight = 0.0
        cfg.losses[name].epsilon = 0.0
    cfg.losses.temporal.prob_threshold = 0.0
    cfg.callbacks.anneal_weight.init_val = 1.0
    cfg.callbacks.anneal_weight.freeze_until_epoch = 0
    factories = get_loss_factories(cfg, fake_data_module(60, KEYPOINTS, size, SEED))
    model = build_model("heatmap", "resnet18", KEYPOINTS, DOWNSAMPLE)
    shapes_params, shapes_stats = state_dict_to_flax(model.state_dict())
    wrng = np.random.default_rng(SEED + 2)
    load_flax_variables(model, seeded_flax_variables(shapes_params, wrng), seeded_flax_variables(shapes_stats, wrng))
    engine = AugmentationEngine("dlc", size, size)
    gen, field_gen = torch.Generator().manual_seed(SEED), torch.Generator(dev).manual_seed(SEED)
    draws = engine.sample(gen, n_lab, field_gen)
    for name in ("histeq_u", "clahe_u", "emboss_u"):  # no integer-bin ops: they round apart
        getattr(draws, name).fill_(1.0)
    video_draws = sample_video_draws(gen, n_win, size, size, field_gen)
    rng = np.random.default_rng(SEED + 3)
    cache = {
        "images": torch.from_numpy(rng.integers(0, 256, (8, size, size, 3), dtype=np.uint8)),
        "keypoints": torch.from_numpy(rng.uniform(8, size - 8, (8, KEYPOINTS, 2)).astype(np.float32)),
        "visibility": torch.full((8, KEYPOINTS), 2, dtype=torch.int64),
        "bbox": torch.tensor([[0.0, 0.0, size, size]] * 8),
    }
    window = {
        "frames": torch.from_numpy(rng.integers(0, 256, (n_win, size, size, 3), dtype=np.uint8)),
        "bbox": torch.tensor([[0.0, 0.0, 120.0, 160.0]] * n_win),
    }
    grads = {}
    for where, m in (("cuda", copy.deepcopy(model).to(dev, memory_format=torch.channels_last)), ("cpu", model)):
        d = torch.device(where, 0) if where == "cuda" else torch.device("cpu")
        optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, 10, m)
        state = trainer.TrainState(model=m, optimizer=optimizer)
        step = trainer.make_step_fns({"model_type": "heatmap", "downsample_factor": DOWNSAMPLE}, factories, engine,
                                     cfg, head_sched, bb_sched, 10, compute_dtype=torch.float32)[2]
        # the draws as sampled (scalars on the host, fields on the card), or
        # all on the CPU
        step_draws, step_video_draws = (draws, video_draws) if where == "cuda" else (
            type(draws)(**{k: None if v is None else v.cpu() for k, v in vars(draws).items()}),
            type(video_draws)(**{k: v.cpu() for k, v in vars(video_draws).items()}),
        )
        logs = step(
            state, {k: v.to(d) for k, v in cache.items()}, torch.arange(n_lab, device=d),
            torch.ones(n_lab, dtype=torch.bool, device=d), step_draws,
            {k: v.to(d) for k, v in window.items()}, step_video_draws,
        )
        check(all(bool(torch.isfinite(v).all()) for v in logs.values()), f"semi-supervised step on {where}: non-finite logs")
        grads[where] = {n: p.grad.detach().cpu().double() for n, p in m.named_parameters()}
        if where == "cuda":
            unsup = float(logs["train_unsupervised_loss"])
    leaf_err = max(
        float((grads["cuda"][n] - g).abs().max() / g.abs().max())
        for n, g in grads["cpu"].items() if n != "head.deconv1.bias" and float(g.abs().max()) > 0
    )
    flat = {k: torch.cat([g.flatten() for n, g in v.items() if n != "head.deconv1.bias"]) for k, v in grads.items()}
    norm_err = float((flat["cuda"] - flat["cpu"]).norm() / flat["cpu"].norm())
    log(f"phase 10 semi-supervised step card vs CPU (resnet18, {size} px, {n_lab} + {n_win} frames, fp32, TF32 off, "
        f"unsupervised loss {unsup:.4f}): parameter gradients, largest leaf error {leaf_err:.3e} of the leaf's "
        f"largest entry (limit {SEMI_LEAF_REL_TOL}), 2-norm error {norm_err:.3e} (limit {SEMI_NORM_REL_TOL})")
    check(leaf_err <= SEMI_LEAF_REL_TOL and norm_err <= SEMI_NORM_REL_TOL,
          "the semi-supervised step's gradients on the card disagree with the CPU")
    return leaf_err, norm_err


def semisup_phase(rng, card: str) -> None:
    """Phase 11: train() of the semi-supervised configuration, prediction
    from its directory, then the step's times."""
    import math

    import torch

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import decode_kernel, warp_kernel
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    dev = torch.device("cuda", 0)
    names = [f"kp{i}" for i in range(KEYPOINTS)]
    with tempfile.TemporaryDirectory() as tmp:
        data = write_labeled_dataset(Path(tmp) / "data", TRAIN_FRAMES, IMAGE, IMAGE, names, seed=SEED)
        videos = [write_unlabeled_video(data, f"session{i}", 120, 240, 320, n_blobs=KEYPOINTS, seed=SEED + i)
                  for i in range(2)]
        cfg = semisup_config(data, names)
        # the evaluation predicts the two mp4s as test videos, with labeled
        # videos; naming every keypoint's column keeps the PCA subspace (None
        # means all of them) and has the evaluation write the PCA metric CSVs
        cfg.data.columns_for_singleview_pca = list(range(KEYPOINTS))
        cfg.eval.predict_vids_after_training = True
        cfg.eval.save_vids_after_training = True
        cfg.eval.test_videos_directory = str(data / "videos")
        model_dir = Path(tmp) / "model"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warp_kernel.launches = decode_kernel.launches = decode_kernel.grad_launches = 0
        t0 = time.perf_counter()
        result = trainer.train(cfg, model_dir, device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"warp": warp_kernel.launches, "decode": decode_kernel.launches,
                    "decode_grad": decode_kernel.grad_launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        train_logs = [h for h in result.history if "train_unsupervised_loss" in h]
        val_logs = [h for h in result.history if "val_supervised_loss" in h]
        dm = result.data_module
        val_batches = len(val_logs) * math.ceil(len(dm.val_dataset) / dm.val_batch_size)
        eval_batches = math.ceil(TRAIN_FRAMES / dm.test_batch_size) + len(videos) * math.ceil(120 / BATCH)
        pca = [h["train_pca_singleview_loss"] for h in train_logs]
        temporal = [h["train_temporal_loss"] for h in train_logs]
        log(f"phase 11 semi-supervised train(): {TRAIN_STEPS} steps of {TRAIN_BATCH} labeled + {WINDOW} unlabeled "
            f"frames (ResNet-50, {IMAGE} px, dlc, bf16, pca_singleview + temporal) in {elapsed:.1f} s with set-up, "
            f"the PCA fit and evaluation, {len(val_logs)} validations of {val_batches // max(len(val_logs), 1)} "
            f"batch(es), {eval_batches} evaluation batches (labeled frames and 2 test videos); "
            f"launches {launches}; unsupervised loss {train_logs[0]['train_unsupervised_loss']:.3e} -> "
            f"{train_logs[-1]['train_unsupervised_loss']:.3e}, pca_singleview max {max(pca):.4f}, temporal max "
            f"{max(temporal):.4f}; peak device memory {peak:.2f} GiB {card}")
        check(launches["warp"] == 2 * TRAIN_STEPS, f"warp launched {launches['warp']} times in {TRAIN_STEPS} steps")
        check(launches["decode_grad"] == TRAIN_STEPS,
              f"the decode's backward launched {launches['decode_grad']} times in {TRAIN_STEPS} steps")
        check(launches["decode"] == 2 * TRAIN_STEPS + val_batches + eval_batches,
              f"decode launched {launches['decode']} times in {TRAIN_STEPS} steps, {val_batches} validation batches "
              f"and {eval_batches} evaluation batches")
        check(len(train_logs) == TRAIN_STEPS and val_logs, "semi-supervised train() logged too little")
        check(all(np.isfinite(v) for h in result.history for k, v in h.items() if "loss" in k),
              "a logged loss is not finite")
        check(max(pca) > 0 and max(temporal) > 0, "the pca_singleview or temporal loss was 0 in every step")
        check(not any(t.is_alive() for t in dm.unlabeled_loader._threads), "the unlabeled loader's threads live on")
        check(json.loads((model_dir / "train_status.json").read_text())["status"] == "COMPLETED",
              "train_status.json is not COMPLETED")
        files = check_image_preds(model_dir, "CollectedData.csv", ["pixel_error", "pca_singleview_error"])
        video_files = sorted(str(f.relative_to(model_dir / "video_preds")) for f in (model_dir / "video_preds").rglob("*.*"))
        expected = sorted(f"{v.stem}{end}" for v in videos for end in (".csv", "_temporal_norm.csv",
                                                                      "_pca_singleview_error.csv"))
        expected += sorted(f"labeled_videos/{v.stem}_labeled.mp4" for v in videos)
        check(sorted(video_files) == sorted(expected), f"video_preds/ holds {video_files}, expected {expected}")
        log(f"phase 11 train()'s evaluation: image_preds/CollectedData.csv/ {files} and their legacy copies; "
            f"video_preds/ {video_files}")
        df = Model.from_dir(model_dir).predict_on_video_file(videos[0]).predictions
        check(df.shape == (120, 3 * KEYPOINTS) and np.isfinite(df.to_numpy()).all(),
              f"the semi-supervised dir's CSV: shape {df.shape} or non-finite values")
        log(f"phase 11 predict from the semi-supervised dir: {df.shape[0]} rows, finite")

        # -- the step at full width ------------------------------------------------
        spe = trainer.calculate_steps_per_epoch(dm)
        factories = get_loss_factories(cfg, dm)
        dm.close()
        torch.manual_seed(SEED)
        model = build_model("heatmap", "resnet50", KEYPOINTS, DOWNSAMPLE).to(dev, memory_format=torch.channels_last)
        optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, spe, model)
        state = trainer.TrainState(model=model, optimizer=optimizer, step=UNFREEZE_STEP)
        engine = AugmentationEngine("dlc", IMAGE, IMAGE)
        step = trainer.make_step_fns({"model_type": "heatmap", "downsample_factor": DOWNSAMPLE}, factories,
                                     engine, cfg, head_sched, bb_sched, spe)[2]
        cache = trainer._device_cache(dm.dataset, dev)
        valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
        window = {
            "frames": torch.from_numpy(rng.integers(0, 256, (WINDOW, IMAGE, IMAGE, 3), dtype=np.uint8)).to(dev),
            "bbox": torch.tensor([[0.0, 0.0, 240.0, 320.0]] * WINDOW, device=dev),
        }
        draw_gen, field_gen = torch.Generator().manual_seed(SEED), torch.Generator(dev).manual_seed(SEED)

        def one_step():
            idxs = torch.from_numpy(rng.permutation(TRAIN_FRAMES)[:TRAIN_BATCH]).to(dev)
            draws = engine.sample(draw_gen, TRAIN_BATCH, field_gen)
            step(state, cache, idxs, valid, draws, window, sample_video_draws(draw_gen, WINDOW, IMAGE, IMAGE, field_gen))

        n, n_prof = 20, 5
        step_ms, device_ms, kernels, busy = profiled_step(one_step, n, n_prof)
        step_grad_ms = sum(e.self_device_time_total for e in kernels if "decode_grad_kernel" in e.key) / n_prof / 1e3
        fwd_ms = sum(e.self_device_time_total for e in kernels
                     if "decode_kernel" in e.key and "grad" not in e.key) / n_prof / 1e3
        log(f"phase 11 semi-supervised step (ResNet-50, {IMAGE} px, bf16, {TRAIN_BATCH} labeled with dlc + {WINDOW} "
            f"unlabeled, backbone unfrozen): {step_ms:.3f} ms, {(TRAIN_BATCH + WINDOW) / step_ms * 1e3:.1f} frames/s, "
            f"mean of {n} steps by the host clock with draws sampled in each; torch.profiler over {n_prof} steps: "
            f"{device_ms:.3f} ms of device time a step, the device busy {busy:.1%}; the decode's backward "
            f"{step_grad_ms:.4f} ms a step ({step_grad_ms / max(device_ms, 1e-9):.2%} of the device time), its forward "
            f"{fwd_ms:.4f} ms {card}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:8]
        log("phase 11 largest device-time entries a step: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / n_prof / 1e3:.3f} ms" for e in top))

        # -- the backward kernel and the warp at the window's shape ------------
        hm_h = IMAGE // 2**DOWNSAMPLE
        hm = torch.from_numpy(peaked_heatmaps(rng, WINDOW, KEYPOINTS, hm_h, hm_h)).to(dev)
        ops = decode_kernel._device_operands(hm_h, hm_h, DOWNSAMPLE, decode_kernel._layout(), dev)
        lse2 = torch.empty(WINDOW * KEYPOINTS, device=dev)
        kp, _ = decode_kernel._launch(hm, ops, DOWNSAMPLE, 1000.0, lse2)
        g = torch.randn(kp.shape, device=dev)
        grad_ms = cuda_ms(lambda: decode_kernel._launch_grad(hm, kp, lse2, g, ops, DOWNSAMPLE, 1000.0), iters=50)
        x = hm.clone().requires_grad_()
        kp_plain, _ = decode_kernel.decode_plain(x, DOWNSAMPLE)
        plain_ms = cuda_ms(lambda: torch.autograd.grad(kp_plain, x, g, retain_graph=True))
        maps = WINDOW * KEYPOINTS
        flops = decode_grad_flops(maps, hm_h, hm_h, DOWNSAMPLE)
        bound = bound_of((2 * hm.numel() + maps * 5) * 4, flops)
        plan = decode_kernel._device_grad_operands(hm_h, hm_h, DOWNSAMPLE, ops.wp, ops.tile_band, dev)
        log(f"phase 11 decode backward at {tuple(hm.shape)} df {DOWNSAMPLE} ({flops / 1e9:.3f} GFLOP banded): kernel "
            f"{grad_ms:.4f} ms back to back, plain (autograd's backward of the plain decode) {plain_ms:.4f} ms; bound "
            f"{bound[0]:.4f} ms ({bound[1]}), {bound[0] / grad_ms:.1%} of it reached; the first design (one block a map), "
            f"not timed in this run, is recorded in PERF.md at {BACKWARD_FIRST_DESIGN_MS} ms; "
            f"{decode_kernel.GRAD_CLUSTER} blocks a map, {plan.smem} bytes of shared memory a block, chunks of "
            f"{plan.chunk_rows} of {plan.strip_rows} rows {card}")
        frames = torch.from_numpy(rng.uniform(0, 255, (WINDOW, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
        theta = 0.1
        ys, xs = torch.meshgrid(torch.arange(IMAGE, dtype=torch.float32, device=dev),
                                torch.arange(IMAGE, dtype=torch.float32, device=dev), indexing="ij")
        c = IMAGE / 2.0
        field = torch.stack([np.cos(theta) * (xs - c) - np.sin(theta) * (ys - c) + c,
                             np.sin(theta) * (xs - c) + np.cos(theta) * (ys - c) + c], dim=-1)
        coords = field.expand(WINDOW, IMAGE, IMAGE, 2).contiguous()
        warp_ms = flushed_ms(lambda: warp_kernel.warp(frames, coords))
        warp_bytes = (frames.numel() * 2 + coords.numel()) * 4
        warp_bound = warp_bytes / HBM_BYTES_PER_S * 1e3
        log(f"phase 11 warp at the window's shape {tuple(frames.shape)}, L2 flushed: {warp_ms:.5f} ms; bound "
            f"{warp_bound:.5f} ms (bytes: {warp_bytes / 1e6:.1f} MB, of which the expanded coordinates "
            f"{coords.numel() * 4 / 1e6:.1f} MB), {warp_bound / warp_ms:.1%} of it reached {card}")


def check_image_preds(model_dir: Path, csv_name: str, metrics: list[str]) -> list[str]:
    """train()'s evaluation of the labeled frames: predictions.csv with its
    set column and the metric CSVs in image_preds/<csv>/, with their legacy
    copies in the model directory. Returns the directory's file names."""
    import pandas as pd

    preds_dir = model_dir / "image_preds" / csv_name
    files = sorted(f.name for f in preds_dir.glob("*.csv"))
    expected = ["predictions.csv"] + [f"predictions_{m}.csv" for m in metrics]
    check(sorted(expected) == files, f"{preds_dir}: {files}, expected {expected}")
    df = pd.read_csv(preds_dir / "predictions.csv", header=[0, 1, 2], index_col=0)
    check(df.shape == (TRAIN_FRAMES, 3 * KEYPOINTS + 1) and df.columns[-1][0] == "set"
          and np.isfinite(df.iloc[:, :-1].to_numpy(float)).all(), f"{preds_dir}/predictions.csv: shape {df.shape}")
    check(all((model_dir / f).is_file() for f in files), f"the legacy copies of {files} are missing")
    return files


def label_csv_phase(model_dir: Path, card: str) -> None:
    """Phase 8b: predict_on_label_csv of the trained directory on the card
    (bf16, the default), then at fp32 on the card and on the CPU."""
    import pandas as pd
    import torch

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel

    model = Model.from_dir(model_dir)
    model._load()  # the model's load and weights stay out of the counts and the time
    torch.cuda.synchronize()
    normalize_kernel.launches = decode_kernel.launches = 0
    t0 = time.perf_counter()
    result = model.predict_on_label_csv("CollectedData.csv", output_dir=model_dir / "label_csv_bf16")
    elapsed = time.perf_counter() - t0
    launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
    batches = -(-TRAIN_FRAMES // int(model.cfg.training.test_batch_size))
    check(all(n == batches for n in launches.values()), f"label CSV path launches {launches}, {batches} batches")
    df = result.predictions
    check(df.shape == (TRAIN_FRAMES, 3 * KEYPOINTS + 1) and np.isfinite(df.iloc[:, :-1].to_numpy(float)).all(),
          f"predict_on_label_csv: shape {df.shape} or non-finite values")
    check(result.metrics is not None and result.metrics.pixel_error_df is not None
          and (model_dir / "label_csv_bf16" / "predictions_pixel_error.csv").is_file(),
          "predict_on_label_csv wrote no pixel-error metrics")
    pixel = result.metrics.pixel_error_df.iloc[:, :-1].to_numpy(float)
    log(f"phase 8b predict_on_label_csv of the trained dir (bf16): {df.shape[0]} frames in {batches} batches, "
        f"launches {launches}, {elapsed:.2f} s with metrics; pixel error median {np.nanmedian(pixel):.2f} px "
        f"(20 steps from random weights) {card}")

    frames = {}
    for device in ("cuda", "cpu"):
        Model.from_dir(model_dir, precision="fp32", device=device).predict_on_label_csv(
            "CollectedData.csv", output_dir=model_dir / f"label_csv_{device}", compute_metrics=False)
        frames[device] = pd.read_csv(model_dir / f"label_csv_{device}" / "predictions.csv", header=[0, 1, 2],
                                     index_col=0)
    xy = frames["cpu"].columns.get_level_values("coords").isin(["x", "y"])
    diff = float(np.abs(frames["cuda"].loc[:, xy].to_numpy(float) - frames["cpu"].loc[:, xy].to_numpy(float)).max())
    check(frames["cuda"].index.equals(frames["cpu"].index), "label CSV predictions: the index differs")
    check(diff <= CARD_VS_CPU_TOL_PX, f"predict_on_label_csv card vs CPU: {diff} px")
    log(f"phase 8b predict_on_label_csv fp32 card (TF32 off) vs CPU, {TRAIN_FRAMES} frames: keypoints max abs diff "
        f"{diff:.3e} px (limit {CARD_VS_CPU_TOL_PX})")


def train_phase(rng, card: str) -> None:
    """Phases 8, 8b and 9: train() of the default model on a synthetic
    labeled set with its evaluation, prediction from the directory it wrote
    (a video, the labeled CSV), then the train step's times."""
    import math

    import torch

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import clahe_kernel, decode_kernel, normalize_kernel, warp_kernel
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset

    dev = torch.device("cuda", 0)
    names = [f"kp{i}" for i in range(KEYPOINTS)]
    with tempfile.TemporaryDirectory() as tmp:
        data = write_labeled_dataset(Path(tmp) / "data", TRAIN_FRAMES, IMAGE, IMAGE, names, seed=SEED)
        cfg = train_config(data, names)
        model_dir = Path(tmp) / "model"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warp_kernel.launches = clahe_kernel.launches = decode_kernel.launches = normalize_kernel.launches = 0
        t0 = time.perf_counter()
        result = trainer.train(cfg, model_dir, device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"warp": warp_kernel.launches, "clahe": clahe_kernel.launches}
        train_decodes, eval_normalizes = decode_kernel.launches, normalize_kernel.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        train_logs = [h for h in result.history if "train_heatmap_mse_loss" in h]
        val_logs = [h for h in result.history if "val_supervised_loss" in h]
        dm = result.data_module
        val_batches = len(val_logs) * math.ceil(len(dm.val_dataset) / dm.val_batch_size)
        eval_batches = math.ceil(TRAIN_FRAMES / dm.test_batch_size)
        log(f"phase 8 train(): {TRAIN_STEPS} steps of {TRAIN_BATCH} (ResNet-50, {IMAGE} px, dlc, bf16) in "
            f"{elapsed:.1f} s with set-up and evaluation, {len(val_logs)} validations of "
            f"{val_batches // max(len(val_logs), 1)} batch(es), {eval_batches} evaluation batches; launches "
            f"{launches}, decode {train_decodes}, normalize {eval_normalizes}; "
            f"train loss {train_logs[0]['train_heatmap_mse_loss']:.4f} -> {train_logs[-1]['train_heatmap_mse_loss']:.4f}, "
            f"lr head {train_logs[-1]['lr-head']:.2e}, backbone {train_logs[-1]['lr-backbone']:.2e}; "
            f"peak device memory {peak:.2f} GiB {card}")
        check(launches["warp"] == TRAIN_STEPS, f"warp launched {launches['warp']} times in {TRAIN_STEPS} steps")
        check(launches["clahe"] >= 1, "CLAHE never launched in training")
        check(train_decodes == TRAIN_STEPS + val_batches + eval_batches,
              f"decode launched {train_decodes} times in {TRAIN_STEPS} steps, {val_batches} validation batches "
              f"and {eval_batches} evaluation batches")
        check(eval_normalizes == eval_batches, f"normalize launched {eval_normalizes} times in {eval_batches} "
              "evaluation batches")
        check(len(train_logs) == TRAIN_STEPS and val_logs, "train() logged too little")
        check(all(np.isfinite(v) for h in result.history for k, v in h.items() if "loss" in k),
              "a logged loss is not finite")
        best = list(model_dir.glob("tb_logs/smoke/version_0/checkpoints/*-best.ckpt"))
        check(len(best) == 1, f"best checkpoints: {best}")
        check(json.loads((model_dir / "train_status.json").read_text())["status"] == "COMPLETED",
              "train_status.json is not COMPLETED")
        files = check_image_preds(model_dir, "CollectedData.csv", ["pixel_error"])
        log(f"phase 8 train()'s evaluation: image_preds/CollectedData.csv/ {files} and their legacy copies")

        video = write_video(Path(tmp) / "synthetic.mp4", rng, 150, 240, 320)
        normalize_kernel.launches = decode_kernel.launches = 0
        df = Model.from_dir(model_dir).predict_on_video_file(video).predictions
        torch.cuda.synchronize()
        predict_launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
        check((model_dir / "video_preds" / "synthetic.csv").is_file(), "the trained dir's CSV was not written")
        check(df.shape == (150, 3 * KEYPOINTS) and np.isfinite(df.to_numpy()).all(),
              f"the trained dir's CSV: shape {df.shape} or non-finite values")
        check(all(n > 0 for n in predict_launches.values()), f"predict launches {predict_launches}")
        log(f"phase 8 predict from the trained dir: {df.shape[0]} rows, finite, launches {predict_launches}")
        label_csv_phase(model_dir, card)

        # -- 9. the train step's times -------------------------------------------
        spe = trainer.calculate_steps_per_epoch(result.data_module)
        torch.manual_seed(SEED)
        model = build_model("heatmap", "resnet50", KEYPOINTS, DOWNSAMPLE).to(dev, memory_format=torch.channels_last)
        optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, spe, model)
        state = trainer.TrainState(model=model, optimizer=optimizer, step=UNFREEZE_STEP)
        engine = AugmentationEngine("dlc", IMAGE, IMAGE)
        step = trainer.make_step_fns({"model_type": "heatmap", "downsample_factor": DOWNSAMPLE},
                                     get_loss_factories(cfg), engine, cfg, head_sched, bb_sched, spe)[2]
        cache = trainer._device_cache(result.data_module.dataset, dev)
        valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
        draw_gen, field_gen = torch.Generator().manual_seed(SEED), torch.Generator(dev).manual_seed(SEED)

        def one_step():
            idxs = torch.from_numpy(rng.permutation(TRAIN_FRAMES)[:TRAIN_BATCH]).to(dev)
            step(state, cache, idxs, valid, engine.sample(draw_gen, TRAIN_BATCH, field_gen))

        for _ in range(3):
            one_step()
        n = 20
        step_ms = timed(lambda: [one_step() for _ in range(n)]) * 1e3 / n
        batch = {k: v[:TRAIN_BATCH] for k, v in cache.items()}
        draws = engine.sample(draw_gen, TRAIN_BATCH, field_gen)
        aug_ms = cuda_ms(lambda: engine.apply(batch["images"], batch["keypoints"], batch["visibility"], draws))
        log(f"phase 9 train step (ResNet-50, {IMAGE} px, bf16, batch {TRAIN_BATCH}, dlc, backbone unfrozen): "
            f"{step_ms:.3f} ms, {TRAIN_BATCH / step_ms * 1e3:.1f} frames/s, mean of {n} steps by the host clock "
            f"with draws sampled in each; the augmentation's apply() alone {aug_ms:.3f} ms per call (CUDA "
            f"events over back-to-back calls with one draw, which count the host's launch gaps) {card}")


# -- the context model (heatmap_mhcrnn) ----------------------------------------------


def multiframe_maps(rng, dev):
    """The multi-frame head's maps of a random-init context model (ResNet-50,
    17 keypoints, the CRNN at Xavier gain 1.0 as flax initialises it) on the
    28 windows of a 32-frame window, train mode, bf16: ``(28, 17, 64, 64)``
    fp32 probability maps, far more peaked than the single-frame head's."""
    import torch

    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.models.heatmap_tracker_mhcrnn import make_context_windows
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images

    torch.manual_seed(SEED)
    model = build_model("heatmap_mhcrnn", "resnet50", KEYPOINTS, DOWNSAMPLE)
    model = model.to(dev, memory_format=torch.channels_last).train()
    frames = torch.from_numpy(rng.integers(0, 256, (WINDOW, IMAGE, IMAGE, 3), dtype=np.uint8)).to(dev)
    windows = make_context_windows(normalize_images(frames).permute(0, 3, 1, 2))
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        hm_sf, hm_mf = model(windows)
    peak = lambda hm: float(hm.flatten(2).amax(-1).mean())  # noqa: E731
    log(f"phase 3 multi-frame maps of a random-init context model {tuple(hm_mf.shape)}: mean peak "
        f"{peak(hm_mf):.3e} (the single-frame head's {peak(hm_sf):.3e}; a uniform map's {1 / hm_mf[0, 0].numel():.3e})")
    return hm_mf.float().contiguous()


def context_kernel_checks(rng, engine, errors: dict) -> dict:
    """Phase 3 at the context model's shapes: the warp over 16 stacks (80
    images, each stack's field repeated over its 5 frames), CLAHE over the
    15 planes of each stack that phase 12a's draws fire it on, one input a
    fired step, and the decode and its backward on multi-frame-head maps
    ``(28, 17, 64, 64)``, each against its plain version. Returns the
    inputs, for the times."""
    import torch

    from lightning_pose_tpu_torch.ops import decode_kernel, warp_kernel

    dev = torch.device("cuda", 0)
    draws = forced_draws(engine, TRAIN_BATCH, SEED + 2)
    _, coords, _, _ = engine.sampling_grid(draws, TRAIN_BATCH, dev)
    coords = coords.repeat_interleave(CONTEXT_FRAMES, dim=0).contiguous()
    n_img = TRAIN_BATCH * CONTEXT_FRAMES
    stacks = torch.from_numpy(rng.uniform(0, 255, (n_img, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
    out = warp_kernel.warp(stacks, coords)
    ref = warp_kernel.warp_plain(stacks, coords)
    torch.cuda.synchronize()
    err = float((out - ref).abs().max())
    log(f"phase 3 warp context stacks {tuple(stacks.shape)}, {TRAIN_BATCH} fields repeated over "
        f"{CONTEXT_FRAMES} frames: max abs err {err:.3e} gray (limit {GRAY_TOL})")
    check(bool(torch.isfinite(out).all()) and err <= GRAY_TOL, "warp of context stacks disagrees with its plain version")
    errors["warp"] = max(errors["warp"], err)

    clahe_inputs = []
    for n_fired in clahe_fired_stacks(engine, CONTEXT_STEPS):
        planes = torch.from_numpy(rng.uniform(0, 255, (n_fired * CONTEXT_FRAMES, 3, IMAGE, IMAGE)).astype(np.float32))
        clip = torch.from_numpy(np.repeat(rng.uniform(1.0, 8.0, n_fired), CONTEXT_FRAMES).astype(np.float32))
        err, x_lut = check_clahe(planes.to(dev), clip.to(dev), 16)
        errors["clahe"] = max(errors["clahe"], err)
        clahe_inputs.append(x_lut)

    hm = multiframe_maps(rng, dev)
    kp, conf = decode_kernel.decode(hm, DOWNSAMPLE)
    kp_ref, conf_ref = decode_kernel.decode_plain(hm, DOWNSAMPLE)
    torch.cuda.synchronize()
    kp_err, conf_err, flips = decode_errors(kp, conf, kp_ref, conf_ref, decode_kernel.GRID_OFFSETS[DOWNSAMPLE])
    log(f"phase 3 decode multi-frame maps {tuple(hm.shape)}: keypoints max abs err {kp_err:.3e} px (limit "
        f"{DECODE_KP_TOL_PX}), confidences {conf_err:.3e} (limit {DECODE_CONF_TOL}), windows differing {flips} "
        f"(limit {DECODE_MAX_WINDOW_FLIPS})")
    check(bool(torch.isfinite(kp).all() and torch.isfinite(conf).all()), "decode multi-frame maps: non-finite")
    check(kp_err <= DECODE_KP_TOL_PX and conf_err <= DECODE_CONF_TOL and flips <= DECODE_MAX_WINDOW_FLIPS,
          "decode of multi-frame maps disagrees with its plain version")
    errors["decode"] = max(errors["decode"], kp_err)
    grad, grad_ref = decode_grads(hm, DOWNSAMPLE, seed=SEED + 5)
    err, scale = float((grad - grad_ref).abs().max()), float(grad_ref.abs().max())
    log(f"phase 3 decode backward multi-frame maps {tuple(hm.shape)}: max abs err {err:.3e} of a largest entry "
        f"{scale:.3e} ({err / scale:.2e}, limit {DECODE_GRAD_REL_TOL})")
    check(bool(torch.isfinite(grad).all()) and scale > 0, "decode backward of multi-frame maps: non-finite or zero")
    check(err <= DECODE_GRAD_REL_TOL * scale, "decode backward of multi-frame maps disagrees with its plain version")
    errors["decode_grad"] = max(errors["decode_grad"], err)
    return {"stacks": stacks, "coords": coords, "hm_mf": hm, "clahe": clahe_inputs}


def bound_of(n_bytes: int, flops: int) -> tuple[float, str]:
    """The least time the card could take for a kernel's work: its bytes at
    the HBM rate or its FP32 operations at the FP32 rate, the larger."""
    by_bytes, by_ops = n_bytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOPS_PER_S * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops, "operations")


def context_times(inputs: dict, card: str) -> dict[str, tuple]:
    """Phase 12e: each kernel at the shapes the context model's paths give
    it, beside its plain version, its bound and, for the warp,
    ``F.grid_sample``: the warp over a step's 80 stack images (phase 12a),
    CLAHE at each fired step's planes (12a; the mean a launch), with the L2
    flushed before each launch; the decode at a video batch's 92 windows
    (12b) and its backward at an unlabeled window's 28 (12d), on
    multi-frame maps, back to back. Returns name -> (ms, plain_ms,
    library_ms, (bound_ms, bound_by), shape)."""
    import torch
    import torch.nn.functional as F

    from lightning_pose_tpu_torch.ops import clahe_kernel, decode_kernel, warp_kernel

    dev = torch.device("cuda", 0)
    stacks, coords, hm = inputs["stacks"], inputs["coords"], inputs["hm_mf"]
    nchw = stacks.permute(0, 3, 1, 2)
    grid = torch.stack([2 * coords[..., 0] / (IMAGE - 1) - 1, 2 * coords[..., 1] / (IMAGE - 1) - 1], dim=-1)
    warp_rounds = flushed_rounds({
        "kernel": lambda: warp_kernel.warp(stacks, coords),
        "grid_sample": lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
    })
    warp_plain_ms = flushed_ms(lambda: warp_kernel.warp_plain(stacks, coords), iters=10)

    clahe = [(flushed_ms(lambda: clahe_kernel.clahe_apply(x, lut, 16)),
              flushed_ms(lambda: clahe_kernel.clahe_apply_plain(x, lut, 16), iters=10),
              bound_of((x.numel() * 2 + lut.numel()) * 4, 0)[0]) for x, lut in inputs["clahe"]]
    planes = [x.shape[0] for x, _ in inputs["clahe"]]

    hm_video = hm.repeat(4, 1, 1, 1)[:BATCH - 4].contiguous()  # a video batch's 92 windows
    n_maps, hm_h, hm_w = hm_video.shape[0] * KEYPOINTS, hm.shape[2], hm.shape[3]
    dec_ms = cuda_ms(lambda: decode_kernel.decode(hm_video, DOWNSAMPLE), iters=50)
    dec_plain_ms = cuda_ms(lambda: decode_kernel.decode_plain(hm_video, DOWNSAMPLE))
    dec_bound = bound_of((hm_video.numel() + n_maps * 3) * 4, decode_flops(n_maps, hm_h, hm_w, DOWNSAMPLE))

    n_maps = hm.shape[0] * KEYPOINTS
    ops = decode_kernel._device_operands(hm_h, hm_w, DOWNSAMPLE, decode_kernel._layout(), dev)
    lse2 = torch.empty(n_maps, device=dev)
    kp, _ = decode_kernel._launch(hm, ops, DOWNSAMPLE, 1000.0, lse2)
    g = torch.randn(kp.shape, device=dev)
    grad_ms = cuda_ms(lambda: decode_kernel._launch_grad(hm, kp, lse2, g, ops, DOWNSAMPLE, 1000.0), iters=50)
    x = hm.clone().requires_grad_()
    kp_plain, _ = decode_kernel.decode_plain(x, DOWNSAMPLE)
    grad_plain_ms = cuda_ms(lambda: torch.autograd.grad(kp_plain, x, g, retain_graph=True))
    grad_bound = bound_of((2 * hm.numel() + n_maps * 5) * 4, decode_grad_flops(n_maps, hm_h, hm_w, DOWNSAMPLE))

    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    times = {
        "warp": (float(np.median(warp_rounds["kernel"])), warp_plain_ms, float(np.median(warp_rounds["grid_sample"])),
                 bound_of((stacks.numel() * 2 + coords.numel()) * 4, 0),
                 f"{tuple(stacks.shape)} fp32, {TRAIN_BATCH} fields repeated over {CONTEXT_FRAMES} frames"),
        "clahe": (mean([c[0] for c in clahe]), mean([c[1] for c in clahe]), None, (mean([c[2] for c in clahe]), "bytes"),
                  f"(planes, {IMAGE}, {IMAGE}) fp32 g=16, planes {planes} in phase 12a's fired steps; the mean a launch"),
        "decode": (dec_ms, dec_plain_ms, None, dec_bound,
                   f"{tuple(hm_video.shape)} fp32 multi-frame maps, df {DOWNSAMPLE}"),
        "decode_grad": (grad_ms, grad_plain_ms, None, grad_bound,
                        f"{tuple(hm.shape)} fp32 multi-frame maps, df {DOWNSAMPLE}"),
    }
    for name, (ms, plain_ms, library_ms, (bound, bound_by), shape) in times.items():
        lib_text = f", F.grid_sample {library_ms:.5f} ms" if library_ms is not None else ""
        log(f"phase 12e {name} at the context model's shape {shape}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms"
            f"{lib_text}; bound {bound:.5f} ms ({bound_by}), {bound / ms:.1%} of it reached {card}")
    return times


def context_config(cfg, name: str):
    """The context model (heatmap_mhcrnn, adjacent context) in ``cfg``:
    CONTEXT_STEPS steps, seeded draws, 96-frame prediction sequences (92
    windows a batch)."""
    cfg.model.model_type = "heatmap_mhcrnn"
    cfg.model.model_name = name
    cfg.training.max_steps = cfg.training.min_steps = CONTEXT_STEPS
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [5, 8]
    cfg.training.rng_seed_data_pt = CONTEXT_SEED
    cfg.dali.context.predict.sequence_length = BATCH
    return cfg


def clahe_fired_stacks(engine, steps: int, seed: int = CONTEXT_SEED, b: int = TRAIN_BATCH) -> list[int]:
    """The stacks (or view images) that CLAHE fires on in each step of a
    supervised train() of ``b`` draws a step from ``seed`` (phase 12a: 16
    stacks, 15 planes each; 13a: 32 view images, 3 planes each), in the
    steps whose draws (the same seeded host generator as train()'s) fire
    it at all: one CLAHE launch each."""
    import torch

    gen = torch.Generator().manual_seed(seed)
    field_gen = torch.Generator("cuda").manual_seed(seed)
    p = engine.spec["clahe"]["p"]
    fired = [int((engine.sample(gen, b, field_gen).clahe_u < p).sum()) for _ in range(steps)]
    return [n for n in fired if n]


def profiled_step(one_step, n: int = 10, n_prof: int = 5) -> tuple[float, float, list, float]:
    """The step's mean ms over ``n`` steps by the host clock, then
    ``torch.profiler`` over ``n_prof``: device ms a step, its device-time
    entries (the Adam annotation left out: it spans the Adam kernels) and
    the device's busy share of the profiled time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        one_step()
    step_ms = timed(lambda: [one_step() for _ in range(n)]) * 1e3 / n
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        prof_s = timed(lambda: [one_step() for _ in range(n_prof)])
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA and "Optimizer.step" not in e.key]
    device_us = sum(e.self_device_time_total for e in kernels)
    return step_ms, device_us / 1e3 / n_prof, kernels, device_us / (prof_s * 1e6)


def context_predict_phase(model_dir: Path, video: Path, card: str) -> dict[str, int]:
    """Phases 12b and 12c from the context model's directory. Returns the
    normalize and decode launches of the first video run."""
    import math
    import shutil

    import torch

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.config import Config
    from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel

    model = Model.from_dir(model_dir)
    model._load()  # the model's load and weights stay out of the counts and the time
    torch.cuda.synchronize()
    rates = []
    for run in range(CONTEXT_VIDEO_RUNS):
        normalize_kernel.launches = decode_kernel.launches = 0
        t0 = time.perf_counter()
        df = model.predict_on_video_file(video, compute_metrics=False).predictions
        rates.append(CONTEXT_VIDEO_FRAMES / (time.perf_counter() - t0))
        if run == 0:
            video_launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
    batches = math.ceil((CONTEXT_VIDEO_FRAMES - 4) / (BATCH - 4))
    check(df.shape == (CONTEXT_VIDEO_FRAMES, 3 * KEYPOINTS) and np.isfinite(df.to_numpy()).all(),
          f"the context model's video CSV: shape {df.shape} or non-finite values")
    check(video_launches == {"normalize": batches, "decode": 2 * batches},
          f"context video launches {video_launches}, {batches} batches of {BATCH - 4} windows")
    log(f"phase 12b predict_on_video_file (bf16, without metrics): {CONTEXT_VIDEO_FRAMES} frames of a 320x240 mp4 "
        f"in {batches} batches of {BATCH} frames ({BATCH - 4} windows), one finite row per frame; launches "
        f"{video_launches} (normalize 1, decode 2 a batch) in the first run; frames/s with the mp4's decode, the "
        f"model loaded before: {rates[0]:.1f} in the first run (loader threads started, first calls at these "
        f"shapes), {', '.join(f'{r:.1f}' for r in rates[1:])} in the next {len(rates) - 1} {card}")

    normalize_kernel.launches = decode_kernel.launches = 0
    t0 = time.perf_counter()
    result = model.predict_on_label_csv("CollectedData.csv", output_dir=model_dir / "label_csv_bf16")
    elapsed = time.perf_counter() - t0
    csv_launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
    csv_batches = math.ceil(TRAIN_FRAMES / int(model.cfg.training.test_batch_size))
    check(csv_launches == {"normalize": csv_batches, "decode": 2 * csv_batches},
          f"context label CSV launches {csv_launches}, {csv_batches} batches")
    frame_df = result.predictions
    check(frame_df.shape == (TRAIN_FRAMES, 3 * KEYPOINTS + 1) and np.isfinite(frame_df.iloc[:, :-1].to_numpy(float)).all(),
          f"context predict_on_label_csv: shape {frame_df.shape} or non-finite values")
    check(result.metrics is not None and result.metrics.pixel_error_df is not None, "no pixel-error metrics")
    log(f"phase 12b predict_on_label_csv (bf16): {TRAIN_FRAMES} context stacks in {csv_batches} batches, launches "
        f"{csv_launches}, {elapsed:.2f} s with metrics {card}")

    srng = np.random.default_rng(SEED + 7)
    stacks = srng.integers(0, 256, (2, CONTEXT_FRAMES, 240, 320, 3), dtype=np.uint8)
    out = model.predict_frame(stacks[0], bbox=(10, 20, 280, 200))
    check(out["keypoints"].shape == (KEYPOINTS, 2) and np.isfinite(out["keypoints"]).all()
          and np.isfinite(out["confidence"]).all(), "predict_frame of a context stack")
    fp32 = {d: Model.from_dir(model_dir, precision="fp32", device=d) for d in ("cuda", "cpu")}
    res = {d: [m.predict_frame(st) for st in stacks] for d, m in fp32.items()}
    kp_diff = max(float(np.abs(a["keypoints"] - b["keypoints"]).max()) for a, b in zip(res["cuda"], res["cpu"]))
    conf_diff = max(float(np.abs(a["confidence"] - b["confidence"]).max()) for a, b in zip(res["cuda"], res["cpu"]))
    log(f"phase 12b predict_frame of a (5, 240, 320, 3) stack with a bbox: finite; fp32 card (TF32 off) vs CPU on "
        f"2 stacks: keypoints max abs diff {kp_diff:.3e} px (limit {CONTEXT_TOL_PX}), confidences {conf_diff:.3e}")
    check(kp_diff <= CONTEXT_TOL_PX, f"context predict_frame card vs CPU: {kp_diff} px")

    # -- 12c. repeat_center from the same weights ---------------------------------
    rc_dir = model_dir.parent / "model_repeat_center"
    shutil.copytree(model_dir, rc_dir, ignore=shutil.ignore_patterns("label_csv_*", "video_preds", "image_preds"))
    cfg = Config.from_yaml(str(rc_dir / "config.yaml"))
    cfg.model.mhcrnn_context_mode = "repeat_center"
    cfg.save(str(rc_dir / "config.yaml"))
    adjacent, repeat = fp32["cuda"], Model.from_dir(rc_dir, precision="fp32")
    repeat._load()
    seen = {"adjacent": 0, "repeat_center": 0}
    for name, m in (("adjacent", adjacent), ("repeat_center", repeat)):
        m._predict_step.model.backbone.register_forward_pre_hook(
            lambda mod, args, name=name: seen.__setitem__(name, seen[name] + args[0].shape[0]))
    centers = srng.integers(0, 256, (2, 240, 320, 3), dtype=np.uint8)
    repeated = [np.repeat(c[None], CONTEXT_FRAMES, axis=0) for c in centers]
    out_a = [adjacent.predict_frame(st) for st in repeated]
    out_r = [repeat.predict_frame(st) for st in repeated]
    kp_diff = max(float(np.abs(a["keypoints"] - b["keypoints"]).max()) for a, b in zip(out_a, out_r))
    conf_diff = max(float(np.abs(a["confidence"] - b["confidence"]).max()) for a, b in zip(out_a, out_r))
    stack_images = dict(seen)
    check(stack_images == {"adjacent": 2 * CONTEXT_FRAMES, "repeat_center": 2},
          f"backbone images on 2 stacks: {stack_images}")
    check(kp_diff <= CONTEXT_TOL_PX and conf_diff <= CONTEXT_CONF_TOL,
          f"repeat_center vs adjacent on repeated stacks: {kp_diff} px, confidences {conf_diff}")
    seen["repeat_center"] = 0
    df_r = repeat.predict_on_video_file(video, compute_metrics=False).predictions
    check(df_r.shape == (CONTEXT_VIDEO_FRAMES, 3 * KEYPOINTS) and np.isfinite(df_r.to_numpy()).all(),
          "repeat_center video CSV")
    check(seen["repeat_center"] == batches * (BATCH - 4), f"repeat_center video: backbone saw {seen['repeat_center']}")
    log(f"phase 12c repeat_center (fp32, TF32 off) from the same weights: the backbone took {stack_images} images for "
        f"2 stacks and {seen['repeat_center']} for the {CONTEXT_VIDEO_FRAMES}-frame video ({batches} batches of "
        f"{BATCH - 4} windows; adjacent context takes 5 a window); on repeated stacks against adjacent: keypoints max "
        f"abs diff {kp_diff:.3e} px (limit {CONTEXT_TOL_PX}), confidences {conf_diff:.3e} (limit {CONTEXT_CONF_TOL})")
    return video_launches


def context_phase(rng, card: str) -> dict[str, int]:
    """Phases 12a-12d: train() of the context model, supervised then
    semi-supervised, with prediction from the directory; the launches of
    each kernel on this slice's paths, each against what the code implies.
    Returns the launches of each kernel on one path: the warp and CLAHE in
    12a's train(), normalize and the decode in 12b's first video run, the
    decode's backward in 12d's train()."""
    import math

    import torch

    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import clahe_kernel, decode_kernel, normalize_kernel, warp_kernel
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.utils.synthetic import write_labeled_dataset, write_unlabeled_video

    dev = torch.device("cuda", 0)
    names = [f"kp{i}" for i in range(KEYPOINTS)]
    meta = {"model_type": "heatmap_mhcrnn", "downsample_factor": DOWNSAMPLE}
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    with tempfile.TemporaryDirectory() as tmp:
        # img0000.png, img0001.png, ...: each labeled frame has real neighbours
        data = write_labeled_dataset(Path(tmp) / "data", TRAIN_FRAMES, IMAGE, IMAGE, names, seed=SEED)
        for i in range(2):
            write_unlabeled_video(data, f"session{i}", 120, 240, 320, n_blobs=KEYPOINTS, seed=SEED + i)

        # -- 12a. supervised train() -------------------------------------------
        cfg = context_config(train_config(data, names), "smokectx")
        model_dir = Path(tmp) / "model"
        implied_clahe = len(clahe_fired_stacks(engine, CONTEXT_STEPS))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warp_kernel.launches = clahe_kernel.launches = decode_kernel.launches = normalize_kernel.launches = 0
        t0 = time.perf_counter()
        result = trainer.train(cfg, model_dir, device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"warp": warp_kernel.launches, "clahe": clahe_kernel.launches, "decode": decode_kernel.launches}
        eval_normalizes = normalize_kernel.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        dm = result.data_module
        val_logs = [h for h in result.history if "val_supervised_loss" in h]
        train_logs = [h for h in result.history if "train_heatmap_mse_loss" in h]
        val_batches = len(val_logs) * math.ceil(len(dm.val_dataset) / dm.val_batch_size)
        eval_batches = math.ceil(TRAIN_FRAMES / dm.test_batch_size)
        implied = {"warp": CONTEXT_STEPS, "clahe": implied_clahe,
                   "decode": CONTEXT_STEPS + val_batches + 2 * eval_batches}
        log(f"phase 12a context train(): {CONTEXT_STEPS} steps of {TRAIN_BATCH} stacks of {CONTEXT_FRAMES} frames "
            f"(ResNet-50, {IMAGE} px, dlc, bf16) in {elapsed:.1f} s with set-up and evaluation; launches {launches}, "
            f"implied {implied} (the warp once a step over {TRAIN_BATCH * CONTEXT_FRAMES} images, CLAHE once a step "
            f"whose draws fire it, the decode once a step on the {2 * TRAIN_BATCH} maps of both heads, once a "
            f"validation batch, twice an evaluation batch), normalize {eval_normalizes} for {eval_batches} evaluation "
            f"batches; train loss {train_logs[0]['train_heatmap_mse_loss']:.4f} -> "
            f"{train_logs[-1]['train_heatmap_mse_loss']:.4f}; peak device memory {peak:.2f} GiB {card}")
        check(launches == implied and implied_clahe >= 1, f"context train() launches {launches}, implied {implied}")
        slice_launches = {"warp": launches["warp"], "clahe": launches["clahe"]}
        check(eval_normalizes == eval_batches, f"normalize launched {eval_normalizes} times")
        check(len(train_logs) == CONTEXT_STEPS and val_logs, "context train() logged too little")
        check(all(np.isfinite(v) for h in result.history for k, v in h.items() if "loss" in k),
              "a logged loss is not finite")
        files = check_image_preds(model_dir, "CollectedData.csv", ["pixel_error"])
        log(f"phase 12a context train()'s evaluation: image_preds/CollectedData.csv/ {files}")

        spe = trainer.calculate_steps_per_epoch(dm)
        torch.manual_seed(SEED)
        model = build_model("heatmap_mhcrnn", "resnet50", KEYPOINTS, DOWNSAMPLE).to(dev, memory_format=torch.channels_last)
        optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, spe, model)
        state = trainer.TrainState(model=model, optimizer=optimizer, step=UNFREEZE_STEP)
        step = trainer.make_step_fns(meta, get_loss_factories(cfg), engine, cfg, head_sched, bb_sched, spe)[2]
        cache = trainer._device_cache(dm.dataset, dev)
        valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
        draw_gen, field_gen = torch.Generator().manual_seed(SEED), torch.Generator(dev).manual_seed(SEED)

        def one_step():
            idxs = torch.from_numpy(rng.permutation(TRAIN_FRAMES)[:TRAIN_BATCH]).to(dev)
            step(state, cache, idxs, valid, engine.sample(draw_gen, TRAIN_BATCH, field_gen))

        torch.cuda.reset_peak_memory_stats()
        step_ms, device_ms, _, busy = profiled_step(one_step)
        n_frames = TRAIN_BATCH * CONTEXT_FRAMES
        log(f"phase 12a context train step (ResNet-50, {IMAGE} px, bf16, {TRAIN_BATCH} stacks = {n_frames} frames, dlc, "
            f"backbone unfrozen): {step_ms:.3f} ms, {n_frames / step_ms * 1e3:.1f} frames/s "
            f"({TRAIN_BATCH / step_ms * 1e3:.1f} stacks/s), mean of 10 steps by the host clock; torch.profiler over 5 "
            f"steps: {device_ms:.3f} ms of device time a step, the device busy {busy:.1%}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
        del model, state, optimizer, cache

        # -- 12b, 12c. prediction from the directory --------------------------
        video = write_video(Path(tmp) / "synthetic.mp4", rng, CONTEXT_VIDEO_FRAMES, 240, 320)
        slice_launches.update(context_predict_phase(model_dir, video, card))

        # -- 12d. semi-supervised train() --------------------------------------
        cfg = context_config(semisup_config(data, names), "smokectxsemi")
        semi_dir = Path(tmp) / "semi"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warp_kernel.launches = decode_kernel.launches = decode_kernel.grad_launches = 0
        t0 = time.perf_counter()
        result = trainer.train(cfg, semi_dir, device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        semi_launches = {"warp": warp_kernel.launches, "decode": decode_kernel.launches,
                         "decode_grad": decode_kernel.grad_launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        dm = result.data_module
        train_logs = [h for h in result.history if "train_unsupervised_loss" in h]
        val_logs = [h for h in result.history if "val_supervised_loss" in h]
        val_batches = len(val_logs) * math.ceil(len(dm.val_dataset) / dm.val_batch_size)
        implied = {"warp": 2 * CONTEXT_STEPS, "decode": 3 * CONTEXT_STEPS + val_batches + 2 * eval_batches,
                   "decode_grad": 2 * CONTEXT_STEPS}
        pca = [h["train_pca_singleview_loss"] for h in train_logs]
        temporal = [h["train_temporal_loss"] for h in train_logs]
        log(f"phase 12d context semi-supervised train(): {CONTEXT_STEPS} steps of {TRAIN_BATCH} stacks + a {WINDOW}-frame "
            f"window ({CONTEXT_WINDOWS} windows of {CONTEXT_FRAMES}), pca_singleview + temporal, ResNet-50, {IMAGE} px, "
            f"bf16, in {elapsed:.1f} s with set-up, the PCA fit and evaluation; launches {semi_launches}, implied "
            f"{implied} (the decode's backward twice a step, one a head); unsupervised loss "
            f"{train_logs[0]['train_unsupervised_loss']:.3e} -> {train_logs[-1]['train_unsupervised_loss']:.3e}, "
            f"pca_singleview max {max(pca):.4f}, temporal max {max(temporal):.4f}; peak device memory {peak:.2f} GiB "
            f"{card}")
        check(semi_launches == implied, f"context semi-supervised launches {semi_launches}, implied {implied}")
        check(len(train_logs) == CONTEXT_STEPS and max(pca) > 0 and max(temporal) > 0,
              "context semi-supervised train() logged too little, or a zero unsupervised loss")
        check(all(np.isfinite(v) for h in result.history for k, v in h.items() if "loss" in k),
              "a logged loss is not finite")
        slice_launches["decode_grad"] = semi_launches["decode_grad"]

        spe = trainer.calculate_steps_per_epoch(dm)
        factories = get_loss_factories(cfg, dm)
        dm.close()
        torch.manual_seed(SEED)
        model = build_model("heatmap_mhcrnn", "resnet50", KEYPOINTS, DOWNSAMPLE).to(dev, memory_format=torch.channels_last)
        optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, spe, model)
        state = trainer.TrainState(model=model, optimizer=optimizer, step=UNFREEZE_STEP)
        step = trainer.make_step_fns(meta, factories, engine, cfg, head_sched, bb_sched, spe)[2]
        cache = trainer._device_cache(dm.dataset, dev)
        window = {
            "frames": torch.from_numpy(rng.integers(0, 256, (WINDOW, IMAGE, IMAGE, 3), dtype=np.uint8)).to(dev),
            "bbox": torch.tensor([[0.0, 0.0, 240.0, 320.0]] * WINDOW, device=dev),
        }

        def semi_step():
            idxs = torch.from_numpy(rng.permutation(TRAIN_FRAMES)[:TRAIN_BATCH]).to(dev)
            draws = engine.sample(draw_gen, TRAIN_BATCH, field_gen)
            step(state, cache, idxs, valid, draws, window, sample_video_draws(draw_gen, WINDOW, IMAGE, IMAGE, field_gen))

        torch.cuda.reset_peak_memory_stats()
        step_ms, device_ms, kernels, busy = profiled_step(semi_step)
        grad_ms = sum(e.self_device_time_total for e in kernels if "decode_grad_kernel" in e.key) / 5e3
        n_frames = TRAIN_BATCH * CONTEXT_FRAMES + CONTEXT_WINDOWS * CONTEXT_FRAMES
        log(f"phase 12d context semi-supervised step (ResNet-50, {IMAGE} px, bf16, {TRAIN_BATCH} stacks with dlc + "
            f"{CONTEXT_WINDOWS} windows of a {WINDOW}-frame window = {n_frames} backbone images, backbone unfrozen): "
            f"{step_ms:.3f} ms, {n_frames / step_ms * 1e3:.1f} backbone images/s, mean of 10 steps by the host clock; "
            f"torch.profiler over 5 steps: {device_ms:.3f} ms of device time a step, the device busy {busy:.1%}; the "
            f"decode's backward {grad_ms:.4f} ms a step over its 2 launches ({grad_ms / device_ms:.2%} of the device "
            f"time); peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        log("phase 12d largest device-time entries a step: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 5e3:.3f} ms" for e in top))
    return slice_launches


# -- the multiview transformer (heatmap_multiview) ------------------------------------


def multiview_config(data_dir: Path, keypoint_names: list[str], name: str, semi: bool):
    """The repo's multiview config (scripts/configs/config_default_multiview.yaml)
    at full width on the synthetic 2-view set: vits_dino, 2 views of 17
    keypoints at 256 px, batch 16 with dlc, Adam 5e-5, MV_STEPS steps in
    step mode, the patch mask from step 0 ramping 0.1 -> 0.5 over the steps.
    ``semi``: pca_multiview + temporal over one 32-frame 2-view window a
    step, the anneal weight 1 from step 0 and the epsilons 0 as in phase
    11, and the videos' sessions predicted after training."""
    cfg = train_config(data_dir, keypoint_names)
    cfg.data.csv_file = [f"CollectedData_{v}.csv" for v in MV_VIEWS]
    cfg.data.view_names = list(MV_VIEWS)
    cfg.data.mirrored_column_matches = list(range(KEYPOINTS))
    cfg.model.model_type = "heatmap_multiview_transformer"
    cfg.model.backbone = MV_BACKBONE
    cfg.model.model_name = name
    cfg.training.optimizer_params.learning_rate = MV_LR
    cfg.training.max_steps = cfg.training.min_steps = MV_STEPS
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [5, 8]
    cfg.training.rng_seed_data_pt = MV_SEED
    cfg.training.patch_mask = {"init_step": 0, "final_step": MV_STEPS, "init_ratio": 0.1, "final_ratio": 0.5}
    if semi:
        cfg.model.losses_to_use = ["pca_multiview", "temporal"]
        check(int(cfg.dali.base.train.sequence_length) == WINDOW, "the defaults changed")
        cfg.losses.pca_multiview.epsilon = 0.0
        cfg.losses.temporal.epsilon = 0.0
        cfg.losses.temporal.prob_threshold = 0.0
        cfg.callbacks.anneal_weight.init_val = 1.0
        cfg.callbacks.anneal_weight.freeze_until_epoch = 0
        cfg.eval.test_videos_directory = str(Path(data_dir) / "videos")
    return cfg


def multiview_maps(rng, dev):
    """The maps of a random-init multiview transformer (vits_dino, 2 views,
    17 keypoints; its head's deconv scaled by 300 so the maps are peaked, as
    the CPU tests do) on 16 samples of 2 random 256 px views, train mode,
    bf16: ``(16, 34, 64, 64)`` fp32 probability maps."""
    import torch

    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images

    torch.manual_seed(SEED)
    model = build_model("heatmap_multiview", MV_BACKBONE, KEYPOINTS, DOWNSAMPLE, num_views=len(MV_VIEWS),
                        image_size=IMAGE)
    with torch.no_grad():
        model.head.deconv0.weight.mul_(300.0)
    model = model.to(dev, memory_format=torch.channels_last).train()
    views = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, len(MV_VIEWS), IMAGE, IMAGE, 3), dtype=np.uint8))
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        hm = model(normalize_images(views.to(dev)).permute(0, 1, 4, 2, 3))
    log(f"phase 3 maps of a random-init multiview transformer {tuple(hm.shape)}: mean peak "
        f"{float(hm.flatten(2).amax(-1).mean()):.3e} (a uniform map's {1 / hm[0, 0].numel():.3e})")
    return hm.float().contiguous()


def multiview_kernel_checks(rng, engine, errors: dict) -> dict:
    """Phase 3 at the multiview transformer's shapes: the normalize on a
    ``(96, 2, 256, 256, 3)`` video batch (one launch over both views), the
    warp over a step's 32 view images, CLAHE over the planes of the view
    images that phase 13a's draws fire it on (one input a fired step), the
    decode on a video batch's ``(96, 34, 64, 64)`` maps and its backward on
    an unlabeled window's ``(32, 34, 64, 64)``, each against its plain
    version. Returns the inputs, for the times."""
    import torch

    from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel, warp_kernel

    dev = torch.device("cuda", 0)
    nv = len(MV_VIEWS)
    frames = torch.from_numpy(rng.integers(0, 256, (BATCH, nv, IMAGE, IMAGE, 3), dtype=np.uint8)).to(dev)
    out = normalize_kernel.normalize(frames, torch.bfloat16)
    ref = normalize_kernel.normalize_plain(frames, torch.bfloat16)
    torch.cuda.synchronize()
    ulps = bf16_ulps(out, ref)
    log(f"phase 3 normalize multiview {tuple(frames.shape)} -> {tuple(out.shape)} bf16: {ulps} bf16 ulps from the "
        f"plain version (limit {NORMALIZE_MAX_ULP})")
    check(out.shape == (BATCH, nv, 3, IMAGE, IMAGE) and ulps <= NORMALIZE_MAX_ULP,
          "normalize of a multiview batch disagrees with its plain version")
    errors["normalize"] = max(errors["normalize"], float((out.float() - ref.float()).abs().max()))

    n_img = TRAIN_BATCH * nv
    draws = forced_draws(engine, n_img, SEED + 8)
    _, coords, _, _ = engine.sampling_grid(draws, n_img, dev)
    coords = coords.contiguous()
    images = torch.from_numpy(rng.uniform(0, 255, (n_img, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
    errors["warp"] = max(errors["warp"], check_warp(engine, images, draws, f"multiview {TRAIN_BATCH}x{nv} views"))

    clahe_inputs = []
    for n_fired in clahe_fired_stacks(engine, MV_STEPS, MV_SEED, n_img):
        planes = torch.from_numpy(rng.uniform(0, 255, (n_fired, 3, IMAGE, IMAGE)).astype(np.float32))
        clip = torch.from_numpy(rng.uniform(1.0, 8.0, n_fired).astype(np.float32))
        err, x_lut = check_clahe(planes.to(dev), clip.to(dev), 16)
        errors["clahe"] = max(errors["clahe"], err)
        clahe_inputs.append(x_lut)

    hm_window = multiview_maps(rng, dev).repeat(2, 1, 1, 1).contiguous()  # a 32-frame window's maps
    hm_video = hm_window.repeat(3, 1, 1, 1).contiguous()  # a video batch's 96 frames
    kp, conf = decode_kernel.decode(hm_video, DOWNSAMPLE)
    kp_ref, conf_ref = decode_kernel.decode_plain(hm_video, DOWNSAMPLE)
    torch.cuda.synchronize()
    kp_err, conf_err, flips = decode_errors(kp, conf, kp_ref, conf_ref, decode_kernel.GRID_OFFSETS[DOWNSAMPLE])
    log(f"phase 3 decode multiview maps {tuple(hm_video.shape)}: keypoints max abs err {kp_err:.3e} px (limit "
        f"{DECODE_KP_TOL_PX}), confidences {conf_err:.3e} (limit {DECODE_CONF_TOL}), windows differing {flips} "
        f"(limit {DECODE_MAX_WINDOW_FLIPS})")
    check(bool(torch.isfinite(kp).all() and torch.isfinite(conf).all()), "decode multiview maps: non-finite")
    check(kp_err <= DECODE_KP_TOL_PX and conf_err <= DECODE_CONF_TOL and flips <= DECODE_MAX_WINDOW_FLIPS,
          "decode of multiview maps disagrees with its plain version")
    errors["decode"] = max(errors["decode"], kp_err)
    grad, grad_ref = decode_grads(hm_window, DOWNSAMPLE, seed=SEED + 9)
    err, scale = float((grad - grad_ref).abs().max()), float(grad_ref.abs().max())
    log(f"phase 3 decode backward multiview maps {tuple(hm_window.shape)}: max abs err {err:.3e} of a largest entry "
        f"{scale:.3e} ({err / scale:.2e}, limit {DECODE_GRAD_REL_TOL})")
    check(bool(torch.isfinite(grad).all()) and scale > 0, "decode backward of multiview maps: non-finite or zero")
    check(err <= DECODE_GRAD_REL_TOL * scale, "decode backward of multiview maps disagrees with its plain version")
    errors["decode_grad"] = max(errors["decode_grad"], err)
    return {"frames": frames, "images": images, "coords": coords, "clahe": clahe_inputs,
            "hm_video": hm_video, "hm_window": hm_window}


def multiview_times(inputs: dict, card: str) -> dict[str, tuple]:
    """Phase 13e: each kernel at the shapes the multiview paths give it,
    beside its plain version, its bound and, for the warp,
    ``F.grid_sample``: the normalize on a video batch (13c), the warp over a
    step's 32 view images and CLAHE at each fired step's planes (13a; the
    mean a launch), with the L2 flushed before each launch; the decode on a
    video batch's 96 x 34 maps (13c) and its backward on a window's 32 x 34
    (13b), back to back. Returns name -> (ms, plain_ms, library_ms,
    (bound_ms, bound_by), shape)."""
    import torch
    import torch.nn.functional as F

    from lightning_pose_tpu_torch.ops import clahe_kernel, decode_kernel, normalize_kernel, warp_kernel

    dev = torch.device("cuda", 0)
    frames, images, coords = inputs["frames"], inputs["images"], inputs["coords"]
    norm_ms = flushed_ms(lambda: normalize_kernel.normalize(frames, torch.bfloat16))
    norm_plain_ms = flushed_ms(lambda: normalize_kernel.normalize_plain(frames, torch.bfloat16), iters=10)

    nchw = images.permute(0, 3, 1, 2)
    grid = torch.stack([2 * coords[..., 0] / (IMAGE - 1) - 1, 2 * coords[..., 1] / (IMAGE - 1) - 1], dim=-1)
    warp_rounds = flushed_rounds({
        "kernel": lambda: warp_kernel.warp(images, coords),
        "grid_sample": lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
    })
    warp_plain_ms = flushed_ms(lambda: warp_kernel.warp_plain(images, coords), iters=10)

    clahe = [(flushed_ms(lambda: clahe_kernel.clahe_apply(x, lut, 16)),
              flushed_ms(lambda: clahe_kernel.clahe_apply_plain(x, lut, 16), iters=10),
              bound_of((x.numel() * 2 + lut.numel()) * 4, 0)[0]) for x, lut in inputs["clahe"]]
    planes = [x.shape[0] for x, _ in inputs["clahe"]]

    hm_video, hm = inputs["hm_video"], inputs["hm_window"]
    n_maps, hm_h, hm_w = hm_video.shape[0] * hm_video.shape[1], hm.shape[2], hm.shape[3]
    dec_ms = cuda_ms(lambda: decode_kernel.decode(hm_video, DOWNSAMPLE), iters=50)
    dec_plain_ms = cuda_ms(lambda: decode_kernel.decode_plain(hm_video, DOWNSAMPLE))
    dec_bound = bound_of((hm_video.numel() + n_maps * 3) * 4, decode_flops(n_maps, hm_h, hm_w, DOWNSAMPLE))

    n_maps = hm.shape[0] * hm.shape[1]
    ops = decode_kernel._device_operands(hm_h, hm_w, DOWNSAMPLE, decode_kernel._layout(), dev)
    lse2 = torch.empty(n_maps, device=dev)
    kp, _ = decode_kernel._launch(hm, ops, DOWNSAMPLE, 1000.0, lse2)
    g = torch.randn(kp.shape, device=dev)
    grad_ms = cuda_ms(lambda: decode_kernel._launch_grad(hm, kp, lse2, g, ops, DOWNSAMPLE, 1000.0), iters=50)
    x = hm.clone().requires_grad_()
    kp_plain, _ = decode_kernel.decode_plain(x, DOWNSAMPLE)
    grad_plain_ms = cuda_ms(lambda: torch.autograd.grad(kp_plain, x, g, retain_graph=True))
    grad_bound = bound_of((2 * hm.numel() + n_maps * 5) * 4, decode_grad_flops(n_maps, hm_h, hm_w, DOWNSAMPLE))

    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    nv = len(MV_VIEWS)
    times = {
        "normalize": (norm_ms, norm_plain_ms, None, bound_of(frames.numel() * (1 + 2), 0),
                      f"{tuple(frames.shape)} uint8 -> bf16, a video batch of {nv} views"),
        "warp": (float(np.median(warp_rounds["kernel"])), warp_plain_ms, float(np.median(warp_rounds["grid_sample"])),
                 bound_of((images.numel() * 2 + coords.numel()) * 4, 0),
                 f"{tuple(images.shape)} fp32, {TRAIN_BATCH} samples x {nv} views, one field an image"),
        "clahe": (mean([c[0] for c in clahe]), mean([c[1] for c in clahe]), None, (mean([c[2] for c in clahe]), "bytes"),
                  f"(planes, {IMAGE}, {IMAGE}) fp32 g=16, planes {planes} in phase 13a's fired steps; the mean a launch"),
        "decode": (dec_ms, dec_plain_ms, None, dec_bound,
                   f"{tuple(hm_video.shape)} fp32 multiview maps ({nv} views x {KEYPOINTS}), df {DOWNSAMPLE}"),
        "decode_grad": (grad_ms, grad_plain_ms, None, grad_bound,
                        f"{tuple(hm.shape)} fp32 multiview maps ({nv} views x {KEYPOINTS}), df {DOWNSAMPLE}"),
    }
    for name, (ms, plain_ms, library_ms, (bound, bound_by), shape) in times.items():
        lib_text = f", F.grid_sample {library_ms:.5f} ms" if library_ms is not None else ""
        log(f"phase 13e {name} at the multiview shape {shape}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms"
            f"{lib_text}; bound {bound:.5f} ms ({bound_by}), {bound / ms:.1%} of it reached {card}")
    return times


def check_multiview_preds(model_dir: Path) -> list[str]:
    """train()'s evaluation of a multiview model: image_preds/<view csv>/
    predictions.csv and its pixel-error CSV for each view, with their
    legacy copies predictions_<view>*.csv in the model directory."""
    import pandas as pd

    found = []
    for view in MV_VIEWS:
        preds_dir = model_dir / "image_preds" / f"CollectedData_{view}.csv"
        files = sorted(f.name for f in preds_dir.glob("*.csv"))
        check(files == ["predictions.csv", "predictions_pixel_error.csv"], f"{preds_dir}: {files}")
        df = pd.read_csv(preds_dir / "predictions.csv", header=[0, 1, 2], index_col=0)
        check(df.shape == (TRAIN_FRAMES, 3 * KEYPOINTS + 1) and df.columns[-1][0] == "set"
              and np.isfinite(df.iloc[:, :-1].to_numpy(float)).all(), f"{preds_dir}/predictions.csv: {df.shape}")
        for name in (f"predictions_{view}.csv", f"predictions_{view}_pixel_error.csv"):
            check((model_dir / name).is_file(), f"the legacy copy {name} is missing")
        found.append(f"{preds_dir.name}/{{{', '.join(files)}}}")
    return found


def multiview_predict_phase(model_dir: Path, videos: list[Path], card: str) -> dict[str, int]:
    """Phases 13c and 13d from the supervised multiview directory. Returns
    the normalize and decode launches of the first video run."""
    import math

    import torch

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel

    model = Model.from_dir(model_dir)
    model._load()  # the model's load and weights stay out of the counts and the time
    torch.cuda.synchronize()
    rates = []
    for run in range(MV_VIDEO_RUNS):
        normalize_kernel.launches = decode_kernel.launches = 0
        t0 = time.perf_counter()
        result = model.predict_on_video_file_multiview(videos, compute_metrics=False)
        rates.append(MV_VIDEO_FRAMES / (time.perf_counter() - t0))
        if run == 0:
            video_launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
    batches = math.ceil(MV_VIDEO_FRAMES / BATCH)
    for view in MV_VIEWS:
        df = result.predictions[view]
        check(df.shape == (MV_VIDEO_FRAMES, 3 * KEYPOINTS) and np.isfinite(df.to_numpy()).all(),
              f"the multiview video CSV of {view}: shape {df.shape} or non-finite values")
    check(video_launches == {"normalize": batches, "decode": batches},
          f"multiview video launches {video_launches}, {batches} batches")
    log(f"phase 13c predict_on_video_file_multiview (bf16, without metrics): {len(MV_VIEWS)} views x "
        f"{MV_VIDEO_FRAMES} frames of 320x240 mp4s in {batches} batches of ({BATCH}, {len(MV_VIEWS)}, {IMAGE}, "
        f"{IMAGE}, 3), one finite row per frame and view; launches {video_launches} (normalize 1, decode 1 a batch "
        f"over {len(MV_VIEWS) * KEYPOINTS} maps a frame) in the first run; frames/s of a view (the session's frames, "
        f"each decoded in both views) with the mp4s' decode, the model loaded before: {rates[0]:.1f} in the first run "
        f"(loader threads started, first calls at these shapes), {', '.join(f'{r:.1f}' for r in rates[1:])} in the "
        f"next {len(rates) - 1} {card}")

    csvs = [f"CollectedData_{v}.csv" for v in MV_VIEWS]
    normalize_kernel.launches = decode_kernel.launches = 0
    t0 = time.perf_counter()
    result = model.predict_on_label_csv_multiview(csvs)
    elapsed = time.perf_counter() - t0
    csv_launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
    csv_batches = math.ceil(TRAIN_FRAMES / int(model.cfg.training.test_batch_size))
    check(csv_launches == {"normalize": csv_batches, "decode": csv_batches},
          f"multiview label CSV launches {csv_launches}, {csv_batches} batches")
    for view in MV_VIEWS:
        df = result.predictions[view]
        check(df.shape == (TRAIN_FRAMES, 3 * KEYPOINTS + 1) and np.isfinite(df.iloc[:, :-1].to_numpy(float)).all(),
              f"predict_on_label_csv_multiview {view}: shape {df.shape} or non-finite values")
        check(result.metrics[view].pixel_error_df is not None, f"no pixel-error metrics for {view}")
    log(f"phase 13d predict_on_label_csv_multiview (bf16): {TRAIN_FRAMES} frames x {len(MV_VIEWS)} views in "
        f"{csv_batches} batches, launches {csv_launches}, {elapsed:.2f} s with metrics {card}")

    srng = np.random.default_rng(SEED + 10)
    frames = srng.integers(0, 256, (2, len(MV_VIEWS), 240, 320, 3), dtype=np.uint8)
    out = model.predict_frame(frames[0], bbox=(10, 20, 280, 200))
    check(out["keypoints"].shape == (len(MV_VIEWS) * KEYPOINTS, 2) and np.isfinite(out["keypoints"]).all()
          and np.isfinite(out["confidence"]).all(), "predict_frame of one frame a view")
    fp32 = {d: Model.from_dir(model_dir, precision="fp32", device=d) for d in ("cuda", "cpu")}
    res = {d: [m.predict_frame(f) for f in frames] for d, m in fp32.items()}
    kp_diff = max(float(np.abs(a["keypoints"] - b["keypoints"]).max()) for a, b in zip(res["cuda"], res["cpu"]))
    conf_diff = max(float(np.abs(a["confidence"] - b["confidence"]).max()) for a, b in zip(res["cuda"], res["cpu"]))
    log(f"phase 13d predict_frame of ({len(MV_VIEWS)}, 240, 320, 3), one frame a view, with a bbox: finite; fp32 card "
        f"(TF32 off) vs CPU on 2 such inputs: keypoints max abs diff {kp_diff:.3e} px (limit {MV_TOL_PX}), "
        f"confidences {conf_diff:.3e}")
    check(kp_diff <= MV_TOL_PX, f"multiview predict_frame card vs CPU: {kp_diff} px")
    return video_launches


def multiview_phase(rng, card: str) -> dict[str, int]:
    """Phases 13a-13d: train() of the multiview transformer, supervised
    then semi-supervised, with prediction from the directory; the launches
    of each kernel on these paths, each against what the code implies.
    Returns the launches of each kernel on one path: the warp and CLAHE in
    13a's train(), normalize and the decode in 13c's first video run, the
    decode's backward in 13b's train()."""
    import math

    import torch

    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import clahe_kernel, decode_kernel, normalize_kernel, warp_kernel
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.utils.synthetic import write_multiview_dataset, write_multiview_videos

    dev = torch.device("cuda", 0)
    names = [f"kp{i}" for i in range(KEYPOINTS)]
    nv = len(MV_VIEWS)
    n_img = TRAIN_BATCH * nv
    meta = {"model_type": "heatmap_multiview", "downsample_factor": DOWNSAMPLE, "num_views": nv}
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    with tempfile.TemporaryDirectory() as tmp:
        data = write_multiview_dataset(Path(tmp) / "data", TRAIN_FRAMES, IMAGE, IMAGE, names, MV_VIEWS, seed=SEED)
        write_multiview_videos(data, "session0", 120, 240, 320, MV_VIEWS, n_blobs=KEYPOINTS, seed=SEED)

        def train_step_fn(cfg, factories, dm):
            spe = trainer.calculate_steps_per_epoch(dm)
            torch.manual_seed(SEED)
            model = build_model("heatmap_multiview", MV_BACKBONE, KEYPOINTS, DOWNSAMPLE, num_views=nv,
                                image_size=IMAGE).to(dev, memory_format=torch.channels_last)
            optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, spe, model)
            state = trainer.TrainState(model=model, optimizer=optimizer, step=UNFREEZE_STEP)
            step = trainer.make_step_fns(meta, factories, engine, cfg, head_sched, bb_sched, spe)[2]
            return state, step, trainer._device_cache(dm.dataset, dev)

        valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
        draw_gen, field_gen = torch.Generator().manual_seed(SEED), torch.Generator(dev).manual_seed(SEED)

        # -- 13a. supervised train() -------------------------------------------
        cfg = multiview_config(data, names, "smokemv", semi=False)
        model_dir = Path(tmp) / "model"
        implied_clahe = len(clahe_fired_stacks(engine, MV_STEPS, MV_SEED, n_img))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warp_kernel.launches = clahe_kernel.launches = decode_kernel.launches = normalize_kernel.launches = 0
        t0 = time.perf_counter()
        result = trainer.train(cfg, model_dir, device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"warp": warp_kernel.launches, "clahe": clahe_kernel.launches, "decode": decode_kernel.launches}
        eval_normalizes = normalize_kernel.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        dm = result.data_module
        val_logs = [h for h in result.history if "val_supervised_loss" in h]
        train_logs = [h for h in result.history if "train_heatmap_mse_loss" in h]
        val_batches = len(val_logs) * math.ceil(len(dm.val_dataset) / dm.val_batch_size)
        eval_batches = math.ceil(TRAIN_FRAMES / dm.test_batch_size)
        implied = {"warp": MV_STEPS, "clahe": implied_clahe, "decode": MV_STEPS + val_batches + eval_batches}
        log(f"phase 13a multiview train(): {MV_STEPS} steps of {TRAIN_BATCH} samples x {nv} views ({MV_BACKBONE}, "
            f"{IMAGE} px, {KEYPOINTS} keypoints a view, dlc, the patch mask 0.1 -> 0.5, bf16) in {elapsed:.1f} s with "
            f"set-up and evaluation; launches {launches}, implied {implied} (the warp once a step over {n_img} view "
            f"images, CLAHE once a step whose draws fire it, the decode once a step, validation batch and evaluation "
            f"batch over {nv * KEYPOINTS} maps a sample), normalize {eval_normalizes} for {eval_batches} evaluation "
            f"batches; train loss {train_logs[0]['train_heatmap_mse_loss']:.4f} -> "
            f"{train_logs[-1]['train_heatmap_mse_loss']:.4f}; peak device memory {peak:.2f} GiB {card}")
        check(launches == implied and implied_clahe >= 1, f"multiview train() launches {launches}, implied {implied}")
        slice_launches = {"warp": launches["warp"], "clahe": launches["clahe"]}
        check(eval_normalizes == eval_batches, f"normalize launched {eval_normalizes} times")
        check(len(train_logs) == MV_STEPS and val_logs, "multiview train() logged too little")
        check(all(np.isfinite(v) for h in result.history for k, v in h.items() if "loss" in k),
              "a logged loss is not finite")
        log(f"phase 13a multiview train()'s evaluation: image_preds/ {'; '.join(check_multiview_preds(model_dir))} "
            f"and their legacy copies")

        state, step, cache = train_step_fn(cfg, get_loss_factories(cfg), dm)

        def one_step():
            idxs = torch.from_numpy(rng.permutation(TRAIN_FRAMES)[:TRAIN_BATCH]).to(dev)
            step(state, cache, idxs, valid, engine.sample(draw_gen, n_img, field_gen), None, None,
                 trainer.sample_mask_scores(field_gen, n_img, (IMAGE, IMAGE)))

        torch.cuda.reset_peak_memory_stats()
        step_ms, device_ms, kernels, busy = profiled_step(one_step)
        log(f"phase 13a multiview train step ({MV_BACKBONE}, {IMAGE} px, bf16, {TRAIN_BATCH} samples x {nv} views = "
            f"{n_img} images, dlc, patch mask, backbone unfrozen): {step_ms:.3f} ms, {n_img / step_ms * 1e3:.1f} "
            f"images/s, mean of 10 steps by the host clock; torch.profiler over 5 steps: {device_ms:.3f} ms of device "
            f"time a step, the device busy {busy:.1%}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        log("phase 13a largest device-time entries a step: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 5e3:.3f} ms" for e in top))
        del state, step, cache

        # -- 13c, 13d. prediction from the directory ---------------------------
        videos = [write_video(Path(tmp) / f"long_{v}.mp4", rng, MV_VIDEO_FRAMES, 240, 320) for v in MV_VIEWS]
        slice_launches.update(multiview_predict_phase(model_dir, videos, card))

        # -- 13b. semi-supervised train() --------------------------------------
        cfg = multiview_config(data, names, "smokemvsemi", semi=True)
        semi_dir = Path(tmp) / "semi"
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warp_kernel.launches = decode_kernel.launches = decode_kernel.grad_launches = 0
        t0 = time.perf_counter()
        result = trainer.train(cfg, semi_dir, device="cuda")
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        semi_launches = {"warp": warp_kernel.launches, "decode": decode_kernel.launches,
                         "decode_grad": decode_kernel.grad_launches}
        peak = torch.cuda.max_memory_allocated() / 2**30
        dm = result.data_module
        train_logs = [h for h in result.history if "train_unsupervised_loss" in h]
        val_logs = [h for h in result.history if "val_supervised_loss" in h]
        val_batches = len(val_logs) * math.ceil(len(dm.val_dataset) / dm.val_batch_size)
        video_batches = math.ceil(120 / BATCH)
        implied = {"warp": MV_STEPS, "decode": 2 * MV_STEPS + val_batches + eval_batches + video_batches,
                   "decode_grad": MV_STEPS}
        pca = [h["train_pca_multiview_loss"] for h in train_logs]
        temporal = [h["train_temporal_loss"] for h in train_logs]
        log(f"phase 13b multiview semi-supervised train(): {MV_STEPS} steps of {TRAIN_BATCH} samples x {nv} views + "
            f"a {WINDOW}-frame {nv}-view window, pca_multiview + temporal, {MV_BACKBONE}, {IMAGE} px, bf16, in "
            f"{elapsed:.1f} s with set-up, the PCA fit and evaluation (the labeled frames, the 120-frame session in "
            f"{video_batches} batches); launches {semi_launches}, implied {implied} (the warp on the labeled views "
            f"only: the window is augmented photometrically); unsupervised loss "
            f"{train_logs[0]['train_unsupervised_loss']:.3e} -> {train_logs[-1]['train_unsupervised_loss']:.3e}, "
            f"pca_multiview max {max(pca):.4f}, temporal max {max(temporal):.4f}; peak device memory {peak:.2f} GiB "
            f"{card}")
        check(semi_launches == implied, f"multiview semi-supervised launches {semi_launches}, implied {implied}")
        check(len(train_logs) == MV_STEPS and max(pca) > 0 and max(temporal) > 0,
              "multiview semi-supervised train() logged too little, or a zero unsupervised loss")
        check(all(np.isfinite(v) for h in result.history for k, v in h.items() if "loss" in k),
              "a logged loss is not finite")
        for view in MV_VIEWS:
            check((semi_dir / "video_preds" / f"session0_{view}.csv").is_file(), f"no test-video CSV of {view}")
        slice_launches["decode_grad"] = semi_launches["decode_grad"]

        factories = get_loss_factories(cfg, dm)
        dm.close()
        state, step, cache = train_step_fn(cfg, factories, dm)
        window = {
            "frames": torch.from_numpy(rng.integers(0, 256, (WINDOW, nv, IMAGE, IMAGE, 3), dtype=np.uint8)).to(dev),
            "bbox": torch.tensor([[0.0, 0.0, 240.0, 320.0] * nv] * WINDOW, device=dev),
        }

        def semi_step():
            idxs = torch.from_numpy(rng.permutation(TRAIN_FRAMES)[:TRAIN_BATCH]).to(dev)
            draws = engine.sample(draw_gen, n_img, field_gen)
            video_draws = sample_video_draws(draw_gen, WINDOW * nv, IMAGE, IMAGE, field_gen)
            step(state, cache, idxs, valid, draws, window, video_draws,
                 trainer.sample_mask_scores(field_gen, n_img, (IMAGE, IMAGE)))

        torch.cuda.reset_peak_memory_stats()
        step_ms, device_ms, kernels, busy = profiled_step(semi_step)
        grad_ms = sum(e.self_device_time_total for e in kernels if "decode_grad_kernel" in e.key) / 5e3
        n_frames = n_img + WINDOW * nv
        log(f"phase 13b multiview semi-supervised step ({MV_BACKBONE}, {IMAGE} px, bf16, {TRAIN_BATCH} samples x {nv} "
            f"views with dlc + a {WINDOW}-frame window x {nv} views = {n_frames} images, backbone unfrozen): "
            f"{step_ms:.3f} ms, {n_frames / step_ms * 1e3:.1f} images/s, mean of 10 steps by the host clock; "
            f"torch.profiler over 5 steps: {device_ms:.3f} ms of device time a step, the device busy {busy:.1%}; the "
            f"decode's backward {grad_ms:.4f} ms a step ({grad_ms / device_ms:.2%} of the device time); peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        log("phase 13b largest device-time entries a step: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 5e3:.3f} ms" for e in top))
    return slice_launches


# -- the rest of single-view training: pretrained files, resume, EfficientNet, regression --


def write_pretrained_files(directory: Path) -> dict[str, Path]:
    """The published key layouts with seeded random values (no pretrained
    weights ship with the repo and none can be downloaded): torchvision
    ResNet-50 raw and in an MMPose ``{"state_dict": {"backbone.*"}}``
    container, torchvision EfficientNet-B0, HF ``ViTModel`` ViT-S/16 with a
    14 x 14 position grid."""
    import torch

    from lightning_pose_tpu_torch.utils.synthetic import (
        hf_vit_state_dict,
        torchvision_efficientnet_state_dict,
        torchvision_resnet_state_dict,
    )

    resnet = torchvision_resnet_state_dict("resnet50", seed=SEED + 20)
    files = {
        "torchvision_resnet50": (resnet, directory / "resnet50_torchvision.pth"),
        "mmpose_resnet50": ({"state_dict": {f"backbone.{k}": v for k, v in resnet.items()}},
                            directory / "resnet50_mmpose.pth"),
        "torchvision_efficientnet_b0": (torchvision_efficientnet_state_dict("b0", seed=SEED + 21),
                                        directory / "efficientnet_b0_torchvision.pth"),
        "hf_vits16": (hf_vit_state_dict(384, 12, grid=14, seed=SEED + 22), directory / "vits16_hf.pth"),
    }
    for state, path in files.values():
        torch.save(state, path)
    log("phase 14 pretrained files (published key layouts, seeded random values): " + "; ".join(
        f"{name} {path.name} {path.stat().st_size / 1e6:.1f} MB" for name, (_, path) in files.items()))
    return {name: path for name, (_, path) in files.items()}


def profiled_seed(engine, steps: int) -> int:
    """The first data seed from TRAIN_SEED on whose draws CLAHE fires in the
    first ``steps`` steps of a train() of TRAIN_BATCH images a step."""
    seed = TRAIN_SEED
    while not clahe_fired_stacks(engine, steps, seed, TRAIN_BATCH):
        seed += 1
    return seed


def resume_config(data: Path, names: list[str], files: dict, steps: int, name: str):
    """Phase 14a: the default model from the MMPose file, ``steps`` steps
    in step mode (4 an epoch), the backbone unfrozen at step 2, a milestone
    at 3/8 of RESUME_STEPS (within the interrupted run), validation and a
    -last.ckpt every epoch, no evaluation."""
    cfg = train_config(data, names)
    cfg.model.backbone = "resnet50_animal_ap10k"
    cfg.model.backbone_checkpoint = str(files["mmpose_resnet50"])
    cfg.model.model_name = name
    cfg.training.max_steps = cfg.training.min_steps = steps
    cfg.training.unfreezing_step = 2
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [RESUME_STEPS * 3 // 8]
    return cfg


def resume_phase(data: Path, names: list[str], files: dict, tmp: Path, card: str) -> None:
    """Phase 14a: the pretrained load checked tensor by tensor; an
    uninterrupted run of RESUME_STEPS steps (twice: the run-to-run spread);
    a run of half as many steps resumed to RESUME_STEPS in its directory;
    the -last.ckpt's size and write time; a profiled run."""
    import torch

    from lightning_pose_tpu_torch.models.backbones.pretrained import load_backbone_checkpoint, load_torch_checkpoint
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import clahe_kernel, warp_kernel
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import checkpoints as ckpt_utils
    from lightning_pose_tpu_torch.train import trainer

    dev = torch.device(DEVICE)
    model = build_model("heatmap", "resnet50_animal_ap10k", KEYPOINTS, DOWNSAMPLE).to(dev, memory_format=torch.channels_last)
    skipped = load_backbone_checkpoint(model.backbone, "resnet50_animal_ap10k", str(files["mmpose_resnet50"]), IMAGE)
    file_state = load_torch_checkpoint(str(files["mmpose_resnet50"]))
    own = model.backbone.state_dict()
    compared = [k for k in file_state if k in own and not k.endswith("num_batches_tracked")]
    unequal = [k for k in compared if not torch.equal(own[k].cpu(), file_state[k])]
    check(not unequal and len(compared) == len(own) - len([k for k in own if k.endswith("num_batches_tracked")]),
          f"the loaded backbone differs from the MMPose file: {unequal[:5]}")
    check(sorted(skipped) == sorted(k for k in file_state if k not in compared), f"skipped keys {skipped[:5]}")
    log(f"phase 14a the MMPose ResNet-50 file into resnet50_animal_ap10k on the card: {len(compared)} tensors equal to "
        f"the file's, bit for bit; skipped {len(skipped)} (fc and the batch counters)")
    del model

    # deterministic cuDNN for the comparison; torch flags max-pool's
    # backward as nondeterministic on CUDA, so two runs may still differ
    flags = torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = True, False
    runs = {}
    for label, steps, name, resume in (("uninterrupted", RESUME_STEPS, "resumea", False),
                                       ("uninterrupted again", RESUME_STEPS, "resumeb", False),
                                       ("first half", RESUME_STEPS // 2, "resumec", False),
                                       ("resumed", RESUME_STEPS, "resumec", True)):
        cfg = resume_config(data, names, files, steps, name)
        cfg.training.resume = resume
        model_dir = tmp / name
        saves = []
        save_module = ckpt_utils.save_module

        def timed_save(path, *args, **kwargs):
            t0 = time.perf_counter()
            save_module(path, *args, **kwargs)
            saves.append((path, time.perf_counter() - t0))

        ckpt_utils.save_module = timed_save
        warp_kernel.launches = 0
        try:
            t0 = time.perf_counter()
            result = trainer.train(cfg, model_dir, skip_evaluation=True, device=DEVICE)
            torch.cuda.synchronize()
            elapsed = time.perf_counter() - t0
        finally:
            ckpt_utils.save_module = save_module
        versions = sorted(p.name for p in (model_dir / "tb_logs" / name).iterdir())
        lasts = list((model_dir / "tb_logs" / name / "version_0" / "checkpoints").glob("*-last.ckpt"))
        check(versions == ["version_0"] and len(lasts) == 1, f"{label}: versions {versions}, last ckpts {lasts}")
        ckpt = ckpt_utils.load_checkpoint(str(lasts[0]))
        steps_run = [h["step"] for h in result.history if "lr-head" in h]
        check(warp_kernel.launches == len(steps_run), f"{label}: warp {warp_kernel.launches} for {len(steps_run)} steps")
        last_saves = [s for p, s in saves if str(p).endswith("-last.ckpt")]
        runs[label] = {"ckpt": ckpt, "history": {h["step"]: h for h in result.history if "lr-head" in h}}
        log(f"phase 14a {label} train(): steps {steps_run[0]}-{steps_run[-1]} in {elapsed:.1f} s, ends at epoch "
            f"{ckpt['epoch']} step {ckpt['step']}; {lasts[0].name} {lasts[0].stat().st_size / 1e6:.1f} MB (weights, "
            f"statistics, Adam's moments, the generators' states), written {len(last_saves)} times in "
            f"{', '.join(f'{s:.3f}' for s in last_saves)} s {card}")
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = flags

    a, b, r = (runs[k]["ckpt"] for k in ("uninterrupted", "uninterrupted again", "resumed"))
    check(a["step"] == r["step"] == RESUME_STEPS and a["epoch"] == r["epoch"], "the resumed run ends elsewhere")
    for step in range(RESUME_STEPS // 2 + 1, RESUME_STEPS + 1):
        ha, hr = runs["uninterrupted"]["history"][step], runs["resumed"]["history"][step]
        check(ha["lr-head"] == hr["lr-head"] and ha["lr-backbone"] == hr["lr-backbone"], f"step {step}: LRs differ")
    check(sorted(runs["resumed"]["history"]) == list(range(RESUME_STEPS // 2 + 1, RESUME_STEPS + 1)),
          "the resumed run took other steps")

    def max_diff(x, y) -> float:
        fx, fy = ckpt_utils._flatten(x["params"]), ckpt_utils._flatten(y["params"])
        return max(float(np.abs(fx[k].astype(np.float64) - fy[k]).max()) for k in fx)

    spread, resumed_diff = max_diff(a, b), max_diff(a, r)
    bitwise = resumed_diff == 0.0
    # without bitwise runs, the resumed run may part from the uninterrupted
    # one by no more than two uninterrupted runs part from each other
    check(bitwise or resumed_diff <= 2 * spread, f"resumed run {resumed_diff:.3e} from the uninterrupted one, two "
          f"uninterrupted runs {spread:.3e}")
    log(f"phase 14a resumed ({RESUME_STEPS // 2} + {RESUME_STEPS // 2} steps) against uninterrupted ({RESUME_STEPS}): "
        f"same step and epoch, the same LRs at each resumed step; largest parameter difference {resumed_diff:.3e} "
        f"({'bitwise' if bitwise else 'not bitwise'}; two uninterrupted runs differ by {spread:.3e}, limit 2x that "
        f"where the runs are not bitwise) {card}")

    # -- the profiler: train() with training.profiler, a seed whose draws fire
    # CLAHE in its one epoch, the backbone frozen (so its weights stay the file's)
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    seed = profiled_seed(engine, 4)
    cfg = resume_config(data, names, files, 4, "profiled")
    cfg.training.profiler = True
    cfg.training.rng_seed_data_pt = seed
    cfg.training.unfreezing_step = 100
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = []
    warp_kernel.launches = clahe_kernel.launches = 0
    t0 = time.perf_counter()
    trainer.train(cfg, tmp / "profiled", skip_evaluation=True, device=DEVICE)
    elapsed = time.perf_counter() - t0
    trace = tmp / "profiled" / "tb_logs" / "profiled" / "version_0" / "profiler_trace.json"
    check(trace.is_file(), f"no profiler trace at {trace}")
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = {e.get("name", "") for e in events if e.get("cat") == "kernel"}
    named = {k: sorted(n for n in kernels if k in n) for k in ("warp_kernel", "clahe_blend_kernel")}
    cats = sorted({str(e.get("cat")) for e in events})
    check(all(named.values()), f"the trace names no warp or CLAHE kernel: {named}; {len(kernels)} kernel names, "
          f"event categories {cats}")
    best = ckpt_utils.load_checkpoint(str(next((tmp / "profiled").glob("tb_logs/profiled/version_0/checkpoints/*-best.ckpt"))))
    conv = ckpt_utils.state_dict_from_flax(best["params"], best["batch_stats"])
    frozen = [k for k, v in file_state.items() if v.ndim == 4]
    check(all(torch.equal(conv[f"backbone.{k}"], file_state[k]) for k in frozen),
          "train() did not start from the backbone file")
    log(f"phase 14a train() with training.profiler (4 steps, data seed {seed}, backbone frozen): {elapsed:.1f} s; "
        f"{trace.name} {trace.stat().st_size / 1e6:.1f} MB, {len(events)} events, {len(kernels)} kernel names, among "
        f"them {named}; launches warp {warp_kernel.launches}, CLAHE {clahe_kernel.launches}; the checkpoint's "
        f"{len(frozen)} backbone conv kernels are the file's {card}")


def sv_config(data: Path, names: list[str], name: str, model_type: str, backbone: str, steps: int):
    """Phases 14b and 14c: ``model_type`` with ``backbone`` at full width
    (256 px, 17 keypoints, batch 16, dlc), ``steps`` steps, milestones at
    half and four fifths of them, the data seed of phase 8."""
    cfg = train_config(data, names)
    cfg.model.model_type = model_type
    cfg.model.backbone = backbone
    cfg.model.model_name = name
    cfg.training.max_steps = cfg.training.min_steps = steps
    cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [steps // 2, steps * 4 // 5]
    return cfg


def video_runs(model_dir: Path, video: Path, runs: int) -> tuple[list[float], dict, object]:
    """predict_on_video_file of ``video`` from ``model_dir`` (bf16, without
    metrics) ``runs`` times, the model loaded before: frames/s of each run,
    the first run's launches, the last result."""
    import torch

    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel

    model = Model.from_dir(model_dir, device=DEVICE)
    model._load()
    torch.cuda.synchronize()
    rates = []
    for run in range(runs):
        normalize_kernel.launches = decode_kernel.launches = 0
        t0 = time.perf_counter()
        result = model.predict_on_video_file(video, compute_metrics=False)
        rates.append(SV_VIDEO_FRAMES / (time.perf_counter() - t0))
        if run == 0:
            launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
    return rates, launches, result


def card_vs_cpu_frames(model_dir: Path, rng) -> tuple[float, float]:
    """predict_frame of 2 random 240x320 frames at fp32 (TF32 off) on the
    card and on the CPU: the largest keypoint and confidence differences."""
    from lightning_pose_tpu_torch.api.model import Model

    frames = rng.integers(0, 256, (2, 240, 320, 3), dtype=np.uint8)
    out = {d: [Model.from_dir(model_dir, precision="fp32", device=d).predict_frame(f, bbox=(10, 20, 280, 200))
               for f in frames] for d in (DEVICE, "cpu")}
    kp = max(float(np.abs(a["keypoints"] - b["keypoints"]).max()) for a, b in zip(out[DEVICE], out["cpu"]))
    conf = max(float(np.abs(a["confidence"] - b["confidence"]).max()) for a, b in zip(out[DEVICE], out["cpu"]))
    check(all(np.isfinite(o["keypoints"]).all() for o in out[DEVICE]), "predict_frame on the card: non-finite")
    return kp, conf


def sv_step_times(cfg, dm, model_type: str, backbone: str, rng, semi: bool = False) -> tuple[float, float, list, float]:
    """``profiled_step`` of the train step of ``model_type``/``backbone`` at
    batch 16 with dlc, the backbone unfrozen; with ``semi`` and a 32-frame
    window."""
    import torch

    from lightning_pose_tpu_torch.losses.factory import get_loss_factories
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.ops.video_augment import sample_video_draws
    from lightning_pose_tpu_torch.train import trainer

    dev = torch.device(DEVICE)
    spe = trainer.calculate_steps_per_epoch(dm)
    torch.manual_seed(SEED)
    model = build_model(model_type, backbone, KEYPOINTS, DOWNSAMPLE).to(dev, memory_format=torch.channels_last)
    optimizer, head_sched, bb_sched = trainer.make_optimizer(cfg, spe, model)
    state = trainer.TrainState(model=model, optimizer=optimizer, step=UNFREEZE_STEP)
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    meta = {"model_type": model_type, "downsample_factor": DOWNSAMPLE}
    step = trainer.make_step_fns(meta, get_loss_factories(cfg, dm), engine, cfg, head_sched, bb_sched, spe)[2]
    cache = trainer._device_cache(dm.dataset, dev)
    valid = torch.ones(TRAIN_BATCH, dtype=torch.bool, device=dev)
    draw_gen, field_gen = torch.Generator().manual_seed(SEED), torch.Generator(dev).manual_seed(SEED)
    window = {
        "frames": torch.from_numpy(rng.integers(0, 256, (WINDOW, IMAGE, IMAGE, 3), dtype=np.uint8)).to(dev),
        "bbox": torch.tensor([[0.0, 0.0, 240.0, 320.0]] * WINDOW, device=dev),
    }

    def one_step():
        idxs = torch.from_numpy(rng.permutation(TRAIN_FRAMES)[:TRAIN_BATCH]).to(dev)
        draws = engine.sample(draw_gen, TRAIN_BATCH, field_gen)
        if semi:
            step(state, cache, idxs, valid, draws, window, sample_video_draws(draw_gen, WINDOW, IMAGE, IMAGE, field_gen))
        else:
            step(state, cache, idxs, valid, draws)

    torch.cuda.reset_peak_memory_stats()
    return profiled_step(one_step)


def sv_kernel_checks(rng, engine, errors: dict) -> dict:
    """Phase 3 at phase 14's shapes: CLAHE over the planes of the images
    that phase 14b's draws fire it on (one input a fired step), and the
    decode on the maps of a random-init EfficientNet-B0 heatmap model (its
    head's deconv scaled by 300 so the maps are peaked) at a video batch's
    (96, 17, 64, 64), against their plain versions. The normalize and the
    warp see phase 3's product shapes there. Returns the inputs."""
    import torch

    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import decode_kernel
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images

    dev = torch.device(DEVICE)
    clahe_inputs = []
    for n_fired in clahe_fired_stacks(engine, SV_STEPS, TRAIN_SEED, TRAIN_BATCH):
        planes = torch.from_numpy(rng.uniform(0, 255, (n_fired, 3, IMAGE, IMAGE)).astype(np.float32))
        clip = torch.from_numpy(rng.uniform(1.0, 8.0, n_fired).astype(np.float32))
        err, x_lut = check_clahe(planes.to(dev), clip.to(dev), 16)
        errors["clahe"] = max(errors["clahe"], err)
        clahe_inputs.append(x_lut)
    torch.manual_seed(SEED)
    model = build_model("heatmap", "efficientnet_b0", KEYPOINTS, DOWNSAMPLE)
    with torch.no_grad():
        model.head.deconv0.weight.mul_(300.0)
    model = model.to(dev, memory_format=torch.channels_last).eval()
    frames = torch.from_numpy(rng.integers(0, 256, (BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)).to(dev)
    with torch.no_grad(), torch.autocast("cuda", dtype=torch.bfloat16):
        hm = model(normalize_images(frames).permute(0, 3, 1, 2)).float().contiguous()
    kp, conf = decode_kernel.decode(hm, DOWNSAMPLE)
    kp_ref, conf_ref = decode_kernel.decode_plain(hm, DOWNSAMPLE)
    torch.cuda.synchronize()
    kp_err, conf_err, flips = decode_errors(kp, conf, kp_ref, conf_ref, decode_kernel.GRID_OFFSETS[DOWNSAMPLE])
    log(f"phase 3 decode EfficientNet-B0 maps {tuple(hm.shape)} (mean peak {float(hm.flatten(2).amax(-1).mean()):.3e}): "
        f"keypoints max abs err {kp_err:.3e} px (limit {DECODE_KP_TOL_PX}), confidences {conf_err:.3e} (limit "
        f"{DECODE_CONF_TOL}), windows differing {flips} (limit {DECODE_MAX_WINDOW_FLIPS})")
    check(bool(torch.isfinite(kp).all() and torch.isfinite(conf).all()), "decode of EfficientNet maps: non-finite")
    check(kp_err <= DECODE_KP_TOL_PX and conf_err <= DECODE_CONF_TOL and flips <= DECODE_MAX_WINDOW_FLIPS,
          "decode of EfficientNet maps disagrees with its plain version")
    errors["decode"] = max(errors["decode"], kp_err)
    images = torch.from_numpy(rng.uniform(0, 255, (TRAIN_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
    draws = forced_draws(engine, TRAIN_BATCH, SEED + 30)
    errors["warp"] = max(errors["warp"], check_warp(engine, images, draws, "phase 14 batch"))
    _, coords, _, _ = engine.sampling_grid(draws, TRAIN_BATCH, dev)
    return {"frames": frames, "images": images, "coords": coords.contiguous(), "clahe": clahe_inputs, "hm": hm}


def sv_times(inputs: dict, card: str) -> dict[str, tuple]:
    """Phase 14e: the normalize on a video batch (14b, 14c), the warp over a
    step's 16 images (with F.grid_sample) and CLAHE at each of 14b's fired
    steps (the mean a launch), the L2 flushed before each launch; the
    decode on 14b's video batch of EfficientNet maps, back to back. Returns
    name -> (ms, plain_ms, library_ms, (bound_ms, bound_by), shape)."""
    import torch
    import torch.nn.functional as F

    from lightning_pose_tpu_torch.ops import clahe_kernel, decode_kernel, normalize_kernel, warp_kernel

    frames, images, coords, hm = inputs["frames"], inputs["images"], inputs["coords"], inputs["hm"]
    norm_ms = flushed_ms(lambda: normalize_kernel.normalize(frames, torch.bfloat16))
    norm_plain_ms = flushed_ms(lambda: normalize_kernel.normalize_plain(frames, torch.bfloat16), iters=10)
    nchw = images.permute(0, 3, 1, 2)
    grid = torch.stack([2 * coords[..., 0] / (IMAGE - 1) - 1, 2 * coords[..., 1] / (IMAGE - 1) - 1], dim=-1)
    warp_rounds = flushed_rounds({
        "kernel": lambda: warp_kernel.warp(images, coords),
        "grid_sample": lambda: F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True),
    })
    warp_plain_ms = flushed_ms(lambda: warp_kernel.warp_plain(images, coords), iters=10)
    clahe = [(flushed_ms(lambda: clahe_kernel.clahe_apply(x, lut, 16)),
              flushed_ms(lambda: clahe_kernel.clahe_apply_plain(x, lut, 16), iters=10),
              bound_of((x.numel() * 2 + lut.numel()) * 4, 0)[0]) for x, lut in inputs["clahe"]]
    planes = [x.shape[0] for x, _ in inputs["clahe"]]
    n_maps, hm_h, hm_w = hm.shape[0] * hm.shape[1], hm.shape[2], hm.shape[3]
    dec_ms = cuda_ms(lambda: decode_kernel.decode(hm, DOWNSAMPLE), iters=50)
    dec_plain_ms = cuda_ms(lambda: decode_kernel.decode_plain(hm, DOWNSAMPLE))
    mean = lambda xs: sum(xs) / len(xs)  # noqa: E731
    times = {
        "normalize": (norm_ms, norm_plain_ms, None, bound_of(frames.numel() * (1 + 2), 0),
                      f"{tuple(frames.shape)} uint8 -> bf16, a video batch"),
        "warp": (float(np.median(warp_rounds["kernel"])), warp_plain_ms, float(np.median(warp_rounds["grid_sample"])),
                 bound_of((images.numel() * 2 + coords.numel()) * 4, 0), f"{tuple(images.shape)} fp32, one field an image"),
        "clahe": (mean([c[0] for c in clahe]), mean([c[1] for c in clahe]), None, (mean([c[2] for c in clahe]), "bytes"),
                  f"(planes, {IMAGE}, {IMAGE}) fp32 g=16, planes {planes} in phase 14b's fired steps; the mean a launch"),
        "decode": (dec_ms, dec_plain_ms, None,
                   bound_of((hm.numel() + n_maps * 3) * 4, decode_flops(n_maps, hm_h, hm_w, DOWNSAMPLE)),
                   f"{tuple(hm.shape)} fp32 EfficientNet-B0 maps, df {DOWNSAMPLE}"),
    }
    for name, (ms, plain_ms, library_ms, (bound, bound_by), shape) in times.items():
        lib_text = f", F.grid_sample {library_ms:.5f} ms" if library_ms is not None else ""
        log(f"phase 14e {name} at {shape}: kernel {ms:.5f} ms, plain {plain_ms:.5f} ms{lib_text}; bound {bound:.5f} "
            f"ms ({bound_by}), {bound / ms:.1%} of it reached {card}")
    return times


def single_view_phase(rng, card: str) -> dict[str, int]:
    """Phases 14a-14d. Returns the launches of the kernels on phase 14b's
    paths: the warp and CLAHE in its train(), normalize and the decode in
    its first video run."""
    import math

    import pandas as pd
    import torch

    from lightning_pose_tpu_torch.models.backbones.pretrained import load_backbone_checkpoint
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import clahe_kernel, decode_kernel, normalize_kernel, warp_kernel
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train import trainer
    from lightning_pose_tpu_torch.utils.synthetic import (
        write_labeled_dataset,
        write_multiview_dataset,
        write_unlabeled_video,
    )

    names = [f"kp{i}" for i in range(KEYPOINTS)]
    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    with tempfile.TemporaryDirectory() as tmp_name:
        tmp = Path(tmp_name)
        files = write_pretrained_files(tmp)
        data = write_labeled_dataset(tmp / "data", TRAIN_FRAMES, IMAGE, IMAGE, names, seed=SEED)
        video = write_video(tmp / "long.mp4", rng, SV_VIDEO_FRAMES, 240, 320)
        resume_phase(data, names, files, tmp, card)

        # -- 14b. EfficientNet-B0 heatmap from the torchvision file ---------------
        cfg = sv_config(data, names, "smokeeff", "heatmap", "efficientnet_b0", SV_STEPS)
        cfg.model.backbone_checkpoint = str(files["torchvision_efficientnet_b0"])
        model_dir = tmp / "eff"
        implied_clahe = len(clahe_fired_stacks(engine, SV_STEPS, TRAIN_SEED, TRAIN_BATCH))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        warp_kernel.launches = clahe_kernel.launches = decode_kernel.launches = normalize_kernel.launches = 0
        t0 = time.perf_counter()
        result = trainer.train(cfg, model_dir, device=DEVICE)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        launches = {"warp": warp_kernel.launches, "clahe": clahe_kernel.launches, "decode": decode_kernel.launches}
        eval_normalizes = normalize_kernel.launches
        peak = torch.cuda.max_memory_allocated() / 2**30
        dm = result.data_module
        train_logs = [h for h in result.history if "train_heatmap_mse_loss" in h]
        val_logs = [h for h in result.history if "val_supervised_loss" in h]
        val_batches = len(val_logs) * math.ceil(len(dm.val_dataset) / dm.val_batch_size)
        eval_batches = math.ceil(TRAIN_FRAMES / dm.test_batch_size)
        implied = {"warp": SV_STEPS, "clahe": implied_clahe, "decode": SV_STEPS + val_batches + eval_batches}
        log(f"phase 14b EfficientNet-B0 train() from the torchvision file: {SV_STEPS} steps of {TRAIN_BATCH} ({IMAGE} "
            f"px, {KEYPOINTS} keypoints, dlc, bf16) in {elapsed:.1f} s with set-up and evaluation; launches {launches}, "
            f"implied {implied}, normalize {eval_normalizes} for {eval_batches} evaluation batches; train loss "
            f"{train_logs[0]['train_heatmap_mse_loss']:.4f} -> {train_logs[-1]['train_heatmap_mse_loss']:.4f}; peak "
            f"device memory {peak:.2f} GiB {card}")
        check(launches == implied and implied_clahe >= 1, f"EfficientNet train() launches {launches}, implied {implied}")
        check(eval_normalizes == eval_batches, f"normalize launched {eval_normalizes} times")
        check(all(np.isfinite(v) for h in result.history for k, v in h.items() if "loss" in k), "a loss is not finite")
        files_written = check_image_preds(model_dir, "CollectedData.csv", ["pixel_error"])
        slice_launches = {"warp": launches["warp"], "clahe": launches["clahe"]}
        step_ms, device_ms, kernels, busy = sv_step_times(cfg, dm, "heatmap", "efficientnet_b0", rng)
        log(f"phase 14b EfficientNet-B0 train step ({IMAGE} px, bf16, batch {TRAIN_BATCH}, dlc, backbone unfrozen): "
            f"{step_ms:.3f} ms, {TRAIN_BATCH / step_ms * 1e3:.1f} frames/s, mean of 10 steps by the host clock; "
            f"torch.profiler over 5 steps: {device_ms:.3f} ms of device time a step, the device busy {busy:.1%}; peak "
            f"device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; evaluation wrote {files_written} {card}")
        top = sorted(kernels, key=lambda e: -e.self_device_time_total)[:6]
        log("phase 14b largest device-time entries a step: " + "; ".join(
            f"{e.key[:60]} {e.self_device_time_total / 5e3:.3f} ms" for e in top))
        rates, video_launches, vres = video_runs(model_dir, video, SV_VIDEO_RUNS)
        batches = math.ceil(SV_VIDEO_FRAMES / BATCH)
        df = vres.predictions
        check(df.shape == (SV_VIDEO_FRAMES, 3 * KEYPOINTS) and np.isfinite(df.to_numpy()).all(),
              f"EfficientNet video CSV: shape {df.shape} or non-finite values")
        check(video_launches == {"normalize": batches, "decode": batches}, f"EfficientNet video launches {video_launches}")
        slice_launches.update(video_launches)
        kp_diff, conf_diff = card_vs_cpu_frames(model_dir, rng)
        check(kp_diff <= SV_TOL_PX, f"EfficientNet predict_frame card vs CPU: {kp_diff} px")
        log(f"phase 14b predict_on_video_file of the EfficientNet dir (bf16, without metrics): {SV_VIDEO_FRAMES} "
            f"frames of a 320x240 mp4 in {batches} batches of {BATCH}, launches {video_launches} in the first run; "
            f"frames/s with the mp4's decode, the model loaded before: {rates[0]:.1f} in the first run, "
            f"{', '.join(f'{r:.1f}' for r in rates[1:])} after it; predict_frame fp32 card (TF32 off) vs CPU on 2 "
            f"frames with a bbox: keypoints max abs diff {kp_diff:.3e} px (limit {SV_TOL_PX}), confidences "
            f"{conf_diff:.3e} {card}")

        # -- 14c. the regression model (ResNet-50) ----------------------------------
        for i in range(2):
            write_unlabeled_video(data, f"session{i}", 120, 240, 320, n_blobs=KEYPOINTS, seed=SEED + i)
        cfg = sv_config(data, names, "smokereg", "regression", "resnet50", SV_STEPS)
        reg_dir = tmp / "reg"
        warp_kernel.launches = clahe_kernel.launches = decode_kernel.launches = normalize_kernel.launches = 0
        t0 = time.perf_counter()
        result = trainer.train(cfg, reg_dir, device=DEVICE)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        reg_launches = {"warp": warp_kernel.launches, "clahe": clahe_kernel.launches, "decode": decode_kernel.launches,
                        "normalize": normalize_kernel.launches}
        dm = result.data_module
        train_logs = [h for h in result.history if "train_regression_loss" in h]
        implied = {"warp": SV_STEPS, "clahe": implied_clahe, "decode": 0, "normalize": eval_batches}
        check(reg_launches == implied, f"regression train() launches {reg_launches}, implied {implied}")
        preds = pd.read_csv(reg_dir / "image_preds" / "CollectedData.csv" / "predictions.csv", header=[0, 1, 2],
                            index_col=0)
        likelihood = preds.loc[:, preds.columns.get_level_values(2) == "likelihood"].to_numpy(float)
        check(likelihood.size and (likelihood == 1.0).all(), "regression evaluation: a likelihood is not 1.0")
        log(f"phase 14c regression ResNet-50 train(): {SV_STEPS} steps of {TRAIN_BATCH} ({IMAGE} px, dlc, bf16) in "
            f"{elapsed:.1f} s with set-up and evaluation; launches {reg_launches}, implied {implied} (no decode); "
            f"train loss {train_logs[0]['train_regression_loss']:.1f} -> {train_logs[-1]['train_regression_loss']:.1f}; "
            f"the evaluation's {likelihood.size} likelihoods all 1.0 {card}")
        step_ms, device_ms, kernels, busy = sv_step_times(cfg, dm, "regression", "resnet50", rng)
        log(f"phase 14c regression train step (ResNet-50, {IMAGE} px, bf16, batch {TRAIN_BATCH}, dlc): {step_ms:.3f} "
            f"ms, {TRAIN_BATCH / step_ms * 1e3:.1f} frames/s; torch.profiler over 5 steps: {device_ms:.3f} ms of device "
            f"time a step, the device busy {busy:.1%}; peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB {card}")

        semi = sv_config(data, names, "smokeregsemi", "regression", "resnet50", SV_STEPS)
        semi.model.losses_to_use = ["temporal"]
        semi.losses.temporal.epsilon = 0.0
        semi.callbacks.anneal_weight.init_val = 1.0
        semi.callbacks.anneal_weight.freeze_until_epoch = 0
        warp_kernel.launches = decode_kernel.launches = decode_kernel.grad_launches = 0
        t0 = time.perf_counter()
        result = trainer.train(semi, tmp / "regsemi", skip_evaluation=True, device=DEVICE)
        torch.cuda.synchronize()
        elapsed = time.perf_counter() - t0
        semi_launches = {"warp": warp_kernel.launches, "decode": decode_kernel.launches,
                         "decode_grad": decode_kernel.grad_launches}
        temporal = [h["train_temporal_loss"] for h in result.history if "train_temporal_loss" in h]
        check(semi_launches == {"warp": 2 * SV_STEPS, "decode": 0, "decode_grad": 0},
              f"semi-supervised regression launches {semi_launches}")
        check(len(temporal) == SV_STEPS and all(np.isfinite(temporal)) and max(temporal) > 0,
              "semi-supervised regression logged no temporal loss")
        semi_ms, semi_device_ms, _, semi_busy = sv_step_times(semi, result.data_module, "regression", "resnet50", rng,
                                                              semi=True)
        log(f"phase 14c semi-supervised regression train() (temporal on the outputs, a {WINDOW}-frame window a step): "
            f"{SV_STEPS} steps in {elapsed:.1f} s; launches {semi_launches} (the warp on the labeled batch and the "
            f"window); temporal loss max {max(temporal):.3f}; the step {semi_ms:.3f} ms, {semi_device_ms:.3f} ms of "
            f"device time, busy {semi_busy:.1%} {card}")
        rates, reg_video_launches, vres = video_runs(reg_dir, video, SV_VIDEO_RUNS)
        values = vres.predictions.to_numpy()
        check(values.shape == (SV_VIDEO_FRAMES, 3 * KEYPOINTS) and np.isfinite(values).all()
              and (values[:, 2::3] == 1.0).all(), "the regression video CSV: shape, values or likelihoods")
        check(reg_video_launches == {"normalize": batches, "decode": 0}, f"regression video launches {reg_video_launches}")
        kp_diff, conf_diff = card_vs_cpu_frames(reg_dir, rng)
        check(kp_diff <= SV_TOL_PX and conf_diff == 0.0, f"regression predict_frame card vs CPU: {kp_diff} px")
        log(f"phase 14c predict_on_video_file of the regression dir: {SV_VIDEO_FRAMES} frames, every likelihood 1.0, "
            f"launches {reg_video_launches}; frames/s {rates[0]:.1f} in the first run, "
            f"{', '.join(f'{r:.1f}' for r in rates[1:])} after it; predict_frame fp32 card vs CPU: keypoints max abs "
            f"diff {kp_diff:.3e} px (limit {SV_TOL_PX}), confidences {conf_diff:.1e} {card}")

        # -- 14d. the multiview transformer from the HF file ---------------------
        dev = torch.device(DEVICE)
        model = build_model("heatmap_multiview", MV_BACKBONE, KEYPOINTS, DOWNSAMPLE, num_views=len(MV_VIEWS),
                            image_size=IMAGE).to(dev)
        skipped = load_backbone_checkpoint(model.backbone, MV_BACKBONE, str(files["hf_vits16"]), IMAGE)
        grid = tuple(model.backbone.pos_embed.shape)
        check(grid == (1, 16 * 16 + 1, 384), f"position grid {grid}")
        del model
        mv_data = write_multiview_dataset(tmp / "mvdata", TRAIN_FRAMES, IMAGE, IMAGE, names, MV_VIEWS, seed=SEED)
        cfg = multiview_config(mv_data, names, "smokemvpre", semi=False)
        cfg.model.backbone_checkpoint = str(files["hf_vits16"])
        cfg.training.max_steps = cfg.training.min_steps = 4
        cfg.training.lr_scheduler_params.multisteplr.milestone_steps = [2]
        t0 = time.perf_counter()
        result = trainer.train(cfg, tmp / "mv", skip_evaluation=True, device=DEVICE)
        elapsed = time.perf_counter() - t0
        losses = [h["train_heatmap_mse_loss"] for h in result.history if "train_heatmap_mse_loss" in h]
        check(len(losses) == 4 and all(np.isfinite(losses)), f"multiview train() from the HF file: losses {losses}")
        log(f"phase 14d {MV_BACKBONE} (2 views) from the HF ViTModel file: position grid 14 x 14 -> {grid[1] - 1} "
            f"tokens (16 x 16) + CLS, skipped {skipped}; train() of 4 steps in {elapsed:.1f} s, losses "
            f"{', '.join(f'{x:.4f}' for x in losses)} {card}")
    return slice_launches


def main() -> int:
    import torch

    # -- 1. device -------------------------------------------------------------
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False; this script needs a GPU")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0].strip()
    card = f"[{smi}]"
    dev = torch.device("cuda", 0)
    log(f"phase 1 device: {torch.cuda.get_device_name(0)}, {smi}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from lightning_pose_tpu_torch.api.model import Model, PredictStep
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.ops import clahe_kernel, cuda_build, decode_kernel, normalize_kernel, warp_kernel
    from lightning_pose_tpu_torch.ops.augment import AugmentationEngine
    from lightning_pose_tpu_torch.train.checkpoints import (
        load_flax_variables,
        save_checkpoint,
        state_dict_to_flax,
    )

    # -- 2. build: one nvcc per CUDA source, started together; then the
    # Triton kernel by its first call
    t0 = time.perf_counter()
    nvcc_s = cuda_build.build("decode.cu", "decode_grad.cu", "warp.cu", "clahe.cu")
    decode_kernel._library()
    decode_kernel._grad_library()
    warp_kernel._library()
    clahe_kernel._library()
    triton_s = {
        "normalize": timed(lambda: normalize_kernel.normalize(
            torch.zeros((1, 2, 2, 3), dtype=torch.uint8, device=dev))),
    }
    log(f"phase 2 build: nvcc started together, {', '.join(f'{k} done after {v:.1f} s' for k, v in nvcc_s.items())}; "
        f"Triton first calls {', '.join(f'{k} {v:.1f} s' for k, v in triton_s.items())}; "
        f"{time.perf_counter() - t0:.1f} s in all")

    # -- 3. kernel vs plain at product shapes ---------------------------------
    rng = np.random.default_rng(SEED)
    errors: dict[str, float] = {}
    frames = torch.from_numpy(
        rng.integers(0, 256, (BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
    ).to(dev)
    for dtype in (torch.bfloat16, torch.float32):
        out = normalize_kernel.normalize(frames, dtype)
        ref = normalize_kernel.normalize_plain(frames, dtype)
        torch.cuda.synchronize()
        check(out.shape == ref.shape == (BATCH, 3, IMAGE, IMAGE), f"normalize shape {tuple(out.shape)}")
        check(out.is_contiguous(memory_format=torch.channels_last), "normalize output is not channels-last")
        err = float((out.float() - ref.float()).abs().max())
        if dtype == torch.bfloat16:
            ulps = bf16_ulps(out, ref)
            check(ulps <= NORMALIZE_MAX_ULP, f"normalize bf16: {ulps} ulps apart")
            errors["normalize"] = err
            log(f"phase 3 normalize bf16 {tuple(frames.shape)}: max abs err {err:.3e}, "
                f"{ulps} ulp (limit {NORMALIZE_MAX_ULP})")
        else:
            check(err <= 1e-5, f"normalize fp32: max abs err {err}")
            log(f"phase 3 normalize fp32: max abs err {err:.3e} (limit 1e-5)")

    hm_h = IMAGE // 2**DOWNSAMPLE
    cases = {
        "peaked": peaked_heatmaps(rng, BATCH, KEYPOINTS, hm_h, hm_h),
        "softmaxed": softmaxed_heatmaps(rng, BATCH, KEYPOINTS, hm_h, hm_h),
        "rectangular": peaked_heatmaps(rng, 8, KEYPOINTS, 48, 64),
    }
    decode_err = 0.0
    for name, maps in cases.items():
        hm = torch.from_numpy(maps).to(dev)
        kp, conf = decode_kernel.decode(hm, DOWNSAMPLE)
        kp_ref, conf_ref = decode_kernel.decode_plain(hm, DOWNSAMPLE)
        torch.cuda.synchronize()
        kp_err, conf_err, flips = decode_errors(
            kp, conf, kp_ref, conf_ref, decode_kernel.GRID_OFFSETS[DOWNSAMPLE]
        )
        log(f"phase 3 decode {name} {tuple(hm.shape)}: keypoints max abs err {kp_err:.3e} px "
            f"(limit {DECODE_KP_TOL_PX}), confidences {conf_err:.3e} (limit {DECODE_CONF_TOL}) "
            f"on the maps whose window agrees; windows differing at a pixel edge: {flips} "
            f"of {conf.numel()} (limit {DECODE_MAX_WINDOW_FLIPS})")
        check(bool(torch.isfinite(kp).all() and torch.isfinite(conf).all()),
              f"decode {name}: non-finite output")
        check(kp_err <= DECODE_KP_TOL_PX and conf_err <= DECODE_CONF_TOL
              and flips <= DECODE_MAX_WINDOW_FLIPS, f"decode {name} disagrees with its plain version")
        decode_err = max(decode_err, kp_err)
    errors["decode"] = decode_err

    # the decode's backward kernel against autograd of the plain decode: the
    # unlabeled window's maps at the product shape, a rectangular shape, df
    # 3, and a map count that neither the cluster nor the strips divide
    grad_err = 0.0
    for name, maps, df in (
        ("window", peaked_heatmaps(rng, WINDOW, KEYPOINTS, hm_h, hm_h), DOWNSAMPLE),
        ("rectangular", peaked_heatmaps(rng, 8, KEYPOINTS, 48, 64), DOWNSAMPLE),
        ("df 3", peaked_heatmaps(rng, 4, KEYPOINTS, 32, 32), 3),
        ("21 maps", peaked_heatmaps(rng, 3, 7, hm_h, hm_h), DOWNSAMPLE),
    ):
        hm = torch.from_numpy(maps).to(dev)
        grad, grad_ref = decode_grads(hm, df, seed=len(name))
        err, scale = float((grad - grad_ref).abs().max()), float(grad_ref.abs().max())
        log(f"phase 3 decode backward {name} {tuple(hm.shape)} df {df}: max abs err {err:.3e} of a largest entry "
            f"{scale:.3e} ({err / scale:.2e}, limit {DECODE_GRAD_REL_TOL})")
        check(bool(torch.isfinite(grad).all()) and scale > 0, f"decode backward {name}: non-finite or zero gradient")
        check(err <= DECODE_GRAD_REL_TOL * scale, f"decode backward {name} disagrees with autograd of the plain decode")
        grad_err = max(grad_err, err)
    errors["decode_grad"] = grad_err
    hm = torch.from_numpy(cases["peaked"]).to(dev)
    ops = decode_kernel._device_operands(hm_h, hm_h, DOWNSAMPLE, decode_kernel._layout(), dev)
    lse2 = torch.full((BATCH * KEYPOINTS,), float("nan"), device=dev)
    kp_off, conf_off = decode_kernel._launch(hm, ops, DOWNSAMPLE, 1000.0)
    kp_on, conf_on = decode_kernel._launch(hm, ops, DOWNSAMPLE, 1000.0, lse2)
    torch.cuda.synchronize()
    check(torch.equal(kp_off, kp_on) and torch.equal(conf_off, conf_on) and bool(torch.isfinite(lse2).all()),
          "the decode forward with its log-sum-exp output differs from the one without")
    log(f"phase 3 decode forward with the log-sum-exp output on: keypoints and confidences bitwise those with it off, "
        f"{lse2.numel()} finite log-sum-exps")

    engine = AugmentationEngine("dlc", IMAGE, IMAGE)
    train_images = torch.from_numpy(rng.uniform(0, 255, (TRAIN_BATCH, IMAGE, IMAGE, 3)).astype(np.float32)).to(dev)
    warp_draws = forced_draws(engine, TRAIN_BATCH, SEED)
    errors["warp"] = check_warp(engine, train_images, warp_draws, "product")
    ragged = AugmentationEngine("dlc", 200, 136)
    ragged_images = torch.from_numpy(rng.uniform(0, 255, (3, 200, 136, 3)).astype(np.float32)).to(dev)
    errors["warp"] = max(errors["warp"], check_warp(ragged, ragged_images, forced_draws(ragged, 3, SEED), "ragged"))
    clip = torch.from_numpy(rng.uniform(1.0, 8.0, TRAIN_BATCH).astype(np.float32)).to(dev)
    clahe_images = train_images.permute(0, 3, 1, 2).contiguous()
    errors["clahe"], clahe_inputs = check_clahe(clahe_images, clip, 16)
    clahe_err6, clahe_inputs6 = check_clahe(clahe_images[:2], clip[:2], 16)
    errors["clahe"] = max(errors["clahe"], clahe_err6, check_clahe(clahe_images[:2], clip[:2], 8)[0])
    context_inputs = context_kernel_checks(rng, engine, errors)
    multiview_inputs = multiview_kernel_checks(rng, engine, errors)
    single_view_inputs = sv_kernel_checks(rng, engine, errors)

    # the engine on the card vs the same call on the CPU, same draws
    frames_u8 = torch.from_numpy(rng.integers(0, 256, (TRAIN_BATCH, IMAGE, IMAGE, 3), dtype=np.uint8))
    kp_in = torch.from_numpy(rng.uniform(0, IMAGE, (TRAIN_BATCH, KEYPOINTS, 2)).astype(np.float32))
    draws = forced_draws(engine, TRAIN_BATCH, SEED + 1)
    img_card, kp_card = engine.apply(frames_u8.to(dev), kp_in.to(dev), None, draws)
    cpu_draws = type(draws)(**{k: None if v is None else v.cpu() for k, v in vars(draws).items()})
    img_cpu, kp_cpu = engine.apply(frames_u8, kp_in, None, cpu_draws)
    diff = (img_card.cpu() - img_cpu).abs()
    off = float((diff > ENGINE_GRAY_TOL).float().mean())
    finite = ~torch.isnan(kp_cpu)
    kp_err = float((kp_card.cpu()[finite] - kp_cpu[finite]).abs().max())
    log(f"phase 3 engine card vs CPU, dlc, {TRAIN_BATCH} images (histeq on 2, CLAHE on 3, emboss on 2): "
        f"keypoints max abs diff {kp_err:.3e} px (limit {ENGINE_KP_TOL_PX}), NaN masks equal "
        f"{bool(torch.equal(torch.isnan(kp_card.cpu()), ~finite))}; pixels {diff.max():.3e} gray at most, "
        f"{off:.2e} of them beyond {ENGINE_GRAY_TOL} (limit {ENGINE_OFF_SHARE})")
    check(bool(torch.equal(torch.isnan(kp_card.cpu()), ~finite)), "engine: NaN keypoints differ")
    check(kp_err <= ENGINE_KP_TOL_PX and off <= ENGINE_OFF_SHARE, "engine on the card disagrees with the CPU")

    # -- 4. main path ----------------------------------------------------------------
    model = build_model("heatmap", "resnet50", KEYPOINTS, DOWNSAMPLE)
    shapes_params, shapes_stats = state_dict_to_flax(model.state_dict())
    wrng = np.random.default_rng(SEED + 1)
    params = seeded_flax_variables(shapes_params, wrng)
    stats = seeded_flax_variables(shapes_stats, wrng)
    load_flax_variables(model, params, stats)
    model = model.eval().to(dev, memory_format=torch.channels_last)
    step = PredictStep(model, IMAGE, IMAGE, torch.bfloat16)
    video = torch.from_numpy(
        rng.integers(0, 256, (MAIN_PATH_BATCHES, BATCH, IMAGE, IMAGE, 3), dtype=np.uint8)
    ).to(dev)
    bbox = torch.tensor([[0.0, 0.0, IMAGE, IMAGE]] * BATCH, device=dev)
    normalize_kernel.launches = 0
    decode_kernel.launches = 0
    outputs = [step(video[i], bbox) for i in range(MAIN_PATH_BATCHES)]
    torch.cuda.synchronize()
    launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
    log(f"phase 4 inference path: {MAIN_PATH_BATCHES} batches of {BATCH}, launches {launches}")
    for name, count in launches.items():
        check(count == MAIN_PATH_BATCHES, f"{name} launched {count} times")
    for kp, conf in outputs:
        check(kp.shape == (BATCH, 2 * KEYPOINTS) and conf.shape == (BATCH, KEYPOINTS),
              f"main path output shapes {tuple(kp.shape)}, {tuple(conf.shape)}")
        check(bool(torch.isfinite(kp).all() and torch.isfinite(conf).all()),
              "main path: non-finite output")
    kp_all = torch.cat([kp for kp, _ in outputs])
    conf_all = torch.cat([c for _, c in outputs])
    log(f"phase 4 outputs: keypoints in [{float(kp_all.min()):.2f}, {float(kp_all.max()):.2f}] px, "
        f"confidence mean {float(conf_all.mean()):.3f}")

    # -- 5. card vs CPU at fp32 ---------------------------------------------------
    cpu_model = build_model("heatmap", "resnet50", KEYPOINTS, DOWNSAMPLE)
    load_flax_variables(cpu_model, params, stats)
    cpu_step = PredictStep(cpu_model.eval(), IMAGE, IMAGE, torch.float32)
    gpu_step = PredictStep(model, IMAGE, IMAGE, torch.float32)
    two = video[0, :2]
    kp_gpu, conf_gpu = gpu_step(two, bbox[:2])
    kp_cpu, conf_cpu = cpu_step(two.cpu(), bbox[:2].cpu())
    card_vs_cpu = float((kp_gpu.cpu() - kp_cpu).abs().max())
    conf_diff = float((conf_gpu.cpu() - conf_cpu).abs().max())
    log(f"phase 5 fp32 card vs CPU, 2 frames: keypoints max abs diff {card_vs_cpu:.3e} px "
        f"(limit {CARD_VS_CPU_TOL_PX}), confidences {conf_diff:.3e}")
    check(card_vs_cpu <= CARD_VS_CPU_TOL_PX, f"card vs CPU: {card_vs_cpu} px")

    # -- 6. file path ------------------------------------------------------------
    from lightning_pose_tpu_torch import native

    log(f"phase 6 native frame ops (g++ into build/native/): "
        f"{'loaded' if native.available() else 'not loaded, the cv2 path decodes'}")
    try:
        import cv2
        import msgpack  # noqa: F401
        import pandas  # noqa: F401
        import yaml
    except ImportError as e:
        log(f"phase 6 file path: left out, {e.name} is not installed here")
    else:
        with tempfile.TemporaryDirectory() as tmp:
            model_dir = Path(tmp) / "model"
            ckpt_dir = model_dir / "tb_logs" / "smoke" / "version_0" / "checkpoints"
            ckpt_dir.mkdir(parents=True)
            save_checkpoint(str(ckpt_dir / "epoch=0-step=0-best.ckpt"), params, stats)
            names = [f"kp{i}" for i in range(KEYPOINTS)]
            cfg = {
                "data": {
                    "image_resize_dims": {"height": IMAGE, "width": IMAGE},
                    "num_keypoints": KEYPOINTS,
                    "keypoint_names": names,
                    "downsample_factor": DOWNSAMPLE,
                },
                "model": {
                    "model_type": "heatmap",
                    "backbone": "resnet50_animal_ap10k",
                    "model_name": "smoke",
                    "losses_to_use": [],
                },
                "eval": {},
                "dali": {"base": {"predict": {"sequence_length": BATCH}}},
            }
            (model_dir / "config.yaml").write_text(yaml.safe_dump(cfg))
            n_frames, vid_h, vid_w = 150, 240, 320
            video_file = Path(tmp) / "synthetic.mp4"
            writer = cv2.VideoWriter(
                str(video_file), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (vid_w, vid_h)
            )
            for _ in range(n_frames):
                writer.write(rng.integers(0, 256, (vid_h, vid_w, 3), dtype=np.uint8))
            writer.release()
            t0 = time.perf_counter()
            result = Model.from_dir(model_dir).predict_on_video_file(video_file, compute_metrics=False)
            elapsed = time.perf_counter() - t0
            df = result.predictions
            csv = model_dir / "video_preds" / "synthetic.csv"
            check(csv.is_file(), f"{csv} was not written")
            check(df.shape == (n_frames, 3 * KEYPOINTS), f"CSV shape {df.shape}")
            values = df.to_numpy()
            check(np.isfinite(values).all(), "CSV holds non-finite values")
            xs, ys = values[:, 0::3], values[:, 1::3]
            log(f"phase 6 file path: {csv.name} {df.shape[0]} rows x {df.shape[1]} columns, "
                f"x in [{xs.min():.1f}, {xs.max():.1f}], y in [{ys.min():.1f}, {ys.max():.1f}] "
                f"for a {vid_w}x{vid_h} video; {n_frames / elapsed:.1f} frames/s including "
                f"model load and decode of a {n_frames}-frame mp4, without metrics {card}")
            # the defaults (metrics on) and a labeled video
            normalize_kernel.launches = decode_kernel.launches = 0
            t0 = time.perf_counter()
            result = Model.from_dir(model_dir).predict_on_video_file(video_file, generate_labeled_video=True)
            elapsed = time.perf_counter() - t0
            video_launches = {"normalize": normalize_kernel.launches, "decode": decode_kernel.launches}
            check(all(n == -(-n_frames // BATCH) for n in video_launches.values()),
                  f"video path launches {video_launches}")
            norm_csv = model_dir / "video_preds" / "synthetic_temporal_norm.csv"
            mp4 = model_dir / "video_preds" / "labeled_videos" / "synthetic_labeled.mp4"
            check(result.metrics is not None and result.metrics.temporal_norm_df is not None and norm_csv.is_file(),
                  "predict_on_video_file with its defaults wrote no temporal-norm metrics")
            norm = result.metrics.temporal_norm_df.to_numpy()
            check(norm.shape == (n_frames, KEYPOINTS) and np.isnan(norm[0]).all() and np.isfinite(norm[1:]).all(),
                  f"temporal norm: shape {norm.shape} or values")
            cap = cv2.VideoCapture(str(mp4))
            labeled_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()
            check(mp4.is_file() and labeled_frames == n_frames, f"labeled video {mp4}: {labeled_frames} frames")
            log(f"phase 6 file path with its defaults and generate_labeled_video=True: {norm_csv.name} "
                f"(temporal norm up to {np.nanmax(norm):.2f} px), {mp4.name} of {labeled_frames} frames; launches "
                f"{video_launches}; {n_frames / elapsed:.1f} frames/s including model load, metrics and the "
                f"labeled video {card}")

    # -- 7. times ----------------------------------------------------------------
    import torch.nn.functional as F

    frames_bf16 = video[0]
    hm = torch.from_numpy(cases["peaked"]).to(dev)
    _, warp_coords, _, _ = engine.sampling_grid(warp_draws, TRAIN_BATCH, dev)
    warp_coords = warp_coords.contiguous()
    clahe_x, clahe_lut = clahe_inputs
    clahe_x6, clahe_lut6 = clahe_inputs6
    # F.grid_sample on the NHWC images viewed as NCHW (channels-last), at the
    # same coordinates normalized outside the timed region
    nchw = train_images.permute(0, 3, 1, 2)
    grid = torch.stack([2 * warp_coords[..., 0] / (IMAGE - 1) - 1, 2 * warp_coords[..., 1] / (IMAGE - 1) - 1], dim=-1)

    def grid_sample():
        return F.grid_sample(nchw, grid, mode="bilinear", padding_mode="zeros", align_corners=True)

    gs_err = float((grid_sample().permute(0, 2, 3, 1) - warp_kernel.warp(train_images, warp_coords)).abs().max())
    # the practical floor of a memory-bound kernel: a device copy of as many
    # bytes as the warp reads and writes, half in and half out
    warp_bytes = (train_images.numel() * 2 + warp_coords.numel()) * 4
    copy_src = torch.empty(warp_bytes // 8, dtype=torch.float32, device=dev)  # half the bytes, as floats
    copy_dst = torch.empty_like(copy_src)
    warp_rounds = flushed_rounds({
        "kernel": lambda: warp_kernel.warp(train_images, warp_coords),
        "grid_sample": grid_sample,
    })
    times = {
        "normalize": (
            flushed_ms(lambda: normalize_kernel.normalize(frames_bf16, torch.bfloat16)),
            flushed_ms(lambda: normalize_kernel.normalize_plain(frames_bf16, torch.bfloat16)),
            None,
        ),
        "decode": (
            cuda_ms(lambda: decode_kernel.decode(hm, DOWNSAMPLE), iters=50),
            cuda_ms(lambda: decode_kernel.decode_plain(hm, DOWNSAMPLE)),
            None,
        ),
        "warp": (
            float(np.median(warp_rounds["kernel"])),
            flushed_ms(lambda: warp_kernel.warp_plain(train_images, warp_coords)),
            float(np.median(warp_rounds["grid_sample"])),
        ),
        "clahe": (
            flushed_ms(lambda: clahe_kernel.clahe_apply(clahe_x, clahe_lut, 16)),
            flushed_ms(lambda: clahe_kernel.clahe_apply_plain(clahe_x, clahe_lut, 16)),
            None,
        ),
    }
    # the least time the card could take for each kernel's work at these
    # shapes: each input read once and each output written once at the HBM
    # rate, or the FP32 operations at the FP32 rate, whichever is larger
    maps = BATCH * KEYPOINTS
    bound_inputs = {
        "normalize": (frames_bf16.numel() * (1 + 2), 0),
        "decode": (hm.numel() * 4 + maps * 3 * 4, decode_flops(maps, hm_h, hm_h, DOWNSAMPLE)),
        "warp": (warp_bytes, 0),
        "clahe": ((clahe_x.numel() * 2 + clahe_lut.numel()) * 4, 0),
    }
    bounds = {name: bound_of(n_bytes, flops) for name, (n_bytes, flops) in bound_inputs.items()}
    for name, (ms, plain_ms, library_ms) in times.items():
        bound_ms, bound_by = bounds[name]
        lib_text = f", library call {library_ms:.4f} ms" if library_ms is not None else ""
        log(f"phase 7 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms{lib_text}; bound {bound_ms:.4f} ms "
            f"({bound_by}), {bound_ms / ms:.1%} of it reached {card}")
    log(f"phase 7 shapes: normalize {tuple(frames_bf16.shape)} uint8 -> bf16; decode {tuple(hm.shape)} fp32 at df "
        f"{DOWNSAMPLE} ({bound_inputs['decode'][1] / 1e9:.3f} GFLOP banded); warp ({TRAIN_BATCH}, {IMAGE}, {IMAGE}, 3) "
        f"fp32 at a dlc grid (F.grid_sample {gs_err:.2e} gray from the kernel); clahe {tuple(clahe_x.shape)} g=16; "
        f"L2 flushed before each timed launch of normalize, warp and CLAHE")
    clahe6_ms = flushed_ms(lambda: clahe_kernel.clahe_apply(clahe_x6, clahe_lut6, 16))
    clahe6_bound = (clahe_x6.numel() * 2 + clahe_lut6.numel()) * 4 / HBM_BYTES_PER_S * 1e3
    log(f"phase 7 clahe at {tuple(clahe_x6.shape)} g=16 (a train step's fired subset), L2 flushed: kernel "
        f"{clahe6_ms:.5f} ms; bound {clahe6_bound:.5f} ms (bytes), {clahe6_bound / clahe6_ms:.1%} of it reached; "
        f"at {tuple(clahe_x.shape)}: {times['clahe'][0]:.5f} ms, bound {bounds['clahe'][0]:.5f} ms, "
        f"{bounds['clahe'][0] / times['clahe'][0]:.1%} {card}")
    copy_ms = flushed_ms(lambda: copy_dst.copy_(copy_src))
    log(f"phase 7 warp kernel against F.grid_sample on the same inputs, medians of "
        f"{len(warp_rounds['kernel'])} alternating rounds of 50 launches: "
        f"{times['warp'][2] / times['warp'][0]:.3f}x; rounds kernel "
        f"{' '.join(f'{x:.5f}' for x in warp_rounds['kernel'])}, grid_sample "
        f"{' '.join(f'{x:.5f}' for x in warp_rounds['grid_sample'])} ms; "
        f"a device copy of its {warp_bytes / 1e6:.1f} MB in and out takes {copy_ms:.4f} ms {card}")
    step_ms = cuda_ms(lambda: step(frames_bf16, bbox), iters=10)
    log(f"phase 7 predict step (ResNet-50, 256 px, bf16, batch {BATCH}): {step_ms:.3f} ms, "
        f"{BATCH / step_ms * 1e3:.1f} frames/s {card}")

    train_phase(rng, card)
    semisup_card_vs_cpu(card)
    semisup_phase(rng, card)
    context_phase(rng, card)
    context_times(context_inputs, card)
    # the kernels line holds each kernel's launches on one of this slice's
    # paths, EfficientNet-B0's (each earlier path checked its own above),
    # beside its times at the shapes that path gives it; the decode's
    # backward runs on no path of this slice and keeps the multiview
    # transformer's (phase 13b)
    mv_launches = multiview_phase(rng, card)
    mv_times = multiview_times(multiview_inputs, card)
    launches = {**single_view_phase(rng, card), "decode_grad": mv_launches["decode_grad"]}
    times = {**sv_times(single_view_inputs, card), "decode_grad": mv_times["decode_grad"]}
    paths = {
        "normalize": "14b the EfficientNet-B0 model's predict_on_video_file, first run: 1 a batch",
        "decode": "14b the EfficientNet-B0 model's predict_on_video_file, first run: 1 a batch",
        "warp": "14b the EfficientNet-B0 model's train(): 1 a step over 16 images",
        "clahe": "14b the EfficientNet-B0 model's train(): 1 a step whose draws fire it",
        "decode_grad": "13b the multiview model's semi-supervised train(): 1 a step",
    }
    blocked = ("jax", "jaxlib", "flax", "optax", "lightning_pose_tpu")
    jax_modules = sorted(m for m in sys.modules if m.split(".")[0] in blocked)
    check(not jax_modules, f"JAX or the JAX package was imported: {jax_modules[:5]}")

    summary = [
        {
            "name": name,
            **KERNELS[name],
            "launches": launches[name],
            "path": paths[name],
            "shape": times[name][4],
            "max_abs_err": errors[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
            "bound_ms": times[name][3][0],
            "bound_by": times[name][3][1],
            "share": times[name][3][0] / times[name][0],
            "library_ms": times[name][2],
        }
        for name in KERNELS
    ]
    print(json.dumps({"kernels": summary}))
    print(smi)
    print(json.dumps({
        "ok": True,
        "device": {
            "platform": "gpu",
            "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count(),
        },
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
