#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the root of a checkout:  python3 chip_smoke.py

Phases, each fatal on failure:
  1. device: CUDA must be available (there is no CPU path); prints the
     ``nvidia-smi`` name and power limit.
  2. build: both kernels from the sources in the checkout (the decode kernel
     with nvcc, the normalize kernel with Triton).
  3. kernel vs plain PyTorch version on the card, at the product shapes.
  4. main path: a ResNet-50 heatmap model (256 px, 17 keypoints, df 2, bf16)
     with seeded weights loaded through the flax bridge predicts 4 batches
     of 96 frames; both kernels must launch once per batch.
  5. the same model at fp32 on the card and on the CPU (plain versions).
  6. file path: Model.from_dir(dir).predict_on_video_file(video) on a
     written config, checkpoint and synthetic mp4.
  7. times of each kernel and its plain version, and the predict step's
     frames/s at batch 96.
The last lines are a JSON summary of the kernels, the nvidia-smi line, and
``{"ok": true, "device": {...}}``.
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

NORMALIZE_MAX_ULP = 1  # bf16 ulps, kernel (one FMA) vs plain ((x/255 - mean)/std)
DECODE_KP_TOL_PX = 0.05
DECODE_CONF_TOL = 1e-3
DECODE_MAX_WINDOW_FLIPS = 2  # maps (of 1632) whose keypoint floors across a pixel edge
CARD_VS_CPU_TOL_PX = 0.05

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
    from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel
    from lightning_pose_tpu_torch.train.checkpoints import (
        load_flax_variables,
        save_checkpoint,
        state_dict_to_flax,
    )

    # -- 2. build ----------------------------------------------------------------
    t0 = time.perf_counter()
    decode_kernel._library()
    t_decode = time.perf_counter() - t0
    t0 = time.perf_counter()
    normalize_kernel.normalize(torch.zeros((1, 2, 2, 3), dtype=torch.uint8, device=dev))
    torch.cuda.synchronize()
    t_normalize = time.perf_counter() - t0
    log(f"phase 2 build: decode.cu (nvcc) {t_decode:.1f} s, normalize (Triton, first call) "
        f"{t_normalize:.1f} s")

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
    log(f"phase 4 main path: {MAIN_PATH_BATCHES} batches of {BATCH}, launches {launches}")
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
            result = Model.from_dir(model_dir).predict_on_video_file(video_file)
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
                f"model load and decode of a {n_frames}-frame mp4 {card}")

    # -- 7. times ----------------------------------------------------------------
    frames_bf16 = video[0]
    hm = torch.from_numpy(cases["peaked"]).to(dev)
    times = {
        "normalize": (
            cuda_ms(lambda: normalize_kernel.normalize(frames_bf16, torch.bfloat16)),
            cuda_ms(lambda: normalize_kernel.normalize_plain(frames_bf16, torch.bfloat16)),
        ),
        "decode": (
            cuda_ms(lambda: decode_kernel.decode(hm, DOWNSAMPLE)),
            cuda_ms(lambda: decode_kernel.decode_plain(hm, DOWNSAMPLE)),
        ),
    }
    for name, (ms, plain_ms) in times.items():
        log(f"phase 7 {name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms at the product shape {card}")
    step_ms = cuda_ms(lambda: step(frames_bf16, bbox), iters=10)
    log(f"phase 7 predict step (ResNet-50, 256 px, bf16, batch {BATCH}): {step_ms:.3f} ms, "
        f"{BATCH / step_ms * 1e3:.1f} frames/s {card}")

    summary = [
        {
            "name": name,
            **KERNELS[name],
            "launches": launches[name],
            "max_abs_err": errors[name],
            "ms": times[name][0],
            "plain_ms": times[name][1],
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
