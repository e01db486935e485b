"""How far the port's compiled and exported predict routes land from the
eager one, and how far bf16 lands from fp32, on the default model (ResNet-50
``heatmap``, 256 px, 17 keypoints) with seeded random weights, on one CUDA
card (a development check of the port, not part of it).

Run from the root of a checkout:  python3 scripts/torch_route_agreement.py

The weights are ``chip_smoke.seeded_flax_variables`` of ``--seed`` (He-normal
convolutions, BatchNorm near identity, a head at ``HEAD_GAIN``), as no
training has shaped them. The decode's softmax runs at temperature 1000, so
where a map's two highest peaks lie closer in value than a rounding moves
them, the keypoint follows whichever one the rounding puts first, and jumps
across the map. The script tells that apart from a fault of a route:

- the video path: ``predict_on_video_file`` of a ``--frames`` noise video
  (240 x 320) through the eager, compiled (``Model.compile``) and exported
  (``Model.export`` then ``use_exported_runtime``) routes at fp32 and bf16,
  TF32 off; each route's CSV against the eager one of its precision, and the
  eager bf16 CSV against the eager fp32 one;
- the step: the same routes on ``--batches`` canonical batches (96, 256,
  256, 3) of noise frames, and each route's keypoints against the eager
  fp32 ones, the nearest this card gets to the model's exact answer;
- the eager heatmaps of these batches at both precisions: per map, the gap
  between its highest value and its highest value more than two pixels
  away (the runner-up peak), and the largest difference between the bf16
  and the fp32 map (the rounding bf16 adds). Printed for all maps and for
  the maps whose keypoint moved more than 1 px between two routes.

Prints one line a comparison, the card's name and power limit, and a last
line of JSON with every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

ROUTES = ("eager", "compiled", "exported")
PRECISIONS = ("fp32", "bf16")
IMAGE = 256
KEYPOINTS = 17
BATCH = 96
JUMP_PX = 1.0


def write_model_dir(root: Path, rng) -> Path:
    """A model directory of the default ResNet-50 heatmap model with seeded
    random weights."""
    import yaml

    from chip_smoke import seeded_flax_variables
    from lightning_pose_tpu_torch.models.factory import build_model
    from lightning_pose_tpu_torch.train.checkpoints import save_checkpoint, state_dict_to_flax

    params, stats = state_dict_to_flax(build_model("heatmap", "resnet50", KEYPOINTS, 2).state_dict())
    params = seeded_flax_variables(params, rng)
    stats = seeded_flax_variables(stats, rng)
    model_dir = root / "model"
    checkpoints = model_dir / "tb_logs" / "agree" / "version_0" / "checkpoints"
    checkpoints.mkdir(parents=True)
    save_checkpoint(str(checkpoints / "epoch=0-step=0-best.ckpt"), params, stats)
    cfg = {"data": {"image_resize_dims": {"height": IMAGE, "width": IMAGE}, "num_keypoints": KEYPOINTS,
                    "keypoint_names": [f"kp{i}" for i in range(KEYPOINTS)], "downsample_factor": 2},
           "model": {"model_type": "heatmap", "backbone": "resnet50_animal_ap10k", "model_name": "agree",
                     "losses_to_use": []},
           "eval": {}, "dali": {"base": {"predict": {"sequence_length": BATCH}}}}
    (model_dir / "config.yaml").write_text(yaml.safe_dump(cfg))
    return model_dir


def keypoint_moves(kp, ref) -> np.ndarray:
    """Per keypoint, the distance in pixels between two ``(N, 2K)`` arrays."""
    d = np.asarray(kp, np.float64) - np.asarray(ref, np.float64)
    return np.hypot(d[:, 0::2], d[:, 1::2])


def summary(moves: np.ndarray, conf: np.ndarray | None = None) -> dict:
    out = {"max_px": float(moves.max()), "median_px": float(np.median(moves)),
           "share_over_1px": float((moves > JUMP_PX).mean())}
    if conf is not None:
        out["max_conf"] = float(conf.max())
    return out


def heatmap_stats(maps32, maps16) -> tuple[np.ndarray, np.ndarray, dict]:
    """Per map of two ``(N, K, h, w)`` tensors: the fp32 map's runner-up gap
    and the bf16 rounding, and their spread over all maps."""
    import torch

    n, k, h, w = maps32.shape
    flat = maps32.reshape(n * k, h * w)
    top, where = flat.max(dim=1)
    rows, cols = torch.div(where, w, rounding_mode="floor"), where % w
    yy = torch.arange(h, device=flat.device).view(1, h, 1)
    xx = torch.arange(w, device=flat.device).view(1, 1, w)
    near = ((yy - rows.view(-1, 1, 1)).abs() <= 2) & ((xx - cols.view(-1, 1, 1)).abs() <= 2)
    second = flat.masked_fill(near.reshape(n * k, h * w), float("-inf")).max(dim=1).values
    gap = (top - second).cpu().numpy()
    rounding = (maps16.float() - maps32).abs().reshape(n * k, h * w).max(dim=1).values.cpu().numpy()
    spread = (flat.max(dim=1).values - flat.min(dim=1).values).cpu().numpy()
    stats = {"median_gap": float(np.median(gap)), "median_rounding_bf16": float(np.median(rounding)),
             "median_range": float(np.median(spread)), "share_gap_below_rounding": float((gap < rounding).mean())}
    return gap, rounding, stats


def main() -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--seed", type=int, default=1)
    parser.add_argument("--frames", type=int, default=1000)
    parser.add_argument("--batches", type=int, default=4)
    args = parser.parse_args()

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("torch_route_agreement: this script needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from chip_smoke import write_video
    from lightning_pose_tpu_torch.api.model import Model
    from lightning_pose_tpu_torch.ops import cuda_build
    from lightning_pose_tpu_torch.ops.preprocess import normalize_images_fused

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    cuda_build.build("decode.cu", "decode_grad.cu")
    rng = np.random.default_rng(args.seed)
    result: dict = {"card": card, "seed": args.seed, "frames": args.frames, "batches": args.batches}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        model_dir = write_model_dir(tmp, rng)
        video = write_video(tmp / "noise.mp4", rng, args.frames, 240, 320)
        frames = torch.from_numpy(rng.integers(0, 256, (args.batches, BATCH, IMAGE, IMAGE, 3), dtype=np.uint8))
        bbox = torch.tensor([[0.0, 0.0, IMAGE, IMAGE]] * BATCH, device="cuda")
        csv, step, maps, seconds = {}, {}, {}, {}
        for precision in PRECISIONS:
            for route in ROUTES:
                model = Model.from_dir(model_dir, precision=precision)
                t0 = time.perf_counter()
                if route == "compiled":
                    model.compile()
                elif route == "exported":
                    model.use_exported_runtime(model.export(tmp / f"export_{precision}"))
                else:
                    model._load()
                torch.cuda.synchronize()
                seconds[f"{precision}_{route}"] = time.perf_counter() - t0
                preds = model.predict_on_video_file(video, compute_metrics=False,
                                                    output_dir=tmp / f"{route}_{precision}").predictions
                csv[precision, route] = preds.to_numpy(np.float64)
                outs = [model._predict_fn(frames[b].cuda(), bbox) for b in range(args.batches)]
                step[precision, route] = tuple(torch.cat(o).cpu().numpy() for o in zip(*outs))
                if route == "eager":
                    s = model._predict_step
                    with torch.inference_mode(), torch.autocast("cuda", dtype=torch.bfloat16,
                                                                enabled=precision == "bf16"):
                        maps[precision] = torch.cat([
                            s.model(normalize_images_fused(frames[b].cuda(), out_dtype=s.compute_dtype)).float()
                            for b in range(args.batches)])
                del model
                torch.cuda.empty_cache()
        result["prepare_s"] = seconds

        # -- the video CSVs, as a user gets them ------------------------------------
        video_rows = {}
        pairs = [((p, r), (p, "eager")) for p in PRECISIONS for r in ("compiled", "exported")]
        pairs.append((("bf16", "eager"), ("fp32", "eager")))
        for a, b in pairs:
            xy = np.ones(csv[a].shape[1], bool)
            xy[2::3] = False
            moves = keypoint_moves(csv[a][:, xy], csv[b][:, xy])
            row = summary(moves, np.abs(csv[a][:, 2::3] - csv[b][:, 2::3]))
            video_rows[f"{a[0]} {a[1]} vs {b[0]} {b[1]}"] = row
            print(f"video CSV {a[0]} {a[1]} vs {b[0]} {b[1]}: keypoints max {row['max_px']:.3e} px, median "
                  f"{row['median_px']:.3e} px, {100 * row['share_over_1px']:.3f}% over {JUMP_PX} px; confidences "
                  f"max {row['max_conf']:.3e}", flush=True)
        result["video"] = video_rows

        # -- the step on the canonical batches, against eager fp32 --------------------
        gap, rounding, stats = heatmap_stats(maps["fp32"], maps["bf16"])
        result["heatmaps"] = stats
        print(f"heatmaps ({args.batches * BATCH} frames x {KEYPOINTS} maps): median value range "
              f"{stats['median_range']:.4g}, median runner-up gap {stats['median_gap']:.4g}, median bf16 rounding "
              f"{stats['median_rounding_bf16']:.4g}; gap below the rounding in "
              f"{100 * stats['share_gap_below_rounding']:.2f}% of the maps", flush=True)
        ref = step["fp32", "eager"][0]
        step_rows = {}
        for precision in PRECISIONS:
            for route in ROUTES:
                if (precision, route) == ("fp32", "eager"):
                    continue
                moves = keypoint_moves(step[precision, route][0], ref).reshape(-1)
                jumped = moves > JUMP_PX
                row = summary(moves)
                row["jumped_maps"] = int(jumped.sum())
                row["jumped_median_gap"] = float(np.median(gap[jumped])) if jumped.any() else None
                row["jumped_median_rounding_bf16"] = float(np.median(rounding[jumped])) if jumped.any() else None
                row["jumped_share_gap_below_rounding"] = (
                    float((gap[jumped] < rounding[jumped]).mean()) if jumped.any() else None)
                step_rows[f"{precision} {route}"] = row
                print(f"step {precision} {route} vs fp32 eager: keypoints max {row['max_px']:.3e} px, median "
                      f"{row['median_px']:.3e} px, {row['jumped_maps']} maps moved over {JUMP_PX} px"
                      + (f" (their median runner-up gap {row['jumped_median_gap']:.4g}, median bf16 rounding "
                         f"{row['jumped_median_rounding_bf16']:.4g}, gap below the rounding in "
                         f"{100 * row['jumped_share_gap_below_rounding']:.1f}%)" if jumped.any() else ""),
                      flush=True)
        result["step_vs_fp32_eager"] = step_rows
    print(card)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
