"""Video prediction, the way a lab runs it: one client predicts a recorded
session with ``Model.predict_on_video_file_multiview`` (one mp4 a view),
product defaults, the next call when the last has returned.

Set-up writes the session and a short warm-up clip (``lpbench/synth.py``)
and seeded weights (``lpbench/weights.py``) as a model directory, loads it
with ``Model.from_dir`` and predicts the clip once, which builds every
kernel and meets the one batch shape the window will (the loader pads a
video's last batch to it). The window repeats the call on the session;
``video_fps`` counts every view's frames of every call that returned, over
the time from the first call's start to the last one's end.

The check holds every row of every call, and the CSVs that the last call
left on disk, to the plain reference's answers for the same frames, in
units of what rounding the reference to bf16 moves them
(``lpbench/compare.py``); the reference runs after the program's state is
freed.
"""

from __future__ import annotations

import gc
import shutil
import time
from pathlib import Path

import numpy as np
import torch

from lpbench import compare, synth, trace
from lpbench.harness import Cell, Run
from lpbench.reference import model as ref
from lpbench.reference.video import read_frames, resize_bilinear
from lpbench.weights import make_weights

__all__ = ["Session", "merged_rows", "reference_answers"]

TRUNK_RANGE = "lpbench.trunk"
HEADS_RANGE = "lpbench.heads"
# frames and windows the reference takes at a time
BLOCK = 64


class Session:
    def __init__(self, cell: Cell, seed: int, workdir: Path, device: torch.device):
        self.cell = cell
        self.seed = int(seed)
        self.workdir = Path(workdir)
        self.device = torch.device(device)
        cfg = cell.config["config"]
        data = cfg["data"]
        self.cfg = cfg
        self.views = list(data["view_names"])
        self.k = int(data["num_keypoints"])
        self.height = int(data["image_resize_dims"]["height"])
        self.width = int(data["image_resize_dims"]["width"])
        raw = cell.config["assumed"]["raw_frame"]
        self.raw_h, self.raw_w = int(raw["height"]), int(raw["width"])
        self.frames = int(cell.mix["session_frames"])
        self.seq_len = int(cfg["dali"]["context"]["predict"]["sequence_length"])
        self.head_gain = float(cell.config["assumed"]["weights"]["head_gain"])
        self.model = None
        self.outputs: list[np.ndarray] = []
        # seconds of each stage of set-up and check, for the log
        self.phases: dict[str, float] = {}

    # -- set-up --------------------------------------------------------------

    def setup(self) -> None:
        import yaml

        from lightning_pose_tpu_torch.api.model import Model
        from lightning_pose_tpu_torch.train.checkpoints import save_checkpoint, state_dict_to_flax

        t = time.perf_counter()
        shutil.rmtree(self.workdir, ignore_errors=True)
        self.videos = synth.write_session(self.workdir / "videos", "session", self.views, self.frames,
                                          self.raw_h, self.raw_w, self.seed)
        warm_up = synth.write_session(self.workdir / "videos", "warm_up", self.views,
                                      int(self.cell.mix["warm_up_frames"]), self.raw_h, self.raw_w, self.seed)
        t = self._phase("videos", t)
        self.weights = make_weights(ref.param_specs(self.k), self.seed, self.device, self.head_gain)
        model_dir = self.workdir / "model"
        name = self.cfg["model"]["model_name"]
        ckpt = model_dir / "tb_logs" / name / "version_0" / "checkpoints" / "epoch=0-step=0-best.ckpt"
        ckpt.parent.mkdir(parents=True)
        save_checkpoint(str(ckpt), *state_dict_to_flax(self.weights))
        (model_dir / "config.yaml").write_text(yaml.safe_dump(self.cfg))
        t = self._phase("weights", t)
        self.model = Model.from_dir(model_dir, device=self.device)
        t = self._phase("load", t)
        self.call(warm_up)  # the model loaded, every kernel built, the batch shape met
        self._phase("warm_up", t)

    def _phase(self, name: str, since: float) -> float:
        now = time.perf_counter()
        self.phases[name] = now - since
        return now

    def call(self, videos: list[Path] | None = None) -> np.ndarray:
        """One prediction of ``videos`` (the session by default); its rows
        ``(V, N, 3K)``."""
        mix = self.cell.mix
        result = self.model.predict_on_video_file_multiview(
            [str(p) for p in videos or self.videos], compute_metrics=bool(mix["compute_metrics"]),
            generate_labeled_video=bool(mix["generate_labeled_video"]))
        return np.stack([result.predictions[v].to_numpy(dtype=np.float64) for v in self.views])

    # -- window --------------------------------------------------------------

    def window(self, seconds: float, trace_dir: Path | None) -> Run:
        hooks = []
        if trace_dir is not None:
            net = self.model._predict_step.model
            hooks = trace.range_hooks({TRUNK_RANGE: net.backbone, HEADS_RANGE: net.head})
        traced = None
        untraced_calls, untraced_s = 0, 0.0
        self.outputs = []
        start = last = time.perf_counter()
        try:
            while True:
                if trace_dir is not None and len(self.outputs) == 1:
                    with trace.capture(trace_dir) as traced:
                        self.outputs.append(self.call())
                    last = time.perf_counter()
                else:
                    self.outputs.append(self.call())
                    now = time.perf_counter()
                    untraced_calls += 1
                    untraced_s += now - last
                    last = now
                if last - start >= seconds and (trace_dir is None or traced is not None):
                    break
        finally:
            for h in hooks:
                h.remove()
        calls = len(self.outputs)
        view_frames = len(self.views) * self.frames
        trunk_flops, head_flops = _flops(self)
        windows = self.frames - 4
        loader_batches = -(-max(windows, 1) // (self.seq_len - 4))
        counts = {
            "calls": calls,
            "view_frames_per_call": view_frames,
            # what the outputs need: the trunk once a distinct frame, the
            # heads once a window
            "flops_per_call": len(self.views) * (self.frames * trunk_flops + windows * head_flops),
            "untraced_calls": untraced_calls,
            "untraced_s": untraced_s,
            "batches_per_call": loader_batches,
            "normalize_pixels_per_launch": self.seq_len * len(self.views) * self.height * self.width,
            "decode_maps_per_launch": (self.seq_len - 4) * len(self.views) * self.k,
            "map_hw": (self.height // 4, self.width // 4),
        }
        return Run(metrics={"video_fps": calls * view_frames / (last - start)}, counts=counts,
                   attempted=calls, trace=traced)

    # -- check ---------------------------------------------------------------

    def last_csvs(self) -> np.ndarray:
        """The CSVs that the last call wrote, one a view, as ``(V, N, 3K)``."""
        import pandas as pd

        out = self.workdir / "model" / "video_preds"
        return np.stack([pd.read_csv(out / f"{Path(p).stem}.csv", header=[0, 1, 2], index_col=0)
                         .to_numpy(dtype=np.float64) for p in self.videos])

    def free_program(self) -> None:
        self.model = None
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def check(self) -> tuple[dict[str, float], int]:
        """The compared numbers and the count of calls with malformed rows."""
        t = time.perf_counter()
        rows = np.stack(self.outputs + [self.last_csvs()])
        self.free_program()
        answers, yardstick = reference_answers(self, (ref.FP32, ref.BF16))
        numbers = compare.video_numbers(rows, answers, merged_rows(yardstick))
        self._phase("check", t)
        return numbers

    def cleanup(self) -> None:
        shutil.rmtree(self.workdir, ignore_errors=True)


def _flops(session: Session) -> tuple[int, int]:
    from lpbench.counts.flops import context_model_flops

    return context_model_flops(session.k, session.height, session.width)


@torch.no_grad()
def reference_answers(session: Session, precisions: tuple[ref.Precision, ...]) -> list[dict[str, np.ndarray]]:
    """The reference's answers at each of ``precisions`` for every frame of
    every view of the session (each view's mp4 decoded once), each head's
    apart (``lpbench/compare.py`` merges them): ``xy_<head> (V, N, K, 2)``
    in frame pixels and ``conf_<head> (V, N, K)``, for ``head`` ``sf`` and
    ``mf``."""
    device, w = session.device, session.weights
    keys = [f"{q}_{h}" for q in ("xy", "conf") for h in ("sf", "mf")]
    out = [{key: [] for key in keys} for _ in precisions]
    scale = torch.tensor([session.raw_w / session.width, session.raw_h / session.height], device=device)
    with ref.fp32_exact():
        for path in session.videos:
            raw = torch.from_numpy(read_frames(path))
            n = raw.shape[0]
            # frame f is window f - 2's center; the first two frames take
            # window 0 and the last two the last window. (A video shorter
            # than its padded batches' windows gives its tail window 0's
            # rows, a quirk of Lightning Pose's that no cell meets.)
            step = session.seq_len - 4
            if -(-(n - 4) // step) * step < n:
                raise ValueError(f"a {n}-frame video gives fewer windows than frames at {session.seq_len}")
            rows = torch.clamp(torch.arange(n, device=device) - 2, 0, n - 5)
            images = [ref.normalize(resize_bilinear(raw[i:i + BLOCK].to(device), session.height, session.width))
                      for i in range(0, n, BLOCK)]
            for prec, answers in zip(precisions, out):
                feats = torch.cat([ref.trunk(x, w, prec) for x in images])
                per = {key: [] for key in keys}
                for s in range(0, n - 4, BLOCK):
                    starts = torch.arange(s, min(s + BLOCK, n - 4), device=device)
                    windows = feats[starts[:, None] + torch.arange(ref.CONTEXT, device=device)]
                    for head, maps in zip(("sf", "mf"), ref.context_heads(windows, w, prec)):
                        kp, conf = ref.decode(maps)
                        per[f"xy_{head}"].append(kp * scale)
                        per[f"conf_{head}"].append(conf)
                del feats
                for key, parts in per.items():
                    answers[key].append(torch.cat(parts)[rows].cpu().numpy().astype(np.float64))
            del images
    return [{key: np.stack(v) for key, v in answers.items()} for answers in out]


def merged_rows(answers: dict[str, np.ndarray]) -> np.ndarray:
    """Answers of :func:`reference_answers` merged as the model merges its
    heads (the multi-frame head where its confidence is at least the
    single-frame head's), as one call's rows ``(1, V, N, 3K)``."""
    take_mf = answers["conf_mf"] >= answers["conf_sf"]
    xy = np.where(take_mf[..., None], answers["xy_mf"], answers["xy_sf"])
    lik = np.maximum(answers["conf_sf"], answers["conf_mf"])
    return np.concatenate([xy, lik[..., None]], axis=-1).reshape(*lik.shape[:2], -1)[None]
