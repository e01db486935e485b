"""Seeded synthetic labeled data and unlabeled video for smoke runs and
tests.

``write_labeled_dataset`` writes what a labeling project holds: PNG frames
under ``labeled-data/``, a DLC-format ``CollectedData.csv`` (scorer,
bodyparts, coords header rows), and an empty ``videos/`` directory. Each
frame is a dark background with one Gaussian blob per keypoint at its
label, so a model can learn the labels. ``write_unlabeled_video`` adds an
mp4 to ``videos/`` in which such blobs drift smoothly from frame to frame,
the unlabeled stream of semi-supervised training.

``write_multiview_dataset`` and ``write_multiview_videos`` write the same
for a multiview project, uncalibrated: one camera a view looking at the
same 3D blobs along another axis (view ``v`` sees ``(x, y)`` rotated about
the vertical axis by ``v * 90 / (V - 1)`` degrees), frames under
``labeled-data/<session>_<view>/``, one ``CollectedData_<view>.csv`` a view,
and frame-synchronized ``videos/<session>_<view>.mp4``.

``write_calibrated_multiview_dataset`` writes a calibrated multiview
project: ``V`` pinhole cameras around a scene, each with its intrinsics,
Rodrigues rotation, translation and 5 distortions, in the anipose TOML
``calibrations/<session>.toml`` that the dataset discovers beside
``labeled-data/<session>_<view>/``; the labels are the distorted
projections of seeded 3D points, so that their triangulations agree.

``torchvision_resnet_state_dict``, ``torchvision_efficientnet_state_dict``,
``hf_vit_state_dict``, ``hf_dinov2_state_dict``, ``hf_dinov3_state_dict``,
``hf_sam_vision_state_dict`` and ``hf_sam2_hiera_state_dict`` make seeded
random weights with the key names and shapes of the published checkpoints
that ``model.backbone_checkpoint`` reads (torchvision's ResNet and
EfficientNet, HF's ``ViTModel``, ``Dinov2Model``, ``DINOv3ViTModel``, the
SAM vision encoder and the SAM2 Hiera trunk), their classifier, pooler,
mask token, relative position tables or neck included: files to load
where no pretrained weights can be downloaded. None needs
``transformers``.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

__all__ = [
    "hf_dinov2_state_dict",
    "hf_dinov3_state_dict",
    "hf_sam2_hiera_state_dict",
    "hf_sam_vision_state_dict",
    "hf_vit_state_dict",
    "project_points",
    "synthetic_cameras",
    "torchvision_efficientnet_state_dict",
    "torchvision_resnet_state_dict",
    "write_calibrated_multiview_dataset",
    "write_labeled_dataset",
    "write_multiview_dataset",
    "write_anipose_toml",
    "write_multiview_videos",
    "write_unlabeled_video",
]


def write_labeled_dataset(
    root: str | Path,
    n_frames: int,
    height: int,
    width: int,
    keypoint_names: list[str],
    seed: int = 0,
    nan_fraction: float = 0.05,
) -> Path:
    """Write ``n_frames`` labeled ``(height, width)`` RGB frames under
    ``root``; a ``nan_fraction`` of the labels are NaN (unlabeled).
    Returns ``root``."""
    import cv2
    import pandas as pd

    root = Path(root)
    (root / "labeled-data").mkdir(parents=True, exist_ok=True)
    (root / "videos").mkdir(exist_ok=True)
    rng = np.random.default_rng(seed)
    k = len(keypoint_names)
    colors = rng.uniform(80, 255, (k, 3))
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    labels = np.stack(
        [rng.uniform(0.1, 0.9, (n_frames, k)) * width, rng.uniform(0.1, 0.9, (n_frames, k)) * height],
        axis=-1,
    )
    names = []
    for i in range(n_frames):
        frame = rng.uniform(0, 30, (height, width, 3))
        for j in range(k):
            x, y = labels[i, j]
            blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0**2))
            frame = np.maximum(frame, blob[..., None] * colors[j])
        name = f"labeled-data/img{i:04d}.png"
        cv2.imwrite(str(root / name), np.clip(frame, 0, 255).astype(np.uint8)[..., ::-1])
        names.append(name)
    labels[rng.uniform(size=(n_frames, k)) < nan_fraction] = np.nan
    columns = pd.MultiIndex.from_tuples(
        [("synthetic", kp, c) for kp in keypoint_names for c in ("x", "y")],
        names=["scorer", "bodyparts", "coords"],
    )
    pd.DataFrame(labels.reshape(n_frames, 2 * k), index=names, columns=columns).to_csv(
        root / "CollectedData.csv"
    )
    return root


def write_unlabeled_video(
    root: str | Path,
    name: str,
    n_frames: int,
    height: int,
    width: int,
    n_blobs: int = 4,
    seed: int = 0,
) -> Path:
    """Write ``root/videos/<name>.mp4``: ``n_frames`` RGB frames of
    ``(height, width)`` in which ``n_blobs`` Gaussian blobs drift along
    smooth paths. Returns the file's path."""
    import cv2

    path = Path(root) / "videos" / f"{name}.mp4"
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    colors = rng.uniform(80, 255, (n_blobs, 3))
    start = rng.uniform(0.2, 0.8, (n_blobs, 2)) * (width, height)
    amplitude = rng.uniform(0.05, 0.15, (n_blobs, 2)) * (width, height)
    period = rng.uniform(40, 120, (n_blobs, 1))
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (width, height))
    try:
        for t in range(n_frames):
            centers = start + amplitude * np.sin(2 * np.pi * t / period)
            frame = rng.uniform(0, 30, (height, width, 3))
            for (x, y), color in zip(centers, colors):
                blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0**2))
                frame = np.maximum(frame, blob[..., None] * color)
            writer.write(np.clip(frame, 0, 255).astype(np.uint8)[..., ::-1])
    finally:
        writer.release()
    return path


def _view_projection(points: np.ndarray, view: int, n_views: int, height: int, width: int) -> np.ndarray:
    """``(..., 3)`` points in [0, 1]^3 -> ``(..., 2)`` pixels of camera
    ``view``: an orthographic view rotated about the vertical axis."""
    angle = np.deg2rad(90.0 * view / max(n_views - 1, 1))
    x, y, z = points[..., 0] - 0.5, points[..., 1], points[..., 2] - 0.5
    u = 0.5 + (np.cos(angle) * x + np.sin(angle) * z) / np.sqrt(2.0)
    return np.stack([u * width, y * height], axis=-1)


def _blob_frame(rng, centers: np.ndarray, colors: np.ndarray, yy: np.ndarray, xx: np.ndarray) -> np.ndarray:
    frame = rng.uniform(0, 30, (*yy.shape, 3))
    for (x, y), color in zip(centers, colors):
        blob = np.exp(-((xx - x) ** 2 + (yy - y) ** 2) / (2 * 6.0**2))
        frame = np.maximum(frame, blob[..., None] * color)
    return np.clip(frame, 0, 255).astype(np.uint8)


def write_multiview_dataset(
    root: str | Path,
    n_frames: int,
    height: int,
    width: int,
    keypoint_names: list[str],
    view_names: list[str],
    session: str = "synth",
    seed: int = 0,
    nan_fraction: float = 0.05,
    csv_name: str = "CollectedData_{view}.csv",
) -> Path:
    """Write ``n_frames`` labeled frames of each view under ``root``:
    ``labeled-data/<session>_<view>/img%04d.png`` (consecutive names, so
    that a context model's stacks find their neighbours) and the label CSV
    ``csv_name`` of each view (``"{view}.csv"`` gives the layout of the
    split mirror-mouse example, ``top.csv`` and ``bot.csv``), the labels of
    one 3D keypoint set seen by each camera; a ``nan_fraction`` of each
    view's labels are NaN. Returns ``root``."""
    import cv2
    import pandas as pd

    root = Path(root)
    (root / "videos").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    k = len(keypoint_names)
    colors = rng.uniform(80, 255, (k, 3))
    points = rng.uniform(0.15, 0.85, (n_frames, k, 3))
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    columns = pd.MultiIndex.from_tuples(
        [("synthetic", kp, c) for kp in keypoint_names for c in ("x", "y")],
        names=["scorer", "bodyparts", "coords"],
    )
    for v, view in enumerate(view_names):
        folder = root / "labeled-data" / f"{session}_{view}"
        folder.mkdir(parents=True, exist_ok=True)
        labels = _view_projection(points, v, len(view_names), height, width)
        names = []
        for i in range(n_frames):
            name = f"labeled-data/{session}_{view}/img{i:04d}.png"
            cv2.imwrite(str(root / name), _blob_frame(rng, labels[i], colors, yy, xx)[..., ::-1])
            names.append(name)
        labels[rng.uniform(size=(n_frames, k)) < nan_fraction] = np.nan
        pd.DataFrame(labels.reshape(n_frames, 2 * k), index=names, columns=columns).to_csv(
            root / csv_name.format(view=view)
        )
    return root


def synthetic_cameras(
    n_views: int, height: int, width: int, span_degrees: float = 90.0, distance: float = 5.0, seed: int = 0
) -> dict:
    """``n_views`` cameras on a circle of radius ``distance`` about the
    vertical axis, ``span_degrees`` from the first to the last, each looking
    at the origin (a little tilt and roll drawn from ``seed``), with a focal
    length that puts a unit cube about the origin across 60% of the width
    and small Brown-Conrady distortions: ``intrinsics (V, 3, 3)``,
    ``rotations (V, 3)`` (Rodrigues), ``translations (V, 3)``,
    ``distortions (V, 5)``, all float64."""
    from lightning_pose_tpu_torch.data.anipose import rodrigues

    rng = np.random.default_rng(seed)
    focal = 0.6 * width * distance
    intrinsics, rotations, translations, distortions = [], [], [], []
    for v in range(n_views):
        angle = np.deg2rad(span_degrees * v / max(n_views - 1, 1))
        rvec = np.array([0.0, angle, 0.0]) + rng.normal(0.0, 0.02, 3)
        center = distance * np.array([np.sin(angle), 0.0, -np.cos(angle)])
        intrinsics.append([[focal, 0.0, width / 2.0], [0.0, focal, height / 2.0], [0.0, 0.0, 1.0]])
        rotations.append(rvec)
        translations.append(-rodrigues(rvec) @ center)
        distortions.append([rng.normal(0, 0.05), rng.normal(0, 0.02), rng.normal(0, 1e-3), rng.normal(0, 1e-3), 0.0])
    return {"intrinsics": np.array(intrinsics), "rotations": np.array(rotations),
            "translations": np.array(translations), "distortions": np.array(distortions)}


def project_points(points: np.ndarray, cameras: dict, view: int) -> np.ndarray:
    """``(..., 3)`` world points -> ``(..., 2)`` distorted pixels of camera
    ``view`` of :func:`synthetic_cameras` (cv2's ``projectPoints``)."""
    from lightning_pose_tpu_torch.data.anipose import rodrigues

    cam = points @ rodrigues(cameras["rotations"][view]).T + cameras["translations"][view]
    x, y = cam[..., 0] / cam[..., 2], cam[..., 1] / cam[..., 2]
    k1, k2, p1, p2, k3 = cameras["distortions"][view]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2**2 + k3 * r2**3
    x_d = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    y_d = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    k = cameras["intrinsics"][view]
    return np.stack([x_d * k[0, 0] + k[0, 2], y_d * k[1, 1] + k[1, 2]], axis=-1)


def write_anipose_toml(path: str | Path, cameras: dict, names: list[str], height: int, width: int) -> Path:
    """Write :func:`synthetic_cameras` as an anipose calibration TOML, one
    ``[cam_N]`` section a camera named by ``names``."""
    def row(values) -> str:
        return "[ " + ", ".join(repr(float(v)) for v in values) + ",]"

    lines = []
    for v, name in enumerate(names):
        k = cameras["intrinsics"][v]
        lines += [
            f"[cam_{v}]",
            f'name = "{name}"',
            f"size = [ {width}, {height},]",
            "matrix = [ " + ", ".join(row(r) for r in k) + ",]",
            f"distortions = {row(cameras['distortions'][v])}",
            f"rotation = {row(cameras['rotations'][v])}",
            f"translation = {row(cameras['translations'][v])}",
            "",
        ]
    lines += ["[metadata]", "adjusted = true", "error = 0.0", ""]
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text("\n".join(lines))
    return path


def write_calibrated_multiview_dataset(
    root: str | Path,
    n_frames: int,
    height: int,
    width: int,
    keypoint_names: list[str],
    view_names: list[str],
    session: str = "synth",
    seed: int = 0,
    nan_fraction: float = 0.05,
    span_degrees: float = 90.0,
    frame_map: bool = False,
) -> Path:
    """Write a calibrated multiview labeled set under ``root``:
    ``labeled-data/<session>_<view>/img%04d.png``, ``CollectedData_<view>.csv``
    and ``calibrations/<session>.toml`` (:func:`synthetic_cameras`, the
    cameras ``span_degrees`` apart from first to last). The labels are the
    projections of ``n_frames`` sets of seeded 3D points in a unit cube
    about the origin, each view's frames a Gaussian blob at each label; a
    ``nan_fraction`` of each view's labels are NaN. ``frame_map`` also
    writes ``calibration_frame_map.csv``: one row a labeled frame (the first
    view's names) whose ``file`` names the TOML. Returns ``root``."""
    import cv2
    import pandas as pd

    root = Path(root)
    (root / "videos").mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    cameras = synthetic_cameras(len(view_names), height, width, span_degrees, seed=seed)
    toml = write_anipose_toml(root / "calibrations" / f"{session}.toml", cameras, view_names, height, width)
    k = len(keypoint_names)
    colors = rng.uniform(80, 255, (k, 3))
    points = rng.uniform(-0.5, 0.5, (n_frames, k, 3))
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    columns = pd.MultiIndex.from_tuples(
        [("synthetic", kp, c) for kp in keypoint_names for c in ("x", "y")],
        names=["scorer", "bodyparts", "coords"],
    )
    first_names = []
    for v, view in enumerate(view_names):
        (root / "labeled-data" / f"{session}_{view}").mkdir(parents=True, exist_ok=True)
        labels = project_points(points, cameras, v)
        names = []
        for i in range(n_frames):
            name = f"labeled-data/{session}_{view}/img{i:04d}.png"
            cv2.imwrite(str(root / name), _blob_frame(rng, labels[i], colors, yy, xx)[..., ::-1])
            names.append(name)
        labels[rng.uniform(size=(n_frames, k)) < nan_fraction] = np.nan
        pd.DataFrame(labels.reshape(n_frames, 2 * k), index=names, columns=columns).to_csv(
            root / f"CollectedData_{view}.csv"
        )
        first_names = first_names or names
    if frame_map:
        rel = str(toml.relative_to(root))
        pd.DataFrame({"file": [rel] * n_frames}, index=first_names).to_csv(root / "calibration_frame_map.csv")
    return root


def write_multiview_videos(
    root: str | Path,
    session: str,
    n_frames: int,
    height: int,
    width: int,
    view_names: list[str],
    n_blobs: int = 4,
    seed: int = 0,
) -> list[Path]:
    """Write ``root/videos/<session>_<view>.mp4`` for each view: ``n_frames``
    frames of ``n_blobs`` 3D blobs drifting along smooth paths, each view's
    camera seeing the same blobs at the same time. Returns the files in
    view order."""
    import cv2

    rng = np.random.default_rng(seed)
    colors = rng.uniform(80, 255, (n_blobs, 3))
    start = rng.uniform(0.3, 0.7, (n_blobs, 3))
    amplitude = rng.uniform(0.05, 0.15, (n_blobs, 3))
    period = rng.uniform(40, 120, (n_blobs, 1))
    t = np.arange(n_frames)[:, None, None]
    points = start + amplitude * np.sin(2 * np.pi * t / period)  # (T, n_blobs, 3)
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float32)
    paths = []
    for v, view in enumerate(view_names):
        path = Path(root) / "videos" / f"{session}_{view}.mp4"
        path.parent.mkdir(parents=True, exist_ok=True)
        centers = _view_projection(points, v, len(view_names), height, width)
        writer = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"mp4v"), 30.0, (width, height))
        try:
            for i in range(n_frames):
                writer.write(_blob_frame(rng, centers[i], colors, yy, xx)[..., ::-1])
        finally:
            writer.release()
        paths.append(path)
    return paths


class _Weights:
    """Seeded random tensors for a state dict: convolution and linear
    weights normal with std ``1/sqrt(fan_in)``, BatchNorm and LayerNorm near
    identity."""

    def __init__(self, seed: int) -> None:
        self.rng = np.random.default_rng(seed)
        self.out: dict = {}

    def put(self, key: str, value: np.ndarray) -> None:
        import torch

        self.out[key] = torch.from_numpy(np.ascontiguousarray(value))

    def weight(self, key: str, shape: tuple[int, ...]) -> None:
        fan_in = int(np.prod(shape[1:]))
        self.put(key, (self.rng.standard_normal(shape) / np.sqrt(fan_in)).astype(np.float32))

    def bias(self, key: str, n: int) -> None:
        self.put(key, (0.1 * self.rng.standard_normal(n)).astype(np.float32))

    def norm(self, prefix: str, n: int, batch_norm: bool = True) -> None:
        self.put(f"{prefix}.weight", self.rng.uniform(0.5, 1.5, n).astype(np.float32))
        self.bias(f"{prefix}.bias", n)
        if batch_norm:
            self.bias(f"{prefix}.running_mean", n)
            self.put(f"{prefix}.running_var", self.rng.uniform(0.5, 1.5, n).astype(np.float32))
            self.put(f"{prefix}.num_batches_tracked", np.asarray(1000, dtype=np.int64))


def torchvision_resnet_state_dict(arch: str = "resnet50", seed: int = 0, num_classes: int = 1000) -> dict:
    """A state dict with the names and shapes of torchvision's ``resnet*``
    (``conv1``, ``bn1``, ``layer{s}.{b}.{conv,bn}{c}``,
    ``layer{s}.{b}.downsample.{0,1}``, ``fc``), seeded random values."""
    from lightning_pose_tpu_torch.models.backbones.resnet import RESNET_CONFIGS

    stage_sizes, bottleneck, features = RESNET_CONFIGS[arch]
    w = _Weights(seed)
    w.weight("conv1.weight", (64, 3, 7, 7))
    w.norm("bn1", 64)
    expansion = 4 if bottleneck else 1
    in_c = 64
    for stage, n_blocks in enumerate(stage_sizes):
        width = 64 * 2**stage
        for block in range(n_blocks):
            prefix = f"layer{stage + 1}.{block}"
            if bottleneck:
                convs = [(in_c, width, 1), (width, width, 3), (width, width * expansion, 1)]
            else:
                convs = [(in_c, width, 3), (width, width, 3)]
            for c, (ci, co, k) in enumerate(convs, start=1):
                w.weight(f"{prefix}.conv{c}.weight", (co, ci, k, k))
                w.norm(f"{prefix}.bn{c}", co)
            stride = 2 if stage > 0 and block == 0 else 1
            if stride != 1 or in_c != width * expansion:
                w.weight(f"{prefix}.downsample.0.weight", (width * expansion, in_c, 1, 1))
                w.norm(f"{prefix}.downsample.1", width * expansion)
            in_c = width * expansion
    w.weight("fc.weight", (num_classes, features))
    w.bias("fc.bias", num_classes)
    return w.out


def torchvision_efficientnet_state_dict(variant: str = "b0", seed: int = 0, num_classes: int = 1000) -> dict:
    """A state dict with the names and shapes of torchvision's
    ``efficientnet_b0/b1/b2``: ``features.0`` the stem conv and BatchNorm,
    ``features.{1-7}.{i}.block`` the MBConv blocks ([expand,] depthwise,
    squeeze-excite ``fc1``/``fc2`` with biases, project), ``features.8`` the
    head conv, ``classifier.1`` the linear classifier; seeded random
    values."""
    from lightning_pose_tpu_torch.models.backbones.efficientnet import (
        BASE_STAGES,
        EFFICIENTNET_CONFIGS,
        round_channels,
        stage_layout,
    )

    width_mult, _, head = EFFICIENTNET_CONFIGS[variant]
    w = _Weights(seed)
    stem = round_channels(32 * width_mult)
    w.weight("features.0.0.weight", (stem, 3, 3, 3))
    w.norm("features.0.1", stem)
    in_c = stem
    for stage, i, expand, _, kernel in stage_layout(variant):
        out_c = round_channels(BASE_STAGES[stage - 1][1] * width_mult)
        mid, squeeze = in_c * expand, max(1, in_c // 4)
        prefix = f"features.{stage}.{i}.block"
        idx = 0
        if expand != 1:
            w.weight(f"{prefix}.0.0.weight", (mid, in_c, 1, 1))
            w.norm(f"{prefix}.0.1", mid)
            idx = 1
        w.weight(f"{prefix}.{idx}.0.weight", (mid, 1, kernel, kernel))
        w.norm(f"{prefix}.{idx}.1", mid)
        w.weight(f"{prefix}.{idx + 1}.fc1.weight", (squeeze, mid, 1, 1))
        w.bias(f"{prefix}.{idx + 1}.fc1.bias", squeeze)
        w.weight(f"{prefix}.{idx + 1}.fc2.weight", (mid, squeeze, 1, 1))
        w.bias(f"{prefix}.{idx + 1}.fc2.bias", mid)
        w.weight(f"{prefix}.{idx + 2}.0.weight", (out_c, mid, 1, 1))
        w.norm(f"{prefix}.{idx + 2}.1", out_c)
        in_c = out_c
    w.weight("features.8.0.weight", (head, in_c, 1, 1))
    w.norm("features.8.1", head)
    w.weight("classifier.1.weight", (num_classes, head))
    w.bias("classifier.1.bias", num_classes)
    return w.out


def hf_vit_state_dict(
    embed_dim: int = 384, depth: int = 12, grid: int = 14, patch: int = 16, seed: int = 0, prefix: str = ""
) -> dict:
    """A state dict with the names and shapes of HF's ``ViTModel``
    (facebook/dino-vits16 at ``embed_dim`` 384): ``embeddings.{cls_token,
    position_embeddings, patch_embeddings.projection}`` with a ``grid x
    grid`` position table, ``encoder.layer.{i}.{attention.attention.{query,
    key, value}, attention.output.dense, intermediate.dense, output.dense,
    layernorm_before, layernorm_after}``, ``layernorm`` and
    ``pooler.dense``, each key under ``prefix``; seeded random values."""
    w = _Weights(seed)
    d = embed_dim
    w.put("embeddings.cls_token", (0.02 * w.rng.standard_normal((1, 1, d))).astype(np.float32))
    w.put("embeddings.position_embeddings", (0.02 * w.rng.standard_normal((1, grid * grid + 1, d))).astype(np.float32))
    w.weight("embeddings.patch_embeddings.projection.weight", (d, 3, patch, patch))
    w.bias("embeddings.patch_embeddings.projection.bias", d)
    for i in range(depth):
        layer = f"encoder.layer.{i}"
        for name, (n_out, n_in) in {
            "attention.attention.query": (d, d),
            "attention.attention.key": (d, d),
            "attention.attention.value": (d, d),
            "attention.output.dense": (d, d),
            "intermediate.dense": (4 * d, d),
            "output.dense": (d, 4 * d),
        }.items():
            w.weight(f"{layer}.{name}.weight", (n_out, n_in))
            w.bias(f"{layer}.{name}.bias", n_out)
        w.norm(f"{layer}.layernorm_before", d, batch_norm=False)
        w.norm(f"{layer}.layernorm_after", d, batch_norm=False)
    w.norm("layernorm", d, batch_norm=False)
    w.weight("pooler.dense.weight", (d, d))
    w.bias("pooler.dense.bias", d)
    return {prefix + k: v for k, v in w.out.items()}


def _linear(w: _Weights, key: str, n_out: int, n_in: int, bias: bool = True) -> None:
    w.weight(f"{key}.weight", (n_out, n_in))
    if bias:
        w.bias(f"{key}.bias", n_out)


def _layer_scale(w: _Weights, key: str, n: int) -> None:
    w.put(key, w.rng.uniform(0.1, 1.0, n).astype(np.float32))


def hf_dinov2_state_dict(embed_dim: int = 384, depth: int = 12, grid: int = 16, patch: int = 14, seed: int = 0) -> dict:
    """A state dict with the names and shapes of HF's ``Dinov2Model``
    (facebook/dinov2-small at ``embed_dim`` 384): ``embeddings.{cls_token,
    mask_token, position_embeddings, patch_embeddings.projection}`` with a
    ``grid x grid`` position table and a ``patch x patch`` projection,
    ``encoder.layer.{i}.{norm1, attention.attention.{query, key, value},
    attention.output.dense, layer_scale1.lambda1, norm2, mlp.fc1, mlp.fc2,
    layer_scale2.lambda1}`` and ``layernorm``; seeded random values."""
    w = _Weights(seed)
    d = embed_dim
    w.put("embeddings.cls_token", (0.02 * w.rng.standard_normal((1, 1, d))).astype(np.float32))
    w.put("embeddings.mask_token", np.zeros((1, d), np.float32))
    w.put("embeddings.position_embeddings", (0.02 * w.rng.standard_normal((1, grid * grid + 1, d))).astype(np.float32))
    w.weight("embeddings.patch_embeddings.projection.weight", (d, 3, patch, patch))
    w.bias("embeddings.patch_embeddings.projection.bias", d)
    for i in range(depth):
        layer = f"encoder.layer.{i}"
        w.norm(f"{layer}.norm1", d, batch_norm=False)
        for name in ("attention.attention.query", "attention.attention.key", "attention.attention.value",
                     "attention.output.dense"):
            _linear(w, f"{layer}.{name}", d, d)
        _layer_scale(w, f"{layer}.layer_scale1.lambda1", d)
        w.norm(f"{layer}.norm2", d, batch_norm=False)
        _linear(w, f"{layer}.mlp.fc1", 4 * d, d)
        _linear(w, f"{layer}.mlp.fc2", d, 4 * d)
        _layer_scale(w, f"{layer}.layer_scale2.lambda1", d)
    w.norm("layernorm", d, batch_norm=False)
    return w.out


def hf_dinov3_state_dict(embed_dim: int = 384, depth: int = 12, registers: int = 4, seed: int = 0) -> dict:
    """A state dict with the names and shapes of HF's ``DINOv3ViTModel``
    (facebook/dinov3-vits16 at ``embed_dim`` 384): ``embeddings.{cls_token,
    mask_token, register_tokens, patch_embeddings}``, ``layer.{i}.{norm1,
    attention.{q_proj, k_proj (no bias), v_proj, o_proj},
    layer_scale1.lambda1, norm2, mlp.{up_proj, down_proj},
    layer_scale2.lambda1}`` and ``norm``; seeded random values."""
    w = _Weights(seed)
    d = embed_dim
    w.put("embeddings.cls_token", (0.02 * w.rng.standard_normal((1, 1, d))).astype(np.float32))
    w.put("embeddings.mask_token", np.zeros((1, 1, d), np.float32))
    w.put("embeddings.register_tokens", (0.02 * w.rng.standard_normal((1, registers, d))).astype(np.float32))
    w.weight("embeddings.patch_embeddings.weight", (d, 3, 16, 16))
    w.bias("embeddings.patch_embeddings.bias", d)
    for i in range(depth):
        layer = f"layer.{i}"
        w.norm(f"{layer}.norm1", d, batch_norm=False)
        for name in ("q_proj", "k_proj", "v_proj", "o_proj"):
            _linear(w, f"{layer}.attention.{name}", d, d, bias=name != "k_proj")
        _layer_scale(w, f"{layer}.layer_scale1.lambda1", d)
        w.norm(f"{layer}.norm2", d, batch_norm=False)
        _linear(w, f"{layer}.mlp.up_proj", 4 * d, d)
        _linear(w, f"{layer}.mlp.down_proj", d, 4 * d)
        _layer_scale(w, f"{layer}.layer_scale2.lambda1", d)
    w.norm("norm", d, batch_norm=False)
    return w.out


def hf_sam_vision_state_dict(
    embed_dim: int = 768,
    depth: int = 12,
    num_heads: int = 12,
    grid: int = 64,
    window: int = 14,
    global_attn_indexes: tuple[int, ...] = (2, 5, 8, 11),
    seed: int = 0,
    prefix: str = "vision_encoder.",
) -> dict:
    """A state dict with the names and shapes of the SAM vision encoder
    (facebook/sam-vit-base at ``embed_dim`` 768, under ``prefix`` as in a
    whole ``SamModel``): ``patch_embed.projection``, a ``(1, grid, grid,
    D)`` ``pos_embed``, ``layers.{i}.{layer_norm1, attn.{qkv, proj,
    rel_pos_h, rel_pos_w}, layer_norm2, mlp.{lin1, lin2}}`` and the neck
    (``neck.{conv1, layer_norm1, conv2, layer_norm2}``); seeded random
    values."""
    w = _Weights(seed)
    d = embed_dim
    hd = d // num_heads
    w.weight("patch_embed.projection.weight", (d, 3, 16, 16))
    w.bias("patch_embed.projection.bias", d)
    w.put("pos_embed", (0.02 * w.rng.standard_normal((1, grid, grid, d))).astype(np.float32))
    for i in range(depth):
        layer = f"layers.{i}"
        w.norm(f"{layer}.layer_norm1", d, batch_norm=False)
        _linear(w, f"{layer}.attn.qkv", 3 * d, d)
        _linear(w, f"{layer}.attn.proj", d, d)
        size = grid if i in global_attn_indexes else window
        for axis in ("h", "w"):
            w.put(f"{layer}.attn.rel_pos_{axis}", (0.02 * w.rng.standard_normal((2 * size - 1, hd))).astype(np.float32))
        w.norm(f"{layer}.layer_norm2", d, batch_norm=False)
        _linear(w, f"{layer}.mlp.lin1", 4 * d, d)
        _linear(w, f"{layer}.mlp.lin2", d, 4 * d)
    w.weight("neck.conv1.weight", (256, d, 1, 1))
    w.norm("neck.layer_norm1", 256, batch_norm=False)
    w.weight("neck.conv2.weight", (256, 256, 3, 3))
    w.norm("neck.layer_norm2", 256, batch_norm=False)
    return {prefix + k: v for k, v in w.out.items()}


def hf_sam2_hiera_state_dict(name: str = "vitt_sam2", seed: int = 0, prefix: str = "vision_encoder.backbone.") -> dict:
    """A state dict with the names and shapes of the SAM2 Hiera trunk
    (``Sam2HieraDetModel`` of facebook/sam2.1-hiera-tiny, -small or
    -base-plus for ``vitt_sam2``, ``vits_sam2``, ``vitb_sam2``) under
    ``prefix`` as in a whole ``Sam2Model``: ``patch_embed.projection`` (7 x
    7), ``pos_embed`` ``(1, C, bkg, bkg)`` and ``pos_embed_window`` ``(1, C,
    8, 8)``, ``blocks.{i}.{layer_norm1, proj (at a stage change), attn.{qkv,
    proj}, layer_norm2, mlp.{proj_in, proj_out}}``, with a neck beside it
    (``vision_encoder.neck.*``); seeded random values."""
    from lightning_pose_tpu_torch.models.backbones.hiera import HIERA_CONFIGS

    config = HIERA_CONFIGS[name]
    c0, blocks_per_stage = config["embed_dim"], config["blocks_per_stage"]
    w = _Weights(seed)
    w.weight("patch_embed.projection.weight", (c0, 3, 7, 7))
    w.bias("patch_embed.projection.bias", c0)
    bkg = config["bkg_size"]
    w.put("pos_embed", (0.02 * w.rng.standard_normal((1, c0, bkg, bkg))).astype(np.float32))
    w.put("pos_embed_window", (0.02 * w.rng.standard_normal((1, c0, 8, 8))).astype(np.float32))
    total = 0
    for stage, n_blocks in enumerate(blocks_per_stage):
        for block in range(n_blocks):
            dim_out = c0 * 2**stage
            dim = c0 * 2 ** (stage - 1) if stage > 0 and block == 0 else dim_out
            key = f"blocks.{total}"
            w.norm(f"{key}.layer_norm1", dim, batch_norm=False)
            if dim != dim_out:
                _linear(w, f"{key}.proj", dim_out, dim)
            _linear(w, f"{key}.attn.qkv", 3 * dim_out, dim)
            _linear(w, f"{key}.attn.proj", dim_out, dim_out)
            w.norm(f"{key}.layer_norm2", dim_out, batch_norm=False)
            _linear(w, f"{key}.mlp.proj_in", 4 * dim_out, dim_out)
            _linear(w, f"{key}.mlp.proj_out", dim_out, 4 * dim_out)
            total += 1
    out = {prefix + k: v for k, v in w.out.items()}
    neck = _Weights(seed + 1)
    neck.weight("vision_encoder.neck.convs.0.weight", (256, c0 * 8, 1, 1))
    neck.bias("vision_encoder.neck.convs.0.bias", 256)
    return {**out, **neck.out}
