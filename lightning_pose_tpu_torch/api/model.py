"""High-level Model API (counterpart of ``lightning_pose_tpu/api/model.py``).

``Model.from_dir`` reads a trained model directory (``config.yaml`` plus the
``tb_logs/.../checkpoints/*.ckpt`` layout the reference writes), rebuilds
the tracker in PyTorch on an explicit device, loads the reference's
checkpoint through the parameter bridge, and serves predictions:

- ``predict_on_video_file`` -> ``video_preds/<stem>.csv``
- ``predict_frame`` -> keypoints of one in-memory frame

Ported so far: the single-view ``heatmap`` model with soft-argmax decode and
RGB transfer. The other options raise ``NotImplementedError`` naming the
ROADMAP item that ports them.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from lightning_pose_tpu_torch.data.bboxes import model_to_frame_batch
from lightning_pose_tpu_torch.ops.preprocess import normalize_images_fused

logger = logging.getLogger(__name__)

__all__ = ["Model", "PredictStep", "resolve_device"]

_PRECISIONS = {
    "bf16": torch.bfloat16, "bfloat16": torch.bfloat16, "16-mixed": torch.bfloat16,
    "fp16": torch.bfloat16, "16": torch.bfloat16,
    "fp32": torch.float32, "32": torch.float32, "float32": torch.float32,
}


def resolve_device(device: str | torch.device) -> torch.device:
    """``torch.device(device)``; raises for a CUDA device when CUDA is absent."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but CUDA is not available")
    return device


def compute_dtype_for(precision: str | None) -> torch.dtype:
    """Compute dtype of a precision string; ``None`` means bf16."""
    key = (precision or "bf16").lower()
    if key not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return _PRECISIONS[key]


class PredictStep:
    """uint8 frames and bboxes -> frame-space keypoints and confidences
    (the single-view heatmap branch of the reference's ``predict_step``).

    normalize kernel -> tracker in ``compute_dtype`` (bf16 by autocast, with
    fp32 parameters and BatchNorm statistics) -> decode kernel -> bbox remap.
    ``model`` must be in eval mode on the device the inputs come on.
    """

    def __init__(self, model: nn.Module, height: int, width: int, compute_dtype: torch.dtype):
        self.model = model
        self.height = height
        self.width = width
        self.compute_dtype = compute_dtype

    @torch.inference_mode()
    def __call__(
        self, images_uint8: torch.Tensor, bbox: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, h, w, 3)`` uint8 and ``(B, 4)`` [x, y, h, w] bboxes ->
        ``(B, 2K)`` keypoints and ``(B, K)`` confidences, float32."""
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(images_uint8.device.type, dtype=torch.bfloat16, enabled=bf16):
            images = normalize_images_fused(images_uint8, out_dtype=self.compute_dtype)
            heatmaps = self.model(images)
        keypoints, confidences = self.model.decode(heatmaps, fast=True)
        keypoints = model_to_frame_batch(keypoints, bbox, self.width, self.height)
        return keypoints, confidences


class Model:
    """Lazy-loading interface to a trained model directory."""

    def __init__(
        self,
        model_dir: str | Path,
        config,
        precision: str | None = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.model_dir = Path(model_dir)
        self.config = config
        self.cfg = config.cfg
        self.precision = precision
        self.device = resolve_device(device)
        self._predict_step: PredictStep | None = None

    @classmethod
    def from_dir(
        cls,
        model_dir: str | Path,
        precision: str | None = None,
        device: str | torch.device = "cuda",
        data_parallel: bool = False,
    ) -> "Model":
        """Load from a model directory holding ``config.yaml``.
        ``precision``: fp32 or bf16 (default bf16; fp16 maps to bf16)."""
        if data_parallel:
            raise NotImplementedError(
                "data-parallel prediction is not ported yet (ROADMAP queue 1, item 14)"
            )
        from lightning_pose_tpu.api.model_config import ModelConfig
        from lightning_pose_tpu.config import Config

        config_path = Path(model_dir) / "config.yaml"
        if not config_path.exists():
            raise FileNotFoundError(f"no config.yaml in {model_dir}")
        cfg = Config.from_yaml(str(config_path))
        return cls(model_dir, ModelConfig(cfg), precision=precision, device=device)

    @property
    def ckpt_path(self) -> str | None:
        from lightning_pose_tpu.utils.io import ckpt_path_from_base_path

        return ckpt_path_from_base_path(str(self.model_dir), self.cfg.model.model_name)

    # -- lazy loading -----------------------------------------------------------

    def _load(self) -> None:
        if self._predict_step is not None:
            return
        from lightning_pose_tpu_torch.models.factory import get_model
        from lightning_pose_tpu_torch.train.checkpoints import (
            load_checkpoint,
            load_flax_variables,
        )

        cfg = self.cfg
        compute_dtype = compute_dtype_for(self.precision)
        decode_method = str(cfg.eval.get("decode_method", "softargmax")).lower()
        if decode_method == "dark":
            raise NotImplementedError(
                "DARK decoding is not ported yet (ROADMAP queue 1, item 13)"
            )
        if decode_method != "softargmax":
            raise ValueError(
                f"cfg.eval.decode_method must be softargmax|dark, got {decode_method!r}"
            )
        module = get_model(cfg, num_keypoints=cfg.data.num_keypoints)
        ckpt_path = self.ckpt_path
        if ckpt_path is None:
            raise FileNotFoundError(f"no checkpoint found under {self.model_dir}")
        ckpt = load_checkpoint(ckpt_path)
        load_flax_variables(module, ckpt["params"], ckpt.get("batch_stats", {}))
        module = module.eval().to(self.device, memory_format=torch.channels_last)
        self._predict_step = PredictStep(
            module,
            height=int(cfg.data.image_resize_dims.height),
            width=int(cfg.data.image_resize_dims.width),
            compute_dtype=compute_dtype,
        )

    # -- prediction entry points ------------------------------------------------

    def predict_on_video_file(
        self,
        video_file: str | Path,
        compute_metrics: bool = False,
        output_dir: str | Path | None = None,
    ):
        """Predict a video; write ``video_preds/<stem>.csv`` (or into
        ``output_dir``). Returns a ``PredictionResult``."""
        self._video_transfer_format()
        self._load()
        from lightning_pose_tpu_torch.utils.video_predictions import predict_video

        preds_file = None
        if output_dir:
            preds_file = str(Path(output_dir) / (Path(video_file).stem + ".csv"))
        return predict_video(
            video_file=str(video_file),
            cfg=self.cfg,
            predict_fn=self._predict_step,
            model_dir=str(self.model_dir),
            device=self.device,
            preds_file=preds_file,
            compute_metrics=compute_metrics,
        )

    def _video_transfer_format(self) -> str:
        """Resolve ``cfg.eval.video_transfer_format``: ``auto`` is ``rgb`` off
        the TPU."""
        fmt = str(self.cfg.eval.get("video_transfer_format", "auto")).lower()
        if fmt == "yuv420":
            raise NotImplementedError(
                "yuv420 video transfer is not ported yet (ROADMAP queue 1, item 10)"
            )
        if fmt not in ("rgb", "auto"):
            raise ValueError(
                f"cfg.eval.video_transfer_format must be rgb|yuv420|auto, got {fmt!r}"
            )
        return "rgb"

    def predict_frame(
        self,
        frame_rgb: np.ndarray,
        bbox: tuple[int, int, int, int] | None = None,
    ) -> dict[str, np.ndarray]:
        """Single-frame inference, no file IO.

        Args:
            frame_rgb: ``(H, W, 3)`` uint8 RGB frame.
            bbox: optional ``(x, y, w, h)`` crop; keypoints are mapped back to
                the original frame.

        Returns:
            ``{"keypoints": (K, 2) float32 (x, y), "confidence": (K,) float32}``.
        """
        self._load()
        import cv2

        if frame_rgb.dtype != np.uint8:
            raise ValueError(
                f"frame_rgb must be uint8, got {frame_rgb.dtype}. "
                "Convert with frame.astype(np.uint8) if values are in [0, 255]."
            )
        if frame_rgb.ndim != 3 or frame_rgb.shape[-1] != 3:
            raise ValueError(
                f"frame_rgb must be (H, W, 3) for a single-view heatmap model, "
                f"got shape {frame_rgb.shape}"
            )
        if frame_rgb.size == 0:
            raise ValueError("frame_rgb is empty")
        if bbox is not None:
            bx, by, bw, bh = bbox
            if bx < 0 or by < 0:
                raise ValueError(f"bbox origin must be non-negative, got x={bx}, y={by}")
            if bw <= 0 or bh <= 0:
                raise ValueError(f"bbox width and height must be positive, got w={bw}, h={bh}")
            crop = frame_rgb[by:by + bh, bx:bx + bw]
            if crop.size == 0:
                raise ValueError(
                    f"bbox (x={bx}, y={by}, w={bw}, h={bh}) produces an empty "
                    f"crop on frame of shape {frame_rgb.shape}"
                )
            bbox_row = [bx, by, crop.shape[0], crop.shape[1]]
        else:
            crop = frame_rgb
            bbox_row = [0.0, 0.0, frame_rgb.shape[0], frame_rgb.shape[1]]

        step = self._predict_step
        image = cv2.resize(crop, (step.width, step.height), interpolation=cv2.INTER_LINEAR)
        images = torch.from_numpy(image[None]).to(self.device)
        bboxes = torch.tensor([bbox_row], dtype=torch.float32, device=self.device)
        kp, conf = step(images, bboxes)
        return {
            "keypoints": kp[0].reshape(-1, 2).cpu().numpy().astype(np.float32),
            "confidence": conf[0].cpu().numpy().astype(np.float32),
        }

    # -- not ported yet ---------------------------------------------------------

    def predict_on_label_csv(self, *args, **kwargs):
        raise NotImplementedError(
            "predict_on_label_csv is not ported yet (ROADMAP queue 1, item 7)"
        )

    def compile(self) -> None:
        raise NotImplementedError("compile is not ported yet (ROADMAP queue 1, item 15)")

    def export(self, output_dir: str | Path | None = None) -> str:
        raise NotImplementedError("export is not ported yet (ROADMAP queue 1, item 15)")
