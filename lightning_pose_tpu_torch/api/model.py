"""High-level Model API (counterpart of ``lightning_pose_tpu/api/model.py``).

``Model.from_dir`` reads a trained model directory (``config.yaml`` plus the
``tb_logs/.../checkpoints/*.ckpt`` layout the reference writes), rebuilds
the tracker in PyTorch on an explicit device, loads the reference's
checkpoint through the parameter bridge, and serves predictions:

- ``predict_on_label_csv`` -> ``image_preds/<csv name>/predictions.csv``
  and its metric CSVs
- ``predict_on_video_file`` -> ``video_preds/<stem>.csv``, its metric CSVs
  and, on request, a labeled mp4
- ``predict_frame`` -> keypoints of one in-memory frame (one frame a view
  for a multiview model)
- ``predict_on_label_csv_multiview`` and ``predict_on_video_file_multiview``
  -> the same files, one a view, for the multiview transformer

Ported so far: the single-view ``heatmap`` and ``regression`` models, the
temporal-context ``heatmap_mhcrnn`` model and the multiview transformer
(``heatmap_multiview``, uncalibrated), with soft-argmax decode (none for
regression, whose confidences are 1.0) and RGB transfer. The other options raise ``NotImplementedError`` naming the ROADMAP
item that ports them.
"""

from __future__ import annotations

import logging
from pathlib import Path

import numpy as np
import torch
from torch import nn

from lightning_pose_tpu_torch.data.bboxes import model_to_frame_batch
from lightning_pose_tpu_torch.models.heatmap_tracker_mhcrnn import (
    HeatmapTrackerMHCRNN,
    make_context_windows,
    repeat_center_stack,
)
from lightning_pose_tpu_torch.models.heatmap_tracker_multiview import HeatmapTrackerMultiviewTransformer
from lightning_pose_tpu_torch.models.regression_tracker import RegressionTracker
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
    (the reference's ``predict_step``).

    normalize kernel -> tracker in ``compute_dtype`` (bf16 by autocast, with
    fp32 parameters and BatchNorm statistics) -> decode kernel -> bbox remap.
    For the context model, a ``(T, h, w, 3)`` sequence becomes its ``T - 4``
    sliding windows and ``(B, 5, h, w, 3)`` stacks go in as they are (both
    as repeated centers under ``repeat_center``); the two heads' maps are
    decoded, two decode launches, and merged per keypoint by confidence.
    The multiview transformer takes ``(B, V, h, w, 3)`` views, one
    normalize launch over all of them, and decodes its ``V*K`` maps in one
    launch; keypoints map to each view's frame through that view's bbox.
    The regression model's outputs are the keypoints: no decode, and
    confidences of 1.0. ``model`` must be in eval mode on the device the
    inputs come on.
    """

    def __init__(self, model: nn.Module, height: int, width: int, compute_dtype: torch.dtype):
        self.model = model
        self.height = height
        self.width = width
        self.compute_dtype = compute_dtype
        self.is_context = isinstance(model, HeatmapTrackerMHCRNN)
        self.is_regression = isinstance(model, RegressionTracker)
        self.num_views = model.num_views if isinstance(model, HeatmapTrackerMultiviewTransformer) else 1

    @torch.inference_mode()
    def __call__(
        self, images_uint8: torch.Tensor, bbox: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, h, w, 3)`` uint8 (context stacks ``(B, 5, h, w, 3)``,
        multiview ``(B, V, h, w, 3)``) and ``(B, 4)`` [x, y, h, w] bboxes
        (``(B, 4V)`` multiview) -> ``(B', 2K)`` keypoints and ``(B', K)``
        confidences, float32 (``K`` over all views); ``B' = B - 4`` for a
        context model's sequence, whose bboxes are trimmed to the window
        centers."""
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(images_uint8.device.type, dtype=torch.bfloat16, enabled=bf16):
            images = normalize_images_fused(images_uint8, out_dtype=self.compute_dtype)
            if self.is_context:
                repeat = self.model.context_repeat
                if images.ndim == 4:
                    images = make_context_windows(images, repeat_center=repeat)
                elif repeat:
                    images = repeat_center_stack(images, time_axis=1)
            heatmaps = self.model(images)
        if self.is_context:
            keypoints, confidences = self.model.decode_heads(heatmaps)
        elif self.is_regression:
            keypoints, confidences = heatmaps, RegressionTracker.confidences(heatmaps)
        else:
            keypoints, confidences = self.model.decode(heatmaps)
        keypoints = model_to_frame_batch(keypoints, bbox, self.width, self.height, num_views=self.num_views)
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
                "data-parallel prediction is not ported yet (ROADMAP queue 1, item 8: multi-GPU)"
            )
        from lightning_pose_tpu_torch.api.model_config import ModelConfig
        from lightning_pose_tpu_torch.config import Config

        config_path = Path(model_dir) / "config.yaml"
        if not config_path.exists():
            raise FileNotFoundError(f"no config.yaml in {model_dir}")
        cfg = Config.from_yaml(str(config_path))
        return cls(model_dir, ModelConfig(cfg), precision=precision, device=device)

    @property
    def ckpt_path(self) -> str | None:
        from lightning_pose_tpu_torch.utils.io import ckpt_path_from_base_path

        return ckpt_path_from_base_path(str(self.model_dir), self.cfg.model.model_name)

    def image_preds_dir(self) -> Path:
        return self.model_dir / "image_preds"

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
                "DARK decoding is not ported yet (ROADMAP queue 1, item 7: remaining model families)"
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

    def predict_on_label_csv(
        self,
        csv_file: str | Path,
        data_dir: str | Path | None = None,
        compute_metrics: bool = True,
        add_train_val_test_set: bool = False,
        output_dir: str | Path | None = None,
        bbox_file: str | Path | None = None,
    ):
        """Predict every frame of a labeled CSV; write
        ``image_preds/<csv name>/predictions.csv`` (or into ``output_dir``)
        and its metric CSVs (reference model.py:958). Returns a
        ``PredictionResult``.

        ``bbox_file``: an optional per-frame [x, y, h, w] CSV; each frame is
        cropped to its box and the keypoints are mapped back to the frame.
        ``add_train_val_test_set``: the seeded training splits give the
        ``set`` column; otherwise every frame is ``train``."""
        if self.config.is_multi_view():
            raise ValueError(
                "this is a multiview model; use predict_on_label_csv_multiview with one CSV per view"
            )
        self._load()
        from lightning_pose_tpu_torch.data.datamodules import BaseDataModule
        from lightning_pose_tpu_torch.data.datasets import HeatmapDataset
        from lightning_pose_tpu_torch.data.datatypes import PredictionResult
        from lightning_pose_tpu_torch.utils.predictions import predict_dataset

        cfg = self.cfg.copy()
        if not add_train_val_test_set:
            cfg.training.train_prob = 1
            cfg.training.val_prob = 0
            cfg.training.train_frames = 1
        data_dir = str(data_dir or cfg.data.data_dir)
        csv_file = str(csv_file)
        dataset = HeatmapDataset(
            root_directory=data_dir,
            csv_path=csv_file,
            image_resize_height=cfg.data.image_resize_dims.height,
            image_resize_width=cfg.data.image_resize_dims.width,
            imgaug_pipeline="default",
            downsample_factor=int(cfg.data.get("downsample_factor", 2)),
            bbox_path=str(bbox_file) if bbox_file else None,
            do_context=cfg.model.model_type == "heatmap_mhcrnn",
            # the context source the model was trained with
            context_mode=cfg.model.get("mhcrnn_context_mode", "adjacent"),
        )
        data_module = BaseDataModule(
            dataset=dataset,
            train_batch_size=cfg.training.train_batch_size,
            val_batch_size=cfg.training.val_batch_size,
            test_batch_size=cfg.training.test_batch_size,
            train_probability=cfg.training.train_prob,
            val_probability=cfg.training.get("val_prob", None),
            torch_seed=cfg.training.get("rng_seed_data_pt", 42),
        )
        if cfg.data.get("keypoint_names", None) is None:
            cfg.data.keypoint_names = list(dataset.keypoint_names)

        out_dir = Path(output_dir) if output_dir else self.image_preds_dir() / Path(csv_file).name
        out_dir.mkdir(parents=True, exist_ok=True)
        preds_file = out_dir / "predictions.csv"
        # the written CSV keeps the 'set' column: the metrics tell labeled
        # from video predictions by it (reference metrics.py:211-216)
        df = predict_dataset(cfg, data_module, self._predict_step, self.device, str(preds_file))

        metrics_result = None
        if compute_metrics:
            from lightning_pose_tpu_torch.metrics import compute_metrics_single

            labels_file = Path(csv_file)
            if not labels_file.is_absolute():
                labels_file = Path(data_dir) / labels_file
            try:
                metrics_result = compute_metrics_single(
                    cfg=cfg, labels_file=str(labels_file), preds_file=str(preds_file), data_module=data_module
                )
            except Exception as e:
                logger.warning(f"metrics computation failed: {e}")
        return PredictionResult(predictions=df, metrics=metrics_result)

    def predict_on_video_file(
        self,
        video_file: str | Path,
        compute_metrics: bool = True,
        generate_labeled_video: bool = False,
        output_dir: str | Path | None = None,
        bbox_df=None,
        bbox_file: str | Path | None = None,
        progress_file: str | Path | None = None,
    ):
        """Predict a video; write ``video_preds/<stem>.csv`` (or into
        ``output_dir``), its metric CSVs and, with
        ``generate_labeled_video``, a labeled mp4 (reference model.py:1139).
        ``bbox_file`` (a per-frame x, y, h, w CSV) or ``bbox_df`` crops each
        frame to its box; ``progress_file`` writes the App's progress JSON.
        Returns a ``PredictionResult``."""
        if self.config.is_multi_view():
            raise ValueError("this is a multiview model; use predict_on_video_file_multiview")
        self._video_transfer_format()
        self._load()
        from lightning_pose_tpu_torch.utils.video_predictions import predict_video

        if bbox_file is not None:
            if bbox_df is not None:
                raise ValueError("pass bbox_file or bbox_df, not both")
            import pandas as pd

            bbox_df = pd.read_csv(bbox_file, index_col=0)
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
            generate_labeled_video=generate_labeled_video,
            compute_metrics=compute_metrics,
            bbox_df=bbox_df,
            progress_file=progress_file,
        )

    def predict_on_video_file_multiview(
        self,
        video_file_per_view: list[str | Path],
        compute_metrics: bool = True,
        generate_labeled_video: bool = False,
        output_dir: str | Path | None = None,
        progress_file: str | Path | None = None,
    ):
        """Predict one session, one video a view in ``data.view_names``
        order, frame-synchronized; write ``video_preds/<stem>.csv`` for each
        view (or into ``output_dir``) with its metric CSVs and, on request,
        labeled mp4s (reference model.py:1225). Returns a
        ``MultiviewPredictionResult``."""
        if not self.config.is_multi_view():
            raise ValueError("this is a single-view model; use predict_on_video_file")
        view_names = list(self.cfg.data.view_names)
        if len(video_file_per_view) != len(view_names):
            raise ValueError(f"got {len(video_file_per_view)} videos for {len(view_names)} views")
        self._video_transfer_format()
        self._load()
        from lightning_pose_tpu_torch.utils.video_predictions import predict_video_multiview

        return predict_video_multiview(
            video_file_per_view=[str(v) for v in video_file_per_view],
            view_names=view_names,
            cfg=self.cfg,
            predict_fn=self._predict_step,
            model_dir=str(self.model_dir),
            device=self.device,
            generate_labeled_video=generate_labeled_video,
            compute_metrics=compute_metrics,
            output_dir=str(output_dir) if output_dir else None,
            progress_file=progress_file,
        )

    def predict_on_label_csv_multiview(
        self,
        csv_file_per_view: list[str | Path],
        data_dir: str | Path | None = None,
        compute_metrics: bool = True,
        add_train_val_test_set: bool = False,
    ):
        """Predict every frame of per-view label CSVs (``data.view_names``
        order); write ``image_preds/<csv name>/predictions.csv`` and its
        metric CSVs for each view (reference model.py:1052). Returns a
        ``MultiviewPredictionResult``. ``add_train_val_test_set`` as in
        :meth:`predict_on_label_csv`."""
        if not self.config.is_multi_view():
            raise ValueError("this is a single-view model; use predict_on_label_csv")
        view_names = list(self.cfg.data.view_names)
        if len(csv_file_per_view) != len(view_names):
            raise ValueError(f"got {len(csv_file_per_view)} CSVs for {len(view_names)} views")
        self._load()
        from lightning_pose_tpu_torch.data.datamodules import BaseDataModule
        from lightning_pose_tpu_torch.data.datasets_multiview import MultiviewHeatmapDataset
        from lightning_pose_tpu_torch.data.datatypes import MultiviewPredictionResult
        from lightning_pose_tpu_torch.utils.predictions import predict_dataset

        cfg = self.cfg.copy()
        if not add_train_val_test_set:
            cfg.training.train_prob = 1
            cfg.training.val_prob = 0
            cfg.training.train_frames = 1
        data_dir = str(data_dir or cfg.data.data_dir)
        cfg.data.csv_file = [str(c) for c in csv_file_per_view]
        dataset = MultiviewHeatmapDataset(cfg, data_dir, imgaug_pipeline="default")
        data_module = BaseDataModule(
            dataset=dataset,
            train_batch_size=cfg.training.train_batch_size,
            val_batch_size=cfg.training.val_batch_size,
            test_batch_size=cfg.training.test_batch_size,
            train_probability=cfg.training.train_prob,
            val_probability=cfg.training.get("val_prob", None),
            torch_seed=cfg.training.get("rng_seed_data_pt", 42),
        )
        view_to_df = predict_dataset(cfg, data_module, self._predict_step, self.device)
        out, out_metrics = {}, {}
        for view, csv_file in zip(view_names, cfg.data.csv_file):
            df = view_to_df[view]
            out_dir = self.image_preds_dir() / Path(csv_file).name
            out_dir.mkdir(parents=True, exist_ok=True)
            preds_file = out_dir / "predictions.csv"
            df.to_csv(preds_file)
            out[view] = df
            if compute_metrics:
                from lightning_pose_tpu_torch.metrics import compute_metrics_single

                labels_file = Path(csv_file)
                if not labels_file.is_absolute():
                    labels_file = Path(data_dir) / labels_file
                try:
                    out_metrics[view] = compute_metrics_single(
                        cfg=cfg, labels_file=str(labels_file), preds_file=str(preds_file), data_module=data_module
                    )
                except Exception as e:
                    logger.warning(f"metrics failed ({view}): {e}")
        return MultiviewPredictionResult(predictions=out, metrics=out_metrics or None)

    def _video_transfer_format(self) -> str:
        """Resolve ``cfg.eval.video_transfer_format``: ``auto`` is ``rgb`` off
        the TPU."""
        fmt = str(self.cfg.eval.get("video_transfer_format", "auto")).lower()
        if fmt == "yuv420":
            raise NotImplementedError(
                "yuv420 video transfer is not ported yet (ROADMAP queue 1, item 5: yuv420 transfer)"
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
            frame_rgb: ``(H, W, 3)`` uint8 RGB frame; for a context model a
                ``(T, H, W, 3)`` stack around the frame (T is the context
                length, 5; the frame is index 2); for a multiview model
                ``(V, H, W, 3)``, one frame a view in ``data.view_names``
                order.
            bbox: optional ``(x, y, w, h)`` crop (the same for every view);
                keypoints are mapped back to the original frame.

        Returns:
            ``{"keypoints": (K, 2) float32 (x, y), "confidence": (K,) float32}``,
            view-major for a multiview model.
        """
        self._load()
        import cv2

        if frame_rgb.dtype != np.uint8:
            raise ValueError(
                f"frame_rgb must be uint8, got {frame_rgb.dtype}. "
                "Convert with frame.astype(np.uint8) if values are in [0, 255]."
            )
        step = self._predict_step
        if step.num_views > 1:
            if frame_rgb.ndim != 4 or frame_rgb.shape[0] != step.num_views or frame_rgb.shape[-1] != 3:
                raise ValueError(
                    f"Multiview model requires frame_rgb of shape ({step.num_views}, H, W, 3), "
                    f"one frame per view in cfg order; got shape {frame_rgb.shape}"
                )
        elif step.is_context:
            if frame_rgb.ndim != 4 or frame_rgb.shape[-1] != 3:
                raise ValueError(
                    "Context model requires frame_rgb of shape (T, H, W, 3) "
                    "where T is the temporal context length (typically 5). "
                    f"Use predict_on_video_file for single-frame input; got shape {frame_rgb.shape}"
                )
        elif frame_rgb.ndim != 3 or frame_rgb.shape[-1] != 3:
            raise ValueError(
                f"frame_rgb must be (H, W, 3) for a single-view model, "
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
            crop = frame_rgb[..., by:by + bh, bx:bx + bw, :]
            if crop.size == 0:
                raise ValueError(
                    f"bbox (x={bx}, y={by}, w={bw}, h={bh}) produces an empty "
                    f"crop on frame of shape {frame_rgb.shape}"
                )
            bbox_row = [bx, by, crop.shape[-3], crop.shape[-2]]
        else:
            crop = frame_rgb
            bbox_row = [0.0, 0.0, frame_rgb.shape[-3], frame_rgb.shape[-2]]

        def resize(img: np.ndarray) -> np.ndarray:
            return cv2.resize(img, (step.width, step.height), interpolation=cv2.INTER_LINEAR)

        image = np.stack([resize(f) for f in crop]) if crop.ndim == 4 else resize(crop)
        images = torch.from_numpy(image[None]).to(self.device)
        bboxes = torch.tensor([bbox_row * step.num_views], dtype=torch.float32, device=self.device)
        kp, conf = step(images, bboxes)
        return {
            "keypoints": kp[0].reshape(-1, 2).cpu().numpy().astype(np.float32),
            "confidence": conf[0].cpu().numpy().astype(np.float32),
        }

    # -- not ported yet ---------------------------------------------------------

    def compile(self) -> None:
        raise NotImplementedError("compile is not ported yet (ROADMAP queue 1, item 9: API and CLI remainder)")

    def export(self, output_dir: str | Path | None = None) -> str:
        raise NotImplementedError("export is not ported yet (ROADMAP queue 1, item 9: API and CLI remainder)")
