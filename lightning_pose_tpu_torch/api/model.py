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
  -> the same files, one a view, for a multiview model: the multiview
  transformer, or ``heatmap`` and ``heatmap_mhcrnn`` trained on multiview
  data

Ported so far: the single-view ``heatmap`` and ``regression`` models, the
temporal-context ``heatmap_mhcrnn`` model, the multiview transformer
(``heatmap_multiview``) and the heatmap models on multiview data, with
every backbone the JAX package takes, the soft-argmax decode or
``eval.decode_method: dark`` (none for regression, whose confidences are
1.0), and RGB or (``eval.video_transfer_format: yuv420``) I420 transfer of
video frames. ``compile`` runs the predictions through ``torch.compile``;
``export`` saves the prediction program with ``torch.export``
(``exports_torch/predict.pt2``), and ``use_exported_runtime`` runs the
predictions through such a file. ``from_dir(..., data_parallel=True)``
splits each prediction batch over every visible GPU, one replica of the
predict step a device.
"""

from __future__ import annotations

import copy
import logging
import time
from pathlib import Path

import numpy as np
import torch
from torch import nn

from lightning_pose_tpu_torch.data.bboxes import model_to_frame_batch
from lightning_pose_tpu_torch.models.heatmap_tracker_mhcrnn import (
    HeatmapTrackerMHCRNN,
    make_context_windows,
    merge_heads_by_confidence,
    repeat_center_stack,
)
from lightning_pose_tpu_torch.models.heatmap_tracker_multiview import HeatmapTrackerMultiviewTransformer
from lightning_pose_tpu_torch.models.regression_tracker import RegressionTracker
from lightning_pose_tpu_torch.ops.dark import run_dark_decode
from lightning_pose_tpu_torch.ops.preprocess import normalize_images_fused
from lightning_pose_tpu_torch.ops.yuv_kernel import i420_to_normalized

logger = logging.getLogger(__name__)

__all__ = ["DECODE_METHODS", "DataParallelPredict", "Model", "PredictStep", "decode_method_of", "resolve_device"]

DECODE_METHODS = ("softargmax", "dark")

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


def decode_method_of(cfg) -> str:
    """``cfg.eval.decode_method`` (default ``softargmax``), checked."""
    method = str(cfg.eval.get("decode_method", "softargmax")).lower()
    if method not in DECODE_METHODS:
        raise ValueError(f"cfg.eval.decode_method must be softargmax|dark, got {method!r}")
    return method


def compute_dtype_for(precision: str | None) -> torch.dtype:
    """Compute dtype of a precision string; ``None`` means bf16."""
    key = (precision or "bf16").lower()
    if key not in _PRECISIONS:
        raise ValueError(f"unknown precision {precision!r}")
    return _PRECISIONS[key]


class PredictStep(nn.Module):
    """uint8 frames and bboxes -> frame-space keypoints and confidences
    (the reference's ``predict_step``).

    normalize kernel -> tracker in ``compute_dtype`` (bf16 by autocast, with
    fp32 parameters and BatchNorm statistics) -> decode kernel -> bbox remap.
    Planar I420 frames (``(T, h*3/2, w)``, multiview ``(T, V, h*3/2, w)``,
    the yuv420 transfer) go through the I420 kernel instead of normalize,
    one launch over all frames and views.
    With ``decode_method="dark"`` the maps are decoded by
    :func:`~lightning_pose_tpu_torch.ops.dark.run_dark_decode` (plain
    PyTorch) instead, on every heatmap path; the decode kernel does not run.
    For the context model, a ``(T, h, w, 3)`` sequence becomes its ``T - 4``
    sliding windows and ``(B, 5, h, w, 3)`` stacks go in as they are (both
    as repeated centers under ``repeat_center``); the two heads' maps are
    decoded, two decode launches, and merged per keypoint by confidence.
    A multiview model (``num_views`` above 1) takes ``(B, V, h, w, 3)``
    views, one normalize launch over all of them, and decodes its ``V*K``
    maps in one launch; keypoints map to each view's frame through that
    view's bbox. A context model on multiview data takes a ``(T, V, h, w,
    3)`` sequence, tiled into ``(T-4, V, 5, ...)`` windows a view, or ``(B,
    V, 5, h, w, 3)`` stacks.
    The regression model's outputs are the keypoints: no decode, and
    confidences of 1.0. ``model`` must be in eval mode on the device the
    inputs come on.

    ``forward`` is the program that ``torch.export`` and ``torch.compile``
    take (normalize and decode are the registered ops
    ``lightning_pose_tpu_torch::normalize`` and ``::decode``); calling the
    step runs it eagerly under ``torch.inference_mode``.
    """

    def __init__(
        self, model: nn.Module, height: int, width: int, compute_dtype: torch.dtype, decode_method: str = "softargmax",
        num_views: int | None = None,
    ):
        """``num_views``: the view count of the model's meta
        (``models.factory.model_meta``); by default the multiview
        transformer's own, else 1."""
        if decode_method not in DECODE_METHODS:
            raise ValueError(f"decode_method must be softargmax|dark, got {decode_method!r}")
        super().__init__()
        self.model = model
        self.decode_method = decode_method
        self.height = height
        self.width = width
        self.compute_dtype = compute_dtype
        self.is_context = isinstance(model, HeatmapTrackerMHCRNN)
        self.is_regression = isinstance(model, RegressionTracker)
        if num_views is None:
            num_views = model.num_views if isinstance(model, HeatmapTrackerMultiviewTransformer) else 1
        self.num_views = num_views

    def __call__(self, images_uint8: torch.Tensor, bbox: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """The eager step: :meth:`forward` with no autograd."""
        with torch.inference_mode():
            return super().__call__(images_uint8, bbox)

    def is_i420(self, images_uint8: torch.Tensor) -> bool:
        """Whether ``images_uint8`` is a planar I420 sequence, ``(T, h*3/2,
        w)`` (multiview ``(T, V, h*3/2, w)``)."""
        return images_uint8.ndim == 3 + int(self.num_views > 1)

    def is_sequence(self, images_uint8: torch.Tensor) -> bool:
        """Whether a context model takes ``images_uint8`` as a sequence of
        frames (``T - 4`` windows out), not as stacks."""
        return self.is_context and images_uint8.ndim <= 4 + int(self.num_views > 1)

    def _normalized(self, images_uint8: torch.Tensor) -> torch.Tensor:
        """uint8 frames -> normalized ``(..., 3, h, w)`` in the compute dtype:
        the normalize kernel, or the I420 kernel for I420 frames."""
        if not self.is_i420(images_uint8):
            return normalize_images_fused(images_uint8, out_dtype=self.compute_dtype)
        if self.num_views > 1:
            t, v = images_uint8.shape[:2]
            flat = i420_to_normalized(images_uint8.reshape(t * v, *images_uint8.shape[2:]), self.compute_dtype)
            return flat.reshape(t, v, *flat.shape[1:])
        return i420_to_normalized(images_uint8, self.compute_dtype)

    def forward(
        self, images_uint8: torch.Tensor, bbox: torch.Tensor
    ) -> tuple[torch.Tensor, torch.Tensor]:
        """``(B, h, w, 3)`` uint8 (context stacks ``(B, 5, h, w, 3)``,
        multiview ``(B, V, h, w, 3)``, multiview context stacks ``(B, V, 5,
        h, w, 3)``; I420 sequences as :meth:`is_i420`) and ``(B, 4)`` [x, y,
        h, w] bboxes (``(B, 4V)`` multiview) -> ``(B', 2K)`` keypoints and
        ``(B', K)`` confidences, float32 (``K`` over all views); ``B' = B -
        4`` for a context model's sequence, whose bboxes are trimmed to the
        window centers."""
        bf16 = self.compute_dtype == torch.bfloat16
        with torch.autocast(images_uint8.device.type, dtype=torch.bfloat16, enabled=bf16):
            images = self._normalized(images_uint8)
            if self.is_context:
                repeat = self.model.context_repeat
                # a sequence: (T, [V,] 3, h, w); stacks: (B, [V,] 5, 3, h, w)
                views = int(self.num_views > 1)
                if images.ndim == 4 + views:
                    images = make_context_windows(images, repeat_center=repeat)
                    if views:  # (T-4, 5, V, ...) -> (T-4, V, 5, ...)
                        images = images.transpose(1, 2)
                elif repeat:
                    images = repeat_center_stack(images, time_axis=1 + views)
            heatmaps = self.model(images)
        if self.is_regression:
            keypoints, confidences = heatmaps, RegressionTracker.confidences(heatmaps)
        elif self.decode_method == "dark":
            df = self.model.downsample_factor
            if self.is_context:
                keypoints, confidences = merge_heads_by_confidence(
                    *run_dark_decode(heatmaps[0], df), *run_dark_decode(heatmaps[1], df)
                )
            else:
                keypoints, confidences = run_dark_decode(heatmaps, df)
        elif self.is_context:
            keypoints, confidences = self.model.decode_heads(heatmaps)
        else:
            keypoints, confidences = self.model.decode(heatmaps)
        keypoints = model_to_frame_batch(keypoints, bbox, self.width, self.height, num_views=self.num_views)
        return keypoints, confidences


class DataParallelPredict:
    """Prediction split over devices (the JAX package's GSPMD-sharded
    predict, api/model.py:305-360): one replica of the predict step a
    device; each batch is split by frames, padded with its last frame to a
    multiple of the replica count and trimmed after. A context model's
    sequence is split by window, each shard with the 4 frames of halo its
    last windows need, so that the concatenated windows are the
    single-device ones. Every shard is launched before the first result is
    copied back; the results gather on the first replica's device.

    ``fns[i](images, bbox)`` runs replica ``i`` (the eager step or its
    compiled forward) on ``devices[i]``."""

    def __init__(self, steps: list[PredictStep], devices: list[torch.device]):
        self.steps = steps
        self.devices = devices
        self.fns = list(steps)

    def __call__(self, images_uint8: torch.Tensor, bbox: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        n = len(self.fns)
        halo = 4 if self.steps[0].is_sequence(images_uint8) else 0
        rows = images_uint8.shape[0] - halo
        pad = (-rows) % n
        if pad:
            images_uint8 = torch.cat([images_uint8, images_uint8[-1:].expand(pad, *images_uint8.shape[1:])])
            bbox = torch.cat([bbox, bbox[-1:].expand(pad, *bbox.shape[1:])])
        per = (rows + pad) // n
        outputs = [
            fn(images_uint8[i * per:(i + 1) * per + halo].to(dev, non_blocking=True),
               bbox[i * per:(i + 1) * per + halo].to(dev, non_blocking=True))
            for i, (fn, dev) in enumerate(zip(self.fns, self.devices))
        ]
        kp = torch.cat([k.to(self.devices[0]) for k, _ in outputs])
        conf = torch.cat([c.to(self.devices[0]) for _, c in outputs])
        return kp[:rows], conf[:rows]


class Model:
    """Lazy-loading interface to a trained model directory."""

    def __init__(
        self,
        model_dir: str | Path,
        config,
        precision: str | None = None,
        device: str | torch.device = "cuda",
        data_parallel: bool = False,
    ) -> None:
        self.model_dir = Path(model_dir)
        self.config = config
        self.cfg = config.cfg
        self.precision = precision
        self.device = resolve_device(device)
        self.data_parallel = data_parallel
        self._predict_step: PredictStep | None = None
        self._data_parallel: DataParallelPredict | None = None
        # the call that runs the predictions: the eager step, its compiled
        # forward, or the exported program of use_exported_runtime
        self._predict_fn = None
        self._exported_runtime_active = False

    @classmethod
    def from_dir(
        cls,
        model_dir: str | Path,
        precision: str | None = None,
        device: str | torch.device = "cuda",
        data_parallel: bool = False,
    ) -> "Model":
        """Load from a model directory holding ``config.yaml``.
        ``precision``: fp32 or bf16 (default bf16; fp16 maps to bf16).
        ``data_parallel``: split prediction batches over every visible GPU
        (:class:`DataParallelPredict`); with one, predict as without it."""
        from lightning_pose_tpu_torch.api.model_config import ModelConfig
        from lightning_pose_tpu_torch.config import Config

        config_path = Path(model_dir) / "config.yaml"
        if not config_path.exists():
            raise FileNotFoundError(f"no config.yaml in {model_dir}")
        cfg = Config.from_yaml(str(config_path))
        return cls(model_dir, ModelConfig(cfg), precision=precision, device=device, data_parallel=data_parallel)

    @classmethod
    def from_dir2(
        cls,
        model_dir: str | Path,
        hydra_overrides: list[str] | None = None,
        precision: str | None = None,
        device: str | torch.device = "cuda",
        data_parallel: bool = False,
    ) -> "Model":
        """:meth:`from_dir`, then Hydra-style ``a.b=value`` overrides applied
        to the config (reference model.py:339)."""
        model = cls.from_dir(model_dir, precision=precision, device=device, data_parallel=data_parallel)
        if hydra_overrides:
            model.cfg.apply_overrides(hydra_overrides)
        return model

    @property
    def ckpt_path(self) -> str | None:
        from lightning_pose_tpu_torch.utils.io import ckpt_path_from_base_path

        return ckpt_path_from_base_path(str(self.model_dir), self.cfg.model.model_name)

    # -- output directory conventions (reference model.py:706-742) ----------------

    def image_preds_dir(self) -> Path:
        return self.model_dir / "image_preds"

    def video_preds_dir(self) -> Path:
        return self.model_dir / "video_preds"

    def labeled_videos_dir(self) -> Path:
        return self.model_dir / "video_preds" / "labeled_videos"

    def cropped_data_dir(self) -> Path:
        """Where cropzoom's cropped images go."""
        return self.model_dir / "cropped_images"

    def cropped_videos_dir(self) -> Path:
        """Where cropzoom's cropped videos go."""
        return self.model_dir / "cropped_videos"

    def cropped_csv_file_path(self, csv_file_path: str | Path) -> Path:
        """``image_preds/<csv name>/cropped_<csv name>``."""
        name = Path(csv_file_path).name
        return self.image_preds_dir() / name / ("cropped_" + name)

    # -- lazy loading -----------------------------------------------------------

    def _load(self) -> None:
        if self._predict_step is not None:
            return
        from lightning_pose_tpu_torch.models.factory import get_model, model_meta
        from lightning_pose_tpu_torch.train.checkpoints import (
            load_checkpoint,
            load_flax_variables,
        )

        cfg = self.cfg
        compute_dtype = compute_dtype_for(self.precision)
        decode_method = decode_method_of(cfg)
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
            decode_method=decode_method,
            num_views=model_meta(cfg)["num_views"],
        )
        self._predict_fn = self._predict_step
        if self.data_parallel:
            self._enable_data_parallel()

    def _enable_data_parallel(self) -> None:
        """One replica of the predict step on each device of
        ``parallel.mesh.devices()`` (the live step on the first when that is
        this model's device), the predictions through
        :class:`DataParallelPredict`. With one device it logs and predicts
        as without (JAX api/model.py:324-326)."""
        from lightning_pose_tpu_torch.parallel import mesh

        devices = mesh.devices()
        if len(devices) < 2:
            logger.info("data_parallel requested but only one device attached")
            return
        step = self._predict_step
        home = self.device
        if home.type == "cuda" and home.index is None:
            home = torch.device("cuda", torch.cuda.current_device())
        steps = []
        for i, device in enumerate(devices):
            if i == 0 and device == home:
                steps.append(step)
                continue
            model = copy.deepcopy(step.model).to(device, memory_format=torch.channels_last)
            steps.append(PredictStep(model, step.height, step.width, step.compute_dtype, step.decode_method,
                                     step.num_views))
        self._data_parallel = DataParallelPredict(steps, devices)
        self._predict_fn = self._data_parallel
        logger.info(f"prediction batches split across {len(devices)} devices")

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
        df = predict_dataset(cfg, data_module, self._predict_fn, self.device, str(preds_file))

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
        transfer_format = self._video_transfer_format()
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
            predict_fn=self._predict_fn,
            model_dir=str(self.model_dir),
            device=self.device,
            preds_file=preds_file,
            generate_labeled_video=generate_labeled_video,
            compute_metrics=compute_metrics,
            bbox_df=bbox_df,
            progress_file=progress_file,
            transfer_format=transfer_format,
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
        transfer_format = self._video_transfer_format()
        self._load()
        from lightning_pose_tpu_torch.utils.video_predictions import predict_video_multiview

        return predict_video_multiview(
            video_file_per_view=[str(v) for v in video_file_per_view],
            view_names=view_names,
            cfg=self.cfg,
            predict_fn=self._predict_fn,
            model_dir=str(self.model_dir),
            device=self.device,
            generate_labeled_video=generate_labeled_video,
            compute_metrics=compute_metrics,
            output_dir=str(output_dir) if output_dir else None,
            progress_file=progress_file,
            transfer_format=transfer_format,
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
        dataset = MultiviewHeatmapDataset(cfg, data_dir, imgaug_pipeline="default",
                                          do_context=cfg.model.model_type == "heatmap_mhcrnn")
        data_module = BaseDataModule(
            dataset=dataset,
            train_batch_size=cfg.training.train_batch_size,
            val_batch_size=cfg.training.val_batch_size,
            test_batch_size=cfg.training.test_batch_size,
            train_probability=cfg.training.train_prob,
            val_probability=cfg.training.get("val_prob", None),
            torch_seed=cfg.training.get("rng_seed_data_pt", 42),
        )
        view_to_df = predict_dataset(cfg, data_module, self._predict_fn, self.device)
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
        """Resolve ``cfg.eval.video_transfer_format``: ``yuv420`` when asked;
        ``auto`` is ``rgb``, as in the JAX package off the TPU; the exported
        runtime's is ``rgb`` whatever the setting (its input shapes are
        RGB)."""
        if self._exported_runtime_active:
            return "rgb"
        fmt = str(self.cfg.eval.get("video_transfer_format", "auto")).lower()
        if fmt not in ("rgb", "yuv420", "auto"):
            raise ValueError(
                f"cfg.eval.video_transfer_format must be rgb|yuv420|auto, got {fmt!r}"
            )
        return "rgb" if fmt == "auto" else fmt

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
                order; for a context model on multiview data ``(V, T, H, W,
                3)``, a stack a view.
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
        nv = step.num_views
        if nv > 1 and step.is_context:
            if frame_rgb.ndim != 5 or frame_rgb.shape[0] != nv or frame_rgb.shape[-1] != 3:
                raise ValueError(
                    f"Multiview context model requires frame_rgb of shape ({nv}, T, H, W, 3): one temporal "
                    f"context stack per view in cfg order; got shape {frame_rgb.shape}"
                )
        elif nv > 1:
            if frame_rgb.ndim != 4 or frame_rgb.shape[0] != nv or frame_rgb.shape[-1] != 3:
                raise ValueError(
                    f"Multiview model requires frame_rgb of shape ({nv}, H, W, 3), "
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

        flat = crop.reshape(-1, *crop.shape[-3:])
        image = np.stack([resize(f) for f in flat]).reshape(*crop.shape[:-3], step.height, step.width, 3)
        images = torch.from_numpy(image[None]).to(self.device)
        bboxes = torch.tensor([bbox_row * step.num_views], dtype=torch.float32, device=self.device)
        kp, conf = self._predict_fn(images, bboxes)
        return {
            "keypoints": kp[0].reshape(-1, 2).cpu().numpy().astype(np.float32),
            "confidence": conf[0].cpu().numpy().astype(np.float32),
        }

    # -- compile / export ---------------------------------------------------------

    def _runner(self, program, images_shape: tuple[int, ...] | None = None):
        """``(images_uint8, bbox) -> (keypoints, confidences)`` through
        ``program`` under ``torch.inference_mode``; with ``images_shape``,
        other image shapes raise."""

        def run(images_uint8: torch.Tensor, bbox: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
            if images_shape is not None and tuple(images_uint8.shape) != images_shape:
                raise ValueError(
                    f"exported program expects images {images_shape}, got {tuple(images_uint8.shape)}; "
                    "use the eager runtime for non-video batch shapes"
                )
            with torch.inference_mode():
                return program(images_uint8, bbox)

        return run

    def _canonical_inputs(self) -> tuple[torch.Tensor, torch.Tensor]:
        """Zero frames and full-frame bboxes of the canonical video batch:
        ``(T, H, W, 3)`` uint8, ``(T, V, H, W, 3)`` for a multiview model,
        ``T`` the model's ``dali.{base,context}.predict.sequence_length``."""
        step = self._predict_step
        seq_len = int(self.cfg.dali["context" if step.is_context else "base"]["predict"]["sequence_length"])
        views = (step.num_views,) if step.num_views > 1 else ()
        images = torch.zeros((seq_len, *views, step.height, step.width, 3), dtype=torch.uint8, device=self.device)
        bbox = torch.tensor([[0.0, 0.0, step.height, step.width] * step.num_views] * seq_len, device=self.device)
        return images, bbox

    def compile(self) -> None:
        """``torch.compile`` the live checkpoint's step (default mode, static
        shapes) and run it once at the canonical video batch, so that the
        predictions after it run compiled (reference model.py:409). Under
        :meth:`use_exported_runtime` it only runs the exported program once
        at that batch, as the JAX package's compile() warms up whatever
        program it serves."""
        self._load()
        t0 = time.perf_counter()
        images, bbox = self._canonical_inputs()
        if not self._exported_runtime_active and self._data_parallel is not None:
            # every replica's forward compiled, the batches split as before
            self._data_parallel.fns = [self._runner(torch.compile(s.forward, dynamic=False))
                                       for s in self._data_parallel.steps]
        elif not self._exported_runtime_active:
            self._predict_fn = self._runner(torch.compile(self._predict_step.forward, dynamic=False))
        self._predict_fn(images, bbox)
        what = "ran the exported program once" if self._exported_runtime_active else "compiled the prediction program"
        logger.info(f"{what} at {tuple(images.shape)} in {time.perf_counter() - t0:.1f} s")

    def export(self, output_dir: str | Path | None = None) -> str:
        """``torch.export`` the live checkpoint's prediction program at the
        canonical video batch and save it as ``<output_dir>/predict.pt2``
        (default ``<model_dir>/exports_torch``), the counterpart of the JAX
        package's ``jax.export`` (reference model.py:615-704). The autocast
        region and the bbox remap are inside the program; normalize and
        decode are its ops ``lightning_pose_tpu_torch::normalize`` and
        ``::decode``. Under ``data_parallel`` it exports the single-device
        step. Returns the path."""
        self._load()
        t0 = time.perf_counter()
        images, bbox = self._canonical_inputs()
        with torch.no_grad():
            program = torch.export.export(self._predict_step, (images, bbox))
        out_dir = Path(output_dir or (self.model_dir / "exports_torch"))
        out_dir.mkdir(parents=True, exist_ok=True)
        path = out_dir / "predict.pt2"
        torch.export.save(program, str(path))
        logger.info(f"exported the prediction program at {tuple(images.shape)} to {path} in "
                    f"{time.perf_counter() - t0:.1f} s")
        return str(path)

    def use_exported_runtime(self, path: str | Path | None = None) -> None:
        """Run the predictions through a saved export instead of the live
        checkpoint (the reference's ``--runtime onnx``, model.py:469-594).
        ``path`` defaults to the single ``.pt2`` under
        ``<model_dir>/exports_torch``. The program has the fixed input
        shapes of the canonical video batch; other batch shapes raise."""
        self._load()
        if path is None:
            export_dir = self.model_dir / "exports_torch"
            candidates = sorted(export_dir.glob("*.pt2"))
            if len(candidates) != 1:
                raise FileNotFoundError(
                    f"expected exactly one .pt2 under {export_dir}, found {len(candidates)}; run "
                    "`litpose-torch export` first or pass an explicit path"
                )
            path = candidates[0]
        program = Model.load_exported(path)
        images_shape = next(
            tuple(node.meta["val"].shape) for node in program.graph.nodes if node.op == "placeholder"
        )
        self._predict_fn = self._runner(program, images_shape)
        self._exported_runtime_active = True
        logger.info(f"predictions now run the exported program at {path}")

    @staticmethod
    def load_exported(path: str | Path) -> torch.fx.GraphModule:
        """Load a saved prediction program (the ORT-runtime analog,
        reference model.py:469-594) as a module ``(images_uint8, bbox) ->
        (keypoints, confidences)`` on the device it was exported on. The
        port's ops are registered first."""
        from lightning_pose_tpu_torch.ops import decode_kernel, normalize_kernel, yuv_kernel  # noqa: F401

        return torch.export.load(str(path)).module()
