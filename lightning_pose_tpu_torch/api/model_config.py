"""Config wrapper and validation (counterpart of
``lightning_pose_tpu/api/model_config.py``, reference
lightning_pose/api/model_config.py:22-320).

The checks are the JAX package's, with the model types looked up in this
package's registry.
"""

from __future__ import annotations

import os
from pathlib import Path

from lightning_pose_tpu_torch.config import Config
from lightning_pose_tpu_torch.models.factory import ALLOWED_MODEL_TYPES, normalize_model_type

__all__ = ["InvalidConfig", "ModelConfig"]


class InvalidConfig(ValueError):
    pass


class ModelConfig:
    """Wraps a config with convenience accessors and a ``validate()`` that
    mirrors the reference's checks (reference model_config.py:127-320)."""

    def __init__(self, cfg: Config) -> None:
        self.cfg = cfg

    @classmethod
    def from_yaml_file(cls, path: str) -> "ModelConfig":
        return cls(Config.from_yaml(path))

    # -- view handling (reference model_config.py:77-91)

    def is_multi_view(self) -> bool:
        view_names = self.cfg.data.get("view_names", None)
        if not view_names:
            return False
        if len(view_names) == 1:
            raise ValueError(
                "view_names with a single entry is not a valid multiview config"
            )
        return True

    def is_single_view(self) -> bool:
        return not self.is_multi_view()

    def test_video_files_singleview(self) -> list[str]:
        from lightning_pose_tpu_torch.utils.io import get_videos_in_dir

        assert self.is_single_view(), "Use test_video_files_multiview for multi-view"
        video_dir = self.cfg.eval.get("test_videos_directory")
        if not video_dir or not os.path.isdir(str(video_dir)):
            return []
        return list(get_videos_in_dir(str(video_dir)))

    def test_video_files_multiview(self) -> list[list[Path]]:
        from lightning_pose_tpu_torch.utils.io import find_video_files_for_views

        assert self.is_multi_view(), "Use test_video_files_singleview for single-view"
        video_dir = self.cfg.eval.get("test_videos_directory")
        if not video_dir:
            return []
        return find_video_files_for_views(
            str(video_dir), list(self.cfg.data.view_names)
        )

    def validate(self) -> None:
        cfg = self.cfg
        self.validate_steps_vs_epochs()

        # resize dims, if set, must be multiples of 128 (reference
        # model_config.py:171-176 skips unset dims)
        for dim in ("height", "width"):
            val = cfg.data.image_resize_dims.get(dim)
            if val is not None and val % 128 != 0:
                raise InvalidConfig(
                    f"data.image_resize_dims.{dim} ({val}) must be a "
                    "multiple of 128"
                )

        # keypoint counts (reference model_config.py:150-161: num_keypoints
        # must be set and positive; names, if set, must match its length)
        num_keypoints = cfg.data.get("num_keypoints")
        keypoint_names = cfg.data.get("keypoint_names")
        if num_keypoints is None:
            raise InvalidConfig("data.num_keypoints must be set")
        if num_keypoints <= 0:
            raise InvalidConfig(
                f"data.num_keypoints must be positive, got {num_keypoints}"
            )
        if keypoint_names is not None:
            if len(keypoint_names) != num_keypoints:
                raise InvalidConfig(
                    f"data.num_keypoints ({num_keypoints}) does not match "
                    f"len(data.keypoint_names) ({len(keypoint_names)})"
                )

        # multiview: one csv per view (reference model_config.py:162-168)
        if self.is_multi_view():
            csv_file = cfg.data.get("csv_file")
            if isinstance(csv_file, (list, tuple)) and len(csv_file) != len(
                cfg.data.view_names
            ):
                raise InvalidConfig(
                    f"len(data.view_names) ({len(cfg.data.view_names)}) must "
                    f"equal len(data.csv_file) ({len(csv_file)})"
                )

        # split probabilities
        train_prob = cfg.training.get("train_prob", 0.95)
        val_prob = cfg.training.get("val_prob", 0.05)
        if train_prob + val_prob > 1.0 + 1e-8:
            raise InvalidConfig(
                f"train_prob ({train_prob}) + val_prob ({val_prob}) must be <= 1"
            )

        # ckpt_every_n_epochs divisibility
        ckpt_every = cfg.training.get("ckpt_every_n_epochs")
        check_val = cfg.training.get("check_val_every_n_epoch", 5)
        if ckpt_every is not None and check_val and ckpt_every % check_val != 0:
            raise InvalidConfig(
                f"ckpt_every_n_epochs ({ckpt_every}) must be divisible by "
                f"check_val_every_n_epoch ({check_val})"
            )

        # milestones within max_epochs / milestone_steps within max_steps
        # (reference model_config.py:206-219 asserts both)
        multisteplr = cfg.training.lr_scheduler_params.get("multisteplr")
        if multisteplr is not None:
            if cfg.training.get("max_epochs") is not None:
                max_epochs = cfg.training.max_epochs
                for m in multisteplr.get("milestones") or []:
                    if m > max_epochs:
                        raise InvalidConfig(
                            f"lr milestone {m} exceeds max_epochs {max_epochs}"
                        )
            if cfg.training.get("max_steps") is not None:
                max_steps = cfg.training.max_steps
                for m in multisteplr.get("milestone_steps") or []:
                    if m > max_steps:
                        raise InvalidConfig(
                            f"lr milestone_steps {m} exceeds max_steps {max_steps}"
                        )

        # active losses must have numeric log_weights; a loss with no
        # cfg.losses entry or a null log_weight is inactive and skipped
        # (reference model_config.py:275-288)
        for loss_name in cfg.model.get("losses_to_use") or []:
            if loss_name not in cfg.losses:
                continue
            lw = cfg.losses[loss_name].get("log_weight")
            if lw is None:
                continue
            if isinstance(lw, bool) or not isinstance(lw, (int, float)):
                raise InvalidConfig(
                    f"losses.{loss_name}.log_weight must be numeric, got {lw!r}"
                )

        # model type
        if cfg.model.model_type not in ALLOWED_MODEL_TYPES:
            raise InvalidConfig(
                f"model_type {cfg.model.model_type} not in {ALLOWED_MODEL_TYPES}"
            )

        ctx_mode = cfg.model.get("mhcrnn_context_mode", "adjacent")
        if ctx_mode not in ("adjacent", "repeat_center"):
            raise InvalidConfig(
                f"model.mhcrnn_context_mode must be 'adjacent' or "
                f"'repeat_center', got {ctx_mode!r}"
            )

        # multiview checks (reference model_config.py:243-268): warn on a
        # non-transformer model type; the 3D reprojection loss requires
        # dlc-style augmentation with the 3D geometric stage enabled
        if self.is_multi_view():
            if normalize_model_type(cfg.model.model_type) != "heatmap_multiview":
                import warnings

                warnings.warn(
                    "multi-view models require model.model_type = "
                    "'heatmap_multiview_transformer', got "
                    f"'{cfg.model.model_type}'",
                    stacklevel=2,
                )
            reproj = cfg.losses.get("supervised_reprojection_heatmap_mse")
            if reproj is not None and reproj.get("log_weight") is not None:
                if cfg.training.get("imgaug") != "dlc":
                    raise InvalidConfig(
                        "training.imgaug must be 'dlc' when "
                        "losses.supervised_reprojection_heatmap_mse is active"
                    )
                if cfg.training.get("imgaug_3d") is not True:
                    raise InvalidConfig(
                        "training.imgaug_3d must be true when "
                        "losses.supervised_reprojection_heatmap_mse is active"
                    )

    def validate_steps_vs_epochs(self) -> None:
        """Strict steps-XOR-epochs mode (reference model_config.py:290-320)."""
        cfg = self.cfg
        epoch_fields = ["min_epochs", "max_epochs", "unfreezing_epoch"]
        step_fields = ["min_steps", "max_steps", "unfreezing_step"]
        has_epoch = any(cfg.training.get(f) is not None for f in epoch_fields)
        has_step = any(cfg.training.get(f) is not None for f in step_fields)
        milestones = cfg.training.lr_scheduler_params.multisteplr
        if milestones.get("milestones") is not None and has_step:
            raise InvalidConfig(
                "cannot mix step-based fields with epoch-based lr milestones; "
                "use milestone_steps"
            )
        if has_epoch and has_step:
            raise InvalidConfig(
                "cannot mix step-based and epoch-based training fields: "
                f"found epoch fields and step fields simultaneously"
            )
        if not has_epoch and not has_step:
            raise InvalidConfig(
                "must provide either epoch-based (min/max_epochs) or step-based "
                "(min/max_steps) training fields"
            )
        mins = cfg.training.get("min_epochs") or cfg.training.get("min_steps")
        maxs = cfg.training.get("max_epochs") or cfg.training.get("max_steps")
        if (mins is None) != (maxs is None):
            raise InvalidConfig("min and max epochs/steps must both be set")
