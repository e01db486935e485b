"""The port's ``ModelConfig.validate`` against the JAX package's: on the same
configs both accept, or both raise their package's ``InvalidConfig`` with
the same message, and both give the same warnings."""

from __future__ import annotations

import warnings

import pytest

from lightning_pose_tpu.api.model_config import InvalidConfig as JaxInvalidConfig
from lightning_pose_tpu.api.model_config import ModelConfig as JaxModelConfig
from lightning_pose_tpu_torch.api.model_config import InvalidConfig, ModelConfig
from lightning_pose_tpu_torch.config import load_config


def _step_mode(cfg):
    t = cfg.training
    t.max_epochs = t.min_epochs = t.unfreezing_epoch = None
    t.max_steps = t.min_steps = 100
    t.unfreezing_step = 10
    t.lr_scheduler_params.multisteplr.milestones = None
    t.lr_scheduler_params.multisteplr.milestone_steps = [50]


def _multiview(cfg, csv_files=("a.csv", "b.csv")):
    cfg.data.view_names = ["top", "side"]
    cfg.data.csv_file = list(csv_files)
    cfg.model.model_type = "heatmap_multiview_transformer"


def _reprojection(cfg, imgaug="dlc", imgaug_3d=True):
    _multiview(cfg)
    cfg.losses["supervised_reprojection_heatmap_mse"] = {"log_weight": 1.0}
    cfg.training.imgaug = imgaug
    cfg.training.imgaug_3d = imgaug_3d


def _set(path: str, value):
    def edit(cfg):
        *parents, leaf = path.split(".")
        node = cfg
        for p in parents:
            node = node[p]
        node[leaf] = value

    return edit


# (case, edit of the defaults, whether validate raises)
CASES = [
    ("defaults", lambda cfg: None, False),
    ("step_mode", _step_mode, False),
    ("unset_resize_dims", _set("data.image_resize_dims.height", None), False),
    ("resize_not_multiple_of_128", _set("data.image_resize_dims.width", 200), True),
    ("num_keypoints_unset", _set("data.num_keypoints", None), True),
    ("num_keypoints_zero", _set("data.num_keypoints", 0), True),
    ("keypoint_names_length", _set("data.keypoint_names", ["a", "b"]), True),
    ("split_over_one", _set("training.val_prob", 0.2), True),
    ("ckpt_every_not_divisible", _set("training.ckpt_every_n_epochs", 7), True),
    ("milestone_past_max_epochs", _set("training.lr_scheduler_params.multisteplr.milestones", [400]), True),
    ("milestone_step_past_max_steps",
     lambda cfg: (_step_mode(cfg), _set("training.lr_scheduler_params.multisteplr.milestone_steps", [500])(cfg)),
     True),
    ("epochs_and_steps_mixed", _set("training.max_steps", 10), True),
    ("active_loss_numeric", _set("model.losses_to_use", ["pca_singleview", "not_configured"]), False),
    ("active_loss_weight_string",
     lambda cfg: (_set("model.losses_to_use", ["temporal"])(cfg), _set("losses.temporal.log_weight", "5")(cfg)),
     True),
    ("active_loss_weight_bool",
     lambda cfg: (_set("model.losses_to_use", ["temporal"])(cfg), _set("losses.temporal.log_weight", True)(cfg)),
     True),
    ("model_type_unknown", _set("model.model_type", "transformer"), True),
    ("model_type_mhcrnn", _set("model.model_type", "heatmap_mhcrnn"), False),
    ("context_mode_unknown", _set("model.mhcrnn_context_mode", "random"), True),
    ("multiview", _multiview, False),
    ("multiview_csv_count", lambda cfg: _multiview(cfg, ("a.csv",) * 3), True),
    ("multiview_plain_heatmap", lambda cfg: (_multiview(cfg), _set("model.model_type", "heatmap")(cfg)), False),
    ("reprojection", _reprojection, False),
    ("reprojection_without_dlc", lambda cfg: _reprojection(cfg, imgaug="default"), True),
    ("reprojection_without_3d", lambda cfg: _reprojection(cfg, imgaug_3d=False), True),
    ("model_type_regression", _set("model.model_type", "regression"), False),
    ("efficientnet_backbone", _set("model.backbone", "efficientnet_b2"), False),
    ("regression_efficientnet_step_mode",
     lambda cfg: (_step_mode(cfg), _set("model.model_type", "regression")(cfg),
                  _set("model.backbone", "efficientnet_b0")(cfg)),
     False),
    ("multiview_regression", lambda cfg: (_multiview(cfg), _set("model.model_type", "regression")(cfg)), False),
    *[(f"transformer_{name}", _set("model.backbone", name), False)
      for name in ("vits_dinov2", "vitb_dinov3", "vitb_sam", "vitb_sam2", "vits_sam2", "vitt_sam2")],
    ("mhcrnn_vit", lambda cfg: (_set("model.model_type", "heatmap_mhcrnn")(cfg),
                                _set("model.backbone", "vits_dino")(cfg)), False),
    ("multiview_dinov3", lambda cfg: (_multiview(cfg), _set("model.backbone", "vits_dinov3")(cfg)), False),
    ("multiview_sam", lambda cfg: (_multiview(cfg), _set("model.backbone", "vitb_sam")(cfg)), False),
    ("decode_dark", _set("eval.decode_method", "dark"), False),
]


def _outcome(config_cls, error_cls, edit):
    cfg = load_config()
    cfg.data.num_keypoints = 3
    cfg.data.keypoint_names = ["a", "b", "c"]
    edit(cfg)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        try:
            config_cls(cfg).validate()
            error = None
        except error_cls as e:
            error = str(e)
    return error, [str(w.message) for w in caught]


@pytest.mark.parametrize("edit,raises", [c[1:] for c in CASES], ids=[c[0] for c in CASES])
def test_validate_matches_jax(edit, raises):
    error, warned = _outcome(ModelConfig, InvalidConfig, edit)
    ref_error, ref_warned = _outcome(JaxModelConfig, JaxInvalidConfig, edit)
    assert (error, warned) == (ref_error, ref_warned)
    assert (error is not None) == raises, error
