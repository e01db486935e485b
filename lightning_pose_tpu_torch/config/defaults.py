"""The canonical default config schema (the port's copy of
``lightning_pose_tpu/config/defaults.py``).

Key-for-key compatible with the reference schema
(reference scripts/configs/config_default.yaml): sections
``data / training / model / dali / losses / eval / callbacks / hydra``.
The ``dali`` section name is preserved for config compatibility even though
video ingest here is a host-decode pipeline, not NVIDIA DALI.
"""

from lightning_pose_tpu_torch.config.conf import Config

_DEFAULTS: dict = {
    "data": {
        "image_resize_dims": {"height": None, "width": None},
        "data_dir": "/replace/with/your/path",
        "video_dir": "/replace/with/your/path",
        "csv_file": "CollectedData.csv",
        "num_keypoints": None,
        "keypoint_names": None,
        "mirrored_column_matches": None,
        "columns_for_singleview_pca": None,
    },
    "training": {
        "imgaug": "dlc",
        "imgaug_hflip": False,
        "train_batch_size": 16,
        "val_batch_size": 32,
        "test_batch_size": 32,
        "train_prob": 0.95,
        "val_prob": 0.05,
        "train_frames": 1,
        # kept under the reference name for config compatibility; the port
        # trains on one GPU
        "num_gpus": 1,
        "unfreezing_epoch": 20,
        "min_epochs": 300,
        "max_epochs": 300,
        "log_every_n_steps": 10,
        "check_val_every_n_epoch": 5,
        "ckpt_every_n_epochs": None,
        "early_stopping": False,
        "early_stop_patience": 3,
        "rng_seed_data_pt": 0,
        "rng_seed_model_pt": 0,
        "optimizer": "Adam",
        "optimizer_params": {"learning_rate": 1e-3},
        "lr_scheduler": "multisteplr",
        "lr_scheduler_params": {
            "multisteplr": {"milestones": [150, 200, 250], "gamma": 0.5},
        },
        "uniform_heatmaps_for_nan_keypoints": True,
    },
    "model": {
        "losses_to_use": [],
        "backbone": "resnet50_animal_ap10k",
        "model_type": "heatmap",
        "heatmap_loss_type": "mse",
        "model_name": "test",
        "checkpoint": None,
        # mhcrnn context source: "adjacent" (reference parity —
        # index-adjacent files) or "repeat_center" (for datasets whose
        # labeled frames are sparse video samples, where index neighbors
        # are not temporal neighbors; see docs/architecture.md)
        "mhcrnn_context_mode": "adjacent",
    },
    "dali": {
        "base": {
            "train": {"sequence_length": 32},
            "predict": {"sequence_length": 96},
        },
        "context": {
            "train": {"batch_size": 16},
            "predict": {"sequence_length": 96},
        },
    },
    "losses": {
        "pca_multiview": {
            "log_weight": 11.0,
            "components_to_keep": 3,
            "epsilon": None,
        },
        "pca_singleview": {
            "log_weight": 11.0,
            "components_to_keep": 0.99,
            "epsilon": None,
        },
        "temporal": {
            "log_weight": 11.0,
            "epsilon": 20.0,
            "prob_threshold": 0.05,
        },
        "unimodal_mse": {
            "log_weight": 11.0,
        },
        "unimodal_kl": {
            "log_weight": 11.0,
        },
    },
    "eval": {
        "predict_vids_after_training": True,
        "test_videos_directory": "${data.video_dir}",
        "save_vids_after_training": False,
        "colormap": "cool",
        "confidence_thresh_for_vid": 0.90,
    },
    "callbacks": {
        "anneal_weight": {
            "attr_name": "total_unsupervised_importance",
            "init_val": 0.0,
            "increase_factor": 0.01,
            "final_val": 1.0,
            "freeze_until_epoch": 60,
        },
    },
    "hydra": {
        "run": {"dir": "outputs/${now:%Y-%m-%d}/${now:%H-%M-%S}"},
        "sweep": {"dir": "multirun/${now:%Y-%m-%d}/${now:%H-%M-%S}"},
    },
}


def default_config() -> Config:
    """Return a fresh copy of the default config tree."""
    return Config(_DEFAULTS)
