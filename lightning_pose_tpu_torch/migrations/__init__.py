"""On-startup data-directory migrations (counterpart of
``lightning_pose_tpu/migrations/``)."""

from lightning_pose_tpu_torch.migrations.migrations import rename_time_directories, run_migrations

__all__ = ["rename_time_directories", "run_migrations"]
