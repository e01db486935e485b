"""``litpose-torch`` command-line interface (counterpart of ``lightning_pose_tpu/cli/``)."""
