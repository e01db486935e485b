"""The run configuration of the port: the JAX package's config system, which
imports no JAX, re-exported so that the port's users and tests load their
configs through this package (``load_config()`` gives the repo's defaults;
``Config.from_yaml`` reads a model directory's ``config.yaml``)."""

from __future__ import annotations

from lightning_pose_tpu.config import Config, load_config

__all__ = ["Config", "load_config"]
