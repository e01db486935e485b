"""The run configuration of the port: a copy of the JAX package's config
system (``lightning_pose_tpu/config/``), an OmegaConf/Hydra-compatible
subset with the same schema and defaults. ``load_config()`` gives the
defaults; ``Config.from_yaml`` reads a model directory's ``config.yaml``."""

from lightning_pose_tpu_torch.config.conf import Config, load_config, register_resolver
from lightning_pose_tpu_torch.config.defaults import default_config

__all__ = ["Config", "default_config", "load_config", "register_resolver"]
