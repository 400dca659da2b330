from crowdmod_tpu_torch.config.frozen import FrozenConfig
from crowdmod_tpu_torch.config.loader import config_dir, load_config

__all__ = ["FrozenConfig", "load_config", "config_dir"]
