from pingpong_tpu_torch.config.schema import (
    DQNConfig,
    DRQNConfig,
    EnvConfig,
    ExperimentConfig,
)
from pingpong_tpu_torch.config.loader import load_config, apply_overrides

__all__ = [
    "EnvConfig",
    "DQNConfig",
    "DRQNConfig",
    "ExperimentConfig",
    "load_config",
    "apply_overrides",
]
