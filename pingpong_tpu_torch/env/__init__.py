from pingpong_tpu_torch.env.physics import collide_sphere_with_moving_plane
from pingpong_tpu_torch.env.pong import (
    EnvParams,
    EnvState,
    StepOut,
    env_params_from_config,
    observe_a,
    observe_b,
    reset,
    step,
)

__all__ = [
    "collide_sphere_with_moving_plane",
    "EnvParams",
    "EnvState",
    "StepOut",
    "env_params_from_config",
    "observe_a",
    "observe_b",
    "reset",
    "step",
]
