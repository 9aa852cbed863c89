from mjlab_tpu_torch.envs.mdp import *  # noqa: F401,F403
from mjlab_tpu_torch.tasks.velocity.mdp.curriculums import (  # noqa: F401
    commands_vel,
    terrain_levels_vel,
)
from mjlab_tpu_torch.tasks.velocity.mdp.rewards import (  # noqa: F401
    angular_momentum_penalty,
    body_angular_velocity_penalty,
    feet_air_time,
    feet_clearance,
    feet_slip,
    feet_swing_height,
    flat_orientation,
    self_collision_cost,
    soft_landing,
    track_angular_velocity,
    track_linear_velocity,
    variable_posture,
)
from mjlab_tpu_torch.tasks.velocity.mdp.velocity_command import (  # noqa: F401
    UniformVelocityCommand,
    UniformVelocityCommandCfg,
)
