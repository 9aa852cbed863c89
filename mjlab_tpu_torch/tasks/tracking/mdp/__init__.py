from mjlab_tpu_torch.envs.mdp import *  # noqa: F401,F403
from mjlab_tpu_torch.tasks.tracking.mdp.commands import (  # noqa: F401
    MotionCommand,
    MotionCommandCfg,
    MotionLoader,
)
from mjlab_tpu_torch.tasks.tracking.mdp.metrics import (  # noqa: F401
    ee_orientation_error,
    ee_position_error,
    joint_velocity_error,
    mpkpe,
    root_relative_mpkpe,
)
from mjlab_tpu_torch.tasks.tracking.mdp.observations import (  # noqa: F401
    motion_anchor_ori_b,
    motion_anchor_pos_b,
    robot_body_ori_b,
    robot_body_pos_b,
)
from mjlab_tpu_torch.tasks.tracking.mdp.rewards import (  # noqa: F401
    motion_global_anchor_orientation_error_exp,
    motion_global_anchor_position_error_exp,
    motion_global_body_angular_velocity_error_exp,
    motion_global_body_linear_velocity_error_exp,
    motion_relative_body_orientation_error_exp,
    motion_relative_body_position_error_exp,
    self_collision_cost,
)
from mjlab_tpu_torch.tasks.tracking.mdp.terminations import (  # noqa: F401
    bad_anchor_ori,
    bad_anchor_pos,
    bad_anchor_pos_z_only,
    bad_motion_body_pos,
    bad_motion_body_pos_z_only,
)
