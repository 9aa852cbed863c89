from mjlab_tpu_torch.envs.mdp import *  # noqa: F401,F403
from mjlab_tpu_torch.tasks.jumping.mdp.commands import (  # noqa: F401
    JumpCommand,
    JumpCommandCfg,
)
from mjlab_tpu_torch.tasks.jumping.mdp.curriculums import (  # noqa: F401
    jump_height_curriculum,
)
from mjlab_tpu_torch.tasks.jumping.mdp.observations import (  # noqa: F401
    both_feet_in_contact,
    feet_in_contact,
    foot_contact,
    foot_contact_forces,
    foot_height,
    pelvis_height,
    pelvis_height_relative,
    pelvis_vertical_velocity,
)
from mjlab_tpu_torch.tasks.jumping.mdp.rewards import (  # noqa: F401
    continuous_jump_height,
    excessive_rotation_penalty,
    feet_slip_penalty,
    flat_orientation,
    horizontal_drift_penalty,
    jump_height_reward,
    launch_velocity_reward,
    soft_landing,
    stable_landing_reward,
)
