from mjlab_tpu_torch.envs.mdp import *  # noqa: F401,F403
from mjlab_tpu_torch.tasks.jump.mdp.commands import (  # noqa: F401
    JumpCommand,
    JumpCommandCfg,
)
from mjlab_tpu_torch.tasks.jump.mdp.curriculums import (  # noqa: F401
    progressive_jump_height,
    progressive_stability_requirement,
)
from mjlab_tpu_torch.tasks.jump.mdp.observations import (  # noqa: F401
    foot_air_time,
    foot_contact,
    foot_contact_forces,
    foot_height,
    height_above_ground,
    vertical_velocity,
)
from mjlab_tpu_torch.tasks.jump.mdp.rewards import (  # noqa: F401
    air_time_bonus,
    explosive_takeoff,
    jump_height_reward,
    landing_balance,
    symmetric_landing,
    synchronized_extension,
    vertical_impulse,
)
from mjlab_tpu_torch.tasks.jump.mdp.terminations import (  # noqa: F401
    excessive_landing_force,
)
