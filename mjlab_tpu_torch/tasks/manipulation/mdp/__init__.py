from mjlab_tpu_torch.envs.mdp import *  # noqa: F401,F403
from mjlab_tpu_torch.tasks.manipulation.mdp.commands import (  # noqa: F401
    LiftingCommand,
    LiftingCommandCfg,
)
from mjlab_tpu_torch.tasks.manipulation.mdp.curriculums import (  # noqa: F401
    reward_weight,
)
from mjlab_tpu_torch.tasks.manipulation.mdp.observations import (  # noqa: F401
    ee_to_object_distance,
    object_position_error,
)
from mjlab_tpu_torch.tasks.manipulation.mdp.rewards import (  # noqa: F401
    bring_object_reward,
    joint_velocity_hinge_penalty,
    staged_position_reward,
)
from mjlab_tpu_torch.tasks.manipulation.mdp.terminations import (  # noqa: F401
    illegal_contact,
)
