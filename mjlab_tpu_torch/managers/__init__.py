from mjlab_tpu_torch.managers.manager_term_config import (  # noqa: F401
    ActionTermCfg,
    CommandTermCfg,
    CurriculumTermCfg,
    EventTermCfg,
    ManagerTermBaseCfg,
    ObservationGroupCfg,
    ObservationTermCfg,
    RewardTermCfg,
    TerminationTermCfg,
)
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg  # noqa: F401
from mjlab_tpu_torch.managers.manager_base import ManagerBase, ManagerTermBase  # noqa: F401
from mjlab_tpu_torch.managers.action_manager import ActionManager, ActionTerm  # noqa: F401
from mjlab_tpu_torch.managers.observation_manager import ObservationManager  # noqa: F401
from mjlab_tpu_torch.managers.reward_manager import RewardManager  # noqa: F401
from mjlab_tpu_torch.managers.termination_manager import TerminationManager  # noqa: F401
from mjlab_tpu_torch.managers.event_manager import EventManager  # noqa: F401
from mjlab_tpu_torch.managers.command_manager import (  # noqa: F401
    CommandManager,
    CommandTerm,
    NullCommandManager,
)
from mjlab_tpu_torch.managers.curriculum_manager import (  # noqa: F401
    CurriculumManager,
    NullCurriculumManager,
)
