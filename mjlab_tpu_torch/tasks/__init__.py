"""Task zoo. Importing this package registers the ported tasks."""

from mjlab_tpu_torch.tasks.registry import (  # noqa: F401
    list_tasks,
    load_env_cfg,
    load_rl_cfg,
    load_runner_cls,
    register_mjlab_task,
)

# task packages register on import
from mjlab_tpu_torch.tasks import velocity  # noqa: F401
