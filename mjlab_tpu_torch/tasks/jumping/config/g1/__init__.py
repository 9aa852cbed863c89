from functools import partial

from mjlab_tpu_torch.tasks.jumping.config.g1.env_cfgs import (
    unitree_g1_jumping_env_cfg,
)
from mjlab_tpu_torch.tasks.jumping.config.g1.rl_cfg import (
    unitree_g1_jumping_ppo_runner_cfg,
)
from mjlab_tpu_torch.tasks.registry import register_mjlab_task

register_mjlab_task(
    "Mjlab-Jumping-Flat-Unitree-G1",
    env_cfg=partial(unitree_g1_jumping_env_cfg, play=False),
    play_env_cfg=partial(unitree_g1_jumping_env_cfg, play=True),
    rl_cfg=unitree_g1_jumping_ppo_runner_cfg,
)
