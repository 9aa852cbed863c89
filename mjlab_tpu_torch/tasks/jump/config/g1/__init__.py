from functools import partial

from mjlab_tpu_torch.tasks.jump.config.g1.env_cfgs import unitree_g1_jump_env_cfg
from mjlab_tpu_torch.tasks.jump.config.g1.rl_cfg import unitree_g1_jump_ppo_runner_cfg
from mjlab_tpu_torch.tasks.registry import register_mjlab_task

register_mjlab_task(
    "Mjlab-Jump-Flat-Unitree-G1",
    env_cfg=partial(unitree_g1_jump_env_cfg, play=False),
    play_env_cfg=partial(unitree_g1_jump_env_cfg, play=True),
    rl_cfg=unitree_g1_jump_ppo_runner_cfg,
)
