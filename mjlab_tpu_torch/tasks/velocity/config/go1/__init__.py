from functools import partial

from mjlab_tpu_torch.tasks.registry import register_mjlab_task
from mjlab_tpu_torch.tasks.velocity.config.go1.env_cfgs import (
    unitree_go1_flat_env_cfg,
    unitree_go1_rough_env_cfg,
)
from mjlab_tpu_torch.tasks.velocity.config.go1.rl_cfg import unitree_go1_ppo_runner_cfg
from mjlab_tpu_torch.tasks.velocity.rl import VelocityOnPolicyRunner

register_mjlab_task(
    "Mjlab-Velocity-Flat-Unitree-Go1",
    env_cfg=partial(unitree_go1_flat_env_cfg, play=False),
    play_env_cfg=partial(unitree_go1_flat_env_cfg, play=True),
    rl_cfg=unitree_go1_ppo_runner_cfg,
    runner_cls=VelocityOnPolicyRunner,
)

register_mjlab_task(
    "Mjlab-Velocity-Rough-Unitree-Go1",
    env_cfg=partial(unitree_go1_rough_env_cfg, play=False),
    play_env_cfg=partial(unitree_go1_rough_env_cfg, play=True),
    rl_cfg=unitree_go1_ppo_runner_cfg,
    runner_cls=VelocityOnPolicyRunner,
)
