from functools import partial

from mjlab_tpu_torch.tasks.registry import register_mjlab_task
from mjlab_tpu_torch.tasks.velocity.config.g1.env_cfgs import (
    unitree_g1_flat_env_cfg,
    unitree_g1_rough_env_cfg,
)

# the PPO config and runner come with the RL slice
register_mjlab_task(
    "Mjlab-Velocity-Flat-Unitree-G1",
    env_cfg=partial(unitree_g1_flat_env_cfg, play=False),
    play_env_cfg=partial(unitree_g1_flat_env_cfg, play=True),
)

register_mjlab_task(
    "Mjlab-Velocity-Rough-Unitree-G1",
    env_cfg=partial(unitree_g1_rough_env_cfg, play=False),
    play_env_cfg=partial(unitree_g1_rough_env_cfg, play=True),
)
