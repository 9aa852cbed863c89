from functools import partial

from mjlab_tpu_torch.tasks.manipulation.config.yam.env_cfgs import yam_lift_cube_env_cfg
from mjlab_tpu_torch.tasks.manipulation.config.yam.rl_cfg import yam_lift_cube_ppo_runner_cfg
from mjlab_tpu_torch.tasks.registry import register_mjlab_task

register_mjlab_task(
    "Mjlab-Lift-Cube-Yam",
    env_cfg=partial(yam_lift_cube_env_cfg, play=False),
    play_env_cfg=partial(yam_lift_cube_env_cfg, play=True),
    rl_cfg=yam_lift_cube_ppo_runner_cfg,
)
