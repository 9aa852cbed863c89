import os
from functools import partial

from mjlab_tpu_torch.tasks.registry import register_mjlab_task
from mjlab_tpu_torch.tasks.tracking.config.g1.env_cfgs import unitree_g1_flat_tracking_env_cfg
from mjlab_tpu_torch.tasks.tracking.config.g1.rl_cfg import unitree_g1_tracking_ppo_runner_cfg
from mjlab_tpu_torch.tasks.tracking.rl import MotionTrackingOnPolicyRunner

# the motion file is resolved when the config is made: the
# MJLAB_TPU_MOTION_FILE environment variable (scripts/train.py sets it from
# --motion-file), or a dotted override of the command's motion_file


def _env_cfg(play=False, has_state_estimation=True):
    return unitree_g1_flat_tracking_env_cfg(
        has_state_estimation=has_state_estimation,
        play=play,
        motion_file=os.environ.get("MJLAB_TPU_MOTION_FILE", ""),
    )


register_mjlab_task(
    "Mjlab-Tracking-Flat-Unitree-G1",
    env_cfg=partial(_env_cfg, play=False),
    play_env_cfg=partial(_env_cfg, play=True),
    rl_cfg=unitree_g1_tracking_ppo_runner_cfg,
    runner_cls=MotionTrackingOnPolicyRunner,
)

register_mjlab_task(
    "Mjlab-Tracking-Flat-Unitree-G1-No-State-Estimation",
    env_cfg=partial(_env_cfg, play=False, has_state_estimation=False),
    play_env_cfg=partial(_env_cfg, play=True, has_state_estimation=False),
    rl_cfg=unitree_g1_tracking_ppo_runner_cfg,
    runner_cls=MotionTrackingOnPolicyRunner,
)
