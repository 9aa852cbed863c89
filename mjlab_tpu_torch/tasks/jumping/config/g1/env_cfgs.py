"""Unitree G1 jumping configuration, with its play variant.

PyTorch counterpart of mjlab_tpu/tasks/jumping/config/g1/env_cfgs.py. The
scene is the G1 on a plane with the feet's contact sensor, from its
knees-bent start: it compiles to the flat velocity task's Model, so it
loads g1_velocity_flat.npz and builds without MuJoCo
(tests/test_torch_model.py shows the equality).
"""

from __future__ import annotations

from mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants import (
    G1_ACTION_SCALE,
    get_g1_robot_cfg,
)
from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.tasks.jumping.jumping_env_cfg import make_jumping_env_cfg
from mjlab_tpu_torch.tasks.velocity.config.g1.physics import SAVED_MODEL, contact_sensor_cfgs

_SITE_NAMES = ("left_foot", "right_foot")


def unitree_g1_jumping_env_cfg(play: bool = False) -> ManagerBasedRlEnvCfg:
    cfg = make_jumping_env_cfg()
    cfg.scene.entities = {"robot": get_g1_robot_cfg()}
    feet_ground, _ = contact_sensor_cfgs()
    cfg.scene.sensors = (feet_ground,)
    cfg.scene.model_file = SAVED_MODEL

    cfg.actions["joint_pos"].scale = G1_ACTION_SCALE

    cfg.observations["critic"].terms["foot_height"].params["asset_cfg"].site_names = _SITE_NAMES
    cfg.rewards["upright"].params["asset_cfg"].body_names = ("torso_link",)
    cfg.rewards["foot_slip"].params["asset_cfg"].site_names = _SITE_NAMES

    # the G1's standing height, from the knees-bent keyframe
    standing_height = 0.76
    cfg.rewards["jump_height"].params["standing_height"] = standing_height
    cfg.rewards["continuous_height"].params["standing_height"] = standing_height
    cfg.commands["jump"].standing_height = standing_height

    if play:
        cfg.episode_length_s = int(1e9)
        cfg.observations["policy"].enable_corruption = False

    return cfg
