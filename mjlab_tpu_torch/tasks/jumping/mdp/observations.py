"""Jumping observations: the pelvis's height and vertical velocity, the
feet's contact flags, and the base library's foot terms.

PyTorch counterpart of mjlab_tpu/tasks/jumping/mdp/observations.py.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.envs.mdp.observations import (  # noqa: F401
    foot_contact,
    foot_contact_forces,
    foot_height,
)
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def pelvis_height(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    return env.scene[asset_cfg.name].data.root_link_pos_w[:, 2:3]


def pelvis_vertical_velocity(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    return env.scene[asset_cfg.name].data.root_link_lin_vel_w[:, 2:3]


def pelvis_height_relative(env, standing_height: float = 0.76,
                           asset_cfg: SceneEntityCfg = _DEFAULT):
    return env.scene[asset_cfg.name].data.root_link_pos_w[:, 2:3] - standing_height


def feet_in_contact(env, sensor_name: str):
    return (env.scene[sensor_name].data.found > 0).to(torch.float32)


def both_feet_in_contact(env, sensor_name: str):
    return (env.scene[sensor_name].data.found > 0).all(1, keepdim=True).to(torch.float32)
