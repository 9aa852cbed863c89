"""Manipulation observations.

PyTorch counterpart of mjlab_tpu/tasks/manipulation/mdp/observations.py.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.utils import math

_DEFAULT = SceneEntityCfg("robot")


def ee_to_object_distance(env, object_name: str,
                          asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
    """The vector from the end-effector site (the first of asset_cfg's
    sites) to the object's root, in the robot's base frame."""
    robot = env.scene[asset_cfg.name]
    obj = env.scene[object_name]
    ee_pos = robot.data.site_pos_w[:, asset_cfg.site_ids][:, 0]
    vec_w = obj.data.root_link_pos_w - ee_pos
    return math.quat_apply(math.quat_inv(robot.data.root_link_quat_w), vec_w)


def object_position_error(env, object_name: str, command_name: str) -> torch.Tensor:
    """The command's target minus the object's root position, world
    frame."""
    term = env.command_manager.get_term(command_name)
    return term.target_pos - env.scene[object_name].data.root_link_pos_w
