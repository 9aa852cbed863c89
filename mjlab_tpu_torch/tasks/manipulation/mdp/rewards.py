"""Manipulation rewards.

PyTorch counterpart of mjlab_tpu/tasks/manipulation/mdp/rewards.py.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def staged_position_reward(env, command_name: str, object_name: str, reaching_std: float,
                           bringing_std: float,
                           asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
    """reaching * (1 + bringing): a Gaussian of the end effector's squared
    distance to the object, times one plus a Gaussian of the object's
    squared distance to the target."""
    robot = env.scene[asset_cfg.name]
    obj_pos = env.scene[object_name].data.root_link_pos_w
    target = env.command_manager.get_term(command_name).target_pos
    ee_pos = robot.data.site_pos_w[:, asset_cfg.site_ids][:, 0]
    reaching = torch.exp(-torch.sum(torch.square(ee_pos - obj_pos), -1) / reaching_std**2)
    bringing = torch.exp(-torch.sum(torch.square(target - obj_pos), -1) / bringing_std**2)
    return reaching * (1.0 + bringing)


def bring_object_reward(env, command_name: str, object_name: str, std: float) -> torch.Tensor:
    """A Gaussian of the object's squared distance to the target."""
    obj_pos = env.scene[object_name].data.root_link_pos_w
    target = env.command_manager.get_term(command_name).target_pos
    return torch.exp(-torch.sum(torch.square(target - obj_pos), -1) / std**2)


def joint_velocity_hinge_penalty(env, max_vel: float,
                                 asset_cfg: SceneEntityCfg = _DEFAULT) -> torch.Tensor:
    """The summed square of each joint speed's excess over max_vel."""
    jv = env.scene[asset_cfg.name].data.joint_vel[:, asset_cfg.joint_ids]
    excess = torch.clamp(torch.abs(jv) - max_vel, min=0.0)
    return torch.sum(excess**2, -1)
