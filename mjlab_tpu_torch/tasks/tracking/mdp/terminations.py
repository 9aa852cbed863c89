"""Tracking-task terminations: the anchor too far from the motion's (in
height, or in all three axes), its orientation off, or a tracked body
too far from its reference.

PyTorch counterpart of mjlab_tpu/tasks/tracking/mdp/terminations.py.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.utils import math

__all__ = [
    "bad_anchor_pos",
    "bad_anchor_pos_z_only",
    "bad_anchor_ori",
    "bad_motion_body_pos",
    "bad_motion_body_pos_z_only",
]


def body_indexes(env, command, body_names) -> torch.Tensor:
    """The command's body rows named by body_names (all for None), as a
    device index made once per selection."""
    ids = [i for i, name in enumerate(command.cfg.body_names)
           if body_names is None or name in body_names]
    return env.const(ids, torch.long)


def bad_anchor_pos(env, command_name: str, threshold: float):
    c = env.command_manager.get_term(command_name)
    return torch.linalg.vector_norm(c.anchor_pos_w - c.robot_anchor_pos_w, dim=1) > threshold


def bad_anchor_pos_z_only(env, command_name: str, threshold: float):
    c = env.command_manager.get_term(command_name)
    return torch.abs(c.anchor_pos_w[:, -1] - c.robot_anchor_pos_w[:, -1]) > threshold


def bad_anchor_ori(env, asset_cfg: SceneEntityCfg, command_name: str, threshold: float):
    asset = env.scene[asset_cfg.name]
    c = env.command_manager.get_term(command_name)
    g = asset.data.gravity_vec_w
    motion_g = math.quat_apply_inverse(c.anchor_quat_w, g.to(c.anchor_quat_w.dtype))
    robot_g = math.quat_apply_inverse(c.robot_anchor_quat_w, g.to(c.robot_anchor_quat_w.dtype))
    return torch.abs(motion_g[:, 2] - robot_g[:, 2]) > threshold


def bad_motion_body_pos(env, command_name: str, threshold: float, body_names=None):
    c = env.command_manager.get_term(command_name)
    ids = body_indexes(env, c, body_names)
    err = torch.linalg.vector_norm(
        c.body_pos_relative_w[:, ids] - c.robot_body_pos_w[:, ids], dim=-1)
    return (err > threshold).any(-1)


def bad_motion_body_pos_z_only(env, command_name: str, threshold: float, body_names=None):
    c = env.command_manager.get_term(command_name)
    ids = body_indexes(env, c, body_names)
    err = torch.abs(c.body_pos_relative_w[:, ids, -1] - c.robot_body_pos_w[:, ids, -1])
    return (err > threshold).any(-1)
