"""Tracking-task observations: the motion's anchor in the robot's anchor
frame, the tracked bodies in the robot's anchor frame.

PyTorch counterpart of mjlab_tpu/tasks/tracking/mdp/observations.py.
"""

from __future__ import annotations

from mjlab_tpu_torch.utils import math

__all__ = [
    "motion_anchor_pos_b",
    "motion_anchor_ori_b",
    "robot_body_pos_b",
    "robot_body_ori_b",
]


def _anchor_rel(env, command_name: str):
    c = env.command_manager.get_term(command_name)
    return math.subtract_frame_transforms(
        c.robot_anchor_pos_w, c.robot_anchor_quat_w, c.anchor_pos_w, c.anchor_quat_w)


def motion_anchor_pos_b(env, command_name: str):
    pos, _ = _anchor_rel(env, command_name)
    return pos.reshape(env.num_envs, -1)


def motion_anchor_ori_b(env, command_name: str):
    _, ori = _anchor_rel(env, command_name)
    mat = math.matrix_from_quat(ori)
    return mat[..., :2].reshape(mat.shape[0], -1)


def _bodies_in_anchor(env, command_name: str):
    c = env.command_manager.get_term(command_name)
    B = len(c.cfg.body_names)
    anchor_pos = c.robot_anchor_pos_w[:, None, :].expand(env.num_envs, B, 3)
    anchor_quat = c.robot_anchor_quat_w[:, None, :].expand(env.num_envs, B, 4)
    return math.subtract_frame_transforms(
        anchor_pos, anchor_quat, c.robot_body_pos_w, c.robot_body_quat_w)


def robot_body_pos_b(env, command_name: str):
    pos_b, _ = _bodies_in_anchor(env, command_name)
    return pos_b.reshape(env.num_envs, -1)


def robot_body_ori_b(env, command_name: str):
    _, ori_b = _bodies_in_anchor(env, command_name)
    mat = math.matrix_from_quat(ori_b)
    return mat[..., :2].reshape(mat.shape[0], -1)
