"""Tracking evaluation metrics: mean per-keypoint position error (mpkpe),
root-relative mpkpe, joint velocity error, end-effector position and
orientation errors.

PyTorch counterpart of mjlab_tpu/tasks/tracking/mdp/metrics.py.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.utils import math

__all__ = [
    "mpkpe",
    "root_relative_mpkpe",
    "joint_velocity_error",
    "ee_position_error",
    "ee_orientation_error",
]


def _norm(x):
    return torch.linalg.vector_norm(x, dim=-1)


def mpkpe(env, command_name: str):
    """Mean per-keypoint position error in the world frame (m)."""
    c = env.command_manager.get_term(command_name)
    return _norm(c.body_pos_w - c.robot_body_pos_w).mean(-1)


def root_relative_mpkpe(env, command_name: str):
    """mpkpe with the keypoints expressed relative to the anchor frames."""
    c = env.command_manager.get_term(command_name)

    def rel(pos, anchor_pos, anchor_quat):
        return math.quat_apply_inverse(anchor_quat[:, None, :], pos - anchor_pos[:, None, :])

    ref = rel(c.body_pos_w, c.anchor_pos_w, c.anchor_quat_w)
    cur = rel(c.robot_body_pos_w, c.robot_anchor_pos_w, c.robot_anchor_quat_w)
    return _norm(ref - cur).mean(-1)


def joint_velocity_error(env, command_name: str):
    c = env.command_manager.get_term(command_name)
    return _norm(c.joint_vel - c.robot_joint_vel)


def _ids(env, c, body_names):
    return env.const([list(c.cfg.body_names).index(n) for n in body_names], torch.long)


def ee_position_error(env, command_name: str, body_names: tuple):
    c = env.command_manager.get_term(command_name)
    ids = _ids(env, c, body_names)
    return _norm(c.body_pos_w[:, ids] - c.robot_body_pos_w[:, ids]).mean(-1)


def ee_orientation_error(env, command_name: str, body_names: tuple):
    c = env.command_manager.get_term(command_name)
    ids = _ids(env, c, body_names)
    return math.quat_error_magnitude(c.body_quat_w[:, ids], c.robot_body_quat_w[:, ids]).mean(-1)
