"""Tracking-task rewards: exponentials of the anchor's and the tracked
bodies' errors against the motion, and the self-collision cost.

PyTorch counterpart of mjlab_tpu/tasks/tracking/mdp/rewards.py.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.tasks.tracking.mdp.terminations import body_indexes
from mjlab_tpu_torch.utils import math

__all__ = [
    "motion_global_anchor_position_error_exp",
    "motion_global_anchor_orientation_error_exp",
    "motion_relative_body_position_error_exp",
    "motion_relative_body_orientation_error_exp",
    "motion_global_body_linear_velocity_error_exp",
    "motion_global_body_angular_velocity_error_exp",
    "self_collision_cost",
]


def motion_global_anchor_position_error_exp(env, command_name: str, std: float):
    c = env.command_manager.get_term(command_name)
    err = torch.square(c.anchor_pos_w - c.robot_anchor_pos_w).sum(-1)
    return torch.exp(-err / std**2)


def motion_global_anchor_orientation_error_exp(env, command_name: str, std: float):
    c = env.command_manager.get_term(command_name)
    err = math.quat_error_magnitude(c.anchor_quat_w, c.robot_anchor_quat_w) ** 2
    return torch.exp(-err / std**2)


def motion_relative_body_position_error_exp(env, command_name: str, std: float,
                                            body_names=None):
    c = env.command_manager.get_term(command_name)
    ids = body_indexes(env, c, body_names)
    err = torch.square(c.body_pos_relative_w[:, ids] - c.robot_body_pos_w[:, ids]).sum(-1)
    return torch.exp(-err.mean(-1) / std**2)


def motion_relative_body_orientation_error_exp(env, command_name: str, std: float,
                                               body_names=None):
    c = env.command_manager.get_term(command_name)
    ids = body_indexes(env, c, body_names)
    err = math.quat_error_magnitude(
        c.body_quat_relative_w[:, ids], c.robot_body_quat_w[:, ids]) ** 2
    return torch.exp(-err.mean(-1) / std**2)


def motion_global_body_linear_velocity_error_exp(env, command_name: str, std: float,
                                                 body_names=None):
    c = env.command_manager.get_term(command_name)
    ids = body_indexes(env, c, body_names)
    err = torch.square(c.body_lin_vel_w[:, ids] - c.robot_body_lin_vel_w[:, ids]).sum(-1)
    return torch.exp(-err.mean(-1) / std**2)


def motion_global_body_angular_velocity_error_exp(env, command_name: str, std: float,
                                                  body_names=None):
    c = env.command_manager.get_term(command_name)
    ids = body_indexes(env, c, body_names)
    err = torch.square(c.body_ang_vel_w[:, ids] - c.robot_body_ang_vel_w[:, ids]).sum(-1)
    return torch.exp(-err.mean(-1) / std**2)


def self_collision_cost(env, sensor_name: str):
    return env.scene[sensor_name].data.found.to(torch.float32).sum(-1)
