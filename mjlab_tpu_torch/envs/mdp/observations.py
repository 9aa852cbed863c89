"""Observation term library.

PyTorch counterpart of mjlab_tpu/envs/mdp/observations.py. A term is
(env, **params) -> a (num_envs, ...) tensor.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

__all__ = [
    "base_lin_vel",
    "base_ang_vel",
    "projected_gravity",
    "joint_pos_rel",
    "joint_vel_rel",
    "last_action",
    "generated_commands",
    "builtin_sensor",
    "foot_height",
    "foot_air_time",
    "foot_contact",
    "foot_contact_forces",
]

_DEFAULT = SceneEntityCfg("robot")


def base_lin_vel(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    return env.scene[asset_cfg.name].data.root_link_lin_vel_b


def base_ang_vel(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    return env.scene[asset_cfg.name].data.root_link_ang_vel_b


def projected_gravity(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    return env.scene[asset_cfg.name].data.projected_gravity_b


def joint_pos_rel(env, asset_cfg: SceneEntityCfg = _DEFAULT, biased: bool = True):
    """Joint positions relative to the defaults; biased reads the encoder
    frame."""
    data = env.scene[asset_cfg.name].data
    jp = data.joint_pos_biased if biased else data.joint_pos
    ids = asset_cfg.joint_ids
    return jp[:, ids] - data.default_joint_pos[:, ids]


def joint_vel_rel(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    data = env.scene[asset_cfg.name].data
    ids = asset_cfg.joint_ids
    return data.joint_vel[:, ids] - data.default_joint_vel[:, ids]


def last_action(env, action_name: str | None = None):
    if action_name is None:
        return env.action_manager.action
    return env.action_manager.get_term(action_name).raw_actions


def generated_commands(env, command_name: str):
    return env.command_manager.get_command(command_name)


def builtin_sensor(env, sensor_name: str):
    return env.scene[sensor_name].data


def foot_height(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    """Foot site heights."""
    return env.scene[asset_cfg.name].data.site_pos_w[:, asset_cfg.site_ids, 2]


def foot_air_time(env, sensor_name: str):
    return env.scene[sensor_name].data.current_air_time


def foot_contact(env, sensor_name: str):
    return env.scene[sensor_name].data.found.to(torch.float32)


def foot_contact_forces(env, sensor_name: str):
    f = env.scene[sensor_name].data.force
    return f.reshape(f.shape[0], -1)
