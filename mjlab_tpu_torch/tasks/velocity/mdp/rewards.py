"""Velocity-task reward terms.

PyTorch counterpart of mjlab_tpu/tasks/velocity/mdp/rewards.py, every
term, the class terms feet_swing_height and variable_posture included.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.envs.mdp.rewards import std_by_joint
from mjlab_tpu_torch.managers.manager_base import ManagerTermBase
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def _command_activity(env, command_name, threshold):
    command = env.command_manager.get_command(command_name)
    total = torch.linalg.norm(command[:, :2], dim=1) + torch.abs(command[:, 2])
    return (total > threshold).to(torch.float32)


def track_linear_velocity(env, std: float, command_name: str,
                          asset_cfg: SceneEntityCfg = _DEFAULT):
    """exp(-(xy error^2 + z^2) / std^2); the commanded z velocity is 0."""
    asset = env.scene[asset_cfg.name]
    command = env.command_manager.get_command(command_name)
    actual = asset.data.root_link_lin_vel_b
    xy_err = torch.square(command[:, :2] - actual[:, :2]).sum(1)
    z_err = torch.square(actual[:, 2])
    return torch.exp(-(xy_err + z_err) / std**2)


def track_angular_velocity(env, std: float, command_name: str,
                           asset_cfg: SceneEntityCfg = _DEFAULT):
    asset = env.scene[asset_cfg.name]
    command = env.command_manager.get_command(command_name)
    actual = asset.data.root_link_ang_vel_b
    z_err = torch.square(command[:, 2] - actual[:, 2])
    xy_err = torch.square(actual[:, :2]).sum(1)
    return torch.exp(-(z_err + xy_err) / std**2)


def flat_orientation(env, std: float, asset_cfg: SceneEntityCfg = _DEFAULT):
    g = env.scene[asset_cfg.name].data.projected_gravity_b
    return torch.exp(-torch.square(g[:, :2]).sum(1) / std**2)


def self_collision_cost(env, sensor_name: str):
    return env.scene[sensor_name].data.found.to(torch.float32).sum(1)


def body_angular_velocity_penalty(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    ang = env.scene[asset_cfg.name].data.root_link_ang_vel_b
    return torch.square(ang[:, :2]).sum(1)


def _masked_mean(values, weights):
    return (values * weights).sum() / torch.clamp(weights.sum(), min=1.0)


def feet_air_time(env, sensor_name: str, threshold_min: float = 0.05,
                  threshold_max: float = 0.5, command_name: str | None = None,
                  command_threshold: float = 0.5):
    air = env.scene[sensor_name].data.current_air_time
    in_range = (air > threshold_min) & (air < threshold_max)
    reward = in_range.to(torch.float32).sum(1)
    env.extras["log"]["Metrics/air_time_mean"] = _masked_mean(
        air, (air > 0).to(torch.float32))
    if command_name is not None:
        reward = reward * _command_activity(env, command_name, command_threshold)
    return reward


def feet_clearance(env, target_height: float, command_name: str | None = None,
                   command_threshold: float = 0.01, asset_cfg: SceneEntityCfg = _DEFAULT):
    asset = env.scene[asset_cfg.name]
    foot_z = asset.data.site_pos_w[:, asset_cfg.site_ids, 2]
    foot_vel_xy = asset.data.site_lin_vel_w[:, asset_cfg.site_ids, :2]
    vel_norm = torch.linalg.norm(foot_vel_xy, dim=-1)
    cost = (torch.abs(foot_z - target_height) * vel_norm).sum(1)
    if command_name is not None:
        cost = cost * _command_activity(env, command_name, command_threshold)
    return cost


class feet_swing_height(ManagerTermBase):
    """The squared error of the swing apex height, at first contact."""

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        self._sensor = env.scene[cfg.params["sensor_name"]]
        asset_cfg = cfg.params.get("asset_cfg", _DEFAULT)
        self._asset = env.scene[asset_cfg.name]
        self._site_ids = asset_cfg.site_ids

    def __call__(self, env, sensor_name: str, target_height: float,
                 command_name: str | None = None, command_threshold: float = 0.01,
                 asset_cfg: SceneEntityCfg = _DEFAULT):
        first_contact = self._sensor.compute_first_contact(env.step_dt)
        foot_z = self._asset.data.site_pos_w[:, self._site_ids, 2]
        err = torch.square(foot_z - target_height) * first_contact.to(torch.float32)
        cost = err.sum(1)
        if command_name is not None:
            cost = cost * _command_activity(env, command_name, command_threshold)
        return cost


def feet_slip(env, sensor_name: str, command_name: str, command_threshold: float = 0.01,
              asset_cfg: SceneEntityCfg = _DEFAULT):
    asset = env.scene[asset_cfg.name]
    active = _command_activity(env, command_name, command_threshold)
    in_contact = env.scene[sensor_name].data.found.to(torch.float32)
    foot_vel_xy = asset.data.site_lin_vel_w[:, asset_cfg.site_ids, :2]
    v = torch.linalg.norm(foot_vel_xy, dim=-1)
    cost = (torch.square(v) * in_contact).sum(1) * active
    env.extras["log"]["Metrics/slip_velocity_mean"] = _masked_mean(v, in_contact)
    return cost


def soft_landing(env, sensor_name: str, command_name: str | None = None,
                 command_threshold: float = 0.05):
    sensor = env.scene[sensor_name]
    fmag = torch.linalg.norm(sensor.data.force, dim=-1)
    first = sensor.compute_first_contact(env.step_dt).to(torch.float32)
    impact = fmag * first
    cost = impact.sum(1)
    env.extras["log"]["Metrics/landing_force_mean"] = impact.sum() / torch.clamp(
        first.sum(), min=1.0)
    if command_name is not None:
        cost = cost * _command_activity(env, command_name, command_threshold)
    return cost


class variable_posture(ManagerTermBase):
    """Exp-kernel posture reward in three regimes of the command's
    magnitude (standing, walking, running), each with per-joint stds from
    regex dicts."""

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        asset_cfg = cfg.params.get("asset_cfg", _DEFAULT)
        self._asset = env.scene[asset_cfg.name]
        names = list(self._asset.joint_names)
        self._std_standing = std_by_joint(cfg.params.get("std_standing", {}), names, env.device)
        self._std_walking = std_by_joint(cfg.params.get("std_walking", {}), names, env.device)
        self._std_running = std_by_joint(cfg.params.get("std_running", {}), names, env.device)

    def __call__(self, env, std_standing=None, std_walking=None, std_running=None,
                 command_name: str = "twist", walking_threshold: float = 0.05,
                 running_threshold: float = 1.5, asset_cfg: SceneEntityCfg = _DEFAULT):
        data = self._asset.data
        err = data.joint_pos - data.default_joint_pos
        command = env.command_manager.get_command(command_name)
        mag = torch.linalg.norm(command[:, :2], dim=1) + torch.abs(command[:, 2])
        std = torch.where(
            (mag <= walking_threshold)[:, None], self._std_standing[None],
            torch.where((mag >= running_threshold)[:, None], self._std_running[None],
                        self._std_walking[None]))
        return torch.exp(-torch.square(err / std).mean(-1))


def angular_momentum_penalty(env, sensor_name: str | None = None,
                             asset_cfg: SceneEntityCfg = _DEFAULT):
    """The squared angular part of the entity's bodies' summed spatial
    momentum in the com frame (cinert x cvel)."""
    entity = env.scene[asset_cfg.name]
    d = env.sim.data
    ids = entity.indexing.body_ids
    h = torch.einsum("ebij,ebj->ebi", d.cinert[:, ids], d.cvel[:, ids])
    L = h[..., :3].sum(1)
    return torch.square(L).sum(-1)
