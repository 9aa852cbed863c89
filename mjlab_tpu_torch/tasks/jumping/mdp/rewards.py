"""Jumping rewards: a sparse landing reward with dense shaping.

PyTorch counterpart of mjlab_tpu/tasks/jumping/mdp/rewards.py. The sparse
landing reward keeps each env's peak height and flight flag as tensors of
its own, updated in place in the JAX term's order (on a landing the peak
restarts at the current height) and cleared for the masked envs by
``reset``; its Metrics/ logs are device scalars over every env.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerTermBase
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.tasks.velocity.mdp.rewards import (  # noqa: F401
    flat_orientation,
    soft_landing,
)

_DEFAULT = SceneEntityCfg("robot")


def _both_down(sensor) -> torch.Tensor:
    return (sensor.data.found > 0).all(1)


class jump_height_reward(ManagerTermBase):
    """exp(-|peak - target| / std) when both feet land after a flight, the
    target the command's height above standing."""

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        self._asset = env.scene[cfg.params.get("asset_cfg", _DEFAULT).name]
        self._sensor = env.scene[cfg.params["sensor_name"]]
        E, dev = env.num_envs, env.device
        self.state = {"peak": torch.zeros((E,), dtype=env.sim.dtype, device=dev),
                      "was_in_flight": torch.zeros((E,), dtype=torch.bool, device=dev)}

    def state_tensors(self) -> list[torch.Tensor]:
        return list(self.state.values())

    def __call__(self, env, command_name: str, sensor_name: str, std: float = 0.1,
                 asset_cfg: SceneEntityCfg = _DEFAULT, standing_height: float = 0.76):
        st = self.state
        h = self._asset.data.root_link_pos_w[:, 2]
        st["peak"].copy_(torch.maximum(st["peak"], h))
        both = _both_down(self._sensor)
        st["was_in_flight"].logical_or_(~both)
        just_landed = st["was_in_flight"] & both

        command = env.command_manager.get_command(command_name)
        target_height = standing_height + command[:, 1]
        height_achieved = st["peak"] - standing_height
        reward = torch.exp(-torch.abs(st["peak"] - target_height) / std) * just_landed

        n = just_landed.sum()
        log = env.extras["log"]
        log["Metrics/jump_height_mean"] = (height_achieved * just_landed).sum() / torch.clamp(
            n, min=1)
        log["Metrics/num_landings"] = n.to(torch.float32)

        st["peak"].copy_(torch.where(just_landed, h, st["peak"]))
        st["was_in_flight"].masked_fill_(just_landed, False)
        return reward

    def reset(self, env_mask) -> dict:
        for t in self.state.values():
            t.masked_fill_(env_mask, 0)
        return {}


class continuous_jump_height(ManagerTermBase):
    """The root's height above standing while not both feet are down."""

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        self._asset = env.scene[cfg.params.get("asset_cfg", _DEFAULT).name]
        self._sensor = env.scene[cfg.params["sensor_name"]]

    def __call__(self, env, sensor_name: str, standing_height: float = 0.76,
                 asset_cfg: SceneEntityCfg = _DEFAULT):
        h = self._asset.data.root_link_pos_w[:, 2] - standing_height
        return torch.clamp(h, min=0.0) * ~_both_down(self._sensor)


def launch_velocity_reward(env, command_name: str, sensor_name: str,
                           asset_cfg: SceneEntityCfg = _DEFAULT):
    """Upward velocity while pushing off under an active trigger."""
    vz = env.scene[asset_cfg.name].data.root_link_lin_vel_w[:, 2]
    in_contact = (env.scene[sensor_name].data.found > 0).any(1)
    triggered = env.command_manager.get_command(command_name)[:, 0] > 0.5
    return torch.clamp(vz, min=0.0) * in_contact * triggered


def horizontal_drift_penalty(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    vel = env.scene[asset_cfg.name].data.root_link_lin_vel_w[:, :2]
    return torch.square(vel).sum(1)


def excessive_rotation_penalty(env, sensor_name: str, asset_cfg: SceneEntityCfg = _DEFAULT):
    ang = env.scene[asset_cfg.name].data.root_link_ang_vel_w[:, :2]
    return torch.square(ang).sum(1) * ~_both_down(env.scene[sensor_name])


def stable_landing_reward(env, sensor_name: str, std: float = 0.2,
                          asset_cfg: SceneEntityCfg = _DEFAULT):
    g = env.scene[asset_cfg.name].data.projected_gravity_b
    upright = torch.exp(-torch.square(g[:, :2]).sum(1) / (std * std))
    return upright * _both_down(env.scene[sensor_name])


def feet_slip_penalty(env, sensor_name: str, asset_cfg: SceneEntityCfg = _DEFAULT):
    in_contact = (env.scene[sensor_name].data.found > 0).to(torch.float32)
    vel = env.scene[asset_cfg.name].data.site_lin_vel_w[:, asset_cfg.site_ids, :2]
    return (torch.square(vel).sum(-1) * in_contact).sum(1)
