"""Phase-aware jump rewards.

PyTorch counterpart of mjlab_tpu/tasks/jump/mdp/rewards.py. The stateful
terms (the peak-height tracker, the landing-balance timer) keep their
per-env state as tensors of their own, updated in place in the JAX
term's order and cleared for the masked envs by ``reset``; the Metrics/
logs are device scalars written inside the step (the counts over all
envs are divisions on the device, no host read).
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerTermBase
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


class jump_height_reward(ManagerTermBase):
    """An exponential kernel of (peak height - initial height) against the
    target: the jump command's target where the env has one (the
    curriculum moves it), else the ``target_height`` param."""

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        self._asset = env.scene[cfg.params.get("asset_cfg", _DEFAULT).name]
        E, dev, dt = env.num_envs, env.device, env.sim.dtype
        self.state = {"peak": torch.zeros((E,), dtype=dt, device=dev),
                      "initial": torch.zeros((E,), dtype=dt, device=dev),
                      "initialized": torch.zeros((E,), dtype=torch.bool, device=dev)}

    def state_tensors(self) -> list[torch.Tensor]:
        return list(self.state.values())

    def __call__(self, env, target_height: float, std: float,
                 asset_cfg: SceneEntityCfg = _DEFAULT):
        st = self.state
        h = self._asset.data.root_link_pos_w[:, 2]
        st["initial"].copy_(torch.where(st["initialized"], st["initial"], h))
        st["initialized"].fill_(True)
        st["peak"].copy_(torch.maximum(st["peak"], h))
        jump_h = st["peak"] - st["initial"]
        cmd_term = env.command_manager.get_term("jump")
        tgt = (cmd_term.state["target_height"] if cmd_term is not None
               else env.const(target_height))
        reward = torch.exp(-torch.square(jump_h - tgt) / (std * std))
        env.extras["log"]["Metrics/peak_jump_height"] = st["peak"].mean()
        env.extras["log"]["Metrics/jump_height"] = jump_h.mean()
        return reward

    def reset(self, env_mask) -> dict:
        for t in self.state.values():
            t.masked_fill_(env_mask, 0)
        return {}


def explosive_takeoff(env, sensor_name: str, power_threshold: float = 500.0,
                      asset_cfg: SceneEntityCfg = _DEFAULT):
    """Joint power above the threshold while a foot is on the ground. As
    the JAX term, it multiplies the actuator forces (actuator order) by
    the joint velocities (joint order) entry by entry."""
    asset = env.scene[asset_cfg.name]
    in_contact = (env.scene[sensor_name].data.found > 0).any(1)
    power = torch.abs(asset.data.actuator_force * asset.data.joint_vel)
    total = power[:, asset_cfg.joint_ids].sum(1)
    return torch.clamp(total - power_threshold, min=0.0) * in_contact / 1000.0


def synchronized_extension(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    """The population variance of the joint velocities (jnp.var), a
    penalty proxy for asymmetric extension."""
    return torch.var(env.scene[asset_cfg.name].data.joint_vel, dim=1, correction=0)


def vertical_impulse(env, sensor_name: str):
    """The feet's upward ground-reaction force."""
    fz = torch.clamp(env.scene[sensor_name].data.force[:, :, 2], min=0.0)
    return fz.sum(1) / 500.0


def air_time_bonus(env, sensor_name: str, min_air_time: float = 0.2):
    """An exponential bonus once both feet are past the minimum air time;
    logs the mean air time over every airborne foot of every env."""
    air = env.scene[sensor_name].data.current_air_time
    min_air = air.amin(1)
    reward = torch.clamp(torch.exp((min_air - min_air_time) / min_air_time) - 1.0, min=0.0)
    in_air = air > 0
    n = torch.clamp(in_air.sum(), min=1)
    env.extras["log"]["Metrics/air_time_mean"] = (air * in_air).sum() / n
    return reward


class landing_balance(ManagerTermBase):
    """An exponential reward on how long the robot has stood stable
    (upright, slow, on the ground) since its last landing."""

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        self._asset = env.scene[cfg.params.get("asset_cfg", _DEFAULT).name]
        self._sensor = env.scene[cfg.params["sensor_name"]]
        E, dev = env.num_envs, env.device
        self.state = {"timer": torch.zeros((E,), dtype=torch.float32, device=dev),
                      "was_in_air": torch.zeros((E,), dtype=torch.bool, device=dev)}

    def state_tensors(self) -> list[torch.Tensor]:
        return list(self.state.values())

    def __call__(self, env, sensor_name: str, stability_time: float = 0.5,
                 asset_cfg: SceneEntityCfg = _DEFAULT):
        st = self.state
        in_contact = (self._sensor.data.found > 0).any(1)
        just_landed = st["was_in_air"] & in_contact
        st["was_in_air"].copy_(~in_contact)

        data = self._asset.data
        upright = torch.abs(data.projected_gravity_b[:, 2] + 1.0) < 0.2
        low_vel = ((torch.linalg.norm(data.root_link_lin_vel_w, dim=1) < 0.5)
                   & (torch.linalg.norm(data.root_link_ang_vel_w, dim=1) < 0.5))
        stable = upright & low_vel & in_contact

        timer = torch.where(just_landed, 0.0, st["timer"])
        timer = torch.where(stable, timer + env.step_dt, 0.0)
        st["timer"].copy_(timer)
        env.extras["log"]["Metrics/landing_success_rate"] = (
            (timer > stability_time).to(torch.float32).mean())
        return torch.exp(timer / stability_time) - 1.0

    def reset(self, env_mask) -> dict:
        for t in self.state.values():
            t.masked_fill_(env_mask, 0)
        return {}


def symmetric_landing(env, sensor_name: str, time_tolerance: float = 0.05):
    """Both feet's first contact in the same step."""
    first = env.scene[sensor_name].compute_first_contact(env.step_dt)
    if first.shape[1] < 2:
        return torch.zeros((env.num_envs,), dtype=torch.float32, device=env.device)
    return (first[:, 0] & first[:, 1]).to(torch.float32)
