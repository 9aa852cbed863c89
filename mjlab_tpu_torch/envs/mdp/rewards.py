"""Reward term library.

PyTorch counterpart of mjlab_tpu/envs/mdp/rewards.py.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.managers.manager_base import ManagerTermBase
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.utils.string import resolve_matching_names_values

__all__ = [
    "is_alive",
    "is_terminated",
    "joint_torques_l2",
    "joint_vel_l2",
    "joint_acc_l2",
    "action_rate_l2",
    "action_acc_l2",
    "joint_pos_limits",
    "flat_orientation_l2",
    "posture",
    "electrical_power_cost",
]

_DEFAULT = SceneEntityCfg("robot")


def is_alive(env):
    return (~env.termination_manager.terminated).to(torch.float32)


def is_terminated(env):
    return env.termination_manager.terminated.to(torch.float32)


def joint_torques_l2(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    data = env.scene[asset_cfg.name].data
    return torch.square(data.actuator_force[:, asset_cfg.actuator_ids]).sum(-1)


def joint_vel_l2(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    data = env.scene[asset_cfg.name].data
    return torch.square(data.joint_vel[:, asset_cfg.joint_ids]).sum(-1)


def joint_acc_l2(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    data = env.scene[asset_cfg.name].data
    return torch.square(data.joint_acc[:, asset_cfg.joint_ids]).sum(-1)


def action_rate_l2(env):
    am = env.action_manager
    return torch.square(am.action - am.prev_action).sum(-1)


def action_acc_l2(env):
    am = env.action_manager
    return torch.square(am.action - 2 * am.prev_action + am.prev_prev_action).sum(-1)


def joint_pos_limits(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    """Joint positions beyond the soft limits."""
    data = env.scene[asset_cfg.name].data
    ids = asset_cfg.joint_ids
    jp = data.joint_pos[:, ids]
    lo = data.soft_joint_pos_limits[:, ids, 0]
    hi = data.soft_joint_pos_limits[:, ids, 1]
    out_lo = -torch.clamp(jp - lo, max=0.0)
    out_hi = torch.clamp(jp - hi, min=0.0)
    return (out_lo + out_hi).sum(-1)


def flat_orientation_l2(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    g = env.scene[asset_cfg.name].data.projected_gravity_b
    return torch.square(g[:, :2]).sum(-1)


def std_by_joint(std_map: dict, names: list[str], device) -> torch.Tensor:
    """Per-joint stds from a regex dict; joints it does not name get inf
    (no penalty)."""
    std = np.full(len(names), np.inf, np.float32)
    if std_map:
        ids, _, vals = resolve_matching_names_values(std_map, names)
        std[ids] = vals
    return torch.as_tensor(std, device=device)


class posture(ManagerTermBase):
    """Exp-kernel posture tracking with per-joint stds from regexes."""

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        asset_cfg = cfg.params.get("asset_cfg", _DEFAULT)
        self._asset = env.scene[asset_cfg.name]
        self._std = std_by_joint(cfg.params["std"], list(self._asset.joint_names),
                                 env.device)

    def __call__(self, env, std=None, asset_cfg: SceneEntityCfg = _DEFAULT):
        data = self._asset.data
        err = data.joint_pos - data.default_joint_pos
        return torch.exp(-torch.square(err / self._std).mean(-1))


class electrical_power_cost(ManagerTermBase):
    """The positive part of tau * qd, summed over the actuated joints."""

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        asset_cfg = cfg.params.get("asset_cfg", _DEFAULT)
        self._asset = env.scene[asset_cfg.name]

    def __call__(self, env, asset_cfg: SceneEntityCfg = _DEFAULT):
        data = self._asset.data
        force = data.actuator_force
        power = force * data.joint_vel[:, :force.shape[1]]
        return torch.clamp(power, min=0.0).sum(-1)
