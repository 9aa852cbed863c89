"""Termination term library.

PyTorch counterpart of mjlab_tpu/envs/mdp/terminations.py.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

__all__ = ["time_out", "bad_orientation", "root_height_below_minimum", "nan_detection"]

_DEFAULT = SceneEntityCfg("robot")


def time_out(env):
    return env.episode_length_buf >= env.max_episode_length


def bad_orientation(env, limit_angle: float, asset_cfg: SceneEntityCfg = _DEFAULT):
    """The angle between -z and the projected gravity above limit_angle."""
    g = env.scene[asset_cfg.name].data.projected_gravity_b
    tilt = torch.arccos(torch.clamp(-g[:, 2], -1.0, 1.0))
    return tilt > limit_angle


def root_height_below_minimum(env, minimum_height: float,
                              asset_cfg: SceneEntityCfg = _DEFAULT):
    return env.scene[asset_cfg.name].data.root_link_pos_w[:, 2] < minimum_height


def nan_detection(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    """Per-env quarantine of non-finite states: such envs terminate and
    reset while training goes on."""
    d = env.sim.data
    bad = ~torch.isfinite(d.qpos).all(dim=-1)
    bad |= ~torch.isfinite(d.qvel).all(dim=-1)
    bad |= ~torch.isfinite(d.qacc).all(dim=-1)
    return bad
