"""Jump observations: the root's height and vertical velocity, and the
base library's foot terms.

PyTorch counterpart of mjlab_tpu/tasks/jump/mdp/observations.py.
"""

from __future__ import annotations

from mjlab_tpu_torch.envs.mdp.observations import (  # noqa: F401
    foot_air_time,
    foot_contact,
    foot_contact_forces,
    foot_height,
)
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def height_above_ground(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    """The root's height above the (flat) terrain."""
    return env.scene[asset_cfg.name].data.root_link_pos_w[:, 2:3]


def vertical_velocity(env, asset_cfg: SceneEntityCfg = _DEFAULT):
    """The root's vertical velocity in the world frame."""
    return env.scene[asset_cfg.name].data.root_link_lin_vel_w[:, 2:3]
