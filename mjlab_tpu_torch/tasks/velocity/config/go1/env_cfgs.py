"""Unitree Go1 velocity env configurations, rough and flat, each with its
play variant.

PyTorch counterpart of mjlab_tpu/tasks/velocity/config/go1/env_cfgs.py.
Each scene loads its Model from a model file (physics.py), so that it
builds without MuJoCo: the rough one from go1_velocity_rough.npz, into
which the env writes the height field of the terrain it generates, the
flat one from go1_velocity_flat.npz.
"""

from __future__ import annotations

from mjlab_tpu_torch.asset_zoo.robots.unitree_go1.go1_constants import (
    GO1_ACTION_SCALE,
    get_go1_robot_cfg,
)
from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.envs.mdp import events as envs_mdp
from mjlab_tpu_torch.managers.manager_term_config import EventTermCfg
from mjlab_tpu_torch.tasks.velocity.config.go1.physics import (
    FLAT_MODEL,
    ROUGH_MODEL,
    contact_sensor_cfgs,
)
from mjlab_tpu_torch.tasks.velocity.velocity_env_cfg import make_velocity_env_cfg

_FOOT_GEOMS = tuple(f"{leg}_foot_collision" for leg in ("FR", "FL", "RR", "RL"))
_FOOT_SITES = ("FR", "FL", "RR", "RL")


def unitree_go1_rough_env_cfg(play: bool = False) -> ManagerBasedRlEnvCfg:
    """Go1 rough-terrain velocity config."""
    cfg = make_velocity_env_cfg()
    cfg.scene.entities = {"robot": get_go1_robot_cfg()}
    cfg.scene.sensors = contact_sensor_cfgs()
    cfg.scene.model_file = ROUGH_MODEL

    cfg.actions["joint_pos"].scale = GO1_ACTION_SCALE

    cfg.observations["critic"].terms["foot_height"].params["asset_cfg"].site_names = _FOOT_SITES
    cfg.events["foot_friction"].params["asset_cfg"].geom_names = _FOOT_GEOMS

    cfg.rewards["pose"].params["std_standing"] = {".*": 0.05}
    cfg.rewards["pose"].params["std_walking"] = {
        ".*hip.*": 0.2, ".*thigh.*": 0.3, ".*calf.*": 0.35,
    }
    cfg.rewards["pose"].params["std_running"] = {
        ".*hip.*": 0.3, ".*thigh.*": 0.5, ".*calf.*": 0.6,
    }
    cfg.rewards["upright"].params["asset_cfg"].body_names = ("trunk",)
    cfg.rewards["body_ang_vel"].params["asset_cfg"].body_names = ("trunk",)
    for reward_name in ("foot_clearance", "foot_swing_height", "foot_slip"):
        cfg.rewards[reward_name].params["asset_cfg"].site_names = _FOOT_SITES
    cfg.rewards["angular_momentum"].weight = 0.0
    cfg.rewards["air_time"].weight = 0.25

    gen = cfg.scene.terrain.terrain_generator
    if play:
        cfg.episode_length_s = int(1e9)
        cfg.observations["policy"].enable_corruption = False
        cfg.events.pop("push_robot", None)
        # play: a random sub-terrain per reset
        cfg.events["randomize_terrain"] = EventTermCfg(
            func=envs_mdp.randomize_terrain, mode="reset")
        if gen is not None:
            gen.curriculum = False
            gen.num_rows = 5
            gen.num_cols = 5
            gen.border_width = 10.0
    elif gen is not None:
        gen.curriculum = True
    return cfg


def unitree_go1_flat_env_cfg(play: bool = False) -> ManagerBasedRlEnvCfg:
    """Flat variant: plane terrain, no terrain curriculum, the Model from
    go1_velocity_flat.npz."""
    cfg = unitree_go1_rough_env_cfg(play=play)
    cfg.scene.terrain.terrain_type = "plane"
    cfg.scene.terrain.terrain_generator = None
    cfg.scene.model_file = FLAT_MODEL
    del cfg.curriculum["terrain_levels"]
    cfg.events.pop("randomize_terrain", None)
    return cfg
