"""Unitree G1 velocity env configurations, rough and flat, each with its
play variant.

PyTorch counterpart of mjlab_tpu/tasks/velocity/config/g1/env_cfgs.py.
The contact sensors are those of the task's physics (physics.py
contact_sensor_cfgs, their one definition in the port). The flat scene
loads its Model from g1_velocity_flat.npz (physics.SAVED_MODEL), so that
it builds without MuJoCo; the rough variant needs the terrain generator
and the height-field pairs, which are not ported, so building its env
raises.
"""

from __future__ import annotations

from mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants import (
    G1_ACTION_SCALE,
    get_g1_robot_cfg,
)
from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.envs.mdp import events as envs_mdp
from mjlab_tpu_torch.managers.manager_term_config import EventTermCfg, RewardTermCfg
from mjlab_tpu_torch.tasks.velocity import mdp
from mjlab_tpu_torch.tasks.velocity.config.g1.physics import (
    SAVED_MODEL,
    contact_sensor_cfgs,
)
from mjlab_tpu_torch.tasks.velocity.velocity_env_cfg import make_velocity_env_cfg

_SITE_NAMES = ("left_foot", "right_foot")
_FOOT_GEOMS = tuple(
    f"{side}_foot{i}_collision" for side in ("left", "right") for i in range(1, 8)
)


def unitree_g1_rough_env_cfg(play: bool = False) -> ManagerBasedRlEnvCfg:
    """G1 rough-terrain velocity config."""
    cfg = make_velocity_env_cfg()
    cfg.scene.entities = {"robot": get_g1_robot_cfg()}
    cfg.scene.sensors = contact_sensor_cfgs()

    cfg.actions["joint_pos"].scale = G1_ACTION_SCALE

    cfg.observations["critic"].terms["foot_height"].params["asset_cfg"].site_names = _SITE_NAMES
    cfg.events["foot_friction"].params["asset_cfg"].geom_names = _FOOT_GEOMS

    cfg.rewards["pose"].params["std_standing"] = {".*": 0.05}
    cfg.rewards["pose"].params["std_walking"] = {
        r".*hip_pitch.*": 0.3,
        r".*hip_roll.*": 0.15,
        r".*hip_yaw.*": 0.15,
        r".*knee.*": 0.35,
        r".*ankle_pitch.*": 0.25,
        r".*ankle_roll.*": 0.1,
        r".*waist_yaw.*": 0.2,
        r".*waist_roll.*": 0.08,
        r".*waist_pitch.*": 0.1,
        r".*shoulder_pitch.*": 0.15,
        r".*shoulder_roll.*": 0.15,
        r".*shoulder_yaw.*": 0.1,
        r".*elbow.*": 0.15,
        r".*wrist.*": 0.3,
    }
    cfg.rewards["pose"].params["std_running"] = {
        r".*hip_pitch.*": 0.5,
        r".*hip_roll.*": 0.2,
        r".*hip_yaw.*": 0.2,
        r".*knee.*": 0.6,
        r".*ankle_pitch.*": 0.35,
        r".*ankle_roll.*": 0.15,
        r".*waist_yaw.*": 0.3,
        r".*waist_roll.*": 0.08,
        r".*waist_pitch.*": 0.2,
        r".*shoulder_pitch.*": 0.5,
        r".*shoulder_roll.*": 0.2,
        r".*shoulder_yaw.*": 0.15,
        r".*elbow.*": 0.35,
        r".*wrist.*": 0.3,
    }

    cfg.rewards["upright"].params["asset_cfg"].body_names = ("torso_link",)
    cfg.rewards["body_ang_vel"].params["asset_cfg"].body_names = ("torso_link",)
    for reward_name in ("foot_clearance", "foot_swing_height", "foot_slip"):
        cfg.rewards[reward_name].params["asset_cfg"].site_names = _SITE_NAMES

    cfg.rewards["body_ang_vel"].weight = -0.05
    cfg.rewards["angular_momentum"].weight = -0.02
    cfg.rewards["air_time"].weight = 0.0
    cfg.rewards["self_collisions"] = RewardTermCfg(
        func=mdp.self_collision_cost,
        weight=-1.0,
        params={"sensor_name": "self_collision"},
    )

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


def unitree_g1_flat_env_cfg(play: bool = False) -> ManagerBasedRlEnvCfg:
    """Flat variant: plane terrain, no terrain curriculum, the Model from
    g1_velocity_flat.npz."""
    cfg = unitree_g1_rough_env_cfg(play=play)
    cfg.scene.terrain.terrain_type = "plane"
    cfg.scene.terrain.terrain_generator = None
    cfg.scene.model_file = SAVED_MODEL
    del cfg.curriculum["terrain_levels"]
    cfg.events.pop("randomize_terrain", None)
    return cfg
