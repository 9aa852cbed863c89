"""Unitree G1 jump configuration, with its play variant.

PyTorch counterpart of mjlab_tpu/tasks/jump/config/g1/env_cfgs.py. The
robot starts crouched (JUMP_CROUCH_KEYFRAME: the defaults the reset
events and the action offsets read come from the entity's init_state).
The scene is the G1 on a plane with the feet's contact sensor: it
compiles to the Model of the flat velocity task's scene (the crouch is a
keyframe, which the env does not read; the timestep is an option the
Simulation applies), so it loads g1_velocity_flat.npz and builds without
MuJoCo (tests/test_torch_model.py shows the equality).
"""

from __future__ import annotations

from mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants import (
    G1_ACTION_SCALE,
    get_g1_robot_cfg,
)
from mjlab_tpu_torch.entity.entity import InitialStateCfg
from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.tasks.jump.jump_env_cfg import make_jump_env_cfg
from mjlab_tpu_torch.tasks.velocity.config.g1.physics import SAVED_MODEL, contact_sensor_cfgs

# the jump-ready crouch
JUMP_CROUCH_KEYFRAME = InitialStateCfg(
    pos=(0, 0, 0.55),
    joint_pos={
        ".*_hip_pitch_joint": -0.6,
        ".*_knee_joint": 1.2,
        ".*_ankle_pitch_joint": -0.6,
        ".*_hip_roll_joint": 0.0,
        ".*_hip_yaw_joint": 0.0,
        ".*_ankle_roll_joint": 0.0,
        "waist_yaw_joint": 0.0,
        "waist_roll_joint": 0.0,
        "waist_pitch_joint": 0.15,
        ".*_shoulder_pitch_joint": -0.5,
        "left_shoulder_roll_joint": 0.3,
        "right_shoulder_roll_joint": -0.3,
        ".*_shoulder_yaw_joint": 0.0,
        ".*_elbow_joint": 0.8,
        ".*_wrist_pitch_joint": 0.0,
        ".*_wrist_roll_joint": 0.0,
        ".*_wrist_yaw_joint": 0.0,
    },
    joint_vel={".*": 0.0},
)


def unitree_g1_jump_env_cfg(play: bool = False) -> ManagerBasedRlEnvCfg:
    cfg = make_jump_env_cfg()

    robot_cfg = get_g1_robot_cfg()
    robot_cfg.init_state = JUMP_CROUCH_KEYFRAME
    cfg.scene.entities = {"robot": robot_cfg}
    feet_ground, _ = contact_sensor_cfgs()
    cfg.scene.sensors = (feet_ground,)
    cfg.scene.model_file = SAVED_MODEL

    cfg.actions["joint_pos"].scale = G1_ACTION_SCALE

    cfg.observations["critic"].terms["foot_height"].params["asset_cfg"].site_names = (
        "left_foot", "right_foot")
    cfg.rewards["upright_in_flight"].params["asset_cfg"].body_names = ("torso_link",)

    if play:
        cfg.episode_length_s = int(1e9)
        cfg.observations["policy"].enable_corruption = False
        cfg.events.clear()

    return cfg
