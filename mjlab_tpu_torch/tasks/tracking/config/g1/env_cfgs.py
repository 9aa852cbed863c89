"""Unitree G1 flat tracking configurations, with and without state
estimation, each with its play variant.

PyTorch counterpart of mjlab_tpu/tasks/tracking/config/g1/env_cfgs.py. The
scene is the G1 on a plane with the self-collision sensor; it compiles to
the same Model as the flat velocity task's scene (the feet's contact
sensor adds nothing to the Model), so it loads g1_velocity_flat.npz and
builds without MuJoCo (tests/test_torch_model.py shows the equality).
"""

from __future__ import annotations

from mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants import (
    G1_ACTION_SCALE,
    get_g1_robot_cfg,
)
from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnvCfg
from mjlab_tpu_torch.managers.manager_term_config import ObservationGroupCfg
from mjlab_tpu_torch.tasks.tracking.tracking_env_cfg import make_tracking_env_cfg
from mjlab_tpu_torch.tasks.velocity.config.g1.physics import SAVED_MODEL, contact_sensor_cfgs

G1_TRACKING_BODY_NAMES = (
    "pelvis",
    "left_hip_roll_link",
    "left_knee_link",
    "left_ankle_roll_link",
    "right_hip_roll_link",
    "right_knee_link",
    "right_ankle_roll_link",
    "torso_link",
    "left_shoulder_roll_link",
    "left_elbow_link",
    "left_wrist_yaw_link",
    "right_shoulder_roll_link",
    "right_elbow_link",
    "right_wrist_yaw_link",
)


def unitree_g1_flat_tracking_env_cfg(
    has_state_estimation: bool = True,
    play: bool = False,
    motion_file: str = "",
) -> ManagerBasedRlEnvCfg:
    cfg = make_tracking_env_cfg()
    cfg.scene.entities = {"robot": get_g1_robot_cfg()}
    _, self_collision = contact_sensor_cfgs()
    cfg.scene.sensors = (self_collision,)
    cfg.scene.model_file = SAVED_MODEL

    cfg.actions["joint_pos"].scale = G1_ACTION_SCALE

    motion = cfg.commands["motion"]
    motion.anchor_body_name = "torso_link"
    motion.body_names = G1_TRACKING_BODY_NAMES
    motion.motion_file = motion_file

    cfg.events["foot_friction"].params["asset_cfg"].geom_names = (
        r"^(left|right)_foot[1-7]_collision$",
    )
    cfg.events["base_com"].params["asset_cfg"].body_names = ("torso_link",)

    cfg.terminations["ee_body_pos"].params["body_names"] = (
        "left_ankle_roll_link",
        "right_ankle_roll_link",
        "left_wrist_yaw_link",
        "right_wrist_yaw_link",
    )

    if not has_state_estimation:
        new_policy_terms = {
            k: v
            for k, v in cfg.observations["policy"].terms.items()
            if k not in ("motion_anchor_pos_b", "base_lin_vel")
        }
        cfg.observations["policy"] = ObservationGroupCfg(
            terms=new_policy_terms,
            concatenate_terms=True,
            enable_corruption=True,
        )

    if play:
        cfg.episode_length_s = int(1e9)
        cfg.observations["policy"].enable_corruption = False
        cfg.events.pop("push_robot", None)
        cfg.commands["motion"].sampling_mode = "start"
        cfg.commands["motion"].pose_range = {}
        cfg.commands["motion"].velocity_range = {}
        cfg.commands["motion"].joint_position_range = (0.0, 0.0)

    return cfg
