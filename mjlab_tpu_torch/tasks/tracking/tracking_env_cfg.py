"""The base motion-tracking (BeyondMimic-style) task configuration.

PyTorch counterpart of mjlab_tpu/tasks/tracking/tracking_env_cfg.py, with
the same terms, weights, ranges and simulation options (nconmax 35, njmax
250, dt 0.005, decimation 4, 10 Newton and 20 line-search iterations).
The robot configs fill in the motion file, the anchor and tracked bodies,
the self-collision sensor and the event targets (config/g1/env_cfgs.py).
"""

from __future__ import annotations

from mjlab_tpu_torch.envs.manager_based_rl_env import (
    ManagerBasedRlEnvCfg,
    ViewerConfig,
)
from mjlab_tpu_torch.envs.mdp.actions import JointPositionActionCfg
from mjlab_tpu_torch.managers.manager_term_config import (
    EventTermCfg,
    ObservationGroupCfg,
    ObservationTermCfg,
    RewardTermCfg,
    TerminationTermCfg,
)
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.scene.scene import SceneCfg
from mjlab_tpu_torch.sim.sim import MujocoCfg, SimulationCfg
from mjlab_tpu_torch.tasks.tracking import mdp
from mjlab_tpu_torch.tasks.tracking.mdp import MotionCommandCfg
from mjlab_tpu_torch.terrains.importer import TerrainImporterCfg
from mjlab_tpu_torch.utils.noise import UniformNoiseCfg as Unoise

VELOCITY_RANGE = {
    "x": (-0.5, 0.5),
    "y": (-0.5, 0.5),
    "z": (-0.2, 0.2),
    "roll": (-0.52, 0.52),
    "pitch": (-0.52, 0.52),
    "yaw": (-0.78, 0.78),
}


def make_tracking_env_cfg() -> ManagerBasedRlEnvCfg:
    policy_terms = {
        "command": ObservationTermCfg(
            func=mdp.generated_commands, params={"command_name": "motion"}
        ),
        "motion_anchor_pos_b": ObservationTermCfg(
            func=mdp.motion_anchor_pos_b,
            params={"command_name": "motion"},
            noise=Unoise(n_min=-0.25, n_max=0.25),
        ),
        "motion_anchor_ori_b": ObservationTermCfg(
            func=mdp.motion_anchor_ori_b,
            params={"command_name": "motion"},
            noise=Unoise(n_min=-0.05, n_max=0.05),
        ),
        "base_lin_vel": ObservationTermCfg(
            func=mdp.builtin_sensor,
            params={"sensor_name": "robot/imu_lin_vel"},
            noise=Unoise(n_min=-0.5, n_max=0.5),
        ),
        "base_ang_vel": ObservationTermCfg(
            func=mdp.builtin_sensor,
            params={"sensor_name": "robot/imu_ang_vel"},
            noise=Unoise(n_min=-0.2, n_max=0.2),
        ),
        "joint_pos": ObservationTermCfg(
            func=mdp.joint_pos_rel,
            noise=Unoise(n_min=-0.01, n_max=0.01),
            params={"biased": True},
        ),
        "joint_vel": ObservationTermCfg(
            func=mdp.joint_vel_rel, noise=Unoise(n_min=-0.5, n_max=0.5)
        ),
        "actions": ObservationTermCfg(func=mdp.last_action),
    }

    critic_terms = {
        "command": ObservationTermCfg(
            func=mdp.generated_commands, params={"command_name": "motion"}
        ),
        "motion_anchor_pos_b": ObservationTermCfg(
            func=mdp.motion_anchor_pos_b, params={"command_name": "motion"}
        ),
        "motion_anchor_ori_b": ObservationTermCfg(
            func=mdp.motion_anchor_ori_b, params={"command_name": "motion"}
        ),
        "body_pos": ObservationTermCfg(
            func=mdp.robot_body_pos_b, params={"command_name": "motion"}
        ),
        "body_ori": ObservationTermCfg(
            func=mdp.robot_body_ori_b, params={"command_name": "motion"}
        ),
        "base_lin_vel": ObservationTermCfg(
            func=mdp.builtin_sensor, params={"sensor_name": "robot/imu_lin_vel"}
        ),
        "base_ang_vel": ObservationTermCfg(
            func=mdp.builtin_sensor, params={"sensor_name": "robot/imu_ang_vel"}
        ),
        "joint_pos": ObservationTermCfg(func=mdp.joint_pos_rel),
        "joint_vel": ObservationTermCfg(func=mdp.joint_vel_rel),
        "actions": ObservationTermCfg(func=mdp.last_action),
    }

    observations = {
        "policy": ObservationGroupCfg(
            terms=policy_terms, concatenate_terms=True, enable_corruption=True
        ),
        "critic": ObservationGroupCfg(
            terms=critic_terms, concatenate_terms=True, enable_corruption=False
        ),
    }

    actions = {
        "joint_pos": JointPositionActionCfg(
            asset_name="robot",
            actuator_names=(".*",),
            scale=0.5,
            use_default_offset=True,
        )
    }

    commands = {
        "motion": MotionCommandCfg(
            asset_name="robot",
            resampling_time_range=(1.0e9, 1.0e9),
            debug_vis=True,
            pose_range={
                "x": (-0.05, 0.05),
                "y": (-0.05, 0.05),
                "z": (-0.01, 0.01),
                "roll": (-0.1, 0.1),
                "pitch": (-0.1, 0.1),
                "yaw": (-0.2, 0.2),
            },
            velocity_range=VELOCITY_RANGE,
            joint_position_range=(-0.1, 0.1),
            motion_file="",  # set per robot
            anchor_body_name="",
            body_names=(),
        )
    }

    events = {
        "push_robot": EventTermCfg(
            func=mdp.push_by_setting_velocity,
            mode="interval",
            interval_range_s=(1.0, 3.0),
            params={"velocity_range": VELOCITY_RANGE},
        ),
        "base_com": EventTermCfg(
            mode="startup",
            func=mdp.randomize_field,
            domain_randomization=True,
            params={
                "asset_cfg": SceneEntityCfg("robot", body_names=()),
                "operation": "add",
                "field": "body_ipos",
                "ranges": {0: (-0.025, 0.025), 1: (-0.05, 0.05), 2: (-0.05, 0.05)},
            },
        ),
        "encoder_bias": EventTermCfg(
            mode="startup",
            func=mdp.randomize_encoder_bias,
            params={
                "asset_cfg": SceneEntityCfg("robot"),
                "bias_range": (-0.01, 0.01),
            },
        ),
        "foot_friction": EventTermCfg(
            mode="startup",
            func=mdp.randomize_field,
            domain_randomization=True,
            params={
                "asset_cfg": SceneEntityCfg("robot", geom_names=()),
                "operation": "abs",
                "field": "geom_friction",
                "ranges": (0.3, 1.2),
                "axes": (0,),
            },
        ),
    }

    rewards = {
        "motion_global_root_pos": RewardTermCfg(
            func=mdp.motion_global_anchor_position_error_exp,
            weight=0.5,
            params={"command_name": "motion", "std": 0.3},
        ),
        "motion_global_root_ori": RewardTermCfg(
            func=mdp.motion_global_anchor_orientation_error_exp,
            weight=0.5,
            params={"command_name": "motion", "std": 0.4},
        ),
        "motion_body_pos": RewardTermCfg(
            func=mdp.motion_relative_body_position_error_exp,
            weight=1.0,
            params={"command_name": "motion", "std": 0.3},
        ),
        "motion_body_ori": RewardTermCfg(
            func=mdp.motion_relative_body_orientation_error_exp,
            weight=1.0,
            params={"command_name": "motion", "std": 0.4},
        ),
        "motion_body_lin_vel": RewardTermCfg(
            func=mdp.motion_global_body_linear_velocity_error_exp,
            weight=1.0,
            params={"command_name": "motion", "std": 1.0},
        ),
        "motion_body_ang_vel": RewardTermCfg(
            func=mdp.motion_global_body_angular_velocity_error_exp,
            weight=1.0,
            params={"command_name": "motion", "std": 3.14},
        ),
        "action_rate_l2": RewardTermCfg(func=mdp.action_rate_l2, weight=-1e-1),
        "joint_limit": RewardTermCfg(
            func=mdp.joint_pos_limits,
            weight=-10.0,
            params={"asset_cfg": SceneEntityCfg("robot", joint_names=(".*",))},
        ),
        "self_collisions": RewardTermCfg(
            func=mdp.self_collision_cost,
            weight=-10.0,
            params={"sensor_name": "self_collision"},
        ),
    }

    terminations = {
        "time_out": TerminationTermCfg(func=mdp.time_out, time_out=True),
        "anchor_pos": TerminationTermCfg(
            func=mdp.bad_anchor_pos_z_only,
            params={"command_name": "motion", "threshold": 0.25},
        ),
        "anchor_ori": TerminationTermCfg(
            func=mdp.bad_anchor_ori,
            params={
                "asset_cfg": SceneEntityCfg("robot"),
                "command_name": "motion",
                "threshold": 0.8,
            },
        ),
        "ee_body_pos": TerminationTermCfg(
            func=mdp.bad_motion_body_pos_z_only,
            params={"command_name": "motion", "threshold": 0.25, "body_names": ()},
        ),
    }

    return ManagerBasedRlEnvCfg(
        scene=SceneCfg(
            terrain=TerrainImporterCfg(terrain_type="plane"), num_envs=1
        ),
        observations=observations,
        actions=actions,
        commands=commands,
        events=events,
        rewards=rewards,
        terminations=terminations,
        viewer=ViewerConfig(
            origin_type="asset_body",
            asset_name="robot",
            distance=3.0,
            elevation=-5.0,
            azimuth=90.0,
        ),
        sim=SimulationCfg(
            nconmax=35,
            njmax=250,
            mujoco=MujocoCfg(timestep=0.005, iterations=10, ls_iterations=20),
        ),
        decimation=4,
        episode_length_s=10.0,
    )
