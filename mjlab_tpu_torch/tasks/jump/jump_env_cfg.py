"""The vertical-jump task configuration.

PyTorch counterpart of mjlab_tpu/tasks/jump/jump_env_cfg.py, with the same
terms, weights, ranges, curricula and simulation options: nconmax 35,
njmax 300 (accepted unused), dt 0.002 and decimation 2 (a control step of
0.004 s), 10 Newton and 20 line-search iterations, a 5 s episode. The
robot config fills in the robot, its crouched start, the feet's contact
sensor and the site and body names (config/g1/env_cfgs.py).
"""

from __future__ import annotations

import math

from mjlab_tpu_torch.envs.manager_based_rl_env import (
    ManagerBasedRlEnvCfg,
    ViewerConfig,
)
from mjlab_tpu_torch.envs.mdp.actions import JointPositionActionCfg
from mjlab_tpu_torch.managers.manager_term_config import (
    CurriculumTermCfg,
    EventTermCfg,
    ObservationGroupCfg,
    ObservationTermCfg,
    RewardTermCfg,
    TerminationTermCfg,
)
from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg
from mjlab_tpu_torch.scene.scene import SceneCfg
from mjlab_tpu_torch.sim.sim import MujocoCfg, SimulationCfg
from mjlab_tpu_torch.tasks.jump import mdp
from mjlab_tpu_torch.tasks.jump.mdp import JumpCommandCfg
from mjlab_tpu_torch.tasks.velocity import mdp as velocity_mdp
from mjlab_tpu_torch.terrains.importer import TerrainImporterCfg
from mjlab_tpu_torch.utils.noise import UniformNoiseCfg as Unoise


def make_jump_env_cfg() -> ManagerBasedRlEnvCfg:
    policy_terms = {
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
        "projected_gravity": ObservationTermCfg(
            func=mdp.projected_gravity, noise=Unoise(n_min=-0.05, n_max=0.05)
        ),
        "joint_pos": ObservationTermCfg(
            func=mdp.joint_pos_rel, noise=Unoise(n_min=-0.01, n_max=0.01)
        ),
        "joint_vel": ObservationTermCfg(
            func=mdp.joint_vel_rel, noise=Unoise(n_min=-1.5, n_max=1.5)
        ),
        "actions": ObservationTermCfg(func=mdp.last_action),
        "height_above_ground": ObservationTermCfg(func=mdp.height_above_ground),
        "vertical_velocity": ObservationTermCfg(func=mdp.vertical_velocity),
        "contact_state": ObservationTermCfg(
            func=mdp.foot_contact, params={"sensor_name": "feet_ground_contact"}
        ),
        "time_in_air": ObservationTermCfg(
            func=mdp.foot_air_time, params={"sensor_name": "feet_ground_contact"}
        ),
        "command": ObservationTermCfg(
            func=mdp.generated_commands, params={"command_name": "jump"}
        ),
    }

    critic_terms = {
        **policy_terms,
        "foot_height": ObservationTermCfg(
            func=mdp.foot_height,
            params={"asset_cfg": SceneEntityCfg("robot", site_names=())},
        ),
        "foot_contact_forces": ObservationTermCfg(
            func=mdp.foot_contact_forces,
            params={"sensor_name": "feet_ground_contact"},
        ),
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
            scale=0.5,  # overridden per-robot
            use_default_offset=True,
        )
    }

    commands = {
        "jump": JumpCommandCfg(target_height=0.25, height_tolerance=0.05)
    }

    events = {
        "reset_base": EventTermCfg(
            func=mdp.reset_root_state_uniform,
            mode="reset",
            params={
                "pose_range": {
                    "x": (-0.1, 0.1), "y": (-0.1, 0.1), "yaw": (-0.1, 0.1),
                },
                "velocity_range": {},
            },
        ),
        "reset_robot_joints": EventTermCfg(
            func=mdp.reset_joints_by_offset,
            mode="reset",
            params={
                "position_range": (-0.1, 0.1),
                "velocity_range": (0.0, 0.0),
                "asset_cfg": SceneEntityCfg("robot", joint_names=(".*",)),
            },
        ),
    }

    rewards = {
        "jump_height": RewardTermCfg(
            func=mdp.jump_height_reward,
            weight=10.0,
            params={"target_height": 0.25, "std": 0.15},
        ),
        "explosive_takeoff": RewardTermCfg(
            func=mdp.explosive_takeoff,
            weight=3.0,
            params={
                "sensor_name": "feet_ground_contact",
                "power_threshold": 500.0,
            },
        ),
        "synchronized_extension": RewardTermCfg(
            func=mdp.synchronized_extension, weight=-2.0
        ),
        "vertical_impulse": RewardTermCfg(
            func=mdp.vertical_impulse,
            weight=2.0,
            params={"sensor_name": "feet_ground_contact"},
        ),
        "air_time_bonus": RewardTermCfg(
            func=mdp.air_time_bonus,
            weight=1.5,
            params={"sensor_name": "feet_ground_contact", "min_air_time": 0.2},
        ),
        "upright_in_flight": RewardTermCfg(
            func=velocity_mdp.flat_orientation,
            weight=3.0,
            params={
                "std": math.sqrt(0.3),
                "asset_cfg": SceneEntityCfg("robot", body_names=()),
            },
        ),
        "angular_momentum_control": RewardTermCfg(
            func=velocity_mdp.angular_momentum_penalty,
            weight=-0.5,
            params={"sensor_name": "robot/root_angmom"},
        ),
        "soft_landing": RewardTermCfg(
            func=velocity_mdp.soft_landing,
            weight=-2.0,
            params={
                "sensor_name": "feet_ground_contact",
                "command_name": None,
            },
        ),
        "landing_stability": RewardTermCfg(
            func=mdp.landing_balance,
            weight=4.0,
            params={
                "sensor_name": "feet_ground_contact",
                "stability_time": 0.5,
            },
        ),
        "symmetric_landing": RewardTermCfg(
            func=mdp.symmetric_landing,
            weight=1.0,
            params={
                "sensor_name": "feet_ground_contact",
                "time_tolerance": 0.05,
            },
        ),
        "action_rate_l2": RewardTermCfg(func=mdp.action_rate_l2, weight=-0.05),
        "action_smoothness": RewardTermCfg(func=mdp.action_acc_l2, weight=-0.01),
        "joint_torques_l2": RewardTermCfg(
            func=mdp.joint_torques_l2,
            weight=-1e-5,
            params={"asset_cfg": SceneEntityCfg("robot", joint_names=(".*",))},
        ),
        "dof_pos_limits": RewardTermCfg(func=mdp.joint_pos_limits, weight=-5.0),
        "alive": RewardTermCfg(func=mdp.is_alive, weight=0.5),
    }

    terminations = {
        "time_out": TerminationTermCfg(func=mdp.time_out, time_out=True),
        "fell_over": TerminationTermCfg(
            func=mdp.bad_orientation, params={"limit_angle": math.radians(60.0)}
        ),
        "height_too_low": TerminationTermCfg(
            func=mdp.root_height_below_minimum,
            params={
                "minimum_height": 0.35,
                "asset_cfg": SceneEntityCfg("robot"),
            },
        ),
        "excessive_impact": TerminationTermCfg(
            func=mdp.excessive_landing_force,
            params={
                "sensor_name": "feet_ground_contact",
                "force_threshold": 2500.0,
            },
        ),
    }

    curriculum = {
        "jump_height_progression": CurriculumTermCfg(
            func=mdp.progressive_jump_height,
            params={
                "command_name": "jump",
                "height_stages": [
                    {"step": 0, "target_height": 0.10, "tolerance": 0.05},
                    {"step": 10000 * 24, "target_height": 0.15, "tolerance": 0.05},
                    {"step": 20000 * 24, "target_height": 0.20, "tolerance": 0.05},
                    {"step": 35000 * 24, "target_height": 0.25, "tolerance": 0.08},
                ],
            },
        ),
        "landing_stability_progression": CurriculumTermCfg(
            func=mdp.progressive_stability_requirement,
            params={
                "reward_name": "landing_stability",
                "weight_stages": [
                    {"step": 0, "weight": 1.0},
                    {"step": 15000 * 24, "weight": 2.5},
                    {"step": 30000 * 24, "weight": 4.0},
                ],
            },
        ),
    }

    return ManagerBasedRlEnvCfg(
        scene=SceneCfg(
            terrain=TerrainImporterCfg(terrain_type="plane"),
            num_envs=4096,
            extent=2.0,
        ),
        observations=observations,
        actions=actions,
        commands=commands,
        events=events,
        rewards=rewards,
        terminations=terminations,
        curriculum=curriculum,
        viewer=ViewerConfig(
            origin_type="asset_body",
            asset_name="robot",
            distance=2.0,
            elevation=-10.0,
            azimuth=90.0,
        ),
        sim=SimulationCfg(
            nconmax=35,
            njmax=300,
            mujoco=MujocoCfg(timestep=0.002, iterations=10, ls_iterations=20),
        ),
        decimation=2,
        episode_length_s=5.0,
    )
