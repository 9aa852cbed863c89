"""The cube-lifting task configuration.

PyTorch counterpart of mjlab_tpu/tasks/manipulation/lift_cube_env_cfg.py,
with the same terms, weights, ranges and simulation options: a plane, the
arm's contact sensor against it, and the elliptic cone. The robot config
fills in the entities, the grasp site, the fingertip geoms and the
sensor's pattern (config/yam/env_cfgs.py).
"""

from __future__ import annotations

from mjlab_tpu_torch.envs import mdp
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
from mjlab_tpu_torch.sensor.contact_sensor import ContactMatch, ContactSensorCfg
from mjlab_tpu_torch.sim.sim import MujocoCfg, SimulationCfg
from mjlab_tpu_torch.tasks.manipulation import mdp as manipulation_mdp
from mjlab_tpu_torch.tasks.manipulation.mdp import LiftingCommandCfg
from mjlab_tpu_torch.terrains.importer import TerrainImporterCfg
from mjlab_tpu_torch.utils.noise import UniformNoiseCfg as Unoise


def make_lift_cube_env_cfg() -> ManagerBasedRlEnvCfg:
    policy_terms = {
        "joint_pos": ObservationTermCfg(
            func=mdp.joint_pos_rel, noise=Unoise(n_min=-0.01, n_max=0.01)
        ),
        "joint_vel": ObservationTermCfg(
            func=mdp.joint_vel_rel, noise=Unoise(n_min=-1.5, n_max=1.5)
        ),
        "ee_to_cube": ObservationTermCfg(
            func=manipulation_mdp.ee_to_object_distance,
            params={
                "object_name": "cube",
                "asset_cfg": SceneEntityCfg("robot", site_names=()),
            },
            noise=Unoise(n_min=-0.01, n_max=0.01),
        ),
        "cube_to_goal": ObservationTermCfg(
            func=manipulation_mdp.object_position_error,
            params={"object_name": "cube", "command_name": "lift_height"},
            noise=Unoise(n_min=-0.01, n_max=0.01),
        ),
        "actions": ObservationTermCfg(func=mdp.last_action),
    }

    observations = {
        "policy": ObservationGroupCfg(
            terms=dict(policy_terms), concatenate_terms=True,
            enable_corruption=True,
        ),
        "critic": ObservationGroupCfg(
            terms=dict(policy_terms), concatenate_terms=True,
            enable_corruption=False,
        ),
    }

    actions = {
        "joint_pos": JointPositionActionCfg(
            asset_name="robot",
            actuator_names=(".*",),
            scale=0.5,  # overridden per robot
            use_default_offset=True,
        )
    }

    commands = {
        "lift_height": LiftingCommandCfg(
            asset_name="cube",
            resampling_time_range=(8.0, 12.0),
            difficulty="dynamic",
            object_pose_range=LiftingCommandCfg.ObjectPoseRangeCfg(
                x=(0.2, 0.4), y=(-0.2, 0.2), z=(0.02, 0.05), yaw=(-3.14, 3.14),
            ),
        )
    }

    events = {
        "reset_base": EventTermCfg(
            func=mdp.reset_root_state_uniform,
            mode="reset",
            params={"pose_range": {}, "velocity_range": {}},
        ),
        "reset_robot_joints": EventTermCfg(
            func=mdp.reset_joints_by_offset,
            mode="reset",
            params={
                "position_range": (0.0, 0.0),
                "velocity_range": (0.0, 0.0),
                "asset_cfg": SceneEntityCfg("robot", joint_names=(".*",)),
            },
        ),
        "fingertip_friction_slide": EventTermCfg(
            mode="startup",
            func=mdp.randomize_field,
            domain_randomization=True,
            params={
                "asset_cfg": SceneEntityCfg("robot", geom_names=()),
                "operation": "abs",
                "field": "geom_friction",
                "distribution": "uniform",
                "axes": (0,),
                "ranges": (0.3, 1.5),
            },
        ),
        "fingertip_friction_spin": EventTermCfg(
            mode="startup",
            func=mdp.randomize_field,
            domain_randomization=True,
            params={
                "asset_cfg": SceneEntityCfg("robot", geom_names=()),
                "operation": "abs",
                "field": "geom_friction",
                "distribution": "log_uniform",
                "axes": (1,),
                "ranges": (1e-4, 2e-2),
            },
        ),
        "fingertip_friction_roll": EventTermCfg(
            mode="startup",
            func=mdp.randomize_field,
            domain_randomization=True,
            params={
                "asset_cfg": SceneEntityCfg("robot", geom_names=()),
                "operation": "abs",
                "field": "geom_friction",
                "distribution": "log_uniform",
                "axes": (2,),
                "ranges": (1e-5, 5e-3),
            },
        ),
    }

    ee_ground_collision_cfg = ContactSensorCfg(
        name="ee_ground_collision",
        primary=ContactMatch(mode="subtree", pattern="", entity="robot"),
        secondary=ContactMatch(mode="body", pattern="terrain/terrain"),
        fields=("found",),
        reduce="none",
        num_slots=1,
    )

    rewards = {
        "lift": RewardTermCfg(
            func=manipulation_mdp.staged_position_reward,
            weight=1.0,
            params={
                "command_name": "lift_height",
                "object_name": "cube",
                "reaching_std": 0.2,
                "bringing_std": 0.3,
                "asset_cfg": SceneEntityCfg("robot", site_names=()),
            },
        ),
        "lift_precise": RewardTermCfg(
            func=manipulation_mdp.bring_object_reward,
            weight=1.0,
            params={
                "command_name": "lift_height",
                "object_name": "cube",
                "std": 0.05,
            },
        ),
        "action_rate_l2": RewardTermCfg(func=mdp.action_rate_l2, weight=-0.01),
        "joint_pos_limits": RewardTermCfg(
            func=mdp.joint_pos_limits,
            weight=-10.0,
            params={"asset_cfg": SceneEntityCfg("robot", joint_names=(".*",))},
        ),
        "joint_vel_hinge": RewardTermCfg(
            func=manipulation_mdp.joint_velocity_hinge_penalty,
            weight=-0.01,
            params={
                "max_vel": 0.5,
                "asset_cfg": SceneEntityCfg("robot", joint_names=(".*",)),
            },
        ),
    }

    terminations = {
        "time_out": TerminationTermCfg(func=mdp.time_out, time_out=True),
        "ee_ground_collision": TerminationTermCfg(
            func=manipulation_mdp.illegal_contact,
            params={"sensor_name": "ee_ground_collision"},
        ),
    }

    curriculum = {
        "joint_vel_hinge_weight": CurriculumTermCfg(
            func=manipulation_mdp.reward_weight,
            params={
                "reward_name": "joint_vel_hinge",
                "weight_stages": [
                    {"step": 0, "weight": -0.01},
                    {"step": 1000 * 24, "weight": -0.1},
                    {"step": 1500 * 24, "weight": -1.0},
                ],
            },
        ),
    }

    return ManagerBasedRlEnvCfg(
        scene=SceneCfg(
            terrain=TerrainImporterCfg(terrain_type="plane"),
            num_envs=1,
            env_spacing=1.0,
            sensors=(ee_ground_collision_cfg,),
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
            distance=1.5,
            elevation=-5.0,
            azimuth=120.0,
        ),
        sim=SimulationCfg(
            nconmax=55,
            njmax=600,
            mujoco=MujocoCfg(
                timestep=0.005,
                iterations=10,
                ls_iterations=20,
                impratio=10,
                cone="elliptic",
            ),
        ),
        decimation=4,
        episode_length_s=20.0,
    )
