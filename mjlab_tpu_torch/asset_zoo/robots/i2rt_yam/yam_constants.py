"""I2RT YAM arm constants for the physics model.

PyTorch-package counterpart of
mjlab_tpu/asset_zoo/robots/i2rt_yam/yam_constants.py: the three actuator
groups, the home keyframe and the gripper-only collision preset the
lift-cube task uses. The YAM XML and meshes
are read in place from the JAX package's asset folder (data files, not
code).

Actuator parameters come from the DM-4340 / DM-4310 motor data; the crank
gripper's rotary motor is reflected to the linear finger joint through the
effective transmission ratio. Only left_finger is actuated: right_finger
mirrors it through the joint equality of yam.xml. PD gains follow
k = I w^2, d = 2 zeta I w (10 Hz for the arm, 2 Hz for the gripper,
zeta = 2).
"""

from __future__ import annotations

import math
from pathlib import Path

import mujoco

from mjlab_tpu_torch.actuator.builtin import BuiltinPositionActuatorCfg
from mjlab_tpu_torch.entity.entity import EntityCfg, InitialStateCfg
from mjlab_tpu_torch.utils.actuator import (
    ElectricActuator, reflect_rotary_to_linear,
)
from mjlab_tpu_torch.utils.spec_config import CollisionCfg

YAM_XML: Path = (
    Path(__file__).resolve().parents[4]
    / "mjlab_tpu" / "asset_zoo" / "robots" / "i2rt_yam" / "xmls" / "yam.xml"
)


def get_spec() -> mujoco.MjSpec:
    return mujoco.MjSpec.from_file(str(YAM_XML))


ARMATURE_DM_4340 = 0.032
ARMATURE_DM_4310 = 0.0018

DM_4340 = ElectricActuator(
    reflected_inertia=ARMATURE_DM_4340, velocity_limit=10.0, effort_limit=28.0
)
DM_4310 = ElectricActuator(
    reflected_inertia=ARMATURE_DM_4310, velocity_limit=30.0, effort_limit=10.0
)

NATURAL_FREQ = 10 * 2.0 * math.pi  # 10 Hz
DAMPING_RATIO = 2.0

STIFFNESS_DM_4340 = ARMATURE_DM_4340 * NATURAL_FREQ**2
STIFFNESS_DM_4310 = ARMATURE_DM_4310 * NATURAL_FREQ**2
DAMPING_DM_4340 = 2.0 * DAMPING_RATIO * ARMATURE_DM_4340 * NATURAL_FREQ
DAMPING_DM_4310 = 2.0 * DAMPING_RATIO * ARMATURE_DM_4310 * NATURAL_FREQ

ACTUATOR_DM_4340 = BuiltinPositionActuatorCfg(
    joint_names_expr=("joint1", "joint2", "joint3"),
    stiffness=STIFFNESS_DM_4340,
    damping=DAMPING_DM_4340,
    effort_limit=DM_4340.effort_limit,
    armature=DM_4340.reflected_inertia,
)
ACTUATOR_DM_4310 = BuiltinPositionActuatorCfg(
    joint_names_expr=("joint4", "joint5", "joint6"),
    stiffness=STIFFNESS_DM_4310,
    damping=DAMPING_DM_4310,
    effort_limit=DM_4310.effort_limit,
    armature=DM_4310.reflected_inertia,
)

# crank gripper, reflected to the linear finger joint
GRIPPER_MOTOR_STROKE_CRANK = 2.7  # [rad]
GRIPPER_LINEAR_STROKE_CRANK = 0.071  # [m]
GRIPPER_TRANSMISSION_RATIO_CRANK = (
    GRIPPER_LINEAR_STROKE_CRANK / GRIPPER_MOTOR_STROKE_CRANK
)
(
    ARMATURE_DM_4310_LINEAR_CRANK,
    VELOCITY_LIMIT_DM_4310_LINEAR_CRANK,
    EFFORT_LIMIT_DM_4310_LINEAR_CRANK,
) = reflect_rotary_to_linear(
    armature_rotary=ARMATURE_DM_4310,
    velocity_limit_rotary=DM_4310.velocity_limit,
    effort_limit_rotary=DM_4310.effort_limit,
    transmission_ratio=GRIPPER_TRANSMISSION_RATIO_CRANK,
)
NATURAL_FREQ_GRIPPER = 2 * 2.0 * math.pi  # 2 Hz
STIFFNESS_DM_4310_LINEAR_CRANK = (
    ARMATURE_DM_4310_LINEAR_CRANK * NATURAL_FREQ_GRIPPER**2
)
DAMPING_DM_4310_LINEAR_CRANK = (
    2.0 * DAMPING_RATIO * ARMATURE_DM_4310_LINEAR_CRANK * NATURAL_FREQ_GRIPPER
)
# force cap for simulation stability (also applied on the hardware)
EFFORT_LIMIT_DM_4310_LINEAR_CRANK_SAFE = EFFORT_LIMIT_DM_4310_LINEAR_CRANK * 0.1

ACTUATOR_DM_4310_LINEAR_CRANK = BuiltinPositionActuatorCfg(
    joint_names_expr=("left_finger",),
    stiffness=STIFFNESS_DM_4310_LINEAR_CRANK,
    damping=DAMPING_DM_4310_LINEAR_CRANK,
    effort_limit=EFFORT_LIMIT_DM_4310_LINEAR_CRANK_SAFE,
    armature=ARMATURE_DM_4310_LINEAR_CRANK,
)

YAM_ACTUATORS = (
    ACTUATOR_DM_4340, ACTUATOR_DM_4310, ACTUATOR_DM_4310_LINEAR_CRANK,
)

HOME_KEYFRAME = InitialStateCfg(
    pos=(0.0, 0.0, 0.01),
    joint_pos={
        "joint2": 1.047,
        "joint3": 1.05,
        "left_finger": 0.0375 / 2,
        "right_finger": -0.0375 / 2,
    },
)

_FINGERTIPS = "[lr]f_down(6|7|8|9|10|11)_collision"

GRIPPER_ONLY_COLLISION = CollisionCfg(
    geom_names_expr=(".*_collision",),
    contype={"(link6|[lr]f)_.*_collision": 1, ".*_collision": 0},
    conaffinity={"(link6|[lr]f)_.*_collision": 1, ".*_collision": 0},
    condim={_FINGERTIPS: 6, ".*_collision": 3},
    friction={_FINGERTIPS: (1, 5e-3, 5e-4), ".*_collision": (0.6,)},
    solref={_FINGERTIPS: (0.01, 1)},
    priority={_FINGERTIPS: 1},
)


def get_yam_robot_cfg() -> EntityCfg:
    """The YAM as the lift-cube task builds it: home keyframe, collisions
    on the gripper only, the three actuator groups."""
    return EntityCfg(
        spec_fn=get_spec,
        init_state=HOME_KEYFRAME,
        collisions=(GRIPPER_ONLY_COLLISION,),
        actuators=YAM_ACTUATORS,
    )
