"""Unitree G1 humanoid constants for the physics model.

PyTorch-package counterpart of
mjlab_tpu/asset_zoo/robots/unitree_g1/g1_constants.py: the actuator classes
with their armatures and PD gains, the knees-bent keyframe and the full
collision preset. The G1 XML and meshes are read in place from the JAX
package's asset folder (data files, not code).

Armatures come from the published rotor inertias of the G1's two-stage
planetary gearboxes; PD gains follow k = I w^2, d = 2 zeta I w with a
natural frequency of 10 Hz and zeta = 2.
"""

from __future__ import annotations

import os
from pathlib import Path
from typing import TYPE_CHECKING

from mjlab_tpu_torch.actuator.builtin import BuiltinPositionActuatorCfg
from mjlab_tpu_torch.entity.entity import EntityCfg, InitialStateCfg
from mjlab_tpu_torch.utils.spec_config import CollisionCfg

if TYPE_CHECKING:
    import mujoco

G1_XML: Path = (
    Path(__file__).resolve().parents[4]
    / "mjlab_tpu" / "asset_zoo" / "robots" / "unitree_g1" / "xmls" / "g1.xml"
)


def get_assets() -> dict[str, bytes]:
    d = G1_XML.parent / "assets"
    return {os.path.join("assets", f): (d / f).read_bytes() for f in os.listdir(d)}


def get_spec() -> "mujoco.MjSpec":
    import mujoco

    spec = mujoco.MjSpec.from_file(str(G1_XML))
    spec.assets = get_assets()
    return spec


def reflected_inertia_from_two_stage_planetary(
    rotor_inertia: tuple[float, float, float],
    gear_ratio: tuple[float, float, float],
) -> float:
    """Each stage's inertia scaled by the square of the downstream ratio."""
    assert gear_ratio[0] == 1
    return (
        rotor_inertia[0] * (gear_ratio[1] * gear_ratio[2]) ** 2
        + rotor_inertia[1] * gear_ratio[2] ** 2
        + rotor_inertia[2]
    )


ARMATURE_5020 = reflected_inertia_from_two_stage_planetary(
    (0.139e-4, 0.017e-4, 0.169e-4), (1, 1 + 46 / 18, 1 + 56 / 16)
)
ARMATURE_7520_14 = reflected_inertia_from_two_stage_planetary(
    (0.489e-4, 0.098e-4, 0.533e-4), (1, 4.5, 1 + 48 / 22)
)
ARMATURE_7520_22 = reflected_inertia_from_two_stage_planetary(
    (0.489e-4, 0.109e-4, 0.738e-4), (1, 4.5, 5)
)
ARMATURE_4010 = reflected_inertia_from_two_stage_planetary(
    (0.068e-4, 0.0, 0.0), (1, 5, 5)
)

EFFORT_5020, EFFORT_7520_14, EFFORT_7520_22, EFFORT_4010 = 25.0, 88.0, 139.0, 5.0

NATURAL_FREQ = 10 * 2.0 * 3.1415926535  # 10 Hz
DAMPING_RATIO = 2.0


def _pd(armature: float) -> tuple[float, float]:
    return (
        armature * NATURAL_FREQ**2,
        2.0 * DAMPING_RATIO * armature * NATURAL_FREQ,
    )


STIFFNESS_5020, DAMPING_5020 = _pd(ARMATURE_5020)
STIFFNESS_7520_14, DAMPING_7520_14 = _pd(ARMATURE_7520_14)
STIFFNESS_7520_22, DAMPING_7520_22 = _pd(ARMATURE_7520_22)
STIFFNESS_4010, DAMPING_4010 = _pd(ARMATURE_4010)

G1_ACTUATOR_5020 = BuiltinPositionActuatorCfg(
    joint_names_expr=(
        ".*_elbow_joint",
        ".*_shoulder_pitch_joint",
        ".*_shoulder_roll_joint",
        ".*_shoulder_yaw_joint",
        ".*_wrist_roll_joint",
    ),
    stiffness=STIFFNESS_5020,
    damping=DAMPING_5020,
    effort_limit=EFFORT_5020,
    armature=ARMATURE_5020,
)
G1_ACTUATOR_7520_14 = BuiltinPositionActuatorCfg(
    joint_names_expr=(".*_hip_pitch_joint", ".*_hip_yaw_joint", "waist_yaw_joint"),
    stiffness=STIFFNESS_7520_14,
    damping=DAMPING_7520_14,
    effort_limit=EFFORT_7520_14,
    armature=ARMATURE_7520_14,
)
G1_ACTUATOR_7520_22 = BuiltinPositionActuatorCfg(
    joint_names_expr=(".*_hip_roll_joint", ".*_knee_joint"),
    stiffness=STIFFNESS_7520_22,
    damping=DAMPING_7520_22,
    effort_limit=EFFORT_7520_22,
    armature=ARMATURE_7520_22,
)
G1_ACTUATOR_4010 = BuiltinPositionActuatorCfg(
    joint_names_expr=(".*_wrist_pitch_joint", ".*_wrist_yaw_joint"),
    stiffness=STIFFNESS_4010,
    damping=DAMPING_4010,
    effort_limit=EFFORT_4010,
    armature=ARMATURE_4010,
)
# Waist pitch/roll and ankles: 4-bar linkages driven by two 5020 motors;
# nominal 1:1 linkage -> double everything.
G1_ACTUATOR_WAIST = BuiltinPositionActuatorCfg(
    joint_names_expr=("waist_pitch_joint", "waist_roll_joint"),
    stiffness=STIFFNESS_5020 * 2,
    damping=DAMPING_5020 * 2,
    effort_limit=EFFORT_5020 * 2,
    armature=ARMATURE_5020 * 2,
)
G1_ACTUATOR_ANKLE = BuiltinPositionActuatorCfg(
    joint_names_expr=(".*_ankle_pitch_joint", ".*_ankle_roll_joint"),
    stiffness=STIFFNESS_5020 * 2,
    damping=DAMPING_5020 * 2,
    effort_limit=EFFORT_5020 * 2,
    armature=ARMATURE_5020 * 2,
)

G1_ACTUATORS = (
    G1_ACTUATOR_5020,
    G1_ACTUATOR_7520_14,
    G1_ACTUATOR_7520_22,
    G1_ACTUATOR_4010,
    G1_ACTUATOR_WAIST,
    G1_ACTUATOR_ANKLE,
)

KNEES_BENT_KEYFRAME = InitialStateCfg(
    pos=(0, 0, 0.76),
    joint_pos={
        ".*_hip_pitch_joint": -0.312,
        ".*_knee_joint": 0.669,
        ".*_ankle_pitch_joint": -0.363,
        ".*_elbow_joint": 0.6,
        "left_shoulder_roll_joint": 0.2,
        "left_shoulder_pitch_joint": 0.2,
        "right_shoulder_roll_joint": -0.2,
        "right_shoulder_pitch_joint": 0.2,
    },
)

FULL_COLLISION = CollisionCfg(
    geom_names_expr=(".*_collision",),
    condim={r"^(left|right)_foot[1-7]_collision$": 3, ".*_collision": 1},
    priority={r"^(left|right)_foot[1-7]_collision$": 1},
    friction={r"^(left|right)_foot[1-7]_collision$": (0.6,)},
)


def get_g1_robot_cfg() -> EntityCfg:
    """The G1 as the velocity task builds it: knees-bent keyframe, full
    collision, the six actuator classes, soft joint limits at 0.9 of the
    range."""
    return EntityCfg(
        spec_fn=get_spec,
        init_state=KNEES_BENT_KEYFRAME,
        collisions=(FULL_COLLISION,),
        actuators=G1_ACTUATORS,
        soft_joint_pos_limit_factor=0.9,
    )


# action scale rule: 0.25 * effort_limit / stiffness per motor class
G1_ACTION_SCALE: dict[str, float] = {}
for _a in G1_ACTUATORS:
    for _n in _a.joint_names_expr:
        G1_ACTION_SCALE[_n] = 0.25 * _a.effort_limit / _a.stiffness
