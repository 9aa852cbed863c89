"""Unitree Go1 quadruped constants for the physics model.

PyTorch-package counterpart of
mjlab_tpu/asset_zoo/robots/unitree_go1/go1_constants.py: the hip and knee
actuator classes (rotor inertia from the published Go1 URDF, reflected
through the gearboxes; PD gains by the G1's natural-frequency rule), the
standing pose and the full collision preset. The Go1 XML and meshes are
read in place from the JAX package's asset folder (data files, not code);
the XML names a trunk.stl that the asset set lacks, so each missing mesh
gets a tiny placeholder (a visual geom; the collision geoms are all
primitives). MuJoCo is imported only where the spec is built.
"""

from __future__ import annotations

import os
import struct
from pathlib import Path
from typing import TYPE_CHECKING

import numpy as np

from mjlab_tpu_torch.actuator.builtin import BuiltinPositionActuatorCfg
from mjlab_tpu_torch.entity.entity import EntityCfg, InitialStateCfg
from mjlab_tpu_torch.utils.actuator import ElectricActuator, reflected_inertia
from mjlab_tpu_torch.utils.spec_config import CollisionCfg

if TYPE_CHECKING:
    import mujoco

GO1_XML: Path = (
    Path(__file__).resolve().parents[4]
    / "mjlab_tpu" / "asset_zoo" / "robots" / "unitree_go1" / "xmls" / "go1.xml"
)


def _placeholder_stl() -> bytes:
    """A minimal binary STL (a tetrahedron) for a missing visual mesh."""
    v = np.array([[0, 0, 0], [0.01, 0, 0], [0, 0.01, 0], [0, 0, 0.01]], np.float32)
    faces = [(0, 1, 2), (0, 1, 3), (0, 2, 3), (1, 2, 3)]
    out = b"\x00" * 80 + struct.pack("<I", len(faces))
    for f in faces:
        out += struct.pack("<3f", 0, 0, 0)
        for i in f:
            out += struct.pack("<3f", *v[i])
        out += b"\x00\x00"
    return out


def get_assets(spec: "mujoco.MjSpec") -> dict[str, bytes]:
    d = GO1_XML.parent / "assets"
    have = set(os.listdir(d))
    assets = {os.path.join("assets", f): (d / f).read_bytes() for f in have}
    for mesh in spec.meshes:
        base = os.path.basename(mesh.file)
        if base not in have:
            assets[os.path.join("assets", base)] = _placeholder_stl()
    return assets


def get_spec() -> "mujoco.MjSpec":
    import mujoco

    spec = mujoco.MjSpec.from_file(str(GO1_XML))
    spec.assets = get_assets(spec)
    return spec


# rotor inertia (Ixx) from the Go1 URDF; hip gear 6, knee gear 6 * 1.5
ROTOR_INERTIA = 0.000111842
HIP_GEAR_RATIO = 6
KNEE_GEAR_RATIO = HIP_GEAR_RATIO * 1.5

HIP_ACTUATOR = ElectricActuator(
    reflected_inertia=reflected_inertia(ROTOR_INERTIA, HIP_GEAR_RATIO),
    velocity_limit=30.1,
    effort_limit=23.7,
)
KNEE_ACTUATOR = ElectricActuator(
    reflected_inertia=reflected_inertia(ROTOR_INERTIA, KNEE_GEAR_RATIO),
    velocity_limit=20.06,
    effort_limit=35.55,
)

NATURAL_FREQ = 10 * 2.0 * 3.1415926535  # 10 Hz
DAMPING_RATIO = 2.0

STIFFNESS_HIP = HIP_ACTUATOR.reflected_inertia * NATURAL_FREQ**2
DAMPING_HIP = 2 * DAMPING_RATIO * HIP_ACTUATOR.reflected_inertia * NATURAL_FREQ
STIFFNESS_KNEE = KNEE_ACTUATOR.reflected_inertia * NATURAL_FREQ**2
DAMPING_KNEE = 2 * DAMPING_RATIO * KNEE_ACTUATOR.reflected_inertia * NATURAL_FREQ

GO1_HIP_ACTUATOR_CFG = BuiltinPositionActuatorCfg(
    joint_names_expr=(".*_hip_joint", ".*_thigh_joint"),
    stiffness=STIFFNESS_HIP,
    damping=DAMPING_HIP,
    effort_limit=HIP_ACTUATOR.effort_limit,
    armature=HIP_ACTUATOR.reflected_inertia,
)
GO1_KNEE_ACTUATOR_CFG = BuiltinPositionActuatorCfg(
    joint_names_expr=(".*_calf_joint",),
    stiffness=STIFFNESS_KNEE,
    damping=DAMPING_KNEE,
    effort_limit=KNEE_ACTUATOR.effort_limit,
    armature=KNEE_ACTUATOR.reflected_inertia,
)
GO1_ACTUATORS = (GO1_HIP_ACTUATOR_CFG, GO1_KNEE_ACTUATOR_CFG)

INIT_STATE = InitialStateCfg(
    pos=(0.0, 0.0, 0.278),
    joint_pos={
        ".*thigh_joint": 0.9,
        ".*calf_joint": -1.8,
        ".*R_hip_joint": 0.1,
        ".*L_hip_joint": -0.1,
    },
    joint_vel={".*": 0.0},
)

_foot_regex = "^[FR][LR]_foot_collision$"

FULL_COLLISION = CollisionCfg(
    geom_names_expr=(".*_collision",),
    condim={_foot_regex: 3, ".*_collision": 1},
    priority={_foot_regex: 1},
    friction={_foot_regex: (0.6,)},
    solimp={_foot_regex: (0.9, 0.95, 0.023)},
    contype=1,
    conaffinity=0,
)


def get_go1_robot_cfg() -> EntityCfg:
    """The Go1 as the velocity task builds it: the standing pose, full
    collision, the hip and knee actuator classes, soft joint limits at 0.9
    of the range."""
    return EntityCfg(
        spec_fn=get_spec,
        init_state=INIT_STATE,
        collisions=(FULL_COLLISION,),
        actuators=GO1_ACTUATORS,
        soft_joint_pos_limit_factor=0.9,
    )


# action scale rule: 0.25 * effort_limit / stiffness per motor class
GO1_ACTION_SCALE: dict[str, float] = {}
for _a in GO1_ACTUATORS:
    for _n in _a.joint_names_expr:
        GO1_ACTION_SCALE[_n] = 0.25 * _a.effort_limit / _a.stiffness
