"""Scene: MjSpec composition of a terrain plane and entities, compiled once.

PyTorch-package counterpart of the host side of mjlab_tpu/scene/scene.py
(``Scene.__init__`` and ``compile``), of the spec edits of
mjlab_tpu/entity/entity.py (``Entity.__init__``: a fixed base wrapped in a
mocap body, a free object without a keyframe) and of the plane branch of
mjlab_tpu/terrains/importer.py. Entities attach under a "{name}/" prefix and
the terrain under "terrain/". The runtime side (entity state, sensors,
managers) belongs to a later slice.

``g1_velocity_flat_model()`` compiles the scene of the
Mjlab-Velocity-Flat-Unitree-G1 task (a ground plane and the G1 robot),
``yam_lift_cube_model()`` that of Mjlab-Lift-Cube-Yam (a ground plane, the
YAM arm and the cube).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import Callable, Sequence

import mujoco

from mjlab_tpu_torch.utils.spec import auto_wrap_fixed_base_mocap

_SCENE_VISUAL_XML = """
<mujoco>
  <visual>
    <headlight diffuse="0.6 0.6 0.6" ambient="0.3 0.3 0.3" specular="0 0 0"/>
    <rgba haze="0.15 0.25 0.35 1"/>
    <global offwidth="1280" offheight="720"/>
    <quality shadowsize="8192"/>
  </visual>
</mujoco>
"""

# default friction of the terrain plane (TerrainImporterCfg.friction)
PLANE_FRICTION = (1.0, 0.005, 0.0001)


@dataclass
class InitialStateCfg:
    """Root pose (a floating base's free joint, or a fixed base's mocap
    frame) and joint positions by regex; joint_pos None adds no keyframe."""

    pos: tuple = (0.0, 0.0, 0.0)
    rot: tuple = (1.0, 0.0, 0.0, 0.0)
    joint_pos: dict[str, float] | None = field(
        default_factory=lambda: {".*": 0.0}
    )


@dataclass
class EntityCfg:
    """An entity's spec and the editors applied to it before attach."""

    spec_fn: Callable[[], mujoco.MjSpec]
    init_state: InitialStateCfg = field(default_factory=InitialStateCfg)
    collisions: tuple = ()
    actuators: tuple = ()


@dataclass
class SceneCfg:
    entities: dict[str, EntityCfg] = field(default_factory=dict)
    plane_terrain: bool = True
    plane_friction: tuple = PLANE_FRICTION


def _matching(keys: Sequence[str], names: Sequence[str]) -> list[str]:
    """Names (in ``names`` order) matched by any regex of keys; every key
    must match at least one name."""
    compiled = [re.compile(k) for k in keys]
    used = [False] * len(keys)
    out = []
    for n in names:
        for ki, c in enumerate(compiled):
            if c.fullmatch(n):
                out.append(n)
                used[ki] = True
                break
    if not all(used):
        unused = [k for k, u in zip(keys, used) if not u]
        raise ValueError(f"no names matched for expressions {unused}")
    return out


def _matching_values(data: dict[str, float], names: Sequence[str]) -> dict:
    """{name: value} for the names matched by exactly one regex of data."""
    out = {}
    for n in names:
        hits = [k for k in data if re.fullmatch(k, n)]
        if len(hits) > 1:
            raise ValueError(f"name {n!r} matched by {hits}")
        if hits:
            out[n] = float(data[hits[0]])
    return out


def build_entity_spec(cfg: EntityCfg) -> mujoco.MjSpec:
    """The entity's spec with its editors applied: a fixed base wrapped in
    a mocap body, unnamed geoms and sites named, collision presets, one
    actuator per claimed joint, and an "init_state" keyframe from
    cfg.init_state (none when its joint_pos is None: a free object keeps
    the model's qpos0)."""
    spec = auto_wrap_fixed_base_mocap(cfg.spec_fn)()
    joints = list(spec.joints)
    floating = bool(joints) and joints[0].type == mujoco.mjtJoint.mjJNT_FREE
    if floating:
        joints = joints[1:]
    for i, g in enumerate(spec.geoms):
        if not g.name:
            g.name = f"_geom{i}"
    for i, s in enumerate(spec.sites):
        if not s.name:
            s.name = f"_site{i}"
    for editor in cfg.collisions:
        editor.edit_spec(spec)

    joint_names = [j.name for j in joints]
    claimed: set[str] = set()
    for acfg in cfg.actuators:
        names = _matching(acfg.joint_names_expr, joint_names)
        overlap = claimed & set(names)
        if overlap:
            raise ValueError(f"joints claimed twice: {sorted(overlap)}")
        claimed |= set(names)
        acfg.edit_spec(spec, names)

    ist = cfg.init_state
    if ist.joint_pos is None:
        if spec.keys:
            spec.keys[0].name = "init_state"
        return spec
    by_name = _matching_values(ist.joint_pos, joint_names)
    qpos = list(ist.pos) + list(ist.rot) if floating else []
    qpos += [by_name.get(n, 0.0) for n in joint_names]
    ctrl = []
    for a in spec.actuators:
        is_position = float(a.gainprm[0]) > 0 and float(a.biasprm[1]) < 0
        ctrl.append(by_name.get(a.target, 0.0) if is_position else 0.0)
    spec.add_key(name="init_state", qpos=qpos, ctrl=ctrl)
    return spec


class Scene:
    """Composes the root spec; ``compile()`` returns the MjModel."""

    def __init__(self, cfg: SceneCfg):
        self.cfg = cfg
        self.spec = mujoco.MjSpec.from_string(_SCENE_VISUAL_XML)
        if cfg.plane_terrain:
            terrain = mujoco.MjSpec()
            body = terrain.worldbody.add_body(name="terrain")
            g = body.add_geom(name="terrain")
            g.type = mujoco.mjtGeom.mjGEOM_PLANE
            g.size = [0.0, 0.0, 1.0]
            g.friction[:] = cfg.plane_friction
            frame = self.spec.worldbody.add_frame()
            self.spec.attach(terrain, frame=frame, prefix="terrain/")
        for name, ecfg in cfg.entities.items():
            frame = self.spec.worldbody.add_frame()
            self.spec.attach(build_entity_spec(ecfg), frame=frame, prefix=f"{name}/")

    def compile(self) -> mujoco.MjModel:
        return self.spec.compile()


def g1_velocity_flat_model() -> mujoco.MjModel:
    """The compiled scene of Mjlab-Velocity-Flat-Unitree-G1: a ground plane
    and the G1 as "robot/" (options as compiled; Simulation applies the
    task's MujocoCfg)."""
    from mjlab_tpu_torch.asset_zoo.robots.unitree_g1.g1_constants import (
        get_g1_robot_cfg,
    )

    return Scene(SceneCfg(entities={"robot": get_g1_robot_cfg()})).compile()


def yam_lift_cube_model() -> mujoco.MjModel:
    """The compiled scene of Mjlab-Lift-Cube-Yam: a ground plane, the YAM
    arm as "robot/" (fixed base, wrapped in a mocap body) and a free cube
    as "cube/" (options as compiled; Simulation applies the task's
    MujocoCfg)."""
    from mjlab_tpu_torch.asset_zoo.robots.i2rt_yam.yam_constants import (
        get_yam_robot_cfg,
    )
    from mjlab_tpu_torch.tasks.manipulation.config.yam.physics import (
        cube_entity_cfg,
    )

    return Scene(SceneCfg(entities={
        "robot": get_yam_robot_cfg(), "cube": cube_entity_cfg(),
    })).compile()
