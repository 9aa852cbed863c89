"""Scene: MjSpec composition of a terrain (a plane or a generated height
field) and entities, and the runtime fan-out to the composed terrain,
entities and sensors.

PyTorch-package counterpart of mjlab_tpu/scene/scene.py. The host side
(``Scene.spec`` and ``compile``, with the spec edits of
mjlab_tpu/entity/entity.py ``Entity.__init__`` and the terrain's spec,
terrains/importer.py) needs MuJoCo; entities attach under a "{name}/"
prefix and the terrain under "terrain/". The runtime side
(``initialize``, ``reset``, ``update``, ``write_data_to_sim``,
``env_origins``) needs only the port's Model, so it runs on a machine
without MuJoCo from a saved model file: entities resolve their indices
from the Model's names, the sensors the entity XMLs declare come as
XmlSensor rows (``xml_sensors`` of a compiled MjModel, or the rows a model
file keeps), and a generated terrain's height field is written into the
Model by the terrain (``TerrainImporter.fill_hfield``). A generated
terrain's per-env state (levels, types, origins) is part of the scene's
state tensors, and ``env_origins`` is its origins tensor, updated in place
by the terrain curriculum.

``g1_velocity_flat_model()`` compiles the scene of the
Mjlab-Velocity-Flat-Unitree-G1 task (a ground plane and the G1 robot),
``yam_lift_cube_model()`` that of Mjlab-Lift-Cube-Yam (a ground plane, the
YAM arm and the cube).
"""

from __future__ import annotations

from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import TYPE_CHECKING

import numpy as np
import torch

from mjlab_tpu_torch.entity.entity import Entity, EntityCfg
from mjlab_tpu_torch.terrains.importer import TerrainImporter, TerrainImporterCfg, grid_origins
from mjlab_tpu_torch.utils.string import (
    resolve_matching_names, resolve_matching_names_values,
)

if TYPE_CHECKING:
    import mujoco

    from mjlab_tpu_torch.sim.sim import Simulation

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

@dataclass
class SceneCfg:
    """The number of envs, entities by name, the terrain (None for none),
    the sensors (configs with a ``build(scene)``) and the spacing of the
    env origins' grid without a terrain (a terrain has its own).
    ``model_file`` names a model file (phys/model.py save_model) that holds
    this scene compiled, with its XML sensors: the env then loads the
    Model from it and needs no MuJoCo (the file must be regenerated when
    the scene changes). ``extent`` is the JAX package's field, carried for
    the viewers."""

    num_envs: int = 1
    env_spacing: float = 2.0
    terrain: TerrainImporterCfg | None = None
    entities: dict[str, EntityCfg] = field(default_factory=dict)
    sensors: tuple = ()
    extent: float | None = None
    model_file: object | None = None


def build_entity_spec(cfg: EntityCfg) -> "mujoco.MjSpec":
    """The entity's spec with its editors applied: a fixed base wrapped in
    a mocap body, unnamed geoms and sites named, collision presets, one
    actuator per claimed joint, and an "init_state" keyframe from
    cfg.init_state (none when its joint_pos is None: a free object keeps
    the model's qpos0)."""
    import mujoco

    from mjlab_tpu_torch.utils.spec import auto_wrap_fixed_base_mocap

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
        _, names = resolve_matching_names(list(acfg.joint_names_expr), joint_names)
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
    _, matched, values = resolve_matching_names_values(ist.joint_pos, joint_names)
    by_name = {n: float(v) for n, v in zip(matched, values)}
    qpos = list(ist.pos) + list(ist.rot) if floating else []
    qpos += [by_name.get(n, 0.0) for n in joint_names]
    ctrl = []
    for a in spec.actuators:
        is_position = float(a.gainprm[0]) > 0 and float(a.biasprm[1]) < 0
        ctrl.append(by_name.get(a.target, 0.0) if is_position else 0.0)
    spec.add_key(name="init_state", qpos=qpos, ctrl=ctrl)
    return spec


@dataclass(frozen=True)
class XmlSensor:
    """A sensor an entity XML declares (an auto-wrapped builtin sensor of
    mjlab_tpu/scene/scene.py:111-121): its prefixed name, the port's type
    name (builtin_sensor.SPEC_SENSOR_TYPES), the kind and prefixed name of
    its object and of its reference frame ("" for none), and its cutoff."""

    name: str
    type: str
    objtype: str
    objname: str
    reftype: str = ""
    refname: str = ""
    cutoff: float = 0.0


_XML_SENSOR_KEYS = ("name", "type", "objtype", "objname", "reftype", "refname")


def xml_sensors(mj: "mujoco.MjModel") -> tuple[XmlSensor, ...]:
    """The sensors of a compiled MjModel whose type the builtin sensor
    surface names (others, e.g. contact sensors, are skipped as the JAX
    scene's auto-wrap skips them)."""
    import mujoco

    from mjlab_tpu_torch.sensor.builtin_sensor import SPEC_SENSOR_TYPES

    obj = mujoco.mjtObj
    kinds = {
        obj.mjOBJ_BODY: "body", obj.mjOBJ_XBODY: "xbody", obj.mjOBJ_GEOM: "geom",
        obj.mjOBJ_SITE: "site", obj.mjOBJ_JOINT: "joint",
        obj.mjOBJ_ACTUATOR: "actuator", obj.mjOBJ_TENDON: "tendon",
    }
    out = []
    for i in range(mj.nsensor):
        entry = SPEC_SENSOR_TYPES.get(mujoco.mjtSensor(int(mj.sensor_type[i])).name)
        if entry is None:
            continue
        stype, kind = entry
        ot, oid = int(mj.sensor_objtype[i]), int(mj.sensor_objid[i])
        rt, rid = int(mj.sensor_reftype[i]), int(mj.sensor_refid[i])
        objname = mujoco.mj_id2name(mj, ot, oid) or "" if oid >= 0 else ""
        refname = mujoco.mj_id2name(mj, rt, rid) or "" if rid >= 0 else ""
        out.append(XmlSensor(
            name=mujoco.mj_id2name(mj, obj.mjOBJ_SENSOR, i) or "",
            type=stype, objtype=kind or kinds.get(ot, "site"), objname=objname,
            reftype=kinds.get(rt, "site") if refname else "", refname=refname,
            cutoff=float(mj.sensor_cutoff[i]),
        ))
    return tuple(out)


def xml_sensor_arrays(sensors: tuple[XmlSensor, ...]) -> dict[str, np.ndarray]:
    """The rows as arrays a model file keeps (phys/model.py save_model
    extras, no pickling)."""
    out = {f"sensor_{k}": np.asarray([getattr(s, k) for s in sensors], dtype=np.str_)
           for k in _XML_SENSOR_KEYS}
    out["sensor_cutoff"] = np.asarray([s.cutoff for s in sensors], np.float64)
    return out


def xml_sensors_from_arrays(extra: dict[str, np.ndarray]) -> tuple[XmlSensor, ...]:
    """The rows xml_sensor_arrays wrote."""
    n = len(extra["sensor_cutoff"])
    return tuple(
        XmlSensor(**{k: str(extra[f"sensor_{k}"][i]) for k in _XML_SENSOR_KEYS},
                  cutoff=float(extra["sensor_cutoff"][i]))
        for i in range(n)
    )


class SimContext:
    """The runtime state the composed scene reads and writes: the
    Simulation's Model and Data (``data`` writes go through the
    Simulation, in place once it is static) and the per-env state tensors
    of the entities and sensors, by name. ``rne_post()`` is the
    rne_postconstraint the acceleration and force sensors read, shared by
    the reads inside one ``read_group()``."""

    def __init__(self, sim: "Simulation", rng=None):
        self.sim = sim
        self.rng = rng  # the env's Rng: the actuators' draws
        self.entity_states: dict[str, object] = {}
        self.sensor_states: dict[str, object] = {}
        self._group: dict | None = None

    @contextmanager
    def read_group(self):
        """Sensor reads that share one rne_postconstraint: the Data must
        not change inside the group (the env wraps its observations in
        one); the shared value is dropped when the group ends."""
        self._group = {}
        try:
            yield self
        finally:
            self._group = None

    def rne_post(self):
        """(cacc, cfrc_int, cfrc_ext) of the current Data (phys/rne_post.py):
        once per read group, else computed anew."""
        from mjlab_tpu_torch.phys.rne_post import rne_postconstraint

        if self._group is None:
            return rne_postconstraint(self.model, self.data)
        if "rne_post" not in self._group:
            self._group["rne_post"] = rne_postconstraint(self.model, self.data)
        return self._group["rne_post"]

    @property
    def model(self):
        return self.sim.model

    @property
    def data(self):
        return self.sim.data

    @data.setter
    def data(self, d) -> None:
        self.sim.data = d


class Scene:
    """Composes the root spec (``spec``, ``compile()``) and fans the
    runtime calls out to its entities and sensors."""

    def __init__(self, cfg: SceneCfg):
        self.cfg = cfg
        self.terrain = TerrainImporter(cfg.terrain) if cfg.terrain is not None else None
        self.entities: dict[str, Entity] = {
            name: Entity(ecfg, name) for name, ecfg in cfg.entities.items()
        }
        self.sensors: dict[str, object] = {}
        for scfg in cfg.sensors:
            sensor = scfg.build(self)
            self.sensors[sensor.name] = sensor
        self._spec = None
        self.ctx: SimContext | None = None

    def __getitem__(self, key: str):
        if key in self.entities:
            return self.entities[key]
        if key in self.sensors:
            return self.sensors[key]
        if key == "terrain" and self.terrain is not None:
            return self.terrain
        raise KeyError(
            f"'{key}' not in scene; entities={list(self.entities)}, "
            f"sensors={list(self.sensors)}"
        )

    @property
    def spec(self) -> "mujoco.MjSpec":
        """The merged spec (built with MuJoCo on first use)."""
        if self._spec is None:
            import mujoco

            spec = mujoco.MjSpec.from_string(_SCENE_VISUAL_XML)
            if self.terrain is not None:
                frame = spec.worldbody.add_frame()
                spec.attach(self.terrain.spec(), frame=frame, prefix="terrain/")
            for name, ecfg in self.cfg.entities.items():
                frame = spec.worldbody.add_frame()
                spec.attach(build_entity_spec(ecfg), frame=frame, prefix=f"{name}/")
            self._spec = spec
        return self._spec

    def compile(self) -> "mujoco.MjModel":
        return self.spec.compile()

    # -- runtime --

    def initialize(self, sim: "Simulation",
                   sensors: tuple[XmlSensor, ...] = (), rng=None) -> SimContext:
        """Resolve every entity and sensor against sim's Model and give
        them their per-env state; ``sensors`` are the XML-declared
        sensors, wrapped as builtin sensors under their prefixed names;
        ``rng`` (utils/random.py Rng) is what the actuator groups draw
        from (a Rng of seed 0 on sim's device when None)."""
        from mjlab_tpu_torch.sensor.builtin_sensor import BuiltinSensor
        from mjlab_tpu_torch.utils.random import Rng

        self.ctx = ctx = SimContext(sim, rng if rng is not None else Rng(0, sim.device))
        for entity in self.entities.values():
            entity.initialize(ctx)
        for row in sensors:
            if row.name not in self.sensors:
                self.sensors[row.name] = BuiltinSensor.from_xml_sensor(self, row)
        for sensor in self.sensors.values():
            sensor.initialize(ctx)
        if self.terrain is None:
            grid = grid_origins(sim.num_envs, self.cfg.env_spacing, sim.device)
        else:
            self.terrain.initialize(sim.num_envs, sim.device)
            grid = self.terrain.origins if self.terrain.generator is None else None
        self._env_origins = None if grid is None else grid.to(sim.dtype)
        return ctx

    @property
    def env_origins(self) -> torch.Tensor:
        """(num_envs, 3) world origin of each env: a generated terrain's
        per-env origins (float32, updated in place by the terrain
        curriculum), else a grid about the world origin of the plane
        terrain's env_spacing (mjlab_tpu/terrains/importer.py:69-78) or the
        scene's (mjlab_tpu/scene/scene.py env_origins), float32 values in
        the Simulation's dtype."""
        if self.terrain is not None and self.terrain.generator is not None:
            return self.terrain.env_origins
        return self._env_origins

    def reset(self, mask: torch.Tensor) -> None:
        """Reset the masked envs' entity and sensor state, in place."""
        for entity in self.entities.values():
            entity.data.clear_state(mask)
            entity.reset(mask)
        for sensor in self.sensors.values():
            sensor.reset(self.ctx, mask)

    def update(self, dt: float) -> None:
        """Per-physics-substep sensor state (contact air time)."""
        for sensor in self.sensors.values():
            sensor.update(self.ctx, dt)

    def write_data_to_sim(self) -> None:
        """Every entity's actuator controls into data.ctrl."""
        for entity in self.entities.values():
            entity.apply_actuator_controls()

    def state_tensors(self) -> list[torch.Tensor]:
        """Every per-env state tensor of the terrain, entities and sensors
        (the buffers a captured control step reads and writes besides the
        Data)."""
        out = [] if self.terrain is None else self.terrain.state_tensors()
        for entity in self.entities.values():
            out += entity.state_tensors()
        for sensor in self.sensors.values():
            out += sensor.state_tensors(self.ctx)
        return out


def model_file_scene_cfg(cfg: SceneCfg) -> SceneCfg:
    """The scene a model file is compiled from: cfg, with a generated
    terrain at its smallest (one flat sub-terrain, no border, seed 0). A
    build writes its own terrain's height field into the file's Model
    (TerrainImporter.fill_hfield); the pair table does not depend on it."""
    import copy

    from mjlab_tpu_torch.terrains.primitive_terrains import BoxFlatTerrainCfg

    cfg = copy.deepcopy(cfg)
    cfg.model_file = None
    if cfg.terrain is not None and cfg.terrain.terrain_type == "generator":
        gen = cfg.terrain.terrain_generator
        gen.num_rows = gen.num_cols = 1
        gen.border_width = 0.0
        gen.seed = 0
        gen.curriculum = False
        gen.sub_terrains = {"flat": BoxFlatTerrainCfg()}
    return cfg


def save_scene_model(path, cfg: SceneCfg, sim_cfg, extra=None) -> None:
    """Compile the scene (model_file_scene_cfg) with MuJoCo, apply the
    simulation options, convert it at float64 and write ``path`` (phys/
    model.py save_model) with its first keyframe, its XML sensors and the
    arrays ``extra(mj)`` returns (by name)."""
    from mjlab_tpu_torch.phys.model import put_model, save_model

    mj = Scene(model_file_scene_cfg(cfg)).compile()
    sim_cfg.mujoco.apply(mj)
    m = put_model(mj, dtype=torch.float64, nconmax=sim_cfg.nconmax, device="cpu")
    save_model(path, m, key_qpos=mj.key_qpos[0], key_ctrl=mj.key_ctrl[0],
               **xml_sensor_arrays(xml_sensors(mj)), **(extra(mj) if extra else {}))


def g1_velocity_flat_scene_cfg() -> SceneCfg:
    """The scene of Mjlab-Velocity-Flat-Unitree-G1 (its env config's): a
    ground plane, the G1 as "robot/", and the task's two contact
    sensors."""
    from mjlab_tpu_torch.tasks.velocity.config.g1.env_cfgs import unitree_g1_flat_env_cfg

    return unitree_g1_flat_env_cfg().scene


def g1_velocity_flat_model() -> "mujoco.MjModel":
    """The compiled scene of Mjlab-Velocity-Flat-Unitree-G1: a ground plane
    and the G1 as "robot/" (options as compiled; Simulation applies the
    task's MujocoCfg)."""
    return Scene(g1_velocity_flat_scene_cfg()).compile()


def yam_lift_cube_model() -> "mujoco.MjModel":
    """The compiled scene of Mjlab-Lift-Cube-Yam (its env config's): a
    ground plane, the YAM arm as "robot/" (fixed base, wrapped in a mocap
    body) and a free cube as "cube/" (options as compiled; Simulation
    applies the task's MujocoCfg)."""
    from mjlab_tpu_torch.tasks.manipulation.config.yam.env_cfgs import (
        yam_lift_cube_env_cfg,
    )

    return Scene(yam_lift_cube_env_cfg().scene).compile()
