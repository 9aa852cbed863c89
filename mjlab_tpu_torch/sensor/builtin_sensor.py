"""Builtin sensors computed from the batched physics state.

PyTorch counterpart of mjlab_tpu/sensor/builtin_sensor.py: every builtin
type of the JAX package but the three tendon types, computed from the
env-first Data the step and the refresh leave (the JAX package's
``_compute``, type by type):

- site: accelerometer, velocimeter, gyro, force, torque, magnetometer,
  rangefinder (phys/ray.py along the site's z axis, the site's body
  excluded);
- joint (hinge or slide; jointactuatorfrc any joint): jointpos,
  jointvel, jointlimitpos, jointlimitvel, jointlimitfrc (MuJoCo's one
  limit row of the nearer side, at ``neq_jnt + nv + index`` of
  efc_force), jointactuatorfrc;
- actuator: actuatorpos, actuatorvel, actuatorfrc;
- frame (a body, xbody, geom or site, with an optional reference frame):
  framepos, framequat, framexaxis, frameyaxis, framezaxis, framelinvel,
  frameangvel, framelinacc, frameangacc (the last two ignore the
  reference, as MuJoCo does), and upvector (framezaxis's other name);
- body: subtreecom, subtreelinvel, subtreeangmom;
- global: e_potential (gravity and the hinge, slide and free-translation
  springs), e_kinetic (the armature term included, per env where the Model
  carries dof_armature so), clock (each env's time).

The tendon types (tendonpos, tendonvel, tendonactuatorfrc) raise
NotImplementedError: the port's Simulation refuses tendons until the
general engine is ported (ROADMAP.md queue 1 item 4).

What the env-last step writes decides what some types read inside an env:
the step writes actuator_force and actuator_velocity but not
actuator_length or qfrc_actuator, which only a full forward() writes, as
in the JAX package; actuatorpos and jointactuatorfrc then read the value
the last forward() or reset left (ROADMAP.md queue 3).

The accelerometer, force, torque and frame-acceleration types read
rne_postconstraint (phys/rne_post.py) through ``SimContext.rne_post``:
computed once per read group (the env's observations,
``SimContext.read_group``), else once per read. The JAX package caches it
by id() of the Data, which says nothing under a captured step whose
tensors keep their identity across replays.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Literal

import numpy as np
import torch

from mjlab_tpu_torch.phys import ray as phys_ray
from mjlab_tpu_torch.phys.math import conj_quat, cross, mul_quat
from mjlab_tpu_torch.phys.model import host_array
from mjlab_tpu_torch.phys.rne_post import (
    object_acceleration, object_velocity, transform_force,
)
from mjlab_tpu_torch.sensor.sensor import Sensor, SensorCfg

if TYPE_CHECKING:
    from mjlab_tpu_torch.scene.scene import SimContext, XmlSensor

_SITE_SENSORS = {
    "accelerometer", "velocimeter", "gyro", "force", "torque",
    "magnetometer", "rangefinder",
}
_FRAME_SENSORS = {
    "framepos", "framequat", "framexaxis", "frameyaxis", "framezaxis",
    "framelinvel", "frameangvel", "framelinacc", "frameangacc", "upvector",
}
_BODY_SENSORS = {"subtreecom", "subtreelinvel", "subtreeangmom"}
_OBJ_REQUIREMENTS = {
    "jointpos": "joint", "jointvel": "joint", "jointlimitpos": "joint",
    "jointlimitvel": "joint", "jointlimitfrc": "joint",
    "jointactuatorfrc": "joint",
    "actuatorpos": "actuator", "actuatorvel": "actuator",
    "actuatorfrc": "actuator",
    "tendonpos": "tendon", "tendonvel": "tendon",
    "tendonactuatorfrc": "tendon",
}
_SPATIAL_FRAME_TYPES = {"body", "xbody", "geom", "site"}
_SENSORS_ALLOWING_REF = _FRAME_SENSORS - {"upvector"}
_GLOBAL_SENSORS = {"e_potential", "e_kinetic", "clock"}

_TENDON_TYPES = frozenset({"tendonpos", "tendonvel", "tendonactuatorfrc"})

# the types this package computes: the JAX package's surface but the
# tendon types
PORTED_TYPES = frozenset(
    _SITE_SENSORS | _FRAME_SENSORS | _BODY_SENSORS | _GLOBAL_SENSORS | set(_OBJ_REQUIREMENTS)
) - _TENDON_TYPES

_JNT_FREE, _JNT_SLIDE, _JNT_HINGE = 0, 2, 3

# mjtSensor member name -> (sensor type, object kind) of the XML-declared
# sensors the scene wraps (the JAX package's _SPEC_SENSOR_TYPES)
SPEC_SENSOR_TYPES = {
    "mjSENS_ACCELEROMETER": ("accelerometer", "site"),
    "mjSENS_VELOCIMETER": ("velocimeter", "site"),
    "mjSENS_GYRO": ("gyro", "site"),
    "mjSENS_FORCE": ("force", "site"),
    "mjSENS_TORQUE": ("torque", "site"),
    "mjSENS_MAGNETOMETER": ("magnetometer", "site"),
    "mjSENS_RANGEFINDER": ("rangefinder", "site"),
    "mjSENS_JOINTPOS": ("jointpos", "joint"),
    "mjSENS_JOINTVEL": ("jointvel", "joint"),
    "mjSENS_JOINTLIMITPOS": ("jointlimitpos", "joint"),
    "mjSENS_JOINTLIMITVEL": ("jointlimitvel", "joint"),
    "mjSENS_JOINTLIMITFRC": ("jointlimitfrc", "joint"),
    "mjSENS_JOINTACTFRC": ("jointactuatorfrc", "joint"),
    "mjSENS_ACTUATORPOS": ("actuatorpos", "actuator"),
    "mjSENS_ACTUATORVEL": ("actuatorvel", "actuator"),
    "mjSENS_ACTUATORFRC": ("actuatorfrc", "actuator"),
    "mjSENS_TENDONPOS": ("tendonpos", "tendon"),
    "mjSENS_TENDONVEL": ("tendonvel", "tendon"),
    "mjSENS_TENDONACTFRC": ("tendonactuatorfrc", "tendon"),
    "mjSENS_FRAMEPOS": ("framepos", None),
    "mjSENS_FRAMEQUAT": ("framequat", None),
    "mjSENS_FRAMEXAXIS": ("framexaxis", None),
    "mjSENS_FRAMEYAXIS": ("frameyaxis", None),
    "mjSENS_FRAMEZAXIS": ("framezaxis", None),
    "mjSENS_FRAMELINVEL": ("framelinvel", None),
    "mjSENS_FRAMEANGVEL": ("frameangvel", None),
    "mjSENS_FRAMELINACC": ("framelinacc", None),
    "mjSENS_FRAMEANGACC": ("frameangacc", None),
    "mjSENS_SUBTREECOM": ("subtreecom", "body"),
    "mjSENS_SUBTREELINVEL": ("subtreelinvel", "body"),
    "mjSENS_SUBTREEANGMOM": ("subtreeangmom", "body"),
    "mjSENS_E_POTENTIAL": ("e_potential", None),
    "mjSENS_E_KINETIC": ("e_kinetic", None),
    "mjSENS_CLOCK": ("clock", None),
}


@dataclass
class ObjRef:
    """A MuJoCo object by kind and name, prefixed with its entity's name
    when entity is given."""

    type: Literal["body", "xbody", "joint", "geom", "site", "actuator",
                  "tendon", "camera"]
    name: str
    entity: str | None = None

    def prefixed_name(self) -> str:
        return f"{self.entity}/{self.name}" if self.entity else self.name


@dataclass(kw_only=True)
class BuiltinSensorCfg(SensorCfg):
    sensor_type: str = "gyro"
    obj: ObjRef | None = None
    ref: ObjRef | None = None
    cutoff: float = 0.0
    name: str = ""

    def __post_init__(self):
        t = self.sensor_type
        if t in _GLOBAL_SENSORS:
            return
        if self.obj is None:
            raise ValueError(f"sensor type '{t}' requires obj")
        if t in _SITE_SENSORS and self.obj.type != "site":
            raise ValueError(f"sensor type '{t}' requires obj.type='site'")
        if t in _BODY_SENSORS and self.obj.type != "body":
            raise ValueError(f"sensor type '{t}' requires obj.type='body'")
        if t in _FRAME_SENSORS and self.obj.type not in _SPATIAL_FRAME_TYPES:
            raise ValueError(
                f"sensor type '{t}' requires obj.type in "
                f"{sorted(_SPATIAL_FRAME_TYPES)}, got '{self.obj.type}'"
            )
        req = _OBJ_REQUIREMENTS.get(t)
        if req is not None and self.obj.type != req:
            raise ValueError(
                f"sensor type '{t}' requires obj.type='{req}', got '{self.obj.type}'"
            )
        if self.ref is not None and t not in _SENSORS_ALLOWING_REF:
            raise ValueError(f"sensor type '{t}' does not support ref")

    def build(self, scene):
        sensor = BuiltinSensor(self, scene)
        sensor.name = self.name
        return sensor


def _object_id(m, kind: str, name: str) -> int:
    names = {"body": m.body_names, "xbody": m.body_names, "geom": m.geom_names,
             "site": m.site_names}[kind]
    if name not in names:
        raise ValueError(f"{kind} '{name}' not found")
    return names.index(name)


class _Frame:
    """A resolved object frame: its ids and accessors into the batched
    Data."""

    def __init__(self, m, obj: ObjRef):
        kind = obj.type
        if kind not in _SPATIAL_FRAME_TYPES:
            raise ValueError(f"unsupported frame object type '{kind}'")
        oid = _object_id(m, kind, obj.prefixed_name())
        if kind in ("body", "xbody"):
            body = oid
            lquat = m.body_iquat[oid] if kind == "body" else None
        elif kind == "geom":
            body = int(m.geom_bodyid[oid])
            lquat = m.geom_quat[oid]
        else:
            body = int(m.site_bodyid[oid])
            lquat = m.site_quat[oid]
        self.kind = kind
        self.oid = oid
        self.body_id = body
        self.root_id = int(m.body_rootid[body])
        # the local orientation against the body frame (the framequat
        # composition, sign included): quat = xquat[body] * local
        identity = lquat is None or torch.allclose(
            lquat.detach().cpu().double(), torch.tensor([1.0, 0.0, 0.0, 0.0],
                                                        dtype=torch.float64))
        self._local_quat = None if identity else lquat

    def quat(self, d):
        q = d.xquat[:, self.body_id]
        if self._local_quat is not None:
            q = mul_quat(q, self._local_quat.to(q.dtype))
        return q

    def pos(self, d):
        return {"body": d.xipos, "xbody": d.xpos, "geom": d.geom_xpos,
                "site": d.site_xpos}[self.kind][:, self.oid]

    def mat(self, d):
        return {"body": d.ximat, "xbody": d.xmat, "geom": d.geom_xmat,
                "site": d.site_xmat}[self.kind][:, self.oid]

    def vel(self, d, local=False):
        return object_velocity(
            self.pos(d), d.subtree_com[:, self.root_id], d.cvel[:, self.body_id],
            self.mat(d) if local else None,
        )

    def acc(self, d, cacc, local=False):
        return object_acceleration(
            self.pos(d), d.subtree_com[:, self.root_id], d.cvel[:, self.body_id],
            cacc[:, self.body_id], self.mat(d) if local else None,
        )


class BuiltinSensor(Sensor):
    def __init__(self, cfg: BuiltinSensorCfg, scene):
        super().__init__(scene)
        self.cfg = cfg

    @classmethod
    def from_xml_sensor(cls, scene, row: "XmlSensor") -> "BuiltinSensor":
        """Wrap an XML-declared sensor (the JAX scene's auto-wrap,
        mjlab_tpu/sensor/builtin_sensor.py from_spec_sensor): a reference
        frame only for the types that take one."""
        obj = ObjRef(type=row.objtype, name=row.objname) if row.objname else None
        ref = None
        if row.refname and not row.refname.endswith("/") and row.type in _SENSORS_ALLOWING_REF:
            ref = ObjRef(type=row.reftype, name=row.refname)
        sensor = cls(BuiltinSensorCfg(sensor_type=row.type, obj=obj, ref=ref,
                                      cutoff=row.cutoff), scene)
        sensor.name = row.name
        return sensor

    def initialize(self, ctx: "SimContext") -> None:
        self.ctx = ctx
        t = self.cfg.sensor_type
        if t in _TENDON_TYPES:
            raise NotImplementedError(
                f"sensor '{self.name}': builtin sensor type '{t}' waits for tendons, "
                "which the port's Simulation refuses until the general engine is "
                "ported (ROADMAP.md queue 1 item 4)"
            )
        if t not in PORTED_TYPES:
            raise NotImplementedError(f"sensor '{self.name}': unknown sensor type '{t}'")
        m = ctx.model
        obj = self.cfg.obj
        if t in _GLOBAL_SENSORS:
            if t == "e_potential":
                # hinge, slide and free joints with a spring (the ball's
                # quaternion spring is not carried, as in the JAX package)
                stiff = host_array(m, "jnt_stiffness")
                self._springs = [
                    (int(m.jnt_type[j]), int(m.jnt_qposadr[j]), float(stiff[j]))
                    for j in range(m.njnt) if float(stiff[j]) != 0.0
                ]
            return
        if t in _SITE_SENSORS or t in _FRAME_SENSORS:
            self._frame = _Frame(m, obj)
            self._ref = _Frame(m, self.cfg.ref) if self.cfg.ref is not None else None
            return
        if t in _BODY_SENSORS:
            bid = _object_id(m, "body", obj.prefixed_name())
            self.body_id = bid
            self.tree_id = int(m.body_rootid[bid])
            sub, stack = [], [bid]
            while stack:
                b = stack.pop()
                sub.append(b)
                stack += [c for c in range(m.nbody)
                          if c != b and int(m.body_parentid[c]) == b]
            self._subtree_bodies = torch.as_tensor(sorted(sub), dtype=torch.long,
                                                   device=m.device)
            return
        name = obj.prefixed_name()
        if _OBJ_REQUIREMENTS[t] == "actuator":
            if name not in m.actuator_names:
                raise ValueError(f"actuator '{name}' not found")
            self._act_id = m.actuator_names.index(name)
            return
        if name not in m.joint_names:
            raise ValueError(f"joint '{name}' not found")
        jid = m.joint_names.index(name)
        if t != "jointactuatorfrc" and int(m.jnt_type[jid]) not in (_JNT_HINGE, _JNT_SLIDE):
            raise ValueError(f"sensor '{t}' requires a scalar (hinge/slide) joint")
        self._jnt_id = jid
        self._jnt_qadr = int(m.jnt_qposadr[jid])
        self._jnt_vadr = int(m.jnt_dofadr[jid])
        lo, hi = host_array(m, "jnt_range")[jid]
        self._jnt_range = (float(lo), float(hi))
        self._jnt_limited = bool(m.jnt_limited[jid])
        # MuJoCo's limit row of the joint: [equality][dof friction][limits]
        pos = np.flatnonzero(np.asarray(m.limit_jntid) == jid)
        self._limit_row = None if pos.size == 0 else m.neq_jnt + m.nv + int(pos[0])

    # -- reading --

    def _limit_terms(self, d):
        """(active, dist, side) of the joint's limit: the nearer side's one
        row, active where it is violated."""
        q = d.qpos[:, self._jnt_qadr]
        lo, hi = self._jnt_range
        dlo, dhi = q - lo, hi - q
        lower_closer = dlo < dhi
        dist = torch.where(lower_closer, dlo, dhi)
        side = torch.where(lower_closer, 1.0, -1.0)
        active = (dist < 0.0) & self._jnt_limited
        return active, dist, side

    def _joint_sensor(self, d, t):
        a = self._jnt_vadr
        if t == "jointpos":
            return d.qpos[:, self._jnt_qadr, None]
        if t == "jointvel":
            return d.qvel[:, a, None]
        if t == "jointactuatorfrc":
            return d.qfrc_actuator[:, a, None]
        active, dist, side = self._limit_terms(d)
        if t == "jointlimitpos":
            return torch.where(active, dist, 0.0)[:, None]
        if t == "jointlimitvel":
            return torch.where(active, side * d.qvel[:, a], 0.0)[:, None]
        if self._limit_row is None:  # jointlimitfrc of a joint without a limit
            return torch.zeros_like(d.qpos[:, :1])
        return torch.where(active, d.efc_force[:, self._limit_row], 0.0)[:, None]

    def _global(self, d, m, t):
        if t == "clock":
            return d.time.reshape(-1, 1).expand(d.qpos.shape[0], 1)
        if t == "e_kinetic":
            ke = 0.5 * torch.einsum("ebi,ebij,ebj->e", d.cvel, d.cinert, d.cvel)
            arm = torch.broadcast_to(m.dof_armature.to(d.qvel.dtype), d.qvel.shape)
            return (ke + 0.5 * (arm * d.qvel ** 2).sum(-1))[:, None]
        g = m.opt.gravity.to(d.qpos.dtype)
        mass = torch.broadcast_to(m.body_mass.to(d.qpos.dtype), d.xipos.shape[:2])
        pe = -(mass * torch.einsum("ebk,k->eb", d.xipos, g)).sum(1)
        for jt, qadr, k in self._springs:
            if jt in (_JNT_HINGE, _JNT_SLIDE):
                dq = d.qpos[:, qadr] - m.qpos_spring[..., qadr]
                pe = pe + 0.5 * k * dq * dq
            elif jt == _JNT_FREE:  # the translational part only
                dq = d.qpos[:, qadr:qadr + 3] - m.qpos_spring[..., qadr:qadr + 3]
                pe = pe + 0.5 * k * (dq * dq).sum(-1)
        return pe[:, None]

    def _body(self, d, m, t):
        sub = self._subtree_bodies
        mass = torch.broadcast_to(m.body_mass.to(d.xipos.dtype), d.xipos.shape[:2])[:, sub]
        msum = mass.sum(1, keepdim=True)
        if t == "subtreecom":
            return (mass[..., None] * d.xipos[:, sub]).sum(1) / torch.clamp(msum, min=1e-12)
        # the subtree's momentum about subtree_com of its tree's root
        h_tot = torch.einsum("ebij,ebj->ebi", d.cinert[:, sub], d.cvel[:, sub]).sum(1)
        if t == "subtreelinvel":
            return h_tot[:, 3:6] / torch.clamp(msum, min=1e-12)
        # subtreeangmom: the angular momentum moved to the subtree's com
        com = (mass[..., None] * d.xipos[:, sub]).sum(1) / torch.clamp(msum, min=1e-12)
        O = d.subtree_com[:, self.tree_id]
        return h_tot[:, 0:3] + cross(O - com, h_tot[:, 3:6])

    def _site(self, d, m, t):
        fr = self._frame
        if t in ("gyro", "velocimeter"):
            v = fr.vel(d, local=True)
            return v[:, 0:3] if t == "gyro" else v[:, 3:6]
        if t == "magnetometer":
            return torch.einsum("eji,j->ei", fr.mat(d), m.opt.magnetic.to(d.qpos.dtype))
        if t == "rangefinder":
            vec = fr.mat(d)[..., :, 2]  # the site's z axis
            return phys_ray.raycast(m, d, fr.pos(d), vec, fr.body_id)[:, None]
        cacc, cfrc_int, _ = self.ctx.rne_post()
        if t == "accelerometer":
            return fr.acc(d, cacc, local=True)[:, 3:6]
        # force, torque: the interaction force of the site's body, moved to
        # the site, in its frame
        frc = transform_force(cfrc_int[:, fr.body_id], fr.pos(d),
                              d.subtree_com[:, fr.root_id])
        part = frc[:, 3:6] if t == "force" else frc[:, 0:3]
        return torch.einsum("eji,ej->ei", fr.mat(d), part)

    def _frame_sensor(self, d, t):
        fr, ref = self._frame, self._ref
        if t == "framepos":
            p = fr.pos(d)
            if ref is None:
                return p
            return torch.einsum("eji,ej->ei", ref.mat(d), p - ref.pos(d))
        if t == "framequat":
            q = fr.quat(d)
            return q if ref is None else mul_quat(conj_quat(ref.quat(d)), q)
        if t in ("framexaxis", "frameyaxis", "framezaxis", "upvector"):
            axis = fr.mat(d)[..., :, {"framexaxis": 0, "frameyaxis": 1}.get(t, 2)]
            return axis if ref is None else torch.einsum("eji,ej->ei", ref.mat(d), axis)
        if t in ("framelinvel", "frameangvel"):
            v = fr.vel(d, local=False)
            if ref is None:
                return v[:, 3:6] if t == "framelinvel" else v[:, 0:3]
            vr = ref.vel(d, local=False)
            if t == "frameangvel":
                rel = v[:, 0:3] - vr[:, 0:3]
            else:  # with the transport term of the rotating reference frame
                rel = v[:, 3:6] - vr[:, 3:6] - cross(vr[:, 0:3], fr.pos(d) - ref.pos(d))
            return torch.einsum("eji,ej->ei", ref.mat(d), rel)
        # framelinacc, frameangacc (no reference, as in MuJoCo)
        cacc, _, _ = self.ctx.rne_post()
        a = fr.acc(d, cacc, local=False)
        return a[:, 3:6] if t == "framelinacc" else a[:, 0:3]

    def _compute(self) -> torch.Tensor:
        d, m = self.ctx.data, self.ctx.model
        t = self.cfg.sensor_type
        if t in _GLOBAL_SENSORS:
            return self._global(d, m, t)
        if t in _BODY_SENSORS:
            return self._body(d, m, t)
        if t in _SITE_SENSORS:
            return self._site(d, m, t)
        if t in _FRAME_SENSORS:
            return self._frame_sensor(d, t)
        if _OBJ_REQUIREMENTS[t] == "actuator":
            src = {"actuatorpos": d.actuator_length, "actuatorvel": d.actuator_velocity,
                   "actuatorfrc": d.actuator_force}[t]
            return src[:, self._act_id, None]
        return self._joint_sensor(d, t)

    @property
    def data(self) -> torch.Tensor:
        out = self._compute()
        if self.cfg.cutoff > 0:
            out = torch.clamp(out, -self.cfg.cutoff, self.cfg.cutoff)
        return out
