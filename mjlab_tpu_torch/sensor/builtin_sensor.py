"""Builtin sensors computed from the batched physics state.

PyTorch counterpart of mjlab_tpu/sensor/builtin_sensor.py for the types
the G1 XML declares (mjlab_tpu/asset_zoo/robots/unitree_g1/xmls/g1.xml
313-318): gyro, velocimeter and accelerometer on a site frame, and
subtreeangmom of a body. The object frames (``_Frame``) resolve bodies,
xbodies, geoms and sites, as the JAX package's do. The config surface and
the classification of MuJoCo's sensor types are the JAX package's; a
sensor of any other type raises NotImplementedError naming it when the
scene initializes it.

The accelerometer reads rne_postconstraint (phys/rne_post.py) of the
current Data on every read: with a static Data (a captured control step)
the tensors keep their identity across steps, so a cache keyed on them, as
the JAX package keys its cache on id(data), would go stale.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Literal

import torch

from mjlab_tpu_torch.phys.math import cross, mul_quat
from mjlab_tpu_torch.phys.rne_post import (
    object_acceleration, object_velocity, rne_postconstraint,
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

# the types this package computes; the others of the JAX package's surface
# are still to port
PORTED_TYPES = frozenset({"gyro", "velocimeter", "accelerometer", "subtreeangmom"})

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
        mjlab_tpu/sensor/builtin_sensor.py from_spec_sensor)."""
        obj = ObjRef(type=row.objtype, name=row.objname) if row.objname else None
        ref = None
        if row.refname and row.type in _SENSORS_ALLOWING_REF:
            ref = ObjRef(type=row.reftype, name=row.refname)
        sensor = cls(BuiltinSensorCfg(sensor_type=row.type, obj=obj, ref=ref,
                                      cutoff=row.cutoff), scene)
        sensor.name = row.name
        return sensor

    def initialize(self, ctx: "SimContext") -> None:
        self.ctx = ctx
        t = self.cfg.sensor_type
        if t not in PORTED_TYPES:
            raise NotImplementedError(
                f"sensor '{self.name}': builtin sensor type '{t}' is not ported "
                f"yet (ported: {sorted(PORTED_TYPES)})"
            )
        m = ctx.model
        if t in _SITE_SENSORS:
            self._frame = _Frame(m, self.cfg.obj)
            return
        # subtreeangmom: the body's subtree (static topology)
        bid = _object_id(m, "body", self.cfg.obj.prefixed_name())
        self.body_id = bid
        self.tree_id = int(m.body_rootid[bid])
        sub, stack = [], [bid]
        while stack:
            b = stack.pop()
            sub.append(b)
            stack += [c for c in range(m.nbody) if c != b and int(m.body_parentid[c]) == b]
        self._subtree_bodies = torch.as_tensor(sorted(sub), dtype=torch.long,
                                               device=m.device)

    def _compute(self) -> torch.Tensor:
        d, m = self.ctx.data, self.ctx.model
        t = self.cfg.sensor_type
        if t == "subtreeangmom":
            sub = self._subtree_bodies
            h_tot = torch.einsum("ebij,ebj->ebi", d.cinert[:, sub], d.cvel[:, sub]).sum(1)
            mass = m.body_mass[..., sub].to(d.xipos.dtype)  # (nsub,) or per env (E, nsub)
            com = ((mass[..., None] * d.xipos[:, sub]).sum(1)
                   / torch.clamp(mass.sum(-1, keepdim=True), min=1e-12))
            O = d.subtree_com[:, self.tree_id]
            return h_tot[:, 0:3] + cross(O - com, h_tot[:, 3:6])
        fr = self._frame
        if t in ("gyro", "velocimeter"):
            v = fr.vel(d, local=True)
            return v[:, 0:3] if t == "gyro" else v[:, 3:6]
        cacc, _, _ = rne_postconstraint(m, d)  # accelerometer
        return fr.acc(d, cacc, local=True)[:, 3:6]

    @property
    def data(self) -> torch.Tensor:
        out = self._compute()
        if self.cfg.cutoff > 0:
            out = torch.clamp(out, -self.cfg.cutoff, self.cfg.cutoff)
        return out
