"""Contact sensor: per-match contact aggregates from the static contact-slot
table, and the air/contact-time state machine.

PyTorch counterpart of mjlab_tpu/sensor/contact_sensor.py. Each primary
match object (a geom, a body, or a body's subtree) resolves at startup to
the contact slots of the Model's pair table it takes part in, against the
secondary objects; at run time the sensor reduces the step's per-slot
contact activity (con_found, condist) and the forces of the compacted
slots (con_force_c, con_torque_c) over those slots. Object names resolve
from the Model's names, so no MuJoCo is needed.

The whole surface of the JAX sensor: the fields found, force, torque,
dist, pos, normal and tangent; reduce "netforce" (one world-frame row per
primary; dist, pos, normal and tangent read zero there, as in MuJoCo),
"mindist", "maxforce" and "none" (the top num_slots active slots per
primary by distance, by force magnitude, or in slot order), with a force
and torque per slot in the contact frame whose normal points from the
primary to the secondary (the first tangent flipped with it), or in the
world frame with global_frame; secondary_policy first / any / error; and
track_air_time. Positions, frames and forces are read from the compacted
K-slot record of the step (con_packed_c, con_force_c, con_torque_c): a
found slot outside the K compacted ones reads zero there, as it carries
no solver force.

The air-time state is four (num_envs, M) tensors updated in place once per
physics substep, so that a captured control step carries them.
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import TYPE_CHECKING, Literal

import numpy as np
import torch

from mjlab_tpu_torch.sensor.sensor import Sensor, SensorCfg

if TYPE_CHECKING:
    from mjlab_tpu_torch.scene.scene import SimContext

_FIELDS = {"found", "force", "torque", "dist", "pos", "normal", "tangent"}


@dataclass
class ContactMatch:
    mode: Literal["geom", "body", "subtree"] = "geom"
    pattern: str | tuple[str, ...] = ".*"
    entity: str | None = None
    exclude: tuple[str, ...] = ()


@dataclass(kw_only=True)
class ContactSensorCfg(SensorCfg):
    name: str = ""
    primary: ContactMatch = None
    secondary: ContactMatch | None = None
    fields: tuple[str, ...] = ("found",)
    reduce: Literal["none", "netforce", "maxforce", "mindist"] = "netforce"
    num_slots: int = 1
    secondary_policy: Literal["first", "any", "error"] = "first"
    track_air_time: bool = False
    global_frame: bool = False

    def __post_init__(self):
        bad = set(self.fields) - _FIELDS
        if bad:
            raise ValueError(f"unknown contact sensor fields: {sorted(bad)}")
        if (self.global_frame and self.reduce != "netforce"
                and {"force", "torque"} & set(self.fields)
                and not {"normal", "tangent"} <= set(self.fields)):
            raise ValueError(
                f"Sensor '{self.name}': global_frame=True requires 'normal' "
                "and 'tangent' in fields"
            )

    def build(self, scene):
        return ContactSensor(self, scene)


@dataclass
class ContactSensorState:
    current_air_time: torch.Tensor  # (E, M)
    current_contact_time: torch.Tensor
    last_air_time: torch.Tensor
    last_contact_time: torch.Tensor


@dataclass
class ContactData:
    """The requested fields (others None): (E, M * num_slots) scalars,
    (E, M * num_slots, 3) vectors; air times per primary (E, M)."""

    found: torch.Tensor | None = None
    force: torch.Tensor | None = None
    torque: torch.Tensor | None = None
    dist: torch.Tensor | None = None
    pos: torch.Tensor | None = None
    normal: torch.Tensor | None = None
    tangent: torch.Tensor | None = None
    current_air_time: torch.Tensor | None = None
    current_contact_time: torch.Tensor | None = None
    last_air_time: torch.Tensor | None = None
    last_contact_time: torch.Tensor | None = None


def _subtree_bodies(m, root: int) -> list[int]:
    out, stack = [], [root]
    while stack:
        b = stack.pop()
        out.append(b)
        stack += [c for c in range(m.nbody) if c != b and int(m.body_parentid[c]) == b]
    return out


def _resolve_objects(m, match: ContactMatch) -> list[tuple[str, set]]:
    """[(object local name, set of global geom ids)], one per match."""
    prefix = f"{match.entity}/" if match.entity else ""
    patterns = (match.pattern if isinstance(match.pattern, (tuple, list))
                else (match.pattern,))

    def local(name):
        if prefix:
            return name[len(prefix):] if name.startswith(prefix) else None
        return name

    def hit(ln):
        return (ln is not None and any(re.fullmatch(p, ln) for p in patterns)
                and not any(re.fullmatch(e, ln) for e in match.exclude))

    if match.mode == "geom":
        return [(local(n), {g}) for g, n in enumerate(m.geom_names) if hit(local(n))]
    objs = []
    for b, n in enumerate(m.body_names):
        ln = local(n)
        if not hit(ln):
            continue
        bodies = set(_subtree_bodies(m, b) if match.mode == "subtree" else [b])
        objs.append((ln, {g for g in range(m.ngeom) if int(m.geom_bodyid[g]) in bodies}))
    return objs


def pyramid_to_force(dim: int, mu: torch.Tensor, rows: torch.Tensor) -> torch.Tensor:
    """The contact-frame force of pyramid edge forces (mj_contactForce):
    f_normal = sum(rows), f_k = mu_k (rows[2k] - rows[2k + 1])."""
    if dim == 1:
        return rows[..., :1]
    fn = rows.sum(-1, keepdim=True)
    fk = [(mu[..., k] * (rows[..., 2 * k] - rows[..., 2 * k + 1]))[..., None]
          for k in range(dim - 1)]
    return torch.cat([fn] + fk, dim=-1)


class ContactSensor(Sensor):
    def __init__(self, cfg: ContactSensorCfg, scene):
        super().__init__(scene)
        self.cfg = cfg
        self.name = cfg.name
        self.match_names: list[str] = []

    def initialize(self, ctx: "SimContext") -> None:
        self.ctx = ctx
        m = ctx.model
        pt = m.pairs
        cfg = self.cfg
        primaries = _resolve_objects(m, cfg.primary)
        if cfg.secondary is not None:
            objs = _resolve_objects(m, cfg.secondary)
            if not objs:
                sec: set | None = set()
            elif cfg.secondary_policy == "any":
                sec = set().union(*[gs for _, gs in objs])
            elif cfg.secondary_policy == "error" and len(objs) > 1:
                raise ValueError(
                    f"Sensor '{self.name}': secondary pattern matched {len(objs)} "
                    f"objects ({[n for n, _ in objs]}) with secondary_policy='error'"
                )
            else:
                sec = objs[0][1]
        else:
            sec = None

        slot_lists = []
        for _, pset in primaries:
            slots, signs = [], []
            for c in range(pt.ncon):
                g1, g2 = int(pt.con_geom1[c]), int(pt.con_geom2[c])
                in1, in2 = g1 in pset, g2 in pset
                if in1 == in2:
                    continue  # not touching the object, or inside it
                other = g2 if in1 else g1
                if sec is not None and other not in sec:
                    continue
                slots.append(c)
                signs.append(1.0 if in2 else -1.0)
            slot_lists.append((slots, signs))
        self.match_names = [n for n, _ in primaries]
        maxmatch = ctx.sim.cfg.contact_sensor_maxmatch
        over = [n for n, (s, _) in zip(self.match_names, slot_lists) if len(s) > maxmatch]
        if over:
            raise ValueError(
                f"Sensor '{self.name}': {over} match more than "
                f"contact_sensor_maxmatch={maxmatch} contact slots"
            )

        M = max(len(slot_lists), 1)
        S = max([len(s) for s, _ in slot_lists] + [1])
        table = np.zeros((M, S), np.int64)
        mask = np.zeros((M, S), bool)
        sign = np.zeros((M, S))
        for i, (slots, signs) in enumerate(slot_lists):
            table[i, :len(slots)] = slots
            mask[i, :len(slots)] = True
            sign[i, :len(slots)] = signs
        self.num_matches = M
        # the flat (m, s) position of each slot, for the scatter of the
        # compacted slots' values; a one-hot product where slots overlap
        slot2flat = np.full(pt.ncon, -1, np.int64)
        self._overlapping = False
        for mm in range(M):
            for s in range(S):
                if mask[mm, s]:
                    self._overlapping |= bool(slot2flat[table[mm, s]] != -1)
                    slot2flat[table[mm, s]] = mm * S + s
        dev, dt = m.device, m.dtype
        self.slot_table = torch.as_tensor(table, device=dev)
        self.slot_mask = torch.as_tensor(mask, device=dev)
        self.slot_sign = torch.as_tensor(sign, dtype=dt, device=dev)
        self._slot2flat = torch.as_tensor(slot2flat, device=dev)
        if cfg.track_air_time:
            # float32 whatever the Model's dtype, as the JAX package keeps it
            z = lambda: torch.zeros((ctx.sim.num_envs, M), dtype=torch.float32,  # noqa: E731
                                    device=dev)
            ctx.sensor_states[self.name] = ContactSensorState(z(), z(), z(), z())

    def state_tensors(self, ctx) -> list[torch.Tensor]:
        if not self.cfg.track_air_time:
            return []
        s = ctx.sensor_states[self.name]
        return [s.current_air_time, s.current_contact_time, s.last_air_time,
                s.last_contact_time]

    # -- runtime --

    def _expand_compacted(self, d, values):
        """Compacted per-slot values (E, K, C) onto the sensor's slot table
        -> (E, M, S, C)."""
        M, S = self.slot_table.shape
        E, K = d.con_sel.shape
        C = values.shape[-1]
        sel = d.con_sel.long()
        vals = torch.where(d.con_sel_active[..., None], values, 0.0)
        if not self._overlapping:
            flat = self._slot2flat[sel]  # (E, K)
            tgt = torch.where((flat >= 0) & d.con_sel_active, flat, M * S)
            buf = values.new_zeros(E, M * S + 1, C)
            buf.scatter_add_(1, tgt[..., None].expand(E, K, C), vals)
            return buf[:, :M * S].reshape(E, M, S, C)
        onehot = (sel[:, None, None, :] == self.slot_table[None, :, :, None]).to(values.dtype)
        out = torch.einsum("emsk,ekc->emsc", onehot, vals)
        return out * self.slot_mask.to(values.dtype)[None, :, :, None]

    def _active(self, d):
        return d.con_found[:, self.slot_table] & self.slot_mask  # (E, M, S)

    def _compute(self, ctx) -> ContactData:
        cfg = self.cfg
        d = ctx.data
        M, S = self.slot_table.shape
        NR = cfg.num_slots
        fields = set(cfg.fields)
        active = self._active(d)
        E = active.shape[0]
        found_count = active.sum(-1).to(torch.int32)  # (E, M)
        out = ContactData()
        if cfg.reduce == "netforce":
            # one net row per primary, world frame, the force applied BY the
            # primary on the secondary
            if "found" in fields:
                out.found = self._tile(found_count, NR)
            sgn = self.slot_sign[None, :, :, None]
            for name, src in (("force", d.con_force_c), ("torque", d.con_torque_c)):
                if name in fields:
                    w = self._expand_compacted(d, src) * sgn
                    setattr(out, name, self._tile(-w.sum(2), NR))
            for name, width in (("dist", None), ("pos", 3), ("normal", 3), ("tangent", 3)):
                if name in fields:
                    shape = (E, M * NR) if width is None else (E, M * NR, width)
                    setattr(out, name, d.condist.new_zeros(shape))
        else:
            self._reduce_slots(out, d, active, found_count)
        if cfg.track_air_time:
            s = ctx.sensor_states[self.name]
            out.current_air_time = s.current_air_time
            out.current_contact_time = s.current_contact_time
            out.last_air_time = s.last_air_time
            out.last_contact_time = s.last_contact_time
        return out

    def _reduce_slots(self, out: ContactData, d, active, found_count) -> None:
        """The top num_slots active slots of each primary ("mindist": the
        nearest; "maxforce": the largest force; "none": the first in slot
        order), their fields into out."""
        cfg = self.cfg
        fields = set(cfg.fields)
        E, M, S = active.shape
        NR = cfg.num_slots
        sgn = self.slot_sign[None, :, :, None]
        force_w = torque_w = None
        if {"force", "torque"} & fields or cfg.reduce == "maxforce":
            # the world force (torque) on the primary, per static slot
            force_w = self._expand_compacted(d, d.con_force_c) * sgn
            if "torque" in fields:
                torque_w = self._expand_compacted(d, d.con_torque_c) * sgn
        dist = torch.where(active, d.condist[:, self.slot_table], torch.inf)
        if cfg.reduce == "mindist":
            key = dist
        elif cfg.reduce == "maxforce":
            key = torch.where(active, -torch.linalg.vector_norm(force_w, dim=-1), torch.inf)
        else:  # "none": the static order among the active slots
            rank = torch.arange(S, dtype=d.condist.dtype, device=dist.device)
            key = torch.where(active, rank[None, None], torch.inf)
        order = torch.argsort(key, dim=-1, stable=True)[..., :NR]  # (E, M, NR)
        R = order.shape[-1]
        picked = torch.take_along_dim(active, order, dim=-1)
        if "found" in fields:
            out.found = torch.where(picked, found_count[..., None], 0).reshape(E, -1)
        if "dist" in fields:
            out.dist = torch.where(
                picked, torch.take_along_dim(dist, order, dim=-1), 0.0
            ).reshape(E, -1)
        if not {"force", "torque", "pos", "normal", "tangent"} & fields:
            return
        # -1 where the primary is the contact's geom2: MuJoCo's frame then
        # reads (s n, s t1, t2) with s = -sign, from primary to secondary
        sflip = -torch.take_along_dim(self.slot_sign.expand(E, M, S), order, dim=-1)

        def pick(x):  # (E, M, S, ...) -> (E, M, R, ...)
            idx = order.reshape(order.shape + (1,) * (x.ndim - 3))
            return torch.take_along_dim(x, idx, dim=2)

        frame = None
        if {"force", "torque", "normal", "tangent"} & fields:
            frame = pick(self._expand_compacted(d, d.con_packed_c[..., 17:26])
                         .reshape(E, M, S, 3, 3))  # (E, M, R, 3, 3)
        for name, w in (("force", force_w), ("torque", torque_w)):
            if name not in fields:
                continue
            w_by = -pick(w)  # world, applied BY the primary
            if not cfg.global_frame:
                comps = torch.einsum("emrfx,emrx->emrf", frame, w_by)
                w_by = torch.stack([sflip * comps[..., 0], sflip * comps[..., 1],
                                    comps[..., 2]], dim=-1)
            setattr(out, name, torch.where(picked[..., None], w_by, 0.0).reshape(E, M * R, 3))
        if "pos" in fields:
            pos = pick(self._expand_compacted(d, d.con_packed_c[..., 2:5]))
            out.pos = torch.where(picked[..., None], pos, 0.0).reshape(E, M * R, 3)
        for name, row in (("normal", 0), ("tangent", 1)):
            if name in fields:
                # the engine's normal points geom1 -> geom2; MuJoCo flips
                # the first tangent with it (a right-handed frame)
                v = frame[..., row, :] * sflip[..., None]
                setattr(out, name, torch.where(picked[..., None], v, 0.0).reshape(E, M * R, 3))

    @staticmethod
    def _tile(x, NR):
        """(E, M, ...) -> (E, M * NR, ...) with the value in each primary's
        first slot and zeros after."""
        if NR == 1:
            return x
        out = x.new_zeros((x.shape[0], x.shape[1], NR) + tuple(x.shape[2:]))
        out[:, :, 0] = x
        return out.reshape((x.shape[0], -1) + tuple(x.shape[2:]))

    @property
    def data(self) -> ContactData:
        return self._compute(self.ctx)

    def _found_per_primary(self, d):
        return self._active(d).any(-1)  # (E, M)

    def update(self, ctx, dt: float) -> None:
        """One physics substep of the air/contact-time state machine, in
        place."""
        if not self.cfg.track_air_time:
            return
        s = ctx.sensor_states[self.name]
        found = self._found_per_primary(ctx.data)
        became_contact = found & (s.current_air_time > 0)
        became_air = ~found & (s.current_contact_time > 0)
        last_air = torch.where(became_contact, s.current_air_time + dt, s.last_air_time)
        last_contact = torch.where(became_air, s.current_contact_time + dt,
                                   s.last_contact_time)
        cur_air = torch.where(found, 0.0, s.current_air_time + dt)
        cur_contact = torch.where(found, s.current_contact_time + dt, 0.0)
        s.last_air_time.copy_(last_air)
        s.last_contact_time.copy_(last_contact)
        s.current_air_time.copy_(cur_air)
        s.current_contact_time.copy_(cur_contact)

    def compute_first_contact(self, dt: float) -> torch.Tensor:
        s = self.ctx.sensor_states[self.name]
        return self._found_per_primary(self.ctx.data) & (s.current_contact_time <= dt)

    def compute_first_air(self, dt: float) -> torch.Tensor:
        s = self.ctx.sensor_states[self.name]
        return ~self._found_per_primary(self.ctx.data) & (s.current_air_time <= dt)

    def reset(self, ctx, mask: torch.Tensor) -> None:
        if self.cfg.track_air_time:
            for t in self.state_tensors(ctx):
                t.masked_fill_(mask[:, None], 0.0)
