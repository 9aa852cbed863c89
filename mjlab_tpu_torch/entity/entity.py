"""Entity: a robot or object composed into the scene, at run time.

PyTorch counterpart of mjlab_tpu/entity/entity.py. The config
(``EntityCfg``: the spec, its editors and actuators, the initial state) is
shared with the scene's spec side (scene/scene.py build_entity_spec). At
run time an Entity resolves its global indices from the port's Model by
its "{name}/" prefix (``initialize``; no MuJoCo needed), builds its
actuator groups (any ActuatorCfg: builtin, PD, DC, delayed, learned, XML),
owns its per-env state (joint targets, encoder bias, each group's state)
as tensors updated in place, and writes its actuators' controls into
data.ctrl once per physics substep (``apply_actuator_controls``). Reads
and writes of the physics state go through the EntityData view
(entity/data.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Callable

import numpy as np
import torch

from mjlab_tpu_torch.actuator.actuator import ActuatorCmd
from mjlab_tpu_torch.entity.data import EntityData
from mjlab_tpu_torch.phys.model import JNT_FREE
from mjlab_tpu_torch.utils.string import (
    resolve_matching_names, resolve_matching_names_values,
)

if TYPE_CHECKING:
    import mujoco

    from mjlab_tpu_torch.scene.scene import SimContext


@dataclass
class InitialStateCfg:
    """Root pose and velocity (a floating base's free joint, or a fixed
    base's mocap frame) and joint positions and velocities by regex;
    joint_pos None adds no keyframe and keeps the model's qpos0."""

    pos: tuple = (0.0, 0.0, 0.0)
    rot: tuple = (1.0, 0.0, 0.0, 0.0)
    lin_vel: tuple = (0.0, 0.0, 0.0)
    ang_vel: tuple = (0.0, 0.0, 0.0)
    joint_pos: dict[str, float] | None = field(
        default_factory=lambda: {".*": 0.0}
    )
    joint_vel: dict[str, float] = field(default_factory=lambda: {".*": 0.0})


@dataclass
class EntityCfg:
    """An entity's spec, the editors applied to it before attach, its
    actuator groups and the soft joint-limit factor."""

    spec_fn: Callable[[], "mujoco.MjSpec"]
    init_state: InitialStateCfg = field(default_factory=InitialStateCfg)
    collisions: tuple = ()
    actuators: tuple = ()
    soft_joint_pos_limit_factor: float = 1.0


@dataclass
class EntityIndexing:
    """Global indices and addresses of the entity in the scene's Model
    (index tensors on the Model's device)."""

    body_ids: torch.Tensor
    geom_ids: torch.Tensor
    site_ids: torch.Tensor
    joint_ids: torch.Tensor  # non-free joints
    ctrl_ids: torch.Tensor  # actuator ids, in the actuator groups' order
    joint_q_adr: torch.Tensor  # qpos addresses of the non-free joints
    joint_v_adr: torch.Tensor
    free_joint_q_adr: torch.Tensor  # (7,) or empty
    free_joint_v_adr: torch.Tensor  # (6,) or empty
    mocap_id: int | None
    mocap_ids: torch.Tensor  # (1,) [mocap_id], or empty
    root_body_id: int
    root_tree_id: int  # body_rootid of the root body
    body_tree_ids: torch.Tensor  # body_rootid of each body


@dataclass
class EntityState:
    """Per-env runtime state (num_envs, joints), float32, written in
    place."""

    joint_pos_target: torch.Tensor
    joint_vel_target: torch.Tensor
    joint_effort_target: torch.Tensor
    encoder_bias: torch.Tensor
    actuator_states: dict  # actuator group index (str) -> its state


class Entity:
    """See the module docstring."""

    def __init__(self, cfg: EntityCfg, name: str):
        self.cfg = cfg
        self.name = name
        self.ctx: SimContext | None = None
        self.indexing: EntityIndexing | None = None
        self.actuators: list = []

    # -- names (local, in the Model's order) --

    def _local(self, names: tuple) -> list[tuple[int, str]]:
        prefix = f"{self.name}/"
        return [(i, n[len(prefix):]) for i, n in enumerate(names)
                if n.startswith(prefix)]

    @property
    def is_fixed_base(self) -> bool:
        return self._free_joint is None

    @property
    def is_articulated(self) -> bool:
        return len(self.joint_names) > 0

    @property
    def is_actuated(self) -> bool:
        return len(self.actuators) > 0

    @property
    def num_joints(self) -> int:
        return len(self.joint_names)

    @property
    def actuator_joint_names(self) -> list[str]:
        return [n for a in self.actuators for n in a.joint_names]

    # -- regex finders (local indices) --

    def find_bodies(self, expr, preserve_order=False):
        return resolve_matching_names(expr, self.body_names, preserve_order)

    def find_joints(self, expr, preserve_order=False):
        return resolve_matching_names(expr, self.joint_names, preserve_order)

    def find_geoms(self, expr, preserve_order=False):
        return resolve_matching_names(expr, self.geom_names, preserve_order)

    def find_sites(self, expr, preserve_order=False):
        return resolve_matching_names(expr, self.site_names, preserve_order)

    def find_actuators(self, expr, preserve_order=False):
        return resolve_matching_names(expr, self.actuator_joint_names, preserve_order)

    # -- initialization against the scene's Model --

    def initialize(self, ctx: "SimContext") -> None:
        """Resolve the global indexing from the Model's names, build the
        default states and limits, and allocate the per-env state
        (mjlab_tpu/entity/entity.py:256-409)."""
        self.ctx = ctx
        m = ctx.model
        E = ctx.sim.num_envs
        dev, dt = m.device, m.dtype
        bodies = self._local(m.body_names)
        joints = self._local(m.joint_names)
        geoms = self._local(m.geom_names)
        sites = self._local(m.site_names)
        if not bodies:
            raise ValueError(f"entity '{self.name}': no body in the model")
        self._free_joint = None
        if joints and int(m.jnt_type[joints[0][0]]) == JNT_FREE:
            self._free_joint = joints[0][0]
            joints = joints[1:]
        self.body_names = [n for _, n in bodies]
        self.joint_names = [n for _, n in joints]
        self.geom_names = [n for _, n in geoms]
        self.site_names = [n for _, n in sites]

        body_ids = np.array([i for i, _ in bodies], np.int64)
        joint_ids = np.array([i for i, _ in joints], np.int64)
        joint_q_adr = m.jnt_qposadr[joint_ids].astype(np.int64)
        joint_v_adr = m.jnt_dofadr[joint_ids].astype(np.int64)
        if self._free_joint is not None:
            fq = int(m.jnt_qposadr[self._free_joint])
            fv = int(m.jnt_dofadr[self._free_joint])
            free_q, free_v = np.arange(fq, fq + 7), np.arange(fv, fv + 6)
        else:
            free_q = free_v = np.zeros(0, np.int64)

        # actuator groups: joints by the groups' regexes, one actuator per
        # joint named after it
        self.actuators = []
        claimed: set[str] = set()
        actuator_ids = {n: i for i, n in enumerate(m.actuator_names)}
        ctrl_ids = []
        for acfg in self.cfg.actuators:
            ids, names = resolve_matching_names(list(acfg.joint_names_expr), self.joint_names)
            overlap = claimed & set(names)
            if overlap:
                raise ValueError(f"joints claimed twice: {sorted(overlap)}")
            claimed |= set(names)
            act = acfg.build(ids, names)
            missing = [n for n in names if f"{self.name}/{n}" not in actuator_ids]
            if missing:
                raise ValueError(f"actuators {missing} of '{self.name}' not in the model")
            gids = [actuator_ids[f"{self.name}/{n}"] for n in names]
            act.ctrl_ids = torch.as_tensor(gids, dtype=torch.long, device=dev)
            act.joint_ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
            ctrl_ids += gids
            self.actuators.append(act)

        root_body_id = int(body_ids[0])
        mocap = int(m.body_mocapid[root_body_id])
        ix = lambda x: torch.as_tensor(np.asarray(x, np.int64), device=dev)  # noqa: E731
        self.indexing = EntityIndexing(
            body_ids=ix(body_ids), geom_ids=ix([i for i, _ in geoms]),
            site_ids=ix([i for i, _ in sites]), joint_ids=ix(joint_ids),
            ctrl_ids=ix(ctrl_ids), joint_q_adr=ix(joint_q_adr),
            joint_v_adr=ix(joint_v_adr), free_joint_q_adr=ix(free_q),
            free_joint_v_adr=ix(free_v), mocap_id=mocap if mocap >= 0 else None,
            mocap_ids=ix([mocap] if mocap >= 0 else []),
            root_body_id=root_body_id,
            root_tree_id=int(m.body_rootid[root_body_id]),
            body_tree_ids=ix(m.body_rootid[body_ids]),
        )
        site_bodyids = m.site_bodyid[[i for i, _ in sites]]
        geom_bodyids = m.geom_bodyid[[i for i, _ in geoms]]
        self.site_bodyids = ix(site_bodyids)
        self.site_tree_ids = ix(m.body_rootid[site_bodyids])
        self.geom_bodyids = ix(geom_bodyids)
        self.geom_tree_ids = ix(m.body_rootid[geom_bodyids])

        # default states from cfg.init_state, and the limits, computed in
        # float32 as the JAX package computes them
        ist = self.cfg.init_state
        J = self.num_joints
        default_pos = np.zeros((1, J), np.float32)
        default_vel = np.zeros((1, J), np.float32)
        if J:
            if ist.joint_pos is None:
                default_pos[0] = m.qpos0.detach().cpu().numpy()[joint_q_adr]
            else:
                ids, _, vals = resolve_matching_names_values(ist.joint_pos, self.joint_names)
                default_pos[0, ids] = vals
            ids, _, vals = resolve_matching_names_values(ist.joint_vel, self.joint_names)
            default_vel[0, ids] = vals
        t = lambda x: torch.as_tensor(np.asarray(x), device=dev).to(dt)  # noqa: E731
        self.default_joint_pos = t(default_pos)
        self.default_joint_vel = t(default_vel)
        self.default_root_state = t(np.concatenate(
            [ist.pos, ist.rot, ist.lin_vel, ist.ang_vel], dtype=np.float32)[None])

        # joint limits, unlimited joints at +-1e10, and the soft limits
        if J:
            limits = m.jnt_range.detach().cpu().numpy()[joint_ids].astype(np.float32)
            limits[~m.jnt_limited[joint_ids].astype(bool)] = (-1e10, 1e10)
        else:
            limits = np.zeros((0, 2), np.float32)
        self.joint_pos_limits = t(limits)[None]  # (1, J, 2)
        mid = 0.5 * (limits[:, 0] + limits[:, 1])
        half = 0.5 * (limits[:, 1] - limits[:, 0]) * self.cfg.soft_joint_pos_limit_factor
        self.soft_joint_pos_limits = t(np.stack([mid - half, mid + half], -1))[None]
        # float32, as the JAX package keeps the local com orientations
        self.body_iquat = m.body_iquat.to(torch.float32)

        # float32 whatever the Model's dtype, as the JAX package keeps it
        zeros = lambda: torch.zeros((E, J), dtype=torch.float32, device=dev)  # noqa: E731
        ctx.entity_states[self.name] = EntityState(
            joint_pos_target=zeros(), joint_vel_target=zeros(),
            joint_effort_target=zeros(), encoder_bias=zeros(),
            actuator_states={str(i): a.initialize(E, dev, ctx.rng)
                             for i, a in enumerate(self.actuators)},
        )
        self._data_view = EntityData(self)

    @property
    def data(self) -> EntityData:
        return self._data_view

    @property
    def state(self) -> EntityState:
        return self.ctx.entity_states[self.name]

    def state_tensors(self) -> list[torch.Tensor]:
        st = self.state
        out = [st.joint_pos_target, st.joint_vel_target, st.joint_effort_target,
               st.encoder_bias]
        for i, act in enumerate(self.actuators):
            out += act.state_tensors(st.actuator_states[str(i)])
        return out

    # -- per-substep control --

    def apply_actuator_controls(self) -> None:
        """Every actuator group's ctrl from the joint targets, in the
        groups' order, written into data.ctrl; runs once per physics
        substep (mjlab_tpu/entity/entity.py:416-443). A group's state
        advances in place, and its draws come from the env's Rng."""
        if not self.actuators:
            return
        st = self.state
        d = self.ctx.data
        ix = self.indexing
        qpos = d.qpos[:, ix.joint_q_adr]
        qvel = d.qvel[:, ix.joint_v_adr]
        ctrl = d.ctrl
        for i, act in enumerate(self.actuators):
            j = act.joint_ids_t
            cmd = ActuatorCmd(
                position_target=st.joint_pos_target[:, j],
                velocity_target=st.joint_vel_target[:, j],
                effort_target=st.joint_effort_target[:, j],
                joint_pos=qpos[:, j],
                joint_vel=qvel[:, j],
            )
            out = act.compute(st.actuator_states[str(i)], cmd, self.ctx.rng)
            ctrl = ctrl.index_copy(1, act.ctrl_ids, out.to(ctrl.dtype))
        self.ctx.data = d.replace(ctrl=ctrl)

    def reset(self, mask: torch.Tensor) -> None:
        """Reset the actuator groups' state of the masked envs, in the
        groups' order (mjlab_tpu/entity/entity.py:445-452)."""
        st = self.state
        for i, act in enumerate(self.actuators):
            act.reset(st.actuator_states[str(i)], mask, self.ctx.rng)
