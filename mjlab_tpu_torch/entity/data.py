"""EntityData: batched views of one entity over the scene's physics Data.

PyTorch counterpart of mjlab_tpu/entity/data.py, with the same properties
and conventions. Reads compute from the current Data (valid after a step's
refresh or a forward); writes of the physics state replace fields of the
Data through the simulation context (in place once the Simulation is
static), and writes of targets update the entity's state tensors in
place. Every tensor has a leading num_envs axis. World frame:
  *_link_* : at the body frame origin
  *_com_*  : at the body center of mass
Root velocities in the body frame use root_link_quat_w.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

from mjlab_tpu_torch.phys.math import cross
from mjlab_tpu_torch.utils import math

if TYPE_CHECKING:
    from mjlab_tpu_torch.entity.entity import Entity, EntityIndexing


def compute_velocity_from_cvel(pos, subtree_com, cvel):
    """cvel ([ang, lin] at the subtree-root com) -> [lin, ang] at pos."""
    ang = cvel[..., 0:3]
    lin = cvel[..., 3:6]
    return torch.cat([lin + cross(ang, pos - subtree_com), ang], dim=-1)


class EntityData:
    """Lazy view bound to an Entity and its simulation context."""

    ROOT_POSE_DIM = 7
    ROOT_VEL_DIM = 6
    ROOT_STATE_DIM = 13

    def __init__(self, entity: "Entity"):
        self._e = entity
        self._consts: dict = {}

    # -- plumbing --

    @property
    def _ctx(self):
        return self._e.ctx

    @property
    def _d(self):
        return self._e.ctx.data

    @property
    def _idx(self) -> "EntityIndexing":
        return self._e.indexing

    @property
    def _st(self):
        return self._e.state

    # -- static metadata --

    @property
    def is_fixed_base(self):
        return self._e.is_fixed_base

    @property
    def is_articulated(self):
        return self._e.is_articulated

    def _const3(self, v):
        """(num_envs, 3) view of the constant v, made once per dtype (no
        host copy after the first call, so a captured step may read it)."""
        d = self._d
        key = (tuple(v), d.qpos.dtype)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.tensor(v, dtype=d.qpos.dtype, device=d.qpos.device)
        return t.expand(d.qpos.shape[0], 3)

    @property
    def gravity_vec_w(self):
        return self._const3((0.0, 0.0, -1.0))

    @property
    def forward_vec_b(self):
        return self._const3((1.0, 0.0, 0.0))

    # -- defaults --

    @property
    def default_root_state(self):
        return self._e.default_root_state

    @property
    def default_joint_pos(self):
        return self._e.default_joint_pos

    @property
    def default_joint_vel(self):
        return self._e.default_joint_vel

    @property
    def joint_pos_limits(self):
        return self._e.joint_pos_limits

    @property
    def soft_joint_pos_limits(self):
        return self._e.soft_joint_pos_limits

    @property
    def encoder_bias(self):
        return self._st.encoder_bias

    # -- targets --

    @property
    def joint_pos_target(self):
        return self._st.joint_pos_target

    @property
    def joint_vel_target(self):
        return self._st.joint_vel_target

    @property
    def joint_effort_target(self):
        return self._st.joint_effort_target

    # -- root state (world) --

    @property
    def root_link_pos_w(self):
        return self._d.xpos[:, self._idx.root_body_id]

    @property
    def root_link_quat_w(self):
        return self._d.xquat[:, self._idx.root_body_id]

    @property
    def root_link_pose_w(self):
        return torch.cat([self.root_link_pos_w, self.root_link_quat_w], -1)

    def _root_vel(self, pos):
        d, ix = self._d, self._idx
        return compute_velocity_from_cvel(
            pos, d.subtree_com[:, ix.root_tree_id], d.cvel[:, ix.root_body_id])

    @property
    def root_link_vel_w(self):
        return self._root_vel(self._d.xpos[:, self._idx.root_body_id])

    @property
    def root_link_lin_vel_w(self):
        return self.root_link_vel_w[..., 0:3]

    @property
    def root_link_ang_vel_w(self):
        return self.root_link_vel_w[..., 3:6]

    @property
    def root_com_pos_w(self):
        return self._d.xipos[:, self._idx.root_body_id]

    @property
    def root_com_quat_w(self):
        q = self._e.body_iquat[self._idx.root_body_id]
        return math.quat_mul(self.root_link_quat_w, q.to(self._d.xquat.dtype))

    @property
    def root_com_vel_w(self):
        return self._root_vel(self._d.xipos[:, self._idx.root_body_id])

    @property
    def root_com_lin_vel_w(self):
        return self.root_com_vel_w[..., 0:3]

    @property
    def root_com_ang_vel_w(self):
        return self.root_com_vel_w[..., 3:6]

    # -- root state (body frame) --

    @property
    def root_link_lin_vel_b(self):
        return math.quat_apply_inverse(self.root_link_quat_w, self.root_link_lin_vel_w)

    @property
    def root_link_ang_vel_b(self):
        return math.quat_apply_inverse(self.root_link_quat_w, self.root_link_ang_vel_w)

    @property
    def root_com_lin_vel_b(self):
        return math.quat_apply_inverse(self.root_link_quat_w, self.root_com_lin_vel_w)

    @property
    def root_com_ang_vel_b(self):
        return math.quat_apply_inverse(self.root_link_quat_w, self.root_com_ang_vel_w)

    # the link-frame variants the observation terms read
    root_pos_w = root_link_pos_w
    root_quat_w = root_link_quat_w
    root_lin_vel_b = root_link_lin_vel_b
    root_ang_vel_b = root_link_ang_vel_b

    @property
    def projected_gravity_b(self):
        return math.quat_apply_inverse(self.root_link_quat_w, self.gravity_vec_w)

    @property
    def heading_w(self):
        fwd = math.quat_apply(self.root_link_quat_w, self.forward_vec_b)
        return torch.atan2(fwd[..., 1], fwd[..., 0])

    # -- bodies / geoms / sites --

    def _vel(self, pos, bodies, roots):
        d = self._d
        return compute_velocity_from_cvel(pos, d.subtree_com[:, roots], d.cvel[:, bodies])

    @property
    def body_link_pos_w(self):
        return self._d.xpos[:, self._idx.body_ids]

    @property
    def body_link_quat_w(self):
        return self._d.xquat[:, self._idx.body_ids]

    @property
    def body_link_vel_w(self):
        ix = self._idx
        return self._vel(self._d.xpos[:, ix.body_ids], ix.body_ids, ix.body_tree_ids)

    @property
    def body_link_lin_vel_w(self):
        return self.body_link_vel_w[..., 0:3]

    @property
    def body_link_ang_vel_w(self):
        return self.body_link_vel_w[..., 3:6]

    @property
    def body_com_pos_w(self):
        return self._d.xipos[:, self._idx.body_ids]

    @property
    def body_com_vel_w(self):
        ix = self._idx
        return self._vel(self._d.xipos[:, ix.body_ids], ix.body_ids, ix.body_tree_ids)

    @property
    def body_com_lin_vel_w(self):
        return self.body_com_vel_w[..., 0:3]

    @property
    def body_com_ang_vel_w(self):
        return self.body_com_vel_w[..., 3:6]

    @property
    def geom_pos_w(self):
        return self._d.geom_xpos[:, self._idx.geom_ids]

    @property
    def site_pos_w(self):
        return self._d.site_xpos[:, self._idx.site_ids]

    @property
    def site_quat_w(self):
        return math.mat_to_quat(self._d.site_xmat[:, self._idx.site_ids])

    @property
    def site_vel_w(self):
        e = self._e
        return self._vel(self._d.site_xpos[:, self._idx.site_ids],
                         e.site_bodyids, e.site_tree_ids)

    @property
    def site_lin_vel_w(self):
        return self.site_vel_w[..., 0:3]

    @property
    def site_ang_vel_w(self):
        return self.site_vel_w[..., 3:6]

    @property
    def geom_lin_vel_w(self):
        e = self._e
        return self._vel(self._d.geom_xpos[:, self._idx.geom_ids],
                         e.geom_bodyids, e.geom_tree_ids)[..., 0:3]

    # -- joints --

    @property
    def joint_pos(self):
        return self._d.qpos[:, self._idx.joint_q_adr]

    @property
    def joint_pos_biased(self):
        return self.joint_pos + self.encoder_bias

    @property
    def joint_vel(self):
        return self._d.qvel[:, self._idx.joint_v_adr]

    @property
    def joint_acc(self):
        return self._d.qacc[:, self._idx.joint_v_adr]

    @property
    def actuator_force(self):
        return self._d.actuator_force[:, self._idx.ctrl_ids]

    @property
    def generalized_force(self):
        return self._d.qfrc_actuator[:, self._idx.joint_v_adr]

    # -- writes of the physics state --

    def _mask(self, env_ids, B):
        """(B,) bool mask of env_ids: None for every env, a bool mask, or
        env indices."""
        dev = self._d.qpos.device
        if env_ids is None:
            return torch.ones(B, dtype=torch.bool, device=dev)
        env_ids = torch.as_tensor(env_ids, device=dev)
        if env_ids.dtype == torch.bool:
            return env_ids
        return torch.zeros(B, dtype=torch.bool, device=dev).index_fill(0, env_ids.long(), True)

    def _write(self, field, adr, value, env_ids, extra_dims=1):
        d = self._d
        cur = getattr(d, field)
        mask = self._mask(env_ids, cur.shape[0]).reshape((-1,) + (1,) * extra_dims)
        new = cur.index_copy(1, adr, torch.where(mask, value.to(cur.dtype), cur[:, adr]))
        self._ctx.data = d.replace(**{field: new})

    def write_root_pose(self, pose, env_ids=None):
        if self._e.is_fixed_base:
            raise ValueError("cannot write root pose of fixed-base entity")
        self._write("qpos", self._idx.free_joint_q_adr, pose, env_ids)

    def write_root_velocity(self, velocity, env_ids=None):
        """velocity (E, 6) [lin_w, ang_w]; the free joint's angular part is
        stored in the body frame, as MuJoCo stores it."""
        if self._e.is_fixed_base:
            raise ValueError("cannot write root velocity of fixed-base entity")
        quat = self._d.qpos[:, self._idx.free_joint_q_adr[3:7]]
        ang_b = math.quat_apply_inverse(quat, velocity[:, 3:6].to(quat.dtype))
        vel_q = torch.cat([velocity[:, 0:3].to(quat.dtype), ang_b], -1)
        self._write("qvel", self._idx.free_joint_v_adr, vel_q, env_ids)

    def write_root_state(self, root_state, env_ids=None):
        self.write_root_pose(root_state[:, :7], env_ids)
        self.write_root_velocity(root_state[:, 7:13], env_ids)

    def write_joint_position(self, position, joint_ids=None, env_ids=None):
        adr = self._idx.joint_q_adr
        self._write("qpos", adr if joint_ids is None else adr[joint_ids], position, env_ids)

    def write_joint_velocity(self, velocity, joint_ids=None, env_ids=None):
        adr = self._idx.joint_v_adr
        self._write("qvel", adr if joint_ids is None else adr[joint_ids], velocity, env_ids)

    def write_joint_state(self, position, velocity, joint_ids=None, env_ids=None):
        self.write_joint_position(position, joint_ids, env_ids)
        self.write_joint_velocity(velocity, joint_ids, env_ids)

    def write_external_wrench(self, force, torque, body_ids=None, env_ids=None):
        ids = self._idx.body_ids if body_ids is None else self._idx.body_ids[body_ids]
        self._write("xfrc_applied", ids, torch.cat([force, torque], -1), env_ids, 2)

    def write_ctrl(self, ctrl, ctrl_ids=None, env_ids=None):
        ids = self._idx.ctrl_ids if ctrl_ids is None else torch.as_tensor(
            ctrl_ids, dtype=torch.long, device=self._d.ctrl.device)
        self._write("ctrl", ids, ctrl, env_ids)

    def write_mocap_pose(self, pose, env_ids=None):
        if self._idx.mocap_id is None:
            raise ValueError("entity is not a mocap body")
        mid = self._e.indexing.mocap_ids
        self._write("mocap_pos", mid, pose[:, None, :3], env_ids, 2)
        self._write("mocap_quat", mid, pose[:, None, 3:7], env_ids, 2)

    # -- writes of the targets (the entity's state, in place) --

    def set_joint_position_target(self, target, joint_ids=None, env_ids=None):
        self._set_target("joint_pos_target", target, joint_ids, env_ids)

    def set_joint_velocity_target(self, target, joint_ids=None, env_ids=None):
        self._set_target("joint_vel_target", target, joint_ids, env_ids)

    def set_joint_effort_target(self, target, joint_ids=None, env_ids=None):
        self._set_target("joint_effort_target", target, joint_ids, env_ids)

    def _set_target(self, name, target, joint_ids, env_ids):
        cur = getattr(self._st, name)
        mask = self._mask(env_ids, cur.shape[0])[:, None]
        target = torch.as_tensor(target, dtype=cur.dtype, device=cur.device)
        if joint_ids is None:
            cur.copy_(torch.where(mask, target, cur))
        else:
            j = torch.as_tensor(joint_ids, dtype=torch.long, device=cur.device)
            cur.index_copy_(1, j, torch.where(mask, target, cur[:, j]))

    def clear_state(self, env_ids=None):
        """Zero the masked envs' joint targets and the external wrenches on
        the entity's bodies."""
        st = self._st
        mask = self._mask(env_ids, st.joint_pos_target.shape[0])
        for t in (st.joint_pos_target, st.joint_vel_target, st.joint_effort_target):
            t.masked_fill_(mask[:, None], 0.0)
        ids = self._idx.body_ids
        xfrc = self._d.xfrc_applied
        zero = torch.zeros((), dtype=xfrc.dtype, device=xfrc.device)
        self._write("xfrc_applied", ids, zero.expand(xfrc.shape[0], len(ids), 6), mask, 2)
