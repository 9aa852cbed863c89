"""Smooth (unconstrained) dynamics over every env, env-first: mass matrix
and its factor, velocities, bias and passive forces, transmission and
actuation.

PyTorch counterpart of mjlab_tpu/phys/smooth.py (mj_crb / mj_comVel /
mj_rne / mj_passive / mj_transmission / mj_fwdActuation semantics) under
jax.vmap. Model fields are shared by every env; tendons and activation
states are not carried (Simulation refuses them).
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.phys import linalg, math
from mjlab_tpu_torch.phys.data import Data
from mjlab_tpu_torch.phys.lm.stages import ancestor_dof_mask, crb_static
from mjlab_tpu_torch.phys.model import (
    DSBL_GRAVITY, JNT_BALL, JNT_FREE, JNT_HINGE, JNT_SLIDE, TRN_JOINT, Model,
    cached, device_array,
)


def crb(m: Model, d: Data, factor: bool = True) -> Data:
    """Dense joint-space inertia qM (composite rigid bodies), and with
    factor its Cholesky factor qLD and the factor's inverse qLDinv."""
    dt = d.qpos.dtype
    S, dof_body, U = _crb_tables(m, dt)
    Ic = torch.einsum("bc,eckl->ebkl", S, d.cinert)  # subtree inertias
    f = torch.einsum("ejkl,ejl->ejk", Ic[:, dof_body], d.cdof)
    upper = (d.cdof @ f.transpose(-1, -2)) * U
    qM = (upper + upper.transpose(-1, -2)
          - torch.diag_embed(torch.diagonal(upper, dim1=-2, dim2=-1)))
    qM = qM + torch.diag(m.dof_armature)
    if not factor:
        return d.replace(qM=qM)
    qLD = linalg.chol_factor(qM)
    return d.replace(qM=qM, qLD=qLD, qLDinv=linalg.tri_inv(qLD))


def _crb_tables(m: Model, dt: torch.dtype):
    """(S (nbody, nbody), dof_body (nv,) long, U (nv, nv)) on the model's
    device, built once per Model."""
    def make():
        S, dof_body, U = crb_static(m)
        t = lambda x, ty: torch.as_tensor(x, dtype=ty, device=m.device)  # noqa: E731
        return t(S, dt), t(dof_body, torch.long), t(U, dt)

    return cached(m, ("crb_tables", dt), make)


def solve_m(d: Data, x: torch.Tensor) -> torch.Tensor:
    """M y = x from the inverted Cholesky factor, one refinement step
    against qM."""
    return linalg.chol_solve_inv(d.qLDinv, x, d.qM)


def com_vel(m: Model, d: Data) -> Data:
    """Body spatial velocities (c-frame) and cdof time derivatives."""
    E = d.qpos.shape[0]
    zero6 = d.qpos.new_zeros(E, 6)
    cvel = [zero6]
    cdof_dot = [zero6] * m.nv
    cdof, qvel = d.cdof, d.qvel

    def acc(v, a, n):  # v + sum_i cdof[a + i] qvel[a + i]
        return v + torch.einsum("eic,ei->ec", cdof[:, a:a + n], qvel[:, a:a + n])

    for b in range(1, m.nbody):
        v = cvel[int(m.body_parentid[b])]
        jadr, jnum = int(m.body_jntadr[b]), int(m.body_jntnum[b])
        for k in range(jnum):
            j = jadr + k
            jtype = int(m.jnt_type[j])
            vadr = int(m.jnt_dofadr[j])
            if jtype == JNT_FREE:
                # translation dofs: derivative zero (world-aligned)
                v = acc(v, vadr, 3)
                for i in range(3, 6):
                    cdof_dot[vadr + i] = math.motion_cross(v, cdof[:, vadr + i])
                v = acc(v, vadr + 3, 3)
            elif jtype == JNT_BALL:
                for i in range(3):
                    cdof_dot[vadr + i] = math.motion_cross(v, cdof[:, vadr + i])
                v = acc(v, vadr, 3)
            else:
                cdof_dot[vadr] = math.motion_cross(v, cdof[:, vadr])
                v = v + cdof[:, vadr] * qvel[:, vadr, None]
        cvel.append(v)
    return d.replace(
        cvel=torch.stack(cvel, dim=1),
        cdof_dot=(torch.stack(cdof_dot, dim=1) if m.nv
                  else d.qpos.new_zeros(E, 0, 6)),
    )


def rne(m: Model, d: Data) -> Data:
    """Bias force qfrc_bias = C(qpos, qvel) by recursive Newton-Euler
    (gravity as base acceleration, no qacc term)."""
    E = d.qpos.shape[0]
    gravity = m.opt.gravity.to(d.qpos.dtype)
    if m.opt.disableflags & DSBL_GRAVITY:
        gravity = torch.zeros_like(gravity)
    cacc = [torch.cat([torch.zeros_like(gravity), -gravity]).expand(E, 6)]
    for b in range(1, m.nbody):
        a = cacc[int(m.body_parentid[b])]
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        if num:
            a = a + torch.einsum("eic,ei->ec", d.cdof_dot[:, adr:adr + num],
                                 d.qvel[:, adr:adr + num])
        cacc.append(a)
    cacc = torch.stack(cacc, dim=1)

    Iv = torch.einsum("ebij,ebj->ebi", d.cinert, d.cvel)
    cfrc_body = (torch.einsum("ebij,ebj->ebi", d.cinert, cacc)
                 + math.force_cross(d.cvel, Iv))
    cfrc = list(cfrc_body.unbind(1))
    for b in range(m.nbody - 1, 0, -1):
        pid = int(m.body_parentid[b])
        cfrc[pid] = cfrc[pid] + cfrc[b]

    parts = []
    for b in range(1, m.nbody):
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        if num:
            parts.append((adr, torch.einsum(
                "eic,ec->ei", d.cdof[:, adr:adr + num], cfrc[b])))
    qfrc_bias = d.qpos.new_zeros(E, m.nv)
    for adr, val in parts:
        qfrc_bias[:, adr:adr + val.shape[1]] = val
    return d.replace(qfrc_bias=qfrc_bias)


def passive(m: Model, d: Data) -> Data:
    """Joint springs and dampers (no tendons, no fluid forces)."""
    qfrc = -m.dof_damping * d.qvel
    spring = torch.zeros_like(qfrc)
    for j in range(m.njnt):
        jtype = int(m.jnt_type[j])
        qadr = int(m.jnt_qposadr[j])
        vadr = int(m.jnt_dofadr[j])
        k = m.jnt_stiffness[j]
        if jtype in (JNT_HINGE, JNT_SLIDE):
            spring[:, vadr] = -k * (d.qpos[:, qadr] - m.qpos_spring[qadr])
        elif jtype == JNT_FREE:
            spring[:, vadr:vadr + 3] = -k * (
                d.qpos[:, qadr:qadr + 3] - m.qpos_spring[qadr:qadr + 3])
            dif = math.quat_sub(d.qpos[:, qadr + 3:qadr + 7],
                                m.qpos_spring[qadr + 3:qadr + 7])
            spring[:, vadr + 3:vadr + 6] = -k * dif
        elif jtype == JNT_BALL:
            dif = math.quat_sub(d.qpos[:, qadr:qadr + 4],
                                m.qpos_spring[qadr:qadr + 4])
            spring[:, vadr:vadr + 3] = -k * dif
    return d.replace(qfrc_passive=qfrc + spring)


def _moment(m: Model) -> np.ndarray:
    """Static (nu, nv) joint-transmission selector (hinge/slide joints)."""
    sel = np.zeros((m.nu, m.nv))
    for u in range(m.nu):
        if int(m.actuator_trntype[u]) != TRN_JOINT:
            raise NotImplementedError("only joint transmissions are ported")
        j = int(m.actuator_trnid[u, 0])
        if int(m.jnt_type[j]) not in (JNT_HINGE, JNT_SLIDE):
            raise NotImplementedError("actuated free/ball joints are not ported")
        sel[u, int(m.jnt_dofadr[j])] = 1.0
    return sel


def transmission(m: Model, d: Data) -> Data:
    """Actuator lengths and the dense (nu, nv) moment matrix."""
    if m.nu == 0:
        return d
    E = d.qpos.shape[0]
    gear = m.actuator_gear[:, 0]
    moment = device_array(m, "moment", lambda: _moment(m), d.qpos.dtype) * gear[:, None]
    qadr = device_array(
        m, "actuator_qposadr",
        lambda: m.jnt_qposadr[m.actuator_trnid[:, 0]], torch.long,
    )
    return d.replace(actuator_moment=moment.expand(E, m.nu, m.nv),
                     actuator_length=d.qpos[:, qadr] * gear)


def _flag(m: Model, name: str) -> torch.Tensor:
    """A static per-actuator flag as a bool tensor on the model's device."""
    return device_array(m, name, lambda: getattr(m, name).astype(bool))


def actuation_input(m: Model, d: Data) -> tuple[torch.Tensor, torch.Tensor]:
    """(force input per actuator, act_dot): the clamped ctrl (no
    activation states)."""
    if m.na:
        raise NotImplementedError("activation states (na > 0) are not ported yet")
    rng = m.actuator_ctrlrange
    ctrl = torch.where(
        _flag(m, "actuator_ctrllimited"),
        torch.clamp(d.ctrl, rng[:, 0], rng[:, 1]), d.ctrl,
    )
    return ctrl, d.act_dot


def fwd_actuation(m: Model, d: Data) -> Data:
    """Actuator forces: gain * input + bias, clamped, through the moments."""
    if m.nu == 0:
        return d.replace(qfrc_actuator=torch.zeros_like(d.qvel))
    ctrl, act_dot = actuation_input(m, d)
    velocity = torch.einsum("euv,ev->eu", d.actuator_moment, d.qvel)
    gp, bp = m.actuator_gainprm, m.actuator_biasprm
    length = d.actuator_length
    gain = torch.where(
        device_array(m, "gain_affine", lambda: m.actuator_gaintype == 1),
        gp[:, 0] + gp[:, 1] * length + gp[:, 2] * velocity, gp[:, 0],
    )
    bias = torch.where(
        device_array(m, "bias_affine", lambda: m.actuator_biastype == 1),
        bp[:, 0] + bp[:, 1] * length + bp[:, 2] * velocity, 0.0,
    )
    force = gain * ctrl + bias
    fr = m.actuator_forcerange  # (nu, 2), or (E, nu, 2) per env
    force = torch.where(_flag(m, "actuator_forcelimited"),
                        torch.clamp(force, fr[..., 0], fr[..., 1]), force)
    return d.replace(
        actuator_velocity=velocity, actuator_force=force,
        qfrc_actuator=torch.einsum("euv,eu->ev", d.actuator_moment, force),
        act_dot=act_dot,
    )


def xfrc_accumulate(m: Model, d: Data) -> torch.Tensor:
    """xfrc_applied (world force/torque at each body's CoM) as qfrc."""
    if m.nbody == 1:
        return torch.zeros_like(d.qvel)
    W = device_array(m, "ancestor_dof_mask", lambda: ancestor_dof_mask(m), d.qpos.dtype)
    root = device_array(m, "body_rootid", lambda: m.body_rootid, torch.long)
    force = d.xfrc_applied[..., :3]
    ang = d.xfrc_applied[..., 3:] + math.cross(d.xipos - d.subtree_com[:, root], force)
    s = torch.cat([ang, force], dim=-1)  # (E, nbody, 6) at the c-frame origin
    return torch.einsum("bi,eik,ebk->ei", W, d.cdof, s)
