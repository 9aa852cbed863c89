"""Env-last smooth stages: kinematics, com quantities, CRB mass matrix,
velocity/bias/passive forces and joint actuation, all as scalar planes.

PyTorch counterpart of mjlab_tpu/phys/lm/stages.py (mj_kinematics /
mj_comPos / mj_crb / mj_rne / mj_passive / mj_fwdActuation semantics).
These functions are the plain versions of the smooth CUDA kernels
(phys/smooth_kernels.py): the kernels walk the same tree in the same order
with the same formulas, one thread per env.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.phys.lm.base import (
    Params, force_cross, mat_mul, maximum, motion_cross, quat_mul,
    quat_normalize, quat_rot, quat_sub, quat_to_mat, vadd, vcross, vdot,
    vscale, vsub,
)
from mjlab_tpu_torch.phys.model import (
    DSBL_GRAVITY, JNT_BALL, JNT_FREE, JNT_HINGE, JNT_SLIDE, Model,
)


def ancestor_dof_mask(m: Model) -> np.ndarray:
    """W[b, i] = 1 if dof i is on the chain from world to body b."""
    W = np.zeros((m.nbody, m.nv), np.float64)
    for b in range(1, m.nbody):
        pid = int(m.body_parentid[b])
        W[b] = W[pid]
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        W[b, adr:adr + num] = 1.0
    return W


def crb_static(m: Model):
    """Static CRBA structure: subtree membership (nbody, nbody), per-dof
    body id, and the dof ancestor-pair mask U[i, j] = 1 iff dof i is on the
    chain from world to dof j's body (upper triangle)."""
    S = np.zeros((m.nbody, m.nbody), np.float64)
    for c in range(m.nbody - 1, -1, -1):
        S[c, c] = 1.0
        if c:
            S[int(m.body_parentid[c])] += S[c]
    dof_body = np.zeros(m.nv, np.int32)
    for b in range(m.nbody):
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        dof_body[adr:adr + num] = b
    U = np.triu(ancestor_dof_mask(m)[dof_body].T)
    return S, dof_body, U


def _p3(P: Params, name: str, i: int):
    return tuple(P.plane(name, i, k) for k in range(3))


def _p4(P: Params, name: str, i: int):
    return tuple(P.plane(name, i, k) for k in range(4))


def kinematics_lm(m: Model, P: Params, q, mocap_pos=(), mocap_quat=(),
                  geoms=None, sites=None):
    """q: tuple of nq (E,) planes; mocap_pos/mocap_quat: per mocap body a
    3-/4-tuple of planes, the frame that replaces the body's own.
    geoms/sites: static id subsets to compute frames for (None = all);
    unselected entries stay None."""
    geoms = range(m.ngeom) if geoms is None else geoms
    sites = range(m.nsite) if sites is None else sites
    zero = torch.zeros_like(q[0])
    one = torch.ones_like(zero)

    xpos = [(zero, zero, zero)]
    xquat = [(one, zero, zero, zero)]
    xanchor = [None] * m.njnt
    xaxis = [None] * m.njnt

    for b in range(1, m.nbody):
        pid = int(m.body_parentid[b])
        jadr = int(m.body_jntadr[b])
        jnum = int(m.body_jntnum[b])

        if jnum == 1 and int(m.jnt_type[jadr]) == JNT_FREE:
            qadr = int(m.jnt_qposadr[jadr])
            pos = (q[qadr], q[qadr + 1], q[qadr + 2])
            quat = quat_normalize(
                (q[qadr + 3], q[qadr + 4], q[qadr + 5], q[qadr + 6])
            )
            xanchor[jadr] = pos
            xaxis[jadr] = _p3(P, "jnt_axis", jadr)
        else:
            pos = vadd(xpos[pid], quat_rot(_p3(P, "body_pos", b), xquat[pid]))
            quat = quat_mul(xquat[pid], _p4(P, "body_quat", b))
            for k in range(jnum):
                j = jadr + k
                jtype = int(m.jnt_type[j])
                qadr = int(m.jnt_qposadr[j])
                anchor = vadd(pos, quat_rot(_p3(P, "jnt_pos", j), quat))
                if jtype == JNT_SLIDE:
                    axis_w = quat_rot(_p3(P, "jnt_axis", j), quat)
                    pos = vadd(
                        pos,
                        vscale(axis_w, q[qadr] - P.plane("qpos0", qadr)),
                    )
                elif jtype == JNT_HINGE:
                    angle = q[qadr] - P.plane("qpos0", qadr)
                    half = 0.5 * angle
                    s, c = torch.sin(half), torch.cos(half)
                    ax = _p3(P, "jnt_axis", j)
                    qloc = (c, ax[0] * s, ax[1] * s, ax[2] * s)
                    quat = quat_mul(quat, qloc)
                    pos = vsub(anchor, quat_rot(_p3(P, "jnt_pos", j), quat))
                elif jtype == JNT_BALL:
                    qloc = quat_normalize(
                        (q[qadr], q[qadr + 1], q[qadr + 2], q[qadr + 3])
                    )
                    quat = quat_mul(quat, qloc)
                    pos = vsub(anchor, quat_rot(_p3(P, "jnt_pos", j), quat))
                else:  # pragma: no cover
                    raise NotImplementedError(jtype)
                xanchor[j] = anchor
                xaxis[j] = quat_rot(_p3(P, "jnt_axis", j), quat)
            quat = quat_normalize(quat)
        mid = int(m.body_mocapid[b])
        if mid >= 0:
            pos = tuple(mocap_pos[mid])
            quat = quat_normalize(tuple(mocap_quat[mid]))
        xpos.append(pos)
        xquat.append(quat)

    xmat = [quat_to_mat(qq) for qq in xquat]
    xipos = [
        vadd(xpos[b], quat_rot(_p3(P, "body_ipos", b), xquat[b]))
        for b in range(m.nbody)
    ]
    ximat = [
        mat_mul(xmat[b], quat_to_mat(_p4(P, "body_iquat", b)))
        for b in range(m.nbody)
    ]

    geom_xpos = [None] * m.ngeom
    geom_xmat = [None] * m.ngeom
    for g in geoms:
        b = int(m.geom_bodyid[g])
        geom_xpos[g] = vadd(
            xpos[b], quat_rot(_p3(P, "geom_pos", g), xquat[b])
        )
        geom_xmat[g] = mat_mul(xmat[b], quat_to_mat(_p4(P, "geom_quat", g)))

    site_xpos = [None] * m.nsite
    site_xmat = [None] * m.nsite
    for s in sites:
        b = int(m.site_bodyid[s])
        site_xpos[s] = vadd(
            xpos[b], quat_rot(_p3(P, "site_pos", s), xquat[b])
        )
        site_xmat[s] = mat_mul(xmat[b], quat_to_mat(_p4(P, "site_quat", s)))

    for j in range(m.njnt):
        if xanchor[j] is None:
            xanchor[j] = (zero, zero, zero)
            xaxis[j] = (zero, zero, one)

    return dict(
        xpos=xpos, xquat=xquat, xmat=xmat, xipos=xipos, ximat=ximat,
        xanchor=xanchor, xaxis=xaxis,
        geom_xpos=geom_xpos, geom_xmat=geom_xmat,
        site_xpos=site_xpos, site_xmat=site_xmat,
    )


def com_pos_lm(m: Model, P: Params, k: dict):
    """Subtree CoMs, c-frame spatial inertias (sym-6 A, offset c, mass m
    per body) and cdof rows (6 planes per dof)."""
    nb = m.nbody
    mass = [P.plane("body_mass", b) for b in range(nb)]
    xipos = k["xipos"]

    sub_mom = [vscale(xipos[b], mass[b]) for b in range(nb)]
    sub_mass = list(mass)
    for b in range(nb - 1, 0, -1):
        pid = int(m.body_parentid[b])
        sub_mom[pid] = vadd(sub_mom[pid], sub_mom[b])
        sub_mass[pid] = sub_mass[pid] + sub_mass[b]
    subtree_com = [
        vscale(sub_mom[b], 1.0 / maximum(sub_mass[b], 1e-12))
        for b in range(nb)
    ]

    cinert = []
    for b in range(nb):
        R = k["ximat"][b]
        inertia = _p3(P, "body_inertia", b)
        # Iw = R diag(I) R^T, 6 unique entries
        Iw = {}
        for i in range(3):
            for j in range(i, 3):
                Iw[(i, j)] = (
                    R[3 * i + 0] * inertia[0] * R[3 * j + 0]
                    + R[3 * i + 1] * inertia[1] * R[3 * j + 1]
                    + R[3 * i + 2] * inertia[2] * R[3 * j + 2]
                )
        root = int(m.body_rootid[b])
        c = vsub(xipos[b], subtree_com[root])
        mb = mass[b]
        cx, cy, cz = c
        c2 = cx * cx + cy * cy + cz * cz
        cc = {
            (0, 0): cx * cx - c2, (0, 1): cx * cy, (0, 2): cx * cz,
            (1, 1): cy * cy - c2, (1, 2): cy * cz, (2, 2): cz * cz - c2,
        }
        A = {ij: Iw[ij] - mb * cc[ij] for ij in Iw}
        cinert.append(dict(A=A, c=c, m=mb))

    zero = torch.zeros_like(k["xpos"][0][0])
    one = torch.ones_like(zero)
    cdof = [None] * m.nv
    for j in range(m.njnt):
        jtype = int(m.jnt_type[j])
        b = int(m.jnt_bodyid[j])
        vadr = int(m.jnt_dofadr[j])
        O = subtree_com[int(m.body_rootid[b])]
        if jtype == JNT_FREE:
            cdof[vadr + 0] = (zero, zero, zero, one, zero, zero)
            cdof[vadr + 1] = (zero, zero, zero, zero, one, zero)
            cdof[vadr + 2] = (zero, zero, zero, zero, zero, one)
            offset = vsub(O, k["xpos"][b])
            R = k["xmat"][b]
            for i in range(3):
                ax = (R[i], R[3 + i], R[6 + i])
                cdof[vadr + 3 + i] = ax + vcross(ax, offset)
        elif jtype == JNT_BALL:
            offset = vsub(O, k["xanchor"][j])
            R = k["xmat"][b]
            for i in range(3):
                ax = (R[i], R[3 + i], R[6 + i])
                cdof[vadr + i] = ax + vcross(ax, offset)
        elif jtype == JNT_SLIDE:
            cdof[vadr] = (zero, zero, zero) + tuple(k["xaxis"][j])
        elif jtype == JNT_HINGE:
            ax = k["xaxis"][j]
            offset = vsub(O, k["xanchor"][j])
            cdof[vadr] = tuple(ax) + vcross(ax, offset)

    k.update(subtree_com=subtree_com, cinert=cinert, cdof=cdof)
    return k


def _spatial_mul(blk, s):
    """Composite-inertia block (A sym-6 dict, h = m c, m) @ motion s."""
    A, h, mb = blk["A"], blk["h"], blk["m"]
    w = s[:3]
    v = s[3:]
    ang = (
        A[(0, 0)] * w[0] + A[(0, 1)] * w[1] + A[(0, 2)] * w[2],
        A[(0, 1)] * w[0] + A[(1, 1)] * w[1] + A[(1, 2)] * w[2],
        A[(0, 2)] * w[0] + A[(1, 2)] * w[1] + A[(2, 2)] * w[2],
    )
    ang = vadd(ang, vcross(h, v))
    lin = vsub(vscale(v, mb), vcross(h, w))
    return ang + lin


def crb_lm(m: Model, P: Params, k: dict):
    """Composite-rigid-body mass matrix as ancestor-pair planes."""
    nb, nv = m.nbody, m.nv
    _, dof_body, U = crb_static(m)

    comp = []
    for b in range(nb):
        ci = k["cinert"][b]
        comp.append(dict(A=dict(ci["A"]), h=vscale(ci["c"], ci["m"]),
                         m=ci["m"]))
    for b in range(nb - 1, 0, -1):
        pid = int(m.body_parentid[b])
        for ij in comp[b]["A"]:
            comp[pid]["A"][ij] = comp[pid]["A"][ij] + comp[b]["A"][ij]
        comp[pid]["h"] = vadd(comp[pid]["h"], comp[b]["h"])
        comp[pid]["m"] = comp[pid]["m"] + comp[b]["m"]

    cdof = k["cdof"]
    f = [_spatial_mul(comp[int(dof_body[j])], cdof[j]) for j in range(nv)]

    Mu = {}
    for i in range(nv):
        for j in range(i, nv):
            if U[i, j]:
                Mu[(i, j)] = vdot(cdof[i], f[j])
    for i in range(nv):
        Mu[(i, i)] = Mu[(i, i)] + P.plane("dof_armature", i)

    k.update(qM=Mu)
    return k


def com_vel_lm(m: Model, P: Params, k: dict, qvel):
    """Body spatial velocities and cdof_dot planes."""
    zero = torch.zeros_like(qvel[0])
    z6 = (zero,) * 6
    cvel = [z6]
    cdof_dot = [z6] * m.nv
    cdof = k["cdof"]

    def add_dof(v, i):
        return tuple(vi + ci * qvel[i] for vi, ci in zip(v, cdof[i]))

    for b in range(1, m.nbody):
        pid = int(m.body_parentid[b])
        v = cvel[pid]
        jadr, jnum = int(m.body_jntadr[b]), int(m.body_jntnum[b])
        for kk in range(jnum):
            j = jadr + kk
            jtype = int(m.jnt_type[j])
            vadr = int(m.jnt_dofadr[j])
            if jtype == JNT_FREE:
                for i in range(3):
                    v = add_dof(v, vadr + i)
                for i in range(3, 6):
                    cdof_dot[vadr + i] = motion_cross(v, cdof[vadr + i])
                for i in range(3, 6):
                    v = add_dof(v, vadr + i)
            elif jtype == JNT_BALL:
                for i in range(3):
                    cdof_dot[vadr + i] = motion_cross(v, cdof[vadr + i])
                for i in range(3):
                    v = add_dof(v, vadr + i)
            else:
                cdof_dot[vadr] = motion_cross(v, cdof[vadr])
                v = add_dof(v, vadr)
        cvel.append(v)

    k.update(cvel=cvel, cdof_dot=cdof_dot)
    return k


def _cinert_mul(ci, s):
    """Single-body cinert block @ motion (blocks A, c, m)."""
    return _spatial_mul(dict(A=ci["A"], h=vscale(ci["c"], ci["m"]),
                             m=ci["m"]), s)


def rne_lm(m: Model, P: Params, k: dict, qvel, gravity3):
    """qfrc_bias via recursive Newton-Euler, no acceleration term.
    gravity3: 3-tuple of floats."""
    zero = torch.zeros_like(qvel[0])
    if m.opt.disableflags & DSBL_GRAVITY:
        cacc0 = (zero,) * 6
    else:
        cacc0 = (
            zero, zero, zero,
            zero - gravity3[0], zero - gravity3[1], zero - gravity3[2],
        )

    cacc = [cacc0]
    cdof = k["cdof"]
    cdof_dot = k["cdof_dot"]
    for b in range(1, m.nbody):
        pid = int(m.body_parentid[b])
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        a = cacc[pid]
        for i in range(num):
            a = tuple(
                ai + ci * qvel[adr + i]
                for ai, ci in zip(a, cdof_dot[adr + i])
            )
        cacc.append(a)

    cfrc = []
    for b in range(m.nbody):
        ci = k["cinert"][b]
        Iv = _cinert_mul(ci, k["cvel"][b])
        cfrc.append(tuple(
            x + y for x, y in zip(
                _cinert_mul(ci, cacc[b]), force_cross(k["cvel"][b], Iv)
            )
        ))

    for b in range(m.nbody - 1, 0, -1):
        pid = int(m.body_parentid[b])
        cfrc[pid] = tuple(x + y for x, y in zip(cfrc[pid], cfrc[b]))

    qfrc_bias = [zero] * m.nv
    for b in range(1, m.nbody):
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        for i in range(num):
            qfrc_bias[adr + i] = vdot(cdof[adr + i], cfrc[b])

    k.update(qfrc_bias=qfrc_bias)
    return k


def passive_lm(m: Model, P: Params, k: dict, q, qvel):
    """Passive spring/damper forces (no tendons)."""
    qfrc = [-P.plane("dof_damping", i) * qvel[i] for i in range(m.nv)]
    for j in range(m.njnt):
        jtype = int(m.jnt_type[j])
        qadr = int(m.jnt_qposadr[j])
        vadr = int(m.jnt_dofadr[j])
        kstiff = P.plane("jnt_stiffness", j)
        if isinstance(kstiff, float) and kstiff == 0.0:  # structurally-zero spring
            continue
        if jtype in (JNT_HINGE, JNT_SLIDE):
            qfrc[vadr] = qfrc[vadr] - kstiff * (
                q[qadr] - P.plane("qpos_spring", qadr)
            )
        elif jtype == JNT_FREE:
            for i in range(3):
                qfrc[vadr + i] = qfrc[vadr + i] - kstiff * (
                    q[qadr + i] - P.plane("qpos_spring", qadr + i)
                )
            dif = quat_sub(
                tuple(q[qadr + 3 + i] for i in range(4)),
                tuple(P.plane("qpos_spring", qadr + 3 + i) for i in range(4)),
            )
            for i in range(3):
                qfrc[vadr + 3 + i] = qfrc[vadr + 3 + i] - kstiff * dif[i]
        elif jtype == JNT_BALL:
            dif = quat_sub(
                tuple(q[qadr + i] for i in range(4)),
                tuple(P.plane("qpos_spring", qadr + i) for i in range(4)),
            )
            for i in range(3):
                qfrc[vadr + i] = qfrc[vadr + i] - kstiff * dif[i]
    k.update(qfrc_passive=qfrc)
    return k


def _ctrl_clipped(m: Model, P: Params, ctrl, u):
    c = ctrl[u]
    if int(m.actuator_ctrllimited[u]):
        c = torch.clamp(
            c,
            P.plane("actuator_ctrlrange", u, 0),
            P.plane("actuator_ctrlrange", u, 1),
        )
    return c


def actuation_lm(m: Model, P: Params, k: dict, q, qvel, ctrl):
    """Joint-transmission actuators on hinge/slide joints, no activation
    states."""
    zero = torch.zeros_like(qvel[0])
    qfrc_actuator = [zero] * m.nv
    act_force = []
    act_vel = []
    for u in range(m.nu):
        j = int(m.actuator_trnid[u, 0])
        qadr = int(m.jnt_qposadr[j])
        vadr = int(m.jnt_dofadr[j])
        gear = P.plane("actuator_gear", u, 0)
        length = q[qadr] * gear
        vel = qvel[vadr] * gear
        c = _ctrl_clipped(m, P, ctrl, u)
        if int(m.actuator_gaintype[u]) == 1:
            gain = (
                P.plane("actuator_gainprm", u, 0)
                + P.plane("actuator_gainprm", u, 1) * length
                + P.plane("actuator_gainprm", u, 2) * vel
            )
        else:
            gain = P.plane("actuator_gainprm", u, 0)
        if int(m.actuator_biastype[u]) == 1:
            bias = (
                P.plane("actuator_biasprm", u, 0)
                + P.plane("actuator_biasprm", u, 1) * length
                + P.plane("actuator_biasprm", u, 2) * vel
            )
        else:
            bias = 0.0
        force = gain * c + bias
        if int(m.actuator_forcelimited[u]):
            force = torch.clamp(
                force,
                P.plane("actuator_forcerange", u, 0),
                P.plane("actuator_forcerange", u, 1),
            )
        act_force.append(force)
        act_vel.append(vel)
        qfrc_actuator[vadr] = qfrc_actuator[vadr] + force * gear
    k.update(
        qfrc_actuator=qfrc_actuator,
        actuator_force=act_force,
        actuator_velocity=act_vel,
    )
    return k


def actuator_vel_deriv_lm(m: Model, P: Params, ctrl, actuator_force):
    """Per-actuator dF/dv planes (None where structurally zero); zero where
    the force is saturated (mjd_smooth_vel semantics)."""
    out = []
    for u in range(m.nu):
        f = actuator_force[u]
        dfdv = None
        if int(m.actuator_biastype[u]) == 1:
            dfdv = torch.zeros_like(f) + P.plane("actuator_biasprm", u, 2)
        if int(m.actuator_gaintype[u]) == 1:
            t = P.plane("actuator_gainprm", u, 2) * _ctrl_clipped(
                m, P, ctrl, u
            )
            dfdv = t if dfdv is None else dfdv + t
        if dfdv is not None and int(m.actuator_forcelimited[u]):
            lo = P.plane("actuator_forcerange", u, 0)
            hi = P.plane("actuator_forcerange", u, 1)
            dfdv = torch.where((f <= lo) | (f >= hi), 0.0, dfdv)
        out.append(dfdv)
    return out


def xfrc_lm(m: Model, P: Params, k: dict, xfrc):
    """Project xfrc_applied (per body 6 planes [force, torque]) into qfrc
    planes."""
    cdof = k["cdof"]
    out = [None] * m.nv
    W = ancestor_dof_mask(m)
    for b in range(1, m.nbody):
        f = xfrc[b][:3]
        t = xfrc[b][3:]
        O = k["subtree_com"][int(m.body_rootid[b])]
        offset = vsub(k["xipos"][b], O)
        ang = vadd(t, vcross(offset, f))
        s = ang + f
        for i in range(m.nv):
            if W[b, i]:
                contrib = vdot(cdof[i], s)
                out[i] = contrib if out[i] is None else out[i] + contrib
    zero = torch.zeros_like(k["subtree_com"][0][0])
    return [o if o is not None else zero for o in out]
