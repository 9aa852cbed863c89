"""Forward kinematics and com-frame quantities over every env, env-first.

PyTorch counterpart of mjlab_tpu/phys/kinematics.py (mj_kinematics /
mj_comPos semantics) under jax.vmap: every Data field keeps its leading
env axis, and the body loop walks the static kinematic tree once for all
envs. These stages write the whole position surface that
Simulation.forward() exposes (body, inertial, joint-anchor/axis, geom and
site frames, subtree_com, cinert, cdof); the step runs the env-last kernel
path instead (phys/smooth_kernels.py).
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.phys import math
from mjlab_tpu_torch.phys.data import Data
from mjlab_tpu_torch.phys.model import (
    JNT_BALL, JNT_FREE, JNT_HINGE, JNT_SLIDE, Model, device_array,
)


def kinematics(m: Model, d: Data) -> Data:
    """Global positions and orientations of bodies, joints, geoms, sites."""
    qpos = d.qpos
    E = qpos.shape[0]
    dt, dev = qpos.dtype, qpos.device

    xpos = [torch.zeros(E, 3, dtype=dt, device=dev)]
    xquat = [torch.tensor([1.0, 0, 0, 0], dtype=dt, device=dev).expand(E, 4)]
    zero3 = torch.zeros(E, 3, dtype=dt, device=dev)
    xanchor = [zero3] * m.njnt
    xaxis = [zero3] * m.njnt

    for b in range(1, m.nbody):
        pid = int(m.body_parentid[b])
        jadr = int(m.body_jntadr[b])
        jnum = int(m.body_jntnum[b])

        if jnum == 1 and int(m.jnt_type[jadr]) == JNT_FREE:
            qadr = int(m.jnt_qposadr[jadr])
            pos = qpos[:, qadr:qadr + 3]
            quat = math.normalize_quat(qpos[:, qadr + 3:qadr + 7])
            xanchor[jadr] = pos
            xaxis[jadr] = m.jnt_axis[jadr].expand(E, 3)  # meaningless for free
        else:
            pos = xpos[pid] + math.rot_vec_quat(m.body_pos[b], xquat[pid])
            quat = math.mul_quat(xquat[pid], m.body_quat[b])
            for k in range(jnum):
                j = jadr + k
                jtype = int(m.jnt_type[j])
                qadr = int(m.jnt_qposadr[j])
                anchor = pos + math.rot_vec_quat(m.jnt_pos[j], quat)
                if jtype == JNT_SLIDE:
                    axis_w = math.rot_vec_quat(m.jnt_axis[j], quat)
                    pos = pos + axis_w * (qpos[:, qadr:qadr + 1] - m.qpos0[qadr])
                elif jtype == JNT_HINGE:
                    angle = qpos[:, qadr] - m.qpos0[qadr]
                    qloc = math.axis_angle_to_quat(m.jnt_axis[j], angle)
                    quat = math.mul_quat(quat, qloc)
                    pos = anchor - math.rot_vec_quat(m.jnt_pos[j], quat)
                elif jtype == JNT_BALL:
                    qloc = math.normalize_quat(qpos[:, qadr:qadr + 4])
                    quat = math.mul_quat(quat, qloc)
                    pos = anchor - math.rot_vec_quat(m.jnt_pos[j], quat)
                else:  # pragma: no cover
                    raise NotImplementedError(jtype)
                xanchor[j] = anchor
                xaxis[j] = math.rot_vec_quat(m.jnt_axis[j], quat)
            quat = math.normalize_quat(quat)

        mid = int(m.body_mocapid[b])
        if mid >= 0:
            pos = d.mocap_pos[:, mid]
            quat = math.normalize_quat(d.mocap_quat[:, mid])
        xpos.append(pos)
        xquat.append(quat)

    xpos = torch.stack(xpos, dim=1)  # (E, nbody, 3)
    xquat = torch.stack(xquat, dim=1)
    xmat = math.quat_to_mat(xquat)
    stack = lambda xs: (torch.stack(xs, dim=1) if xs  # noqa: E731
                        else torch.zeros(E, 0, 3, dtype=dt, device=dev))

    gb = device_array(m, "geom_bodyid", lambda: m.geom_bodyid, torch.long)
    geom_xpos = xpos[:, gb] + math.rot_vec_quat(m.geom_pos, xquat[:, gb])
    geom_xmat = xmat[:, gb] @ math.quat_to_mat(m.geom_quat)
    if m.nsite:
        sb = device_array(m, "site_bodyid", lambda: m.site_bodyid, torch.long)
        site_xpos = xpos[:, sb] + math.rot_vec_quat(m.site_pos, xquat[:, sb])
        site_xmat = xmat[:, sb] @ math.quat_to_mat(m.site_quat)
    else:
        site_xpos = torch.zeros(E, 0, 3, dtype=dt, device=dev)
        site_xmat = torch.zeros(E, 0, 3, 3, dtype=dt, device=dev)

    return d.replace(
        xpos=xpos, xquat=xquat, xmat=xmat,
        xipos=xpos + math.rot_vec_quat(m.body_ipos, xquat),
        ximat=xmat @ math.quat_to_mat(m.body_iquat),
        xanchor=stack(xanchor), xaxis=stack(xaxis),
        geom_xpos=geom_xpos, geom_xmat=geom_xmat,
        site_xpos=site_xpos, site_xmat=site_xmat,
    )


def com_pos(m: Model, d: Data) -> Data:
    """Subtree CoMs, com-frame spatial inertias and dof motion subspaces."""
    E = d.qpos.shape[0]
    dt, dev = d.qpos.dtype, d.qpos.device

    # subtree com: backward accumulation over the tree
    mass = m.body_mass
    mom = d.xipos * mass[:, None]
    sub_mom = list(mom.unbind(1))
    sub_mass = list(mass.unbind(0))
    for b in range(m.nbody - 1, 0, -1):
        pid = int(m.body_parentid[b])
        sub_mom[pid] = sub_mom[pid] + sub_mom[b]
        sub_mass[pid] = sub_mass[pid] + sub_mass[b]
    sub_mom = torch.stack(sub_mom, dim=1)
    sub_mass = torch.stack(sub_mass)
    subtree_com = sub_mom / torch.clamp(sub_mass, min=1e-12)[:, None]

    # spatial inertia of each body about its tree root's subtree com;
    # I_c[i, j] = sum_k a_k R_ik R_jk
    root = device_array(m, "body_rootid", lambda: m.body_rootid, torch.long)
    Ra = d.ximat * m.body_inertia[..., None, :]
    inertia_c = torch.stack(
        [torch.sum(Ra[..., i, :] * d.ximat[..., j, :], dim=-1)
         for i in range(3) for j in range(3)],
        dim=-1,
    ).reshape(d.ximat.shape)
    cinert = math.spatial_inertia(
        m.body_mass.expand(E, m.nbody), inertia_c,
        d.xipos - subtree_com[:, root],
    )

    # cdof rows in dof order (dof order follows joint order)
    rows = []
    for j in range(m.njnt):
        jtype = int(m.jnt_type[j])
        b = int(m.jnt_bodyid[j])
        O = subtree_com[:, int(m.body_rootid[b])]
        if jtype == JNT_FREE:
            eye = torch.eye(3, dtype=dt, device=dev)
            rows.append(torch.cat(
                [torch.zeros(3, 3, dtype=dt, device=dev), eye], dim=1
            ).expand(E, 3, 6))
            ax = d.xmat[:, b].transpose(-1, -2)  # (E, 3 axes, 3)
            offset = (O - d.xpos[:, b])[:, None]
            rows.append(torch.cat([ax, math.cross(ax, offset)], dim=-1))
        elif jtype == JNT_BALL:
            ax = d.xmat[:, b].transpose(-1, -2)
            offset = (O - d.xanchor[:, j])[:, None]
            rows.append(torch.cat([ax, math.cross(ax, offset)], dim=-1))
        elif jtype == JNT_SLIDE:
            rows.append(torch.cat(
                [torch.zeros(E, 3, dtype=dt, device=dev), d.xaxis[:, j]], dim=-1
            )[:, None])
        elif jtype == JNT_HINGE:
            ax = d.xaxis[:, j]
            offset = O - d.xanchor[:, j]
            rows.append(torch.cat([ax, math.cross(ax, offset)], dim=-1)[:, None])
    cdof = (torch.cat(rows, dim=1) if rows
            else torch.zeros(E, m.nv, 6, dtype=dt, device=dev))
    return d.replace(subtree_com=subtree_com, cinert=cinert, cdof=cdof)
