"""Post-constraint body accelerations and interaction forces.

PyTorch counterpart of mjlab_tpu/phys/rne_post.py: MuJoCo's
``mj_rnePostConstraint`` on env-first Data, as the accelerometer, force,
torque and frame-acceleration sensors read it. For every env:
  cacc      (E, nbody, 6)  spatial acceleration of each body in the
                           c-frame (origin subtree_com[root], world axes,
                           [rot(3), lin(3)]), gravity offset included;
  cfrc_int  (E, nbody, 6)  interaction force body <- parent, c-frame;
  cfrc_ext  (E, nbody, 6)  external force on the body (xfrc_applied and
                           contact forces), c-frame.
The limits are the JAX package's: the contact torque of condim > 3 is not
included, and the engine has no connect or weld equalities.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.phys.data import Data
from mjlab_tpu_torch.phys.math import cross, force_cross
from mjlab_tpu_torch.phys.model import DSBL_GRAVITY, Model, device_array


def rne_postconstraint(m: Model, d: Data):
    """(cacc, cfrc_int, cfrc_ext), each (E, nbody, 6)."""
    E = d.qpos.shape[0]
    dtype, dev = d.qpos.dtype, d.qpos.device
    nbody = m.nbody
    rootid = device_array(m, "body_rootid", lambda: m.body_rootid, torch.long)
    O_all = d.subtree_com[:, rootid]  # (E, nbody, 3)

    # cfrc_ext: xfrc_applied [force, torque] at the body com, world axes
    force = d.xfrc_applied[..., :3]
    torque = d.xfrc_applied[..., 3:]
    cfrc_ext = torch.cat([torque + cross(d.xipos - O_all, force), force], dim=-1)
    cfrc_ext[:, 0] = 0.0

    # contacts: the world force f at the contact point acts +f on the
    # second geom's body and -f on the first (MuJoCo's frame convention).
    # Each body's sum over the K compacted slots is a reduction over a
    # one-hot of the bodies that take part in contacts, not a scatter of
    # atomic adds, so that it is the same bit for bit on every run (a
    # captured step against its eager twin)
    if m.ncon_max and m.pairs.ncon:
        pt = m.pairs
        b1 = device_array(m, "slot_body1", lambda: m.geom_bodyid[pt.con_geom1], torch.long)
        b2 = device_array(m, "slot_body2", lambda: m.geom_bodyid[pt.con_geom2], torch.long)
        bodies = device_array(m, "contact_bodies", lambda: np.unique(np.concatenate(
            [m.geom_bodyid[pt.con_geom1], m.geom_bodyid[pt.con_geom2]])), torch.long)
        sel = d.con_sel.long()  # (E, K)
        cb1, cb2 = b1[sel], b2[sel]
        pos = d.con_packed_c[..., 2:5]
        f = torch.where(d.con_sel_active[..., None], d.con_force_c, 0.0)

        def spatial_at(bids):
            O = torch.take_along_dim(O_all, bids[..., None], dim=1)  # (E, K, 3)
            return torch.cat([cross(pos - O, f), f], dim=-1)

        on1 = (cb1[..., None] == bodies).to(dtype)[..., None]  # (E, K, C, 1)
        on2 = (cb2[..., None] == bodies).to(dtype)[..., None]
        per_body = (on2 * spatial_at(cb2)[:, :, None] - on1 * spatial_at(cb1)[:, :, None]).sum(1)
        cfrc_ext = cfrc_ext.index_add(1, bodies, per_body)  # each body once
        cfrc_ext[:, 0] = 0.0

    # cacc: forward pass from the world's -gravity
    if m.opt.disableflags & DSBL_GRAVITY:
        grav = torch.zeros(3, dtype=dtype, device=dev)
    else:
        grav = m.opt.gravity.to(dtype)
    cacc = [torch.cat([torch.zeros(3, dtype=dtype, device=dev), -grav]).expand(E, 6)]
    for b in range(1, nbody):
        a = cacc[int(m.body_parentid[b])]
        adr, num = int(m.body_dofadr[b]), int(m.body_dofnum[b])
        if num:
            sl = slice(adr, adr + num)
            a = (a + torch.einsum("evk,ev->ek", d.cdof_dot[:, sl], d.qvel[:, sl])
                 + torch.einsum("evk,ev->ek", d.cdof[:, sl], d.qacc[:, sl]))
        cacc.append(a)
    cacc = torch.stack(cacc, dim=1)  # (E, nbody, 6)

    # cfrc_int: each body's force balance, summed leaves to root
    Iv = torch.einsum("ebij,ebj->ebi", d.cinert, d.cvel)
    cfrc_body = (torch.einsum("ebij,ebj->ebi", d.cinert, cacc)
                 + force_cross(d.cvel, Iv) - cfrc_ext)
    cfrc = list(cfrc_body.unbind(1))
    for b in range(nbody - 1, 0, -1):
        pid = int(m.body_parentid[b])
        cfrc[pid] = cfrc[pid] + cfrc[b]
    return cacc, torch.stack(cfrc, dim=1), cfrc_ext


def object_velocity(pos, O, cvel, mat=None):
    """6D velocity [rot, lin] of the point pos of a body whose c-frame
    velocity is cvel about the origin O; in the frame mat when it is given
    (mj_objectVelocity with flg_local)."""
    ang = cvel[..., :3]
    lin = cvel[..., 3:] + cross(ang, pos - O)
    if mat is not None:
        ang = torch.einsum("...ji,...j->...i", mat, ang)
        lin = torch.einsum("...ji,...j->...i", mat, lin)
    return torch.cat([ang, lin], dim=-1)


def object_acceleration(pos, O, cvel, cacc, mat=None):
    """6D acceleration [rot, lin] of the point pos (mj_objectAcceleration):
    cacc moved to the point plus the convective term ang_vel x lin_vel; in
    the frame mat when it is given."""
    vel = object_velocity(pos, O, cvel)
    ang = cacc[..., :3]
    lin = cacc[..., 3:] + cross(ang, pos - O) + cross(vel[..., :3], vel[..., 3:])
    if mat is not None:
        ang = torch.einsum("...ji,...j->...i", mat, ang)
        lin = torch.einsum("...ji,...j->...i", mat, lin)
    return torch.cat([ang, lin], dim=-1)


def transform_force(frc, newpos, oldpos):
    """A spatial force [torque, force] moved from oldpos to newpos
    (mju_transformSpatial with flg_force)."""
    f = frc[..., 3:]
    return torch.cat([frc[..., :3] - cross(newpos - oldpos, f), f], dim=-1)
