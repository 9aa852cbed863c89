"""Env-last constraint rows, both friction cones.

PyTorch counterpart of mjlab_tpu/phys/lm/constraint.py in its two modes.
Row layout [joint equality][dof friction][joint limits][contacts]. In
kernel mode (``assemble_j=False``, the step) the dense contact Jacobian is
not built: the fused solve kernel rebuilds it from the compact per-slot
tensors (positions, frames, ancestor dof masks, and the friction
coefficients (pyramidal) or friction-row D values and the whitened cone
coefficient (elliptic)). With ``assemble_j=True`` (Simulation.forward) the
contact rows are built here: the dense Jacobian efc_Jc and the contact
slices of efc_D and efc_aref.

Top-K compaction keeps, per env, the K slots with the lowest score
(dist - includemargin), lower slot index first on ties: the first K of a
stable ascending sort, the order jax.lax.top_k gives on the negated score.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.phys.lm.collision import slot_params
from mjlab_tpu_torch.phys.lm.stages import ancestor_dof_mask
from mjlab_tpu_torch.phys.model import (
    CONE_PYRAMIDAL, JNT_HINGE, JNT_SLIDE, Model, cached, device_array,
)

# contact dimension each friction direction needs: t1, t2 (3), torsion
# (4), roll1, roll2 (6)
_DIR_NEED = (3, 3, 4, 6, 6)

_MINVAL = 1e-10


def _impedance(si, pos):
    """si: (..., 5, Eb); pos (..., E)."""
    dmin, dmax, width = si[..., 0, :], si[..., 1, :], si[..., 2, :]
    mid = torch.clamp(si[..., 3, :], 0.0001, 0.9999)
    power = torch.clamp(si[..., 4, :], min=1.0)
    x = torch.clamp(
        torch.abs(pos) / torch.clamp(width, min=_MINVAL), 0.0, 1.0
    )
    y_low = torch.pow(x, power) / torch.pow(mid, power - 1.0)
    y_high = 1.0 - torch.pow(1.0 - x, power) / torch.pow(
        1.0 - mid, power - 1.0
    )
    y = torch.where(x <= mid, y_low, y_high)
    return torch.clamp(dmin + y * (dmax - dmin), _MINVAL, 1.0 - _MINVAL)


def _kb(sr, si):
    dmax = si[..., 1, :]
    timeconst, dampratio = sr[..., 0, :], sr[..., 1, :]
    std = timeconst > 0
    b = torch.where(
        std, 2.0 / torch.clamp(dmax * timeconst, min=_MINVAL), -dampratio
    )
    k = torch.where(
        std,
        1.0 / torch.clamp(
            dmax * dmax * timeconst * timeconst * dampratio * dampratio,
            min=_MINVAL,
        ),
        -timeconst,
    )
    return k, b


def _efc_kbid(sr, si, pos, diag_approx):
    imp = _impedance(si, pos)
    k, b = _kb(sr, si)
    R = torch.clamp((1.0 - imp) / imp * diag_approx, min=_MINVAL)
    return imp, k, b, 1.0 / R


def topk_lowest(score: torch.Tensor, K: int) -> tuple[torch.Tensor, torch.Tensor]:
    """score (S, E) -> (values (K, E), slot ids (K, E) int64): the K lowest
    scores per env, lower slot index first on ties."""
    vals, idx = torch.sort(score.T, dim=1, stable=True)
    return vals[:, :K].T, idx[:, :K].T


def _take(arr: torch.Tensor, sel: torch.Tensor) -> torch.Tensor:
    """Rows of env-last arr (S, F, E) at per-env slot ids sel (K, E)."""
    F = arr.shape[1]
    idx = sel[:, None, :].expand(sel.shape[0], F, sel.shape[1])
    return torch.gather(arr, 0, idx)


def _contact_rows(m: Model, cdof, pos_k, frame_k, W1, W2, O1, O2, mu_dirs):
    """Dense contact rows (K, R, nv, E) of every slot (activity not yet
    applied): the contact frame's rows of the point Jacobian
    J2 - J1 (body 2 minus body 1, each about its tree root's subtree com),
    then of the angular Jacobian for torsion and rolling. Pyramidal rows
    are [n + mu_i d_i, n - mu_i d_i] per friction direction d_i; elliptic
    rows are [n, t1, t2, torsion, roll1, roll2][:R]."""
    K, E = pos_k.shape[0], pos_k.shape[-1]
    R = m.rows_per_con
    elliptic = int(m.opt.cone) != CONE_PYRAMIDAL
    ndirs = R - 1 if elliptic else R // 2
    cd_ang, cd_lin = cdof[None, :, :3], cdof[None, :, 3:]  # (1, nv, 3, E)
    w1, w2 = W1.permute(1, 0, 2), W2.permute(1, 0, 2)  # (K, nv, E)

    def point_jac(w, O):
        r = (pos_k - O.permute(1, 0, 2))[:, None]  # (K, 1, 3, E)
        a = cd_ang
        cx = torch.stack(
            [
                a[:, :, 1] * r[:, :, 2] - a[:, :, 2] * r[:, :, 1],
                a[:, :, 2] * r[:, :, 0] - a[:, :, 0] * r[:, :, 2],
                a[:, :, 0] * r[:, :, 1] - a[:, :, 1] * r[:, :, 0],
            ],
            dim=2,
        )
        return (cd_lin + cx) * w[:, :, None]  # (K, nv, 3, E)

    fr = frame_k.reshape(K, 3, 3, E)
    jacd = point_jac(w2, O2) - point_jac(w1, O1)
    Jc3 = torch.einsum("kfxe,kvxe->kfve", fr, jacd)  # (K, 3, nv, E)
    Jn = Jc3[:, 0]
    dirJ = [Jc3[:, 1], Jc3[:, 2]]
    if ndirs > 2:
        Ja = torch.einsum("kfxe,kvxe->kfve", fr, cd_ang * (w2 - w1)[:, :, None])
        dirJ += [Ja[:, 0], Ja[:, 1], Ja[:, 2]][:ndirs - 2]
    if elliptic:
        rows = [Jn] + dirJ[:ndirs]
    else:
        rows = []
        for i in range(ndirs):
            rows.append(Jn + mu_dirs[:, i, None] * dirJ[i])
            rows.append(Jn - mu_dirs[:, i, None] * dirJ[i])
    return torch.stack(rows, dim=1)


def make_constraint_lm(m: Model, P: Params, k: dict, q, qvel, dtype,
                       assemble_j: bool = False) -> dict:
    """Constraint rows. q, qvel: tuples of (E,) planes; k holds
    con_dist/con_pos/con_frame (collision_lm) and subtree_com (nbody, 3, E),
    and with assemble_j also cdof (nv, 6, E).

    Adds efc_D/efc_aref/efc_fl (nefc, E), efc_Jeq (neq, nv, E),
    efc_lim_side (nlimit, E), efc_pos/efc_margin/efc_active, and the
    compacted slot record (con_sel, con_sel_active, con_dist_k, con_pos_k,
    con_frame_k, con_mu_k, con_dim_k, con_solref_k, con_solimp_k,
    con_margin_k).

    Kernel mode: the contact slices of efc_D/efc_aref are zero (the kernel
    owns them), and the per-slot kernel inputs con_Dc/con_bb/con_kimp
    (K, E), con_W1/con_W2 (nv, K, E), con_O1/con_O2 (3, K, E), con_on
    (R*K, E) r-major, with con_mu_dirs (K, R/2, E) (pyramidal) or con_Dfri
    (K, R-1, E) and con_mut (K, E) (elliptic) are added. assemble_j: the
    contact slices of efc_D/efc_aref are filled and the dense contact rows
    efc_Jc (K*R, nv, E) are added (k-major: the R rows of slot 0, then
    slot 1, ...), zero on inactive rows."""
    nv = m.nv
    neq = m.neq_jnt
    nlimit = m.nlimit
    E = P.E
    dev = m.device

    D_b, aref_b, fl_b = [], [], []
    pos_b, margin_b, act_b = [], [], []

    # ---- joint equality rows: q1 = poly(q2) ----
    Jeq = torch.zeros((neq, nv, E), dtype=dtype, device=dev)
    if neq:
        rows_D, rows_aref, rows_pos = [], [], []
        for e in range(neq):
            q1adr = int(m.eq_j1_qadr[e])
            q2adr = int(m.eq_j2_qadr[e])
            d1 = int(m.eq_j1_dofadr[e])
            pc = [P.plane("eq_polycoef", e, i) for i in range(5)]
            q1v = q[q1adr] - P.plane("eq_q0_1", e)
            Jeq[e, d1] = 1.0
            if q2adr >= 0:
                d2 = int(m.eq_j2_dofadr[e])
                q2v = q[q2adr] - P.plane("eq_q0_2", e)
                poly = pc[0] + q2v * (pc[1] + q2v * (pc[2] + q2v * (pc[3] + q2v * pc[4])))
                dpoly = pc[1] + q2v * (2 * pc[2] + q2v * (3 * pc[3] + 4 * pc[4] * q2v))
                pos_eq = q1v - poly
                vel = qvel[d1] - dpoly * qvel[d2]
                iw = P.plane("dof_invweight0", d1) + P.plane("dof_invweight0", d2)
                Jeq[e, d2] = Jeq[e, d2] - dpoly
            else:
                pos_eq = q1v - pc[0]
                vel = qvel[d1]
                iw = P.plane("dof_invweight0", d1)
            imp, kk, bb, De = _efc_kbid(
                P("eq_solref")[e], P("eq_solimp")[e], pos_eq, iw
            )
            rows_D.append(torch.broadcast_to(De, (E,)))
            rows_aref.append(-bb * vel - kk * imp * pos_eq)
            rows_pos.append(pos_eq)
        D_b.append(torch.stack(rows_D))
        aref_b.append(torch.stack(rows_aref))
        fl_b.append(torch.zeros((neq, E), dtype=dtype, device=dev))
        pos_b.append(torch.stack(rows_pos))
        margin_b.append(torch.zeros((neq, E), dtype=dtype, device=dev))
        act_b.append(torch.ones((neq, E), dtype=torch.bool, device=dev))

    # ---- dof friction rows (their D and b are constants of the model) ----
    def friction_rows():
        _, _, b, D = _efc_kbid(
            P("dof_solref"), P("dof_solimp"),
            torch.zeros((nv, 1), dtype=dtype, device=dev), P("dof_invweight0"),
        )
        return D, b

    Df, bb = cached(m, ("friction_rows", dtype), friction_rows)
    qvel_s = torch.stack(qvel)
    fl_dof = torch.broadcast_to(P("dof_frictionloss"), (nv, E)).to(dtype)
    D_b.append(torch.broadcast_to(Df, (nv, E)))
    aref_b.append(torch.broadcast_to(-bb, (nv, E)) * qvel_s)
    fl_b.append(fl_dof)
    pos_b.append(torch.zeros((nv, E), dtype=dtype, device=dev))
    margin_b.append(torch.zeros((nv, E), dtype=dtype, device=dev))
    act_b.append(fl_dof > 0)

    # ---- joint limit rows ----
    lim_side = torch.zeros((nlimit, E), dtype=dtype, device=dev)
    if nlimit:
        jids = m.limit_jntid
        ok = device_array(m, "limit_ok", lambda: np.isin(
            m.jnt_type[jids], (JNT_HINGE, JNT_SLIDE)
        ))
        qsel = torch.stack([q[int(a)] for a in m.jnt_qposadr[jids]])
        vadr = m.jnt_dofadr[jids]
        vsel = torch.stack([qvel[int(a)] for a in vadr])
        jidx = device_array(m, "limit_jntid", lambda: jids, torch.long)
        rng = P("jnt_range")[jidx]  # (nlimit, 2, 1)
        lo, hi = rng[:, 0], rng[:, 1]
        dist_lo = qsel - lo
        dist_hi = hi - qsel
        lower = dist_lo < dist_hi
        dist = torch.minimum(dist_lo, dist_hi)
        side = torch.where(lower, 1.0, -1.0).to(dtype)
        margin = P("jnt_margin")[jidx]
        pos = dist - margin
        iw_lim = P("dof_invweight0")[
            device_array(m, "limit_dofadr", lambda: vadr, torch.long)
        ]
        imp, kk, bb, Dl = _efc_kbid(
            P("jnt_solref")[jidx], P("jnt_solimp")[jidx], pos, iw_lim
        )
        act_lim = (dist < margin) & ok[:, None]
        lim_side = torch.where(act_lim, side, 0.0)
        vel = side * vsel
        D_b.append(torch.where(act_lim, Dl, 0.0))
        aref_b.append(torch.where(act_lim, -bb * vel - kk * imp * pos, 0.0))
        fl_b.append(torch.zeros((nlimit, E), dtype=dtype, device=dev))
        pos_b.append(torch.broadcast_to(dist, (nlimit, E)))
        margin_b.append(torch.broadcast_to(margin, (nlimit, E)).to(dtype))
        act_b.append(act_lim)

    # ---- contact slots (top-K compaction) ----
    pt = m.pairs
    K = m.ncon_max
    R = m.rows_per_con
    KR = K * R
    S = pt.ncon
    out = {}
    if S and K:
        f5, sr_s, si_s, inclm = slot_params(m, P, dtype)
        dist = k["con_dist"]  # (S, E)
        score = dist - inclm
        score_k, sel = topk_lowest(score, K)
        sel_active = score_k < 0.0  # (K, E)

        feat = torch.cat(
            [dist[:, None, :], k["con_pos"], k["con_frame"]], dim=1
        )  # (S, 13, E)
        featk = _take(feat, sel)
        dist_k = featk[:, 0]
        pos_k = featk[:, 1:4]  # (K, 3, E)
        frame_k = featk[:, 4:13]  # (K, 9, E) rows [n, t1, t2]

        parts = (f5, sr_s, si_s, inclm[:, None])
        Eb = max(x.shape[-1] for x in parts)
        ptab = torch.cat([x.expand(-1, -1, Eb) for x in parts], dim=1)  # (S, 13, Eb)
        if ptab.shape[-1] == 1:  # every env shares the slot parameters
            pk = ptab[:, :, 0][sel].permute(0, 2, 1)  # (K, 13, E)
        else:
            pk = torch.gather(ptab, 0, sel[:, None, :].expand(K, 13, E))
        mu_k = pk[:, 0:5]
        solref_k = pk[:, 5:7]
        solimp_k = pk[:, 7:12]
        margin_k = pk[:, 12]

        # static per-slot ids (bodies, roots, condim) by integer gathers
        b1 = device_array(
            m, "slot_body1", lambda: m.geom_bodyid[pt.con_geom1], torch.long
        )[sel]  # (K, E)
        b2 = device_array(
            m, "slot_body2", lambda: m.geom_bodyid[pt.con_geom2], torch.long
        )[sel]
        root = device_array(m, "body_rootid", lambda: m.body_rootid, torch.long)
        dim_k = device_array(m, "slot_dim", lambda: pt.con_dim, dtype)[sel]
        W = device_array(m, "ancestor_dof_mask", lambda: ancestor_dof_mask(m), dtype)
        W1 = W[b1].permute(2, 0, 1)  # (nv, K, E)
        W2 = W[b2].permute(2, 0, 1)
        subtree = k["subtree_com"]  # (nbody, 3, E)
        O1 = _take(subtree, root[b1]).permute(1, 0, 2)  # (3, K, E)
        O2 = _take(subtree, root[b2]).permute(1, 0, 2)
        iw_body = P("body_invweight0")[:, 0, 0]  # (nbody,)
        invweight_t = iw_body[b1] + iw_body[b2]  # (K, E)

        elliptic = int(m.opt.cone) != CONE_PYRAMIDAL
        ndirs = R - 1 if elliptic else R // 2
        frictionless = dim_k == 1
        dir_need = device_array(
            m, ("dir_need", ndirs), lambda: np.array(_DIR_NEED)[:ndirs], dtype,
        )
        mu_dirs = torch.where(
            (dim_k[:, None] >= dir_need[None, :, None])
            & ~frictionless[:, None],
            mu_k[:, :ndirs],
            0.0,
        )  # (K, ndirs, E)

        pos_c = dist_k - margin_k
        if elliptic:
            # rows [normal, t1, t2, torsion, roll1, roll2][:R]: the normal
            # row's D from the slot's impedance, friction row i's D
            # D_n * impratio * (mu_i / mu_0)^2, the whitened cone
            # coefficient mu_0 / sqrt(impratio)
            row_on = (
                torch.arange(R, dtype=dtype, device=dev)[None, :, None]
                < torch.clamp(dim_k, max=float(R))[:, None, :]
            )
            imp, kk, bb, Dn = _efc_kbid(solref_k, solimp_k, pos_c, invweight_t)
            impratio = m.opt.impratio.to(dtype)
            mu0 = torch.clamp(mu_dirs[:, 0], min=1e-10)
            ratio2 = torch.square(mu_dirs / mu0[:, None])  # (K, ndirs, E)
            zR1 = torch.zeros((K, R - 1, E), dtype=dtype, device=dev)
            pos_rows = torch.cat([dist_k[:, None], zR1], dim=1)
            margin_rows = torch.cat([margin_k[:, None], zR1], dim=1)
            Dck = torch.where(sel_active, Dn, 0.0)
            mut = mu_k[:, 0] / torch.sqrt(torch.clamp(impratio, min=1e-12))
            extra = dict(
                con_Dfri=Dck[:, None] * impratio * ratio2,
                con_mut=torch.where(sel_active, mut, 0.0),
                con_Dc=Dck,
            )
        else:
            row_count = torch.where(
                frictionless, 4.0, 2.0 * (torch.clamp(dim_k, min=3.0) - 1.0)
            )
            row_on = (
                torch.arange(R, dtype=dtype, device=dev)[None, :, None]
                < row_count[:, None, :]
            )  # (K, R, E)
            mu1 = mu_dirs[:, 0]
            diag_pyr = (
                2.0 * mu1 * mu1 * (1.0 + mu1 * mu1) * invweight_t
                / cached(m, "impratio", lambda: float(m.opt.impratio))
            )
            diag_approx = torch.where(frictionless, invweight_t * 4.0, diag_pyr)
            imp, kk, bb, Dc = _efc_kbid(solref_k, solimp_k, pos_c, diag_approx)
            pos_rows = torch.broadcast_to(dist_k[:, None], (K, R, E))
            margin_rows = torch.broadcast_to(margin_k[:, None], (K, R, E))
            extra = dict(con_mu_dirs=mu_dirs, con_Dc=torch.where(sel_active, Dc, 0.0))

        on = (sel_active[:, None] & row_on).reshape(KR, E)
        zKR = torch.zeros((KR, E), dtype=dtype, device=dev)
        if assemble_j:
            rowsJ = _contact_rows(
                m, k["cdof"], pos_k, frame_k, W1, W2, O1, O2, mu_dirs
            ).reshape(KR, nv, E)
            vel = torch.einsum("rve,ve->re", rowsJ, torch.stack(qvel))
            vel = vel.reshape(K, R, E)
            if elliptic:
                D_rows = torch.cat(
                    [Dn[:, None], Dn[:, None] * impratio * ratio2], dim=1
                )
                aref_c = -bb[:, None] * vel
                aref_c[:, 0] = aref_c[:, 0] - kk * imp * pos_c
            else:
                aref_c = -bb[:, None] * vel - (kk * imp * pos_c)[:, None]
                D_rows = torch.broadcast_to(Dc[:, None], (K, R, E))
            Jc = torch.where(on[:, None, :], rowsJ, 0.0)
            D_b.append(torch.where(on, D_rows.reshape(KR, E), 0.0))
            aref_b.append(torch.where(on, aref_c.reshape(KR, E), 0.0))
        else:
            on_rm = (sel_active[None] & row_on.permute(1, 0, 2)).reshape(R * K, E)
            out.update(
                extra, con_bb=bb, con_kimp=kk * imp * pos_c,
                con_W1=W1, con_W2=W2, con_O1=O1, con_O2=O2, con_on=on_rm,
            )
            D_b.append(zKR)
            aref_b.append(zKR)
        out.update(
            con_sel=sel, con_sel_active=sel_active,
            con_dist_k=dist_k, con_pos_k=pos_k, con_frame_k=frame_k,
            con_mu_k=mu_k, con_dim_k=dim_k,
            con_solref_k=solref_k, con_solimp_k=solimp_k,
            con_margin_k=margin_k,
        )
        fl_b.append(zKR)
        pos_b.append(pos_rows.reshape(KR, E))
        margin_b.append(margin_rows.reshape(KR, E))
        act_b.append(on)
    elif KR:
        zKR = torch.zeros((KR, E), dtype=dtype, device=dev)
        D_b += [zKR]
        aref_b += [zKR]
        fl_b += [zKR]
        pos_b += [zKR]
        margin_b += [zKR]
        act_b.append(torch.zeros((KR, E), dtype=torch.bool, device=dev))
    if assemble_j:
        k["efc_Jc"] = (Jc if S and K
                       else torch.zeros((KR, nv, E), dtype=dtype, device=dev))

    k.update(
        efc_D=torch.cat(D_b, dim=0), efc_aref=torch.cat(aref_b, dim=0),
        efc_fl=torch.cat(fl_b, dim=0), efc_Jeq=Jeq, efc_lim_side=lim_side,
        efc_pos=torch.cat(pos_b, dim=0), efc_margin=torch.cat(margin_b, dim=0),
        efc_active=torch.cat(act_b, dim=0), **out,
    )
    return k
