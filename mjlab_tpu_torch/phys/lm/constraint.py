"""Env-last constraint rows for the fused assemble + solve kernel.

PyTorch counterpart of mjlab_tpu/phys/lm/constraint.py in its kernel mode
(``make_constraint_lm(..., assemble_j=False)``), pyramidal cone. Row layout
[dof friction][joint limits][contacts]; the dense contact Jacobian is not
built here: the solver kernel rebuilds it from the compact per-slot
tensors (positions, frames, ancestor dof masks, friction directions).

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


def make_constraint_lm(m: Model, P: Params, k: dict, q, qvel, dtype) -> dict:
    """Kernel-mode constraint rows. q, qvel: tuples of (E,) planes; k holds
    con_dist/con_pos/con_frame (collision_lm) and subtree_com (nbody, 3, E).

    Adds efc_D/efc_aref/efc_fl (nefc, E) with the contact slices zero (the
    kernel owns them), efc_lim_side (nlimit, E), efc_pos/efc_margin/
    efc_active, and the per-slot kernel inputs con_mu_dirs (K, ndirs, E),
    con_Dc/con_bb/con_kimp (K, E), con_W1/con_W2 (nv, K, E), con_O1/con_O2
    (3, K, E), con_on (R*K, E) r-major, plus the compacted slot record
    (con_sel, con_sel_active, con_dist_k, con_pos_k, con_frame_k,
    con_mu_k, con_dim_k, con_solref_k, con_solimp_k, con_margin_k)."""
    if int(m.opt.cone) != CONE_PYRAMIDAL:
        raise NotImplementedError("the elliptic cone is not ported yet")
    if m.neq_jnt:
        raise NotImplementedError("equality constraints are not ported yet")
    nv = m.nv
    nlimit = m.nlimit
    E = P.E
    dev = m.device

    D_b, aref_b, fl_b = [], [], []
    pos_b, margin_b, act_b = [], [], []

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

        ptab = torch.cat(
            [f5[..., 0], sr_s[..., 0], si_s[..., 0], inclm], dim=1
        )  # (S, 13)
        pk = ptab[sel].permute(0, 2, 1)  # (K, 13, E)
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

        ndirs = R // 2
        frictionless = dim_k == 1
        dir_need = device_array(
            m, ("dir_need", ndirs), lambda: np.array([3, 3, 4, 6, 6])[:ndirs],
            dtype,
        )
        mu_dirs = torch.where(
            (dim_k[:, None] >= dir_need[None, :, None])
            & ~frictionless[:, None],
            mu_k[:, :ndirs],
            0.0,
        )  # (K, ndirs, E)

        pos_c = dist_k - margin_k
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

        on_rm = (sel_active[None] & row_on.permute(1, 0, 2)).reshape(R * K, E)
        on = (sel_active[:, None] & row_on).reshape(KR, E)
        out.update(
            con_mu_dirs=mu_dirs,
            con_Dc=torch.where(sel_active, Dc, 0.0),
            con_bb=bb, con_kimp=kk * imp * pos_c,
            con_W1=W1, con_W2=W2, con_O1=O1, con_O2=O2, con_on=on_rm,
            con_sel=sel, con_sel_active=sel_active,
            con_dist_k=dist_k, con_pos_k=pos_k, con_frame_k=frame_k,
            con_mu_k=mu_k, con_dim_k=dim_k,
            con_solref_k=solref_k, con_solimp_k=solimp_k,
            con_margin_k=margin_k,
        )
        zKR = torch.zeros((KR, E), dtype=dtype, device=dev)
        D_b.append(zKR)
        aref_b.append(zKR)
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

    k.update(
        efc_D=torch.cat(D_b, dim=0), efc_aref=torch.cat(aref_b, dim=0),
        efc_fl=torch.cat(fl_b, dim=0), efc_lim_side=lim_side,
        efc_pos=torch.cat(pos_b, dim=0), efc_margin=torch.cat(margin_b, dim=0),
        efc_active=torch.cat(act_b, dim=0), **out,
    )
    return k
