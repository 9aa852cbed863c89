"""Env-last narrowphase: contact distance, position and frame per slot.

PyTorch counterpart of mjlab_tpu/phys/lm/collision.py for the pair
families the G1 velocity task uses: plane-sphere, plane-capsule,
sphere-sphere, sphere-capsule and capsule-capsule. Pair groups run as
(P, E) tensors, pairs on the first axis and envs on the last. Per-slot
contact parameters (friction, solref, solimp, margin - gap) are mixed on
the host in numpy: no geom parameter is per-env in this package.
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.phys.model import (
    GEOM_CAPSULE, GEOM_PLANE, GEOM_SPHERE, Model, cached, host_array,
)

# (type1, type2) narrowphase families carried by collision_lm
PAIR_FAMILIES = frozenset({
    (GEOM_PLANE, GEOM_SPHERE), (GEOM_PLANE, GEOM_CAPSULE),
    (GEOM_SPHERE, GEOM_SPHERE), (GEOM_SPHERE, GEOM_CAPSULE),
    (GEOM_CAPSULE, GEOM_CAPSULE),
})


def pair_families(m: Model) -> set[tuple[int, int]]:
    """The (type1, type2) keys of the model's contact pairs."""
    pt = m.pairs
    t1 = m.geom_type[pt.geom1]
    t2 = m.geom_type[pt.geom2]
    return {(int(a), int(b)) for a, b in zip(t1, t2)}


def _np_pair_params(m: Model):
    """Host-side pair parameter mixing (MuJoCo's priority/solmix rules)."""
    pt = m.pairs
    g1, g2 = pt.geom1, pt.geom2
    host = lambda name: host_array(m, name)  # noqa: E731
    pri1 = m.geom_priority[g1]
    pri2 = m.geom_priority[g2]
    f1, f2 = host("geom_friction")[g1], host("geom_friction")[g2]
    sr1, sr2 = host("geom_solref")[g1], host("geom_solref")[g2]
    si1, si2 = host("geom_solimp")[g1], host("geom_solimp")[g2]
    mix1, mix2 = host("geom_solmix")[g1], host("geom_solmix")[g2]

    denom = mix1 + mix2
    w = np.where(
        denom > 1e-12, mix1 / np.where(denom > 1e-12, denom, 1.0), 0.5
    )
    w = np.where((mix1 < 1e-12) & (mix2 < 1e-12), 0.5, w)
    w = np.where((mix1 < 1e-12) & (mix2 >= 1e-12), 0.0, w)
    w = np.where((mix2 < 1e-12) & (mix1 >= 1e-12), 1.0, w)
    w = w[:, None]

    solref_mix = w * sr1 + (1 - w) * sr2
    direct = (sr1[:, 0:1] <= 0) | (sr2[:, 0:1] <= 0)
    solref_eq = np.where(direct, np.minimum(sr1, sr2), solref_mix)
    solimp_eq = w * si1 + (1 - w) * si2
    friction_eq = np.maximum(f1, f2)

    p1_gt = (pri1 > pri2)[:, None]
    p2_gt = (pri2 > pri1)[:, None]
    friction = np.where(p1_gt, f1, np.where(p2_gt, f2, friction_eq))
    solref = np.where(p1_gt, sr1, np.where(p2_gt, sr2, solref_eq))
    solimp = np.where(p1_gt, si1, np.where(p2_gt, si2, solimp_eq))
    margin = np.maximum(host("geom_margin")[g1], host("geom_margin")[g2])
    gap = np.maximum(host("geom_gap")[g1], host("geom_gap")[g2])
    friction5 = np.stack(
        [friction[:, 0], friction[:, 0], friction[:, 1], friction[:, 2],
         friction[:, 2]],
        axis=-1,
    )
    if pt.ex_mask.any():
        exm = pt.ex_mask[:, None]
        friction5 = np.where(exm, pt.ex_friction5, friction5)
        solref = np.where(exm, pt.ex_solref, solref)
        solimp = np.where(exm, pt.ex_solimp, solimp)
        margin = np.where(pt.ex_mask, pt.ex_margin, margin)
        gap = np.where(pt.ex_mask, pt.ex_gap, gap)
    return friction5, solref, solimp, margin, gap


def slot_params(m: Model, P: Params, dtype):
    """Per contact-SLOT parameters: friction5 (S, 5, 1), solref (S, 2, 1),
    solimp (S, 5, 1), includemargin (S, 1), shared by every env."""

    def make():
        cp = m.pairs.con_pairid
        f5, sr, si, mg, gp = _np_pair_params(m)

        def to(x):
            return torch.as_tensor(x[cp], dtype=dtype, device=m.device)[..., None]

        return (
            to(f5), to(sr), to(si),
            torch.as_tensor((mg - gp)[cp], dtype=dtype, device=m.device)[:, None],
        )

    return cached(m, ("slot_params", dtype), make)


# 3-vectors are (P, 3, E) tensors (pairs, component, envs) and frames
# (P, 9, E) row-major. Dot products sum in the JAX package's order, so
# distances (and with them the top-K contact order) round as there.


def _dot(a, b):
    p = a * b
    return p[:, 0] + p[:, 1] + p[:, 2]


def _cross(a, b):
    return torch.linalg.cross(a, b, dim=1)


def _times(v, s):
    """Vector times a per-pair scalar (P, E) or (P, 1)."""
    return v * s[:, None]


def _make_frame(n):
    """Contact frame rows [n, t1, t2] from the normal (mju_makeFrame)."""
    ny_small = (torch.abs(n[:, 1]) < 0.5).to(n.dtype)
    cand = torch.stack([torch.zeros_like(ny_small), ny_small, 1.0 - ny_small], 1)
    t1 = cand - _times(n, _dot(cand, n))
    t1 = t1 / torch.sqrt(torch.clamp(_dot(t1, t1), min=1e-30))[:, None]
    return torch.cat([n, t1, _cross(n, t1)], dim=1)


def _sphere_sphere_raw(c1, r1, c2, r2):
    dvec = c2 - c1
    L = torch.sqrt(torch.clamp(_dot(dvec, dvec), min=0.0))
    bad = L < 1e-12
    n = dvec / torch.where(bad, 1.0, L)[:, None]
    ez = torch.eye(3, dtype=n.dtype, device=n.device)[2]  # made on the device
    n = torch.where(bad[:, None], ez[None, :, None], n)
    dist = L - (r1 + r2)
    return dist, c1 + _times(n, r1 + 0.5 * dist), n


def _closest_on_segment(p, a, b):
    ab = b - a
    t = _dot(p - a, ab) / torch.clamp(_dot(ab, ab), min=1e-12)
    return a + _times(ab, torch.clamp(t, 0.0, 1.0))


def _col(mat9, i):
    """Column i of row-major (P, 9, E) frames, as (P, 3, E)."""
    return mat9[:, i::3]


def _groups(m: Model, dtype):
    """Per narrowphase family, in slot order: (key, geom1 ids, geom2 ids,
    geom1 sizes (P, 3), geom2 sizes (P, 3)) as device tensors."""

    def make():
        pt = m.pairs
        type1 = m.geom_type[pt.geom1]
        type2 = m.geom_type[pt.geom2]
        groups: dict[tuple[int, int], list[int]] = {}
        for p in range(len(pt.geom1)):
            groups.setdefault((int(type1[p]), int(type2[p])), []).append(p)
        size = host_array(m, "geom_size")
        out, adr = [], 0
        for key in sorted(groups):
            plist = np.array(groups[key])
            assert pt.pair_conadr[plist[0]] == adr, "pair table not sorted"
            adr += int(pt.pair_ncon[plist].sum())
            g1, g2 = pt.geom1[plist], pt.geom2[plist]
            t = lambda x, dt=None: torch.as_tensor(x, dtype=dt, device=m.device)  # noqa: E731
            out.append((key, t(g1).long(), t(g2).long(), t(size[g1], dtype),
                        t(size[g2], dtype)))
        return out

    return cached(m, ("collision_groups", dtype), make)


def collision_lm(m: Model, P: Params, gx: torch.Tensor, gm: torch.Tensor,
                 k: dict) -> dict:
    """gx (ngeom, 3, E) / gm (ngeom, 9, E) geom frames (only pair geoms are
    read). Adds con_dist (S, E), con_pos (S, 3, E), con_frame (S, 9, E) in
    slot order to k."""
    S = m.pairs.ncon
    E = P.E
    if S == 0:
        k.update(con_dist=gx.new_zeros(0, E))
        return k
    missing = pair_families(m) - PAIR_FAMILIES
    if missing:
        raise NotImplementedError(
            f"narrowphase families {sorted(missing)} are not ported yet"
        )

    dist_b, pos_b, frame_b = [], [], []
    for key, g1, g2, s1, s2 in _groups(m, gx.dtype):
        xp1, xm1, xp2, xm2 = gx[g1], gm[g1], gx[g2], gm[g2]
        r1, r2 = s1[:, 0:1], s2[:, 0:1]

        if key == (GEOM_PLANE, GEOM_SPHERE):
            n = _col(xm1, 2)
            dist = _dot(n, xp2 - xp1) - r2
            dist_b.append(dist)
            pos_b.append(xp2 - _times(n, r2 + 0.5 * dist))
            frame_b.append(_make_frame(n))
        elif key == (GEOM_PLANE, GEOM_CAPSULE):
            n = _col(xm1, 2)
            axis = _col(xm2, 2)
            hl = s2[:, 1:2]
            # first tangent along the projected capsule axis
            t1v = axis - _times(n, _dot(axis, n))
            t1n = torch.sqrt(torch.clamp(_dot(t1v, t1v), min=0.0))
            t1u = torch.where(
                (t1n > 1e-8)[:, None],
                t1v / torch.clamp(t1n, min=1e-12)[:, None],
                _make_frame(n)[:, 3:6],
            )
            frame = torch.cat([n, t1u, _cross(n, t1u)], dim=1)
            ds, ps = [], []
            for sgn in (1.0, -1.0):
                e = xp2 + _times(axis, sgn * hl)
                dist = _dot(n, e - xp1) - r2
                ds.append(dist)
                ps.append(e - _times(n, r2 + 0.5 * dist))
            # two slots per pair, pair-major
            dist_b.append(torch.stack(ds, 1).reshape(-1, E))
            pos_b.append(torch.stack(ps, 1).reshape(-1, 3, E))
            frame_b.append(torch.stack([frame, frame], 1).reshape(-1, 9, E))
        elif key == (GEOM_SPHERE, GEOM_SPHERE):
            dist, pos, n = _sphere_sphere_raw(xp1, r1, xp2, r2)
            dist_b.append(dist)
            pos_b.append(pos)
            frame_b.append(_make_frame(n))
        elif key == (GEOM_SPHERE, GEOM_CAPSULE):
            axis = _times(_col(xm2, 2), s2[:, 1:2])
            cp = _closest_on_segment(xp1, xp2 - axis, xp2 + axis)
            dist, pos, n = _sphere_sphere_raw(xp1, r1, cp, r2)
            dist_b.append(dist)
            pos_b.append(pos)
            frame_b.append(_make_frame(n))
        else:  # (GEOM_CAPSULE, GEOM_CAPSULE): closest points of two segments
            ax1 = _times(_col(xm1, 2), s1[:, 1:2])
            ax2 = _times(_col(xm2, 2), s2[:, 1:2])
            a1, a2 = xp1 - ax1, xp2 - ax2
            d1, d2 = (xp1 + ax1) - a1, (xp2 + ax2) - a2
            r = a1 - a2
            A, Eq = _dot(d1, d1), _dot(d2, d2)
            F, C, B = _dot(d2, r), _dot(d1, r), _dot(d1, d2)
            denom = A * Eq - B * B
            s = torch.where(
                denom > 1e-12,
                (B * F - C * Eq) / torch.clamp(denom, min=1e-12),
                0.0,
            )
            s = torch.clamp(s, 0.0, 1.0)
            t = torch.where(
                Eq > 1e-12, (B * s + F) / torch.clamp(Eq, min=1e-12), 0.0
            )
            t_cl = torch.clamp(t, 0.0, 1.0)
            s = torch.where(
                t != t_cl,
                torch.clamp((B * t_cl - C) / torch.clamp(A, min=1e-12),
                            0.0, 1.0),
                s,
            )
            dist, pos, n = _sphere_sphere_raw(
                a1 + _times(d1, s), r1, a2 + _times(d2, t_cl), r2
            )
            dist_b.append(dist)
            pos_b.append(pos)
            frame_b.append(_make_frame(n))

    k.update(
        con_dist=torch.cat(dist_b, dim=0),  # (S, E)
        con_pos=torch.cat(pos_b, dim=0),  # (S, 3, E)
        con_frame=torch.cat(frame_b, dim=0),  # (S, 9, E)
    )
    return k
