"""Env-last narrowphase: contact distance, position and frame per slot.

PyTorch counterpart of mjlab_tpu/phys/lm/collision.py for the pair
families the G1 velocity and YAM lift-cube tasks use: plane-sphere,
plane-capsule, plane-box, sphere-sphere, sphere-capsule, sphere-box,
capsule-capsule, capsule-box and box-box (the heightfield families are
not carried yet). Same formulas and the same selection order as the JAX
package: a box's corners are taken deepest first, lower corner index
first on ties, and box-box picks its separating axis as argmax does
(first axis on ties). Pair groups run as
(P, E) tensors, pairs on the first axis and envs on the last. Per-slot
contact parameters (friction, solref, solimp, margin - gap) are mixed on
the host in numpy once per Model while every env shares the geom
parameters, and on the device inside every step once a domain
randomisation event has given one of them a leading env axis
(Simulation.expand_model_fields).
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.phys.model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_PLANE, GEOM_SPHERE, Model, cached,
    device_array, host_array,
)

# (type1, type2) narrowphase families carried by collision_lm
PAIR_FAMILIES = frozenset({
    (GEOM_PLANE, GEOM_SPHERE), (GEOM_PLANE, GEOM_CAPSULE),
    (GEOM_PLANE, GEOM_BOX), (GEOM_SPHERE, GEOM_SPHERE),
    (GEOM_SPHERE, GEOM_CAPSULE), (GEOM_SPHERE, GEOM_BOX),
    (GEOM_CAPSULE, GEOM_CAPSULE), (GEOM_CAPSULE, GEOM_BOX),
    (GEOM_BOX, GEOM_BOX),
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


# the geom parameters the slot mixing reads, with their shared ndim; a
# field with one axis more carries a value per env (E, ngeom, ...)
PARAM_FIELDS = {
    "geom_friction": 2, "geom_solref": 2, "geom_solimp": 2,
    "geom_solmix": 1, "geom_margin": 1, "geom_gap": 1,
}


def per_env_params(m: Model) -> frozenset[str]:
    """The slot-parameter fields of m that carry a value per env."""
    return frozenset(
        n for n, nd in PARAM_FIELDS.items() if getattr(m, n).dim() > nd
    )


def slot_params(m: Model, P: Params, dtype):
    """Per contact-SLOT parameters: friction5 (S, 5, Eb), solref (S, 2, Eb),
    solimp (S, 5, Eb), includemargin (S, Eb); Eb is 1 when every env
    shares the geom parameters (mixed once on the host and cached) and E
    when one of them is per env (mixed on the device on every call, so a
    domain randomisation write to the field is read by the next step)."""
    if per_env_params(m):
        return _device_slot_params(m, dtype)

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


def _device_slot_params(m: Model, dtype):
    """slot_params with per-env geom parameters: MuJoCo's priority and
    solmix rules on (npair, k, Eb) tensors, as the JAX package's traced
    DR path (mjlab_tpu/phys/lm/collision.py:98-149)."""
    pt = m.pairs
    dev = m.device
    index = lambda key, x: device_array(m, key, lambda: x, torch.long)  # noqa: E731
    g1, g2 = index("pair_geom1", pt.geom1), index("pair_geom2", pt.geom2)
    batched = per_env_params(m)

    def gf(name, g):
        v = getattr(m, name).to(dtype)
        if name in batched:
            v = torch.movedim(v, 0, -1)  # (ngeom, ..., E)
        else:
            v = v[..., None]
        v = v[g]
        return v if v.dim() == 3 else v[:, None]  # (npair, k, Eb)

    f1, f2 = gf("geom_friction", g1), gf("geom_friction", g2)
    sr1, sr2 = gf("geom_solref", g1), gf("geom_solref", g2)
    si1, si2 = gf("geom_solimp", g1), gf("geom_solimp", g2)
    mix1, mix2 = gf("geom_solmix", g1), gf("geom_solmix", g2)
    pri = lambda g: torch.as_tensor(m.geom_priority[g], device=dev)[:, None, None]  # noqa: E731
    pri1, pri2 = cached(m, "pair_priority", lambda: (pri(pt.geom1), pri(pt.geom2)))

    denom = mix1 + mix2
    w = torch.where(denom > 1e-12, mix1 / torch.where(denom > 1e-12, denom, 1.0), 0.5)
    w = torch.where((mix1 < 1e-12) & (mix2 < 1e-12), 0.5, w)
    w = torch.where((mix1 < 1e-12) & (mix2 >= 1e-12), 0.0, w)
    w = torch.where((mix2 < 1e-12) & (mix1 >= 1e-12), 1.0, w)

    solref_mix = w * sr1 + (1 - w) * sr2
    direct = (sr1[:, 0:1] <= 0) | (sr2[:, 0:1] <= 0)
    solref = torch.where(direct, torch.minimum(sr1, sr2), solref_mix)
    solimp = w * si1 + (1 - w) * si2
    friction = torch.maximum(f1, f2)

    p1_gt, p2_gt = pri1 > pri2, pri2 > pri1
    friction = torch.where(p1_gt, f1, torch.where(p2_gt, f2, friction))
    solref = torch.where(p1_gt, sr1, torch.where(p2_gt, sr2, solref))
    solimp = torch.where(p1_gt, si1, torch.where(p2_gt, si2, solimp))
    margin = torch.maximum(gf("geom_margin", g1), gf("geom_margin", g2))[:, 0]
    gap = torch.maximum(gf("geom_gap", g1), gf("geom_gap", g2))[:, 0]

    friction5 = torch.stack(
        [friction[:, 0], friction[:, 0], friction[:, 1], friction[:, 2],
         friction[:, 2]],
        dim=1,
    )
    if pt.ex_mask.any():
        def ex(name, x, rows):
            v = device_array(m, ("pair_" + name, dtype), lambda: getattr(pt, name), dtype)
            return torch.where(rows, v[..., None], x)

        exm = device_array(m, "pair_ex_mask", lambda: pt.ex_mask, torch.bool)
        friction5 = ex("ex_friction5", friction5, exm[:, None, None])
        solref = ex("ex_solref", solref, exm[:, None, None])
        solimp = ex("ex_solimp", solimp, exm[:, None, None])
        margin = ex("ex_margin", margin, exm[:, None])
        gap = ex("ex_gap", gap, exm[:, None])
    cp = index("slot_pair", pt.con_pairid)
    return friction5[cp], solref[cp], solimp[cp], (margin - gap)[cp]


# 3-vectors are (P, 3, E) tensors (pairs, component, envs) and frames
# (P, 9, E) row-major. Dot products sum in the JAX package's order, so
# distances (and with them the top-K contact order) round as there; _dot
# also takes extra leading axes, (..., P, 3, E).


def _dot(a, b):
    p0, p1, p2 = (a * b).unbind(-2)
    return p0 + p1 + p2


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


# The box families carry extra leading axes (corners, search points): their
# 3-vectors are (..., P, 3, E), the component on axis -2, and every sum
# keeps the JAX package's order of terms.


def _rot(R, v):
    """R v for row-major (P, 9, E) frames and (..., P, 3, E|1) vectors."""
    Rm = R.reshape(R.shape[0], 3, 3, -1)
    return (Rm[:, :, 0] * v[..., 0:1, :] + Rm[:, :, 1] * v[..., 1:2, :]
            + Rm[:, :, 2] * v[..., 2:3, :])


def _rot_t(R, v):
    """R^T v (world to the frame's local coordinates)."""
    Rm = R.reshape(R.shape[0], 3, 3, -1)
    return (Rm[:, 0] * v[..., 0:1, :] + Rm[:, 1] * v[..., 1:2, :]
            + Rm[:, 2] * v[..., 2:3, :])


def _corners(xp, xm, size):
    """The 8 corners (8, P, 3, E) of boxes at xp (P, 3, E), frames xm
    (P, 9, E), half-sizes size (P, 3): corner c has the signs of the bits
    of c (x the highest), -1 for 0, the JAX package's corner order."""
    # made on the device: no host copy inside a captured step
    i = torch.arange(8, device=size.device)
    signs = (2 * torch.stack([(i >> 2) & 1, (i >> 1) & 1, i & 1], 1) - 1).to(size.dtype)
    local = (signs[:, None] * size[None])[..., None]  # (8, P, 3, 1)
    return xp + _rot(xm, local)


def _deepest4(D8, C8):
    """The 4 lowest of the distances D8 (8, P, E), lower corner first on
    ties (jax.lax.top_k of the negated distances), with their points from
    C8 (8, P, 3, E): (d4 (P, 4, E), p4 (P, 4, 3, E))."""
    d8, idx = torch.sort(D8.permute(1, 0, 2), dim=1, stable=True)
    i4 = idx[:, :4, None, :].expand(-1, -1, 3, -1)
    return d8[:, :4], torch.gather(C8.permute(1, 0, 2, 3), 1, i4)


def _point_box_sd(p, size):
    """Signed distance of local points p (..., P, 3, E) to boxes of
    half-sizes size (P, 3), and its parts (the clamped point, the face
    distances and the nearest-face flags) for _point_box_dist."""
    s = size[:, :, None]
    q = torch.clamp(p, min=-s, max=s)
    delta = p - q
    d_out = torch.sqrt(torch.clamp(_dot(delta, delta), min=0.0))
    f0, f1, f2 = (s - torch.abs(p)).unbind(-2)
    k0 = (f0 <= f1) & (f0 <= f2)
    k1 = (~k0) & (f1 <= f2)
    k2 = ~(k0 | k1)
    d_in = -(torch.where(k0, f0, 0.0) + torch.where(k1, f1, 0.0)
             + torch.where(k2, f2, 0.0))
    outside = d_out > 1e-12
    return torch.where(outside, d_out, d_in), (q, delta, d_out, outside,
                                               (k0, k1, k2), d_in)


def _point_box_dist(p, size):
    """Signed distance of local points p (P, 3, E) to boxes of half-sizes
    size (P, 3): (dist (P, E), outward normal, surface point), local."""
    dist, (q, delta, d_out, outside, ks, d_in) = _point_box_sd(p, size)
    n_out = delta / torch.clamp(d_out, min=1e-12)[:, None]
    sgn = torch.where(p >= 0, 1.0, -1.0)
    n_in = torch.stack(
        [torch.where(k, sgn[:, i], 0.0) for i, k in enumerate(ks)], dim=1
    )
    n = torch.where(outside[:, None], n_out, n_in)
    surf = torch.where(outside[:, None], q, p - _times(n_in, d_in))
    return dist, n, surf


def _point_box_contact(p_world, r, xp2, xm2, s2):
    """Contact of spheres of radius r (P, 1) at p_world (P, 3, E) with
    boxes: (dist, pos, frame), the normal pointing from the sphere into
    the box (geom1 to geom2)."""
    sd, n_l, surf_l = _point_box_dist(_rot_t(xm2, p_world - xp2), s2)
    dist = sd - r
    n = -_rot(xm2, n_l)
    surf_w = xp2 + _rot(xm2, surf_l)
    return dist, surf_w - _times(n, 0.5 * dist), _make_frame(n)


def _box_box(xp1, xm1, s1, xp2, xm2, s2):
    """Face-SAT box-box (mirrors phys.collision._box_box): 4 deepest
    corners of the incident box against the reference face; (d4 (P, 4,
    E), p4 (P, 4, 3, E), frame (P, 9, E))."""
    delta = xp2 - xp1
    # the 6 candidate axes: box 1's frame columns, then box 2's
    axes = torch.cat([xm1.reshape(-1, 3, 3, xm1.shape[-1]),
                      xm2.reshape(-1, 3, 3, xm2.shape[-1])], dim=2)
    axes = axes.permute(2, 0, 1, 3)  # (6, P, 3, E)

    def radius(xm, s):  # sum_i |axis . u_i| s_i for every axis
        out = None
        for i in range(3):
            t = torch.abs(_dot(axes, _col(xm, i))) * s[:, i:i + 1]
            out = t if out is None else out + t
        return out  # (6, P, E)

    r1s, r2s = radius(xm1, s1), radius(xm2, s2)
    cds = _dot(axes, delta)
    sep = torch.abs(cds) - (r1s + r2s)
    kbest = torch.argmax(sep, dim=0)  # first maximum on ties

    def select(vals):  # vals (6, P, ...) at kbest
        idx = kbest.reshape((1,) + kbest.shape[:1] + (1,) * (vals.dim() - 3)
                            + kbest.shape[1:])
        return torch.gather(vals, 0, idx.expand((1,) + vals.shape[1:]))[0]

    n = _times(select(axes), torch.sign(select(cds)))
    ref1 = kbest < 3
    ref_pos = torch.where(ref1[:, None], xp1, xp2)
    r_ref = torch.where(ref1, select(r1s), select(r2s))
    n_out = torch.where(ref1[:, None], n, -n)
    plane_p = ref_pos + _times(n_out, r_ref)
    corners = torch.where(
        ref1[:, None], _corners(xp2, xm2, s2), _corners(xp1, xm1, s1)
    )
    d4, p4 = _deepest4(_dot(corners - plane_p, n_out), corners)
    return d4, p4 - n_out[:, None] * 0.5 * d4[:, :, None], _make_frame(n)


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
        elif key == (GEOM_PLANE, GEOM_BOX):
            n = _col(xm1, 2)
            corners = _corners(xp2, xm2, s2)
            d4, p4 = _deepest4(_dot(n, corners - xp1), corners)
            dist_b.append(d4.reshape(-1, E))
            pos_b.append((p4 - n[:, None] * 0.5 * d4[:, :, None]).reshape(-1, 3, E))
            frame_b.append(
                _make_frame(n)[:, None].expand(-1, 4, -1, -1).reshape(-1, 9, E)
            )
        elif key == (GEOM_SPHERE, GEOM_BOX):
            dist, pos, frame = _point_box_contact(xp1, r1, xp2, xm2, s2)
            dist_b.append(dist)
            pos_b.append(pos)
            frame_b.append(frame)
        elif key == (GEOM_CAPSULE, GEOM_BOX):
            # the deepest point of the segment by ternary search (both
            # probes of a step in one batch), and the end farther from it
            ax = _times(_col(xm1, 2), s1[:, 1:2])
            a, b = xp1 - ax, xp1 + ax
            ab = b - a

            def seg_point(t):  # t (..., P, E) -> (..., P, 3, E)
                return a + ab * t[..., None, :]

            lo = torch.zeros_like(a[:, 0])
            hi = torch.ones_like(lo)
            for _ in range(20):
                third = (hi - lo) / 3.0
                m12 = torch.stack([lo + third, hi - third])
                sd, _ = _point_box_sd(_rot_t(xm2, seg_point(m12) - xp2), s2)
                take = sd[0] > sd[1]
                lo = torch.where(take, m12[0], lo)
                hi = torch.where(take, hi, m12[1])
            t_star = 0.5 * (lo + hi)
            t_end = torch.where(t_star > 0.5, 0.0, 1.0).to(t_star.dtype)
            ds, ps, fs = zip(*[
                _point_box_contact(seg_point(t), r1, xp2, xm2, s2)
                for t in (t_star, t_end)
            ])
            dist_b.append(torch.stack(ds, 1).reshape(-1, E))
            pos_b.append(torch.stack(ps, 1).reshape(-1, 3, E))
            frame_b.append(torch.stack(fs, 1).reshape(-1, 9, E))
        elif key == (GEOM_BOX, GEOM_BOX):
            d4, p4, frame = _box_box(xp1, xm1, s1, xp2, xm2, s2)
            dist_b.append(d4.reshape(-1, E))
            pos_b.append(p4.reshape(-1, 3, E))
            frame_b.append(frame[:, None].expand(-1, 4, -1, -1).reshape(-1, 9, E))
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
