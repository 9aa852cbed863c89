"""Batched ray casting against the primitive geom set.

PyTorch counterpart of mjlab_tpu/phys/ray.py, the analog of MuJoCo's
``mj_ray`` that the rangefinder sensor reads (sensor/builtin_sensor.py):
plane, sphere, capsule and box geoms; height fields, meshes, cylinders and
ellipsoids are transparent, as in the JAX package. Every function is
batched over a leading env axis. The geoms come from the Model's static
topology on the host (types, bodies, sizes), so a cast reads no device
value on the host and runs inside a captured control step. Plain PyTorch:
the JAX package computes the cast outside any Pallas kernel.

The JAX package unrolls the loop over geoms, which XLA fuses; unrolled in
eager PyTorch, each geom would cost its own ~100 small kernels (3,370 torch
operators for one cast on the G1, counted on the CPU). Here each geom type
is one batch over its geoms (same formulas, elementwise, then the nearest
over the batch), so a cast costs a fixed ~30-45 operators per type
present: on the G1 flat-velocity scene with the pelvis excluded (the
plane, 1 sphere and 31 capsules cast; the 35 visual meshes transparent)
174 torch operators per cast, counted on the CPU, each a CUDA kernel in
a replay.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.phys.model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_PLANE, GEOM_SPHERE, Model, device_array, host_array,
)

_INF = 1e10


def _ray_plane(p, v):
    """Ray against the z = 0 plane of the local frame, hit only from above
    (the solid side faces +z). p, v: (..., 3)."""
    vz = v[..., 2]
    t = -p[..., 2] / torch.where(vz.abs() < 1e-15, 1e-15, vz)
    hit = (t > 0) & (vz.abs() >= 1e-15)
    return torch.where(hit, t, _INF)


def _ray_sphere(p, v, r):
    a = (v * v).sum(-1)
    b = 2.0 * (p * v).sum(-1)
    c = (p * p).sum(-1) - r * r
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    t0 = (-b - sq) / (2 * a)
    t1 = (-b + sq) / (2 * a)
    t = torch.where(t0 > 0, t0, t1)
    hit = (disc >= 0) & (t > 0)
    return torch.where(hit, t, _INF)


def _ray_capsule(p, v, r, hl):
    """Capsule along the local z axis, half-length hl (broadcast against
    p[..., 2:]), radius r."""
    # the infinite cylinder in xy
    a = (v[..., :2] ** 2).sum(-1)
    b = 2.0 * (p[..., :2] * v[..., :2]).sum(-1)
    c = (p[..., :2] ** 2).sum(-1) - r * r
    disc = b * b - 4 * a * c
    sq = torch.sqrt(torch.clamp(disc, min=0.0))
    safe_a = torch.where(a < 1e-15, 1e-15, a)
    t0 = (-b - sq) / (2 * safe_a)
    t1 = (-b + sq) / (2 * safe_a)
    t_cyl = torch.where(t0 > 0, t0, t1)
    z_hit = p[..., 2] + t_cyl * v[..., 2]
    cyl_ok = (disc >= 0) & (t_cyl > 0) & (z_hit.abs() <= hl[..., 0]) & (a >= 1e-15)
    t_cyl = torch.where(cyl_ok, t_cyl, _INF)
    # the end caps' spheres
    xy, z = p[..., :2], p[..., 2:]
    t_up = _ray_sphere(torch.cat([xy, z - hl], -1), v, r)
    t_dn = _ray_sphere(torch.cat([xy, z + hl], -1), v, r)
    return torch.minimum(t_cyl, torch.minimum(t_up, t_dn))


def _ray_box(p, v, half):
    """Box of half extents half (3,) about the local frame's origin."""
    safe_v = torch.where(v.abs() < 1e-15, 1e-15, v)
    t_lo = (-half - p) / safe_v
    t_hi = (half - p) / safe_v
    t_near = torch.minimum(t_lo, t_hi).amax(-1)
    t_far = torch.maximum(t_lo, t_hi).amin(-1)
    t = torch.where(t_near > 0, t_near, t_far)
    hit = (t_far >= t_near) & (t > 0)
    return torch.where(hit, t, _INF)


def raycast(m: Model, d, pnt: torch.Tensor, vec: torch.Tensor,
            exclude_body: int) -> torch.Tensor:
    """Distance along ``vec`` (unit, world, (E, 3)) from ``pnt`` (E, 3) to
    the nearest geom surface, (E,); -1 where nothing is hit. The geoms of
    ``exclude_body`` are skipped (MuJoCo's rangefinder)."""
    best = torch.full(pnt.shape[:1], _INF, dtype=pnt.dtype, device=pnt.device)
    size = host_array(m, "geom_size")
    for t in (GEOM_PLANE, GEOM_SPHERE, GEOM_CAPSULE, GEOM_BOX):
        ids = [g for g in range(m.ngeom)
               if int(m.geom_type[g]) == t and int(m.geom_bodyid[g]) != exclude_body]
        if not ids:
            continue
        idx = device_array(m, ("ray_geoms", t, exclude_body), lambda ids=ids: ids, torch.long)
        half = device_array(m, ("ray_sizes", t, exclude_body),
                            lambda ids=ids: size[ids], pnt.dtype)  # (G, 3)
        gmat = d.geom_xmat[:, idx]  # (E, G, 3, 3)
        # into each geom's frame
        pl = torch.einsum("egji,egj->egi", gmat, pnt[:, None] - d.geom_xpos[:, idx])
        vl = torch.einsum("egji,ej->egi", gmat, vec)
        if t == GEOM_PLANE:
            dist = _ray_plane(pl, vl)
        elif t == GEOM_SPHERE:
            dist = _ray_sphere(pl, vl, half[:, 0])
        elif t == GEOM_CAPSULE:
            dist = _ray_capsule(pl, vl, half[:, 0], half[:, 1, None])
        else:
            dist = _ray_box(pl, vl, half)
        best = torch.minimum(best, dist.amin(1))
    return torch.where(best >= _INF, -1.0, best)
