"""Quaternion and spatial (6D) algebra with MuJoCo conventions.

PyTorch counterpart of mjlab_tpu/phys/math.py, for the env-first batched
stages (phys/kinematics.py, phys/smooth.py, phys/forward.py).

Conventions:
  - Quaternions are (w, x, y, z).
  - Spatial vectors are 6D with the ANGULAR part first: [omega(3), v(3)]
    for motion, [torque(3), force(3)] for force (mjData.cvel/cfrc).
  - Every function works on the trailing axes and broadcasts over any
    leading (batch) axes. The quaternion and cross-product formulas are
    lm/base.py's plane functions, applied to the trailing axis.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.phys.lm import base as _p

# The formulas live once, in lm/base.py, on tuples of component planes;
# these wrappers apply them to the trailing axis of stacked tensors.


def _on_planes(fn, *xs, **kw) -> torch.Tensor:
    return torch.stack(fn(*(x.unbind(-1) for x in xs), **kw), dim=-1)


def cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a x b over the trailing axis, broadcasting the leading ones."""
    return _on_planes(_p.vcross, a, b)


# ---------------------------------------------------------------------------
# Quaternions
# ---------------------------------------------------------------------------


def mul_quat(u: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Hamilton product u*v."""
    return _on_planes(_p.quat_mul, u, v)


def conj_quat(q: torch.Tensor) -> torch.Tensor:
    return _on_planes(_p.quat_conj, q)


def normalize_quat(q: torch.Tensor, eps: float = 1e-15) -> torch.Tensor:
    """q / |q|; the zero quaternion becomes the identity."""
    return _on_planes(_p.quat_normalize, q, eps=eps)


def rot_vec_quat(v: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Rotate v by q: v + 2w (u x v) + 2 u x (u x v)."""
    return _on_planes(_p.quat_rot, v, q)


def quat_to_mat(q: torch.Tensor) -> torch.Tensor:
    """Quaternion -> 3x3 rotation matrix."""
    return _on_planes(_p.quat_to_mat, q).reshape(q.shape[:-1] + (3, 3))


def axis_angle_to_quat(axis: torch.Tensor, angle: torch.Tensor) -> torch.Tensor:
    return torch.stack(_p.axis_angle_quat(axis.unbind(-1), angle), dim=-1)


def quat_integrate(q: torch.Tensor, omega: torch.Tensor, dt) -> torch.Tensor:
    """q * exp(0.5 * omega * dt), omega in the local frame
    (mju_quatIntegrate)."""
    return _on_planes(_p.quat_integrate, q, omega, dt=dt)


def quat_sub(qa: torch.Tensor, qb: torch.Tensor) -> torch.Tensor:
    """Velocity-space difference taking qb to qa, in qb's frame
    (mju_subQuat)."""
    return _on_planes(_p.quat_sub, qa, qb)


# ---------------------------------------------------------------------------
# Spatial algebra ([angular, linear] ordering)
# ---------------------------------------------------------------------------


def motion_cross(v: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    """Spatial motion cross product v x m (crm)."""
    return _on_planes(_p.motion_cross, v, m)


def force_cross(v: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
    """Spatial force cross product v x* f (crf)."""
    return _on_planes(_p.force_cross, v, f)


def offset_motion(s: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """A motion vector re-expressed at a new origin (offset = old - new):
    lin' = lin + ang x offset."""
    ang, lin = s[..., :3], s[..., 3:]
    return torch.cat([ang, lin + cross(ang, offset)], dim=-1)


def offset_force(s: torch.Tensor, offset: torch.Tensor) -> torch.Tensor:
    """A force vector re-expressed at a new origin (offset = old - new):
    ang' = ang + offset x lin."""
    ang, lin = s[..., :3], s[..., 3:]
    return torch.cat([ang + cross(offset, lin), lin], dim=-1)


def skew(v: torch.Tensor) -> torch.Tensor:
    """skew(v) @ u == cross(v, u)."""
    x, y, z = v[..., 0], v[..., 1], v[..., 2]
    zero = torch.zeros_like(x)
    m = torch.stack([zero, -z, y, z, zero, -x, -y, x, zero], dim=-1)
    return m.reshape(v.shape[:-1] + (3, 3))


def spatial_inertia(mass: torch.Tensor, inertia_c: torch.Tensor,
                    com: torch.Tensor) -> torch.Tensor:
    """6x6 spatial inertia about a frame origin O: mass (...,), inertia
    about the CoM, world-aligned (..., 3, 3), CoM relative to O (..., 3).
    [[I_c - m cx cx, m cx], [-m cx, m I]] with cx = skew(com)."""
    cx = skew(com)
    m = mass[..., None, None]
    c0, c1, c2 = com[..., 0], com[..., 1], com[..., 2]
    cc = c0 * c0 + c1 * c1 + c2 * c2
    cxcx = torch.stack(
        [
            c0 * c0 - cc, c0 * c1, c0 * c2,
            c1 * c0, c1 * c1 - cc, c1 * c2,
            c2 * c0, c2 * c1, c2 * c2 - cc,
        ],
        dim=-1,
    ).reshape(com.shape[:-1] + (3, 3))
    eye = torch.eye(3, dtype=cx.dtype, device=cx.device).expand(cx.shape)
    top = torch.cat([inertia_c - m * cxcx, m * cx], dim=-1)
    bottom = torch.cat([-m * cx, m * eye], dim=-1)
    return torch.cat([top, bottom], dim=-2)


def transform_motion(s: torch.Tensor, rot: torch.Tensor,
                     offset: torch.Tensor) -> torch.Tensor:
    """Rotate (by the 3x3 rot) then move a motion vector to a new origin."""
    ang = torch.einsum("...ij,...j->...i", rot, s[..., :3])
    lin = torch.einsum("...ij,...j->...i", rot, s[..., 3:])
    return offset_motion(torch.cat([ang, lin], -1), offset)
