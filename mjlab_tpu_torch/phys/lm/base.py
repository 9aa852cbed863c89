"""Env-last building blocks: scalar-plane math and model-parameter access.

PyTorch counterpart of mjlab_tpu/phys/lm/base.py. A 3-vector is a tuple of
three (E,) tensors ("planes"), a quaternion a 4-tuple, a 3x3 matrix a
9-tuple (row-major), a spatial vector a 6-tuple ([angular, linear]). Every
op is elementwise over the env axis. A plane may also be a Python float: a
model constant shared by all envs (see Params.plane).
"""

from __future__ import annotations

import numpy as np
import torch

from mjlab_tpu_torch.phys.model import host_array, per_env_smooth


class Params:
    """Env-last view of the Model fields, shared or per env.

    P(name)             -> tensor with the env axis last: (..., E) for a
                           per-env field, a trailing broadcast axis
                           (..., 1) for a shared one
    P.plane(name, *idx) -> the value: an (E,) tensor for a per-env field,
                           a Python float for a shared one

    Floats mix with (E,) planes in the tensors' dtype, so a shared constant
    costs no device op. ``batched`` is the set of fields m carries per env
    (model.per_env_smooth: a domain randomisation event's fields)."""

    def __init__(self, m, num_envs: int):
        self.m = m
        self.E = num_envs
        self.batched = frozenset(per_env_smooth(m))

    def __call__(self, name: str) -> torch.Tensor:
        v = getattr(self.m, name)
        if name in self.batched:
            return torch.movedim(v, 0, -1)
        return v[..., None]

    def host(self, name: str) -> np.ndarray:
        return host_array(self.m, name)

    def plane(self, name: str, *idx):
        if name in self.batched:
            return getattr(self.m, name)[(slice(None),) + idx]
        v = self.host(name)
        return float(v[idx]) if idx else float(v)


# -- scalar helpers that accept a plane or a float ---------------------------


def maximum(x, c: float):
    return max(x, c) if isinstance(x, float) else torch.clamp(x, min=c)


def sqrt(x):
    return float(np.sqrt(x)) if isinstance(x, float) else torch.sqrt(x)


# -- tuple-plane algebra -----------------------------------------------------


def vadd(a, b):
    return tuple(x + y for x, y in zip(a, b))


def vsub(a, b):
    return tuple(x - y for x, y in zip(a, b))


def vscale(a, s):
    return tuple(x * s for x in a)


def vdot(a, b):
    out = a[0] * b[0]
    for x, y in zip(a[1:], b[1:]):
        out = out + x * y
    return out


def vcross(a, b):
    ax, ay, az = a
    bx, by, bz = b
    return (ay * bz - az * by, az * bx - ax * bz, ax * by - ay * bx)


def quat_mul(u, v):
    uw, ux, uy, uz = u
    vw, vx, vy, vz = v
    return (
        uw * vw - ux * vx - uy * vy - uz * vz,
        uw * vx + ux * vw + uy * vz - uz * vy,
        uw * vy - ux * vz + uy * vw + uz * vx,
        uw * vz + ux * vy - uy * vx + uz * vw,
    )


def quat_conj(q):
    w, x, y, z = q
    return (w, -x, -y, -z)


def quat_normalize(q, eps=1e-15):
    n2 = vdot(q, q)
    n = torch.sqrt(torch.clamp(n2, min=eps * eps))
    bad = n < eps
    w = torch.where(bad, 1.0, q[0] / n)
    rest = tuple(torch.where(bad, 0.0, c / n) for c in q[1:])
    return (w,) + rest


def quat_rot(v, q):
    """Rotate vector v by quaternion q: v + 2w(u x v) + 2u x (u x v)."""
    w = q[0]
    u = q[1:]
    uv = vcross(u, v)
    uuv = vcross(u, uv)
    return tuple(
        vi + 2.0 * (w * uvi + uuvi) for vi, uvi, uuvi in zip(v, uv, uuv)
    )


def quat_to_mat(q):
    """Quaternion -> 9-tuple rotation matrix, row-major."""
    w, x, y, z = q
    xx, yy, zz = x * x, y * y, z * z
    xy, xz, yz = x * y, x * z, y * z
    wx, wy, wz = w * x, w * y, w * z
    return (
        1 - 2 * (yy + zz), 2 * (xy - wz), 2 * (xz + wy),
        2 * (xy + wz), 1 - 2 * (xx + zz), 2 * (yz - wx),
        2 * (xz - wy), 2 * (yz + wx), 1 - 2 * (xx + yy),
    )


def mat_mul(a, b):
    """9-tuple row-major matrix product a @ b."""
    return (
        a[0] * b[0] + a[1] * b[3] + a[2] * b[6],
        a[0] * b[1] + a[1] * b[4] + a[2] * b[7],
        a[0] * b[2] + a[1] * b[5] + a[2] * b[8],
        a[3] * b[0] + a[4] * b[3] + a[5] * b[6],
        a[3] * b[1] + a[4] * b[4] + a[5] * b[7],
        a[3] * b[2] + a[4] * b[5] + a[5] * b[8],
        a[6] * b[0] + a[7] * b[3] + a[8] * b[6],
        a[6] * b[1] + a[7] * b[4] + a[8] * b[7],
        a[6] * b[2] + a[7] * b[5] + a[8] * b[8],
    )


def axis_angle_quat(axis, angle):
    half = 0.5 * angle
    s = torch.sin(half)
    return (torch.cos(half), axis[0] * s, axis[1] * s, axis[2] * s)


def quat_integrate(q, omega, dt):
    """q' = q * exp(0.5 * omega_local * dt) (mju_quatIntegrate)."""
    angle = torch.sqrt(torch.clamp(vdot(omega, omega), min=0.0))
    small = angle < 1e-12
    safe = torch.where(small, 1.0, angle)
    axis = tuple(torch.where(small, 0.0, o / safe) for o in omega)
    dq = axis_angle_quat(axis, angle * dt)
    return quat_normalize(quat_mul(q, dq))


def quat_sub(qa, qb):
    """3D velocity-space difference taking qb to qa (mju_subQuat)."""
    qd = quat_mul(quat_conj(qb), qa)
    neg = qd[0] < 0
    qd = tuple(torch.where(neg, -c, c) for c in qd)
    sin_half = torch.sqrt(
        torch.clamp(qd[1] ** 2 + qd[2] ** 2 + qd[3] ** 2, min=0.0)
    )
    angle = 2.0 * torch.atan2(sin_half, qd[0])
    small = sin_half < 1e-12
    safe = torch.where(small, 1.0, sin_half)
    return tuple(torch.where(small, 0.0, c / safe * angle) for c in qd[1:])


# -- spatial (6-tuple, [angular(3), linear(3)]) ------------------------------


def motion_cross(v, m):
    vang, vlin = v[:3], v[3:]
    mang, mlin = m[:3], m[3:]
    ang = vcross(vang, mang)
    lin = vadd(vcross(vlin, mang), vcross(vang, mlin))
    return ang + lin


def force_cross(v, f):
    vang, vlin = v[:3], v[3:]
    fang, flin = f[:3], f[3:]
    ang = vadd(vcross(vang, fang), vcross(vlin, flin))
    lin = vcross(vang, flin)
    return ang + lin
