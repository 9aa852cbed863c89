"""Env-level quaternion and frame helpers (batched torch tensors).

PyTorch counterpart of the part of mjlab_tpu/utils/math.py that the entity
view (entity/data.py), the sensors and the env's terms call. Quaternions
are (w, x, y, z) on the trailing axis; the algebra is phys/math.py's.
"""

from __future__ import annotations

import math

import torch

from mjlab_tpu_torch.phys.math import (
    conj_quat, mul_quat, normalize_quat, quat_sub, quat_to_mat, rot_vec_quat,
)

# the reference's names and argument order (quat_apply(q, v) rotates v by q)
quat_mul = mul_quat
quat_conjugate = conj_quat
quat_inv = conj_quat  # unit quaternions
matrix_from_quat = quat_to_mat


def quat_apply(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v rotated by q."""
    return rot_vec_quat(v, q)


def quat_apply_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v rotated by the inverse of the unit quaternion q."""
    return rot_vec_quat(v, conj_quat(q))


def quat_error_magnitude(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """The angle of the rotation taking q2 to q1."""
    return torch.linalg.vector_norm(quat_sub(q1, q2), dim=-1)


def subtract_frame_transforms(p1, q1, p2, q2=None):
    """The pose of frame 2 in frame 1 (T10 T02): (position, quaternion or
    None when q2 is None)."""
    q1_inv = conj_quat(q1)
    p = rot_vec_quat(p2 - p1, q1_inv)
    return p, None if q2 is None else mul_quat(q1_inv, q2)


def mat_to_quat(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrices -> unit quaternions with w >= 0: the
    four-hypothesis construction, the hypothesis of the largest of
    (trace, m00, m11, m22) taken (mjlab_tpu/phys/math.py mat_to_quat)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=1e-18))

    qw = torch.stack([safe_sqrt(1 + tr), m21 - m12, m02 - m20, m10 - m01], -1)
    qx = torch.stack([m21 - m12, safe_sqrt(1 + m00 - m11 - m22), m01 + m10, m02 + m20], -1)
    qy = torch.stack([m02 - m20, m01 + m10, safe_sqrt(1 - m00 + m11 - m22), m12 + m21], -1)
    qz = torch.stack([m10 - m01, m02 + m20, m12 + m21, safe_sqrt(1 - m00 - m11 + m22)], -1)
    cases = torch.stack([qw, qx, qy, qz], dim=-2)  # (..., 4, 4)
    idx = torch.argmax(torch.stack([tr, m00, m11, m22], dim=-1), dim=-1)
    q = torch.take_along_dim(cases, idx[..., None, None].expand(idx.shape + (1, 4)), dim=-2)[..., 0, :]
    q = normalize_quat(q)
    return torch.where(q[..., 0:1] < 0, -q, q)


def yaw_quat(q: torch.Tensor) -> torch.Tensor:
    """The yaw-only part of q (mjlab_tpu/utils/math.py yaw_quat)."""
    qw, qx, qy, qz = q.unbind(-1)
    yaw = torch.atan2(2 * (qw * qz + qx * qy), 1 - 2 * (qy * qy + qz * qz))
    half = 0.5 * yaw
    zero = torch.zeros_like(half)
    return torch.stack([torch.cos(half), zero, zero, torch.sin(half)], dim=-1)


def quat_from_euler_xyz(roll, pitch, yaw) -> torch.Tensor:
    cr, sr = torch.cos(roll * 0.5), torch.sin(roll * 0.5)
    cp, sp = torch.cos(pitch * 0.5), torch.sin(pitch * 0.5)
    cy, sy = torch.cos(yaw * 0.5), torch.sin(yaw * 0.5)
    return torch.stack([
        cr * cp * cy + sr * sp * sy,
        sr * cp * cy - cr * sp * sy,
        cr * sp * cy + sr * cp * sy,
        cr * cp * sy - sr * sp * cy,
    ], dim=-1)


def euler_xyz_from_quat(q: torch.Tensor):
    w, x, y, z = q.unbind(-1)
    roll = torch.atan2(2 * (w * x + y * z), 1 - 2 * (x * x + y * y))
    pitch = torch.asin(torch.clamp(2 * (w * y - z * x), -1.0, 1.0))
    yaw = torch.atan2(2 * (w * z + x * y), 1 - 2 * (y * y + z * z))
    return roll, pitch, yaw


def wrap_to_pi(x: torch.Tensor) -> torch.Tensor:
    """x wrapped into [-pi, pi) (floor modulo, as jnp.mod)."""
    return torch.remainder(x + math.pi, 2 * math.pi) - math.pi
