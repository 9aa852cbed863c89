"""Env-level math library (batched torch tensors).

PyTorch counterpart of mjlab_tpu/utils/math.py, the reference's vendored
Isaac Lab math utilities: quaternion operations, frame and pose
transforms, yaw and heading, scalings, and samplers. Quaternions are (w,
x, y, z) on the trailing axis; the algebra is phys/math.py's. Every
function but ``is_identity_pose`` (a host bool) stays on its inputs'
device and reads no device value on the host. The samplers take a
``torch.Generator`` and a device where the JAX package takes a key: their
streams differ from jax.random's, their distributions are the same.
"""

from __future__ import annotations

import math

import torch

from mjlab_tpu_torch.phys.math import (
    conj_quat, cross, mul_quat, normalize_quat, quat_sub, quat_to_mat, rot_vec_quat, skew,
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


quat_from_matrix = mat_to_quat


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


def quat_rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v rotated by q (quat_apply's other name)."""
    return rot_vec_quat(v, q)


def quat_rotate_inverse(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """v rotated by the inverse of the unit quaternion q."""
    return rot_vec_quat(v, conj_quat(q))


def _unit_x(q: torch.Tensor) -> torch.Tensor:
    """(..., 3) unit x vectors shaped as q's leading axes, made on the
    device (no host copy)."""
    v = torch.zeros_like(q[..., :3])
    v[..., 0] = 1.0
    return v


def _identity_quat(q: torch.Tensor) -> torch.Tensor:
    out = torch.zeros_like(q)
    out[..., 0] = 1.0
    return out


def heading_from_quat(q: torch.Tensor) -> torch.Tensor:
    """The heading (yaw) of the body's x axis in the world frame."""
    fwd = rot_vec_quat(_unit_x(q), q)
    return torch.atan2(fwd[..., 1], fwd[..., 0])


def combine_frame_transforms(p1, q1, p2=None, q2=None):
    """The pose of frame 2 in frame 0 (T01 T12): (position, quaternion);
    p2 and q2 default to the identity."""
    if p2 is None:
        p2 = torch.zeros_like(p1)
    if q2 is None:
        q2 = _identity_quat(q1)
    return p1 + rot_vec_quat(p2, q1), mul_quat(q1, q2)


# ---------------------------------------------------------------------------
# scalings
# ---------------------------------------------------------------------------


def scale_transform(x, lower, upper):
    """[lower, upper] -> [-1, 1]."""
    offset = (lower + upper) * 0.5
    return 2.0 * (x - offset) / (upper - lower)


def unscale_transform(x, lower, upper):
    """[-1, 1] -> [lower, upper]."""
    offset = (lower + upper) * 0.5
    return x * (upper - lower) * 0.5 + offset


def saturate(x, lower, upper):
    return torch.clamp(x, lower, upper)


def copysign_like(mag: float, other: torch.Tensor) -> torch.Tensor:
    """|mag| with the elementwise sign of ``other`` (+ where it is 0)."""
    return abs(mag) * torch.sign(torch.where(other == 0, 1.0, other))


# ---------------------------------------------------------------------------
# quaternions
# ---------------------------------------------------------------------------


def quat_unique(q: torch.Tensor) -> torch.Tensor:
    """The hemisphere of w >= 0: quaternions with a negative w negated."""
    return torch.where(q[..., 0:1] < 0, -q, q)


def convert_quat(quat: torch.Tensor, to: str = "xyzw") -> torch.Tensor:
    """Reorder between (w, x, y, z) and (x, y, z, w)."""
    if to == "xyzw":
        return torch.cat([quat[..., 1:4], quat[..., 0:1]], dim=-1)
    if to == "wxyz":
        return torch.cat([quat[..., 3:4], quat[..., 0:3]], dim=-1)
    raise ValueError(f"convert_quat: unknown target '{to}'")


def quat_from_angle_axis(angle: torch.Tensor, axis: torch.Tensor) -> torch.Tensor:
    """The rotation by ``angle`` (rad) about the unit ``axis``."""
    half = 0.5 * angle[..., None]
    return torch.cat([torch.cos(half), torch.sin(half) * axis], dim=-1)


def axis_angle_from_quat(quat: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """The rotation vector (axis times angle) of a quaternion, taken in the
    w >= 0 hemisphere; near the identity angle / sin(angle / 2) is its
    Taylor value 2 + angle^2 / 12."""
    q = quat_unique(quat)
    sin_half = torch.linalg.vector_norm(q[..., 1:4], dim=-1, keepdim=True)
    angle = 2.0 * torch.atan2(sin_half, q[..., 0:1])
    small = sin_half < eps
    scale = torch.where(small, 2.0 + angle * angle / 12.0,
                        angle / torch.where(small, 1.0, sin_half))
    return scale * q[..., 1:4]


def quat_box_minus(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """The tangent-space difference q1 [-] q2."""
    return axis_angle_from_quat(mul_quat(q1, conj_quat(q2)))


def quat_box_plus(q: torch.Tensor, delta: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """q [+] delta: the tangent-space increment delta applied to q."""
    angle = torch.linalg.vector_norm(delta, dim=-1, keepdim=True)
    small = angle < eps
    axis = torch.where(small, 0.0, delta / torch.where(small, 1.0, angle))
    dq = quat_from_angle_axis(angle[..., 0], axis)
    return normalize_quat(mul_quat(dq, q))


def quat_apply_yaw(quat: torch.Tensor, vec: torch.Tensor) -> torch.Tensor:
    """vec rotated by the yaw part of quat alone."""
    return quat_apply(yaw_quat(quat), vec)


def quat_slerp(q1: torch.Tensor, q2: torch.Tensor, tau) -> torch.Tensor:
    """Spherical interpolation from q1 (tau 0) to q2 (tau 1) along the
    shorter arc; linear where the two are within 1e-6 of each other."""
    d = (q1 * q2).sum(-1, keepdim=True)
    q2 = torch.where(d < 0, -q2, q2)
    d = torch.clamp(d.abs(), 0.0, 1.0)
    theta = torch.acos(d)
    sin = torch.sin(theta)
    small = sin < 1e-6
    safe = torch.where(small, 1.0, sin)
    w1 = torch.where(small, 1.0 - tau, torch.sin((1 - tau) * theta) / safe)
    w2 = torch.where(small, tau, torch.sin(tau * theta) / safe)
    return normalize_quat(w1 * q1 + w2 * q2)


def skew_symmetric_matrix(vec: torch.Tensor) -> torch.Tensor:
    return skew(vec)


# ---------------------------------------------------------------------------
# poses and twists
# ---------------------------------------------------------------------------


def is_identity_pose(pos: torch.Tensor, rot: torch.Tensor, atol: float = 1e-6) -> bool:
    """Whether every pose is the identity (rot +-identity), on the host."""
    ident = _identity_quat(rot)
    zero = torch.zeros_like(pos)
    return bool(torch.allclose(pos, zero, atol=atol)
                and (torch.allclose(rot, ident, atol=atol)
                     or torch.allclose(rot, -ident, atol=atol)))


def rigid_body_twist_transform(v_b, w_b, p_ab, q_ab):
    """The twist of frame B expressed in A from B's twist and the A <- B
    transform: w_a = R w_b, v_a = R v_b + p x w_a."""
    w_a = quat_apply(q_ab, w_b)
    v_a = quat_apply(q_ab, v_b) + cross(p_ab, w_a)
    return v_a, w_a


def compute_pose_error(t01, q01, t02, q02, rot_error_type: str = "axis_angle"):
    """The position and orientation error from pose 1 to pose 2: the
    orientation as a quaternion ("quat") or a rotation vector
    ("axis_angle")."""
    pos_err = t02 - t01
    if rot_error_type == "quat":
        return pos_err, mul_quat(q02, conj_quat(q01))
    if rot_error_type == "axis_angle":
        return pos_err, quat_box_minus(q02, q01)
    raise ValueError(f"unknown rot_error_type '{rot_error_type}'")


def apply_delta_pose(source_pos, source_rot, delta_pose, eps: float = 1e-6):
    """A pose moved by a 6D [dpos, drotvec] increment."""
    return (source_pos + delta_pose[..., :3],
            quat_box_plus(source_rot, delta_pose[..., 3:6], eps))


def transform_points(points, pos=None, quat=None):
    """(..., N, 3) points moved by a pose ((..., 3), (..., 4))."""
    out = points
    if quat is not None:
        out = quat_apply(quat[..., None, :], out)
    if pos is not None:
        out = out + pos[..., None, :]
    return out


def make_pose(pos: torch.Tensor, rot_mat: torch.Tensor) -> torch.Tensor:
    """(..., 4, 4) homogeneous poses from positions and rotation
    matrices."""
    batch = torch.broadcast_shapes(pos.shape[:-1], rot_mat.shape[:-2])
    pose = pos.new_zeros(batch + (4, 4))
    pose[..., :3, :3] = rot_mat
    pose[..., :3, 3] = pos
    pose[..., 3, 3] = 1.0
    return pose


def unmake_pose(pose: torch.Tensor):
    return pose[..., :3, 3], pose[..., :3, :3]


def pose_inv(pose: torch.Tensor) -> torch.Tensor:
    R = pose[..., :3, :3]
    Rt = R.transpose(-1, -2)
    return make_pose(-torch.einsum("...ij,...j->...i", Rt, pose[..., :3, 3]), Rt)


def pose_in_A_to_pose_in_B(pose_in_A: torch.Tensor, pose_A_in_B: torch.Tensor) -> torch.Tensor:
    return pose_A_in_B @ pose_in_A


def matrix_from_euler(euler_angles: torch.Tensor, convention: str = "XYZ") -> torch.Tensor:
    """The rotation matrix of euler angles about the axes of
    ``convention``, composed left to right."""
    out = None
    for i, ax in enumerate(convention):
        ang = euler_angles[..., i]
        c, s = torch.cos(ang), torch.sin(ang)
        one, zero = torch.ones_like(c), torch.zeros_like(c)
        if ax == "X":
            rows = [one, zero, zero, zero, c, -s, zero, s, c]
        elif ax == "Y":
            rows = [c, zero, s, zero, one, zero, -s, zero, c]
        else:
            rows = [c, -s, zero, s, c, zero, zero, zero, one]
        R = torch.stack(rows, dim=-1).reshape(ang.shape + (3, 3))
        out = R if out is None else out @ R
    return out


def default_orientation(num: int, device="cpu", dtype=torch.float32) -> torch.Tensor:
    """(num, 4) identity quaternions."""
    out = torch.zeros((num, 4), dtype=dtype, device=device)
    out[:, 0] = 1.0
    return out


# ---------------------------------------------------------------------------
# samplers: a torch.Generator on ``device`` where the JAX package takes a key
# ---------------------------------------------------------------------------


def _uniform(generator, shape, device, dtype=torch.float32, lo=0.0, hi=1.0):
    u = torch.rand(tuple(shape), generator=generator, dtype=dtype, device=device)
    return u * (hi - lo) + lo


def sample_uniform(generator, lo, hi, shape, dtype=torch.float32, device="cpu"):
    """Uniform on [lo, hi)."""
    return _uniform(generator, shape, device, dtype, lo, hi)


def sample_log_uniform(generator, lo, hi, shape, dtype=torch.float32, device="cpu"):
    """exp of a uniform on [log lo, log hi)."""
    lo = torch.as_tensor(lo, dtype=dtype, device=device)
    hi = torch.as_tensor(hi, dtype=dtype, device=device)
    u = _uniform(generator, shape, device, dtype)
    return torch.exp(torch.log(lo) + u * (torch.log(hi) - torch.log(lo)))


def sample_gaussian(generator, mean, std, shape, dtype=torch.float32, device="cpu"):
    """mean + std N(0, 1)."""
    return mean + std * torch.randn(tuple(shape), generator=generator, dtype=dtype,
                                    device=device)


def sample_triangle(generator, lower: float, upper: float, shape, device="cpu"):
    """The symmetric triangular distribution on [lower, upper]."""
    r = _uniform(generator, shape, device, lo=-1.0, hi=1.0)
    r = torch.where(r < 0, -torch.sqrt(-r), torch.sqrt(r))  # in [-1, 1], peaked at 0
    return (r + 1.0) * 0.5 * (upper - lower) + lower


def sample_cylinder(generator, radius: float, h_range, shape, device="cpu"):
    """Uniform points inside an upright cylinder of ``radius`` about the
    z axis, heights in h_range: (*shape, 3)."""
    r = radius * torch.sqrt(_uniform(generator, shape, device))
    theta = 2 * math.pi * _uniform(generator, shape, device)
    h = _uniform(generator, shape, device, lo=h_range[0], hi=h_range[1])
    return torch.stack([r * torch.cos(theta), r * torch.sin(theta), h], dim=-1)


def random_orientation(generator, num: int, device="cpu") -> torch.Tensor:
    """(num, 4) unit quaternions uniform on the rotations."""
    u1, u2, u3 = _uniform(generator, (3, num), device)
    w = torch.sqrt(1 - u1) * torch.sin(2 * math.pi * u2)
    x = torch.sqrt(1 - u1) * torch.cos(2 * math.pi * u2)
    y = torch.sqrt(u1) * torch.sin(2 * math.pi * u3)
    z = torch.sqrt(u1) * torch.cos(2 * math.pi * u3)
    return torch.stack([w, x, y, z], dim=-1)


def random_yaw_orientation(generator, num: int, device="cpu") -> torch.Tensor:
    """(num, 4) rotations about z by a yaw uniform on [-pi, pi)."""
    yaw = _uniform(generator, (num,), device, lo=-math.pi, hi=math.pi)
    zeros = torch.zeros_like(yaw)
    return quat_from_euler_xyz(zeros, zeros, yaw)
