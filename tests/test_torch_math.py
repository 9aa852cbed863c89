"""The port's env-level math library (mjlab_tpu_torch/utils/math.py)
against the JAX package's (mjlab_tpu/utils/math.py) on seeded inputs, at
float64, within 1e-12 relative (to max(1, |JAX|max)).

Sign-sensitive outputs are held as the JAX package defines them, not up
to -q: quat_unique's hemisphere, axis_angle_from_quat's and
quat_box_minus's rotation vectors (inputs on both hemispheres, and near
the identity where the Taylor branch takes over), quat_slerp across a
negative dot product. The samplers draw from a torch.Generator where the
JAX package draws from a key, so their streams differ: each is held by
shape, dtype, support and its first two moments over 200,000 seeded
draws (to 0.01 of the distribution's scale), and a sampler of
orientations by the unit norm and the uniform distribution's moments.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_tpu.utils.math as J
import mjlab_tpu_torch.utils.math as P

from torch_port_common import rel_err

N = 64


def _quats(rs, n=N, near_identity=0):
    q = rs.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    if near_identity:
        # the first rows within 1e-7 of +-identity (the Taylor branches)
        k = near_identity
        small = 1e-8 * rs.standard_normal((k, 3))
        q[:k] = np.concatenate([np.ones((k, 1)), small], axis=1)
        q[: k // 2] *= -1.0
        q[:k] /= np.linalg.norm(q[:k], axis=1, keepdims=True)
    return q


def _inputs(name, rs):
    """(positional args, keyword args) as numpy arrays or python values."""
    v = rs.standard_normal((N, 3))
    q1, q2 = _quats(rs, near_identity=6), _quats(rs)
    lo, hi = -rs.uniform(0.5, 2.0, (N, 3)), rs.uniform(0.5, 2.0, (N, 3))
    pose = np.zeros((N, 4, 4))
    pose[:, :3, :3] = np.asarray(J.quat_to_mat(jnp.asarray(q1)))
    pose[:, :3, 3] = v
    pose[:, 3, 3] = 1.0
    table = {
        "apply_delta_pose": ((v, q1, rs.standard_normal((N, 6))), {}),
        "axis_angle_from_quat": ((q1,), {}),
        "combine_frame_transforms": ((v, q1, rs.standard_normal((N, 3)), q2), {}),
        "compute_pose_error": ((v, q1, rs.standard_normal((N, 3)), q2), {}),
        "convert_quat": ((q1,), {"to": "xyzw"}),
        "copysign_like": ((-2.5, np.where(rs.random((N, 3)) < 0.2, 0.0, v)), {}),
        "heading_from_quat": ((q1,), {}),
        "make_pose": ((v, np.asarray(J.quat_to_mat(jnp.asarray(q2)))), {}),
        "matrix_from_euler": ((rs.uniform(-3, 3, (N, 3)),), {"convention": "ZYX"}),
        "pose_in_A_to_pose_in_B": ((pose, pose[::-1].copy()), {}),
        "pose_inv": ((pose,), {}),
        "quat_apply_yaw": ((q1, v), {}),
        "quat_box_minus": ((q1, q2), {}),
        "quat_box_plus": ((q1, np.concatenate([1e-8 * v[:4], v[4:]])), {}),
        "quat_from_angle_axis": ((rs.uniform(-4, 4, N),
                                  v / np.linalg.norm(v, axis=1, keepdims=True)), {}),
        "quat_rotate": ((q1, v), {}),
        "quat_rotate_inverse": ((q1, v), {}),
        "quat_slerp": ((q1, np.concatenate([q1[:3], -q2[3:]]), rs.uniform(0, 1, (N, 1))), {}),
        "quat_unique": ((q1,), {}),
        "rigid_body_twist_transform": ((v, rs.standard_normal((N, 3)),
                                        rs.standard_normal((N, 3)), q2), {}),
        "saturate": ((3 * v, lo, hi), {}),
        "scale_transform": ((v, lo, hi), {}),
        "skew_symmetric_matrix": ((v,), {}),
        "transform_points": ((rs.standard_normal((N, 5, 3)), v, q1), {}),
        "unmake_pose": ((pose,), {}),
        "unscale_transform": ((v, lo, hi), {}),
    }
    return table[name]


DETERMINISTIC = sorted([
    "apply_delta_pose", "axis_angle_from_quat", "combine_frame_transforms",
    "compute_pose_error", "convert_quat", "copysign_like", "heading_from_quat", "make_pose",
    "matrix_from_euler", "pose_in_A_to_pose_in_B", "pose_inv", "quat_apply_yaw",
    "quat_box_minus", "quat_box_plus", "quat_from_angle_axis", "quat_rotate",
    "quat_rotate_inverse", "quat_slerp", "quat_unique", "rigid_body_twist_transform",
    "saturate", "scale_transform", "skew_symmetric_matrix", "transform_points", "unmake_pose",
    "unscale_transform",
])
SAMPLERS = sorted(["sample_uniform", "sample_log_uniform", "sample_gaussian",
                   "sample_triangle", "sample_cylinder", "random_orientation",
                   "random_yaw_orientation"])
OTHER = sorted(["default_orientation", "is_identity_pose"])


def _flat(x):
    if isinstance(x, (tuple, list)):
        return [y for z in x for y in _flat(z)]
    return [np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x, np.float64)]


def test_every_missing_function_is_covered():
    """The 35 functions this file holds, each now in the port."""
    names = DETERMINISTIC + SAMPLERS + OTHER
    assert len(set(names)) == 35
    for n in names:
        assert callable(getattr(P, n)) and callable(getattr(J, n)), n


@pytest.mark.parametrize("name", DETERMINISTIC)
def test_math_function_matches_jax(name):
    rs = np.random.default_rng(sum(map(ord, name)))
    args, kw = _inputs(name, rs)
    with jax.enable_x64(True):
        jargs = [jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]
        want = _flat(getattr(J, name)(*jargs, **kw))
    pargs = [torch.as_tensor(a.copy()) if isinstance(a, np.ndarray) else a for a in args]
    got = _flat(getattr(P, name)(*pargs, **kw))
    assert len(want) == len(got)
    for w, g in zip(want, got):
        assert w.shape == g.shape
        assert rel_err(w, g) < 1e-12, f"{name}: {rel_err(w, g):.2e}"


def test_sign_sensitive_outputs_keep_the_jax_hemisphere():
    """quat_unique takes w >= 0 exactly as the JAX package (a quaternion
    and its negation give the same output); axis_angle_from_quat of q and
    -q agree; convert_quat round-trips."""
    rs = np.random.default_rng(2)
    q = torch.as_tensor(_quats(rs, near_identity=8))
    u = P.quat_unique(q)
    assert (u[:, 0] >= 0).all()
    torch.testing.assert_close(P.quat_unique(-q)[q[:, 0] != 0], u[q[:, 0] != 0],
                               rtol=0, atol=0)
    torch.testing.assert_close(P.axis_angle_from_quat(q), P.axis_angle_from_quat(-q),
                               rtol=0, atol=0)
    torch.testing.assert_close(P.convert_quat(P.convert_quat(q, "xyzw"), "wxyz"), q,
                               rtol=0, atol=0)
    with pytest.raises(ValueError):
        P.convert_quat(q, "abcd")


def test_default_orientation_and_identity_pose_match_jax():
    with jax.enable_x64(True):
        want = np.asarray(J.default_orientation(5))
    got = P.default_orientation(5)
    assert got.dtype == torch.float32 and got.shape == (5, 4)
    np.testing.assert_array_equal(want, got.numpy())
    q = P.default_orientation(3, dtype=torch.float64)
    p = torch.zeros(3, 3, dtype=torch.float64)
    for pos, rot in ((p, q), (p, -q), (p + 1e-3, q), (p, P.quat_from_angle_axis(
            torch.full((3,), 0.1, dtype=torch.float64), torch.eye(3, dtype=torch.float64)))):
        with jax.enable_x64(True):
            expect = J.is_identity_pose(jnp.asarray(pos.numpy()), jnp.asarray(rot.numpy()))
        assert P.is_identity_pose(pos, rot) is expect


M = 200_000


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _moments_close(x, mean, var, scale, what):
    x = x.double()
    assert abs(float(x.mean()) - mean) < 0.01 * scale, (what, float(x.mean()), mean)
    assert abs(float(x.var()) - var) < 0.01 * scale ** 2, (what, float(x.var()), var)


@pytest.mark.parametrize("name", SAMPLERS)
def test_sampler_distribution(name):
    """Shape, dtype, support and moments (the JAX sampler's shape and
    dtype on the same arguments; the moments the distribution's)."""
    g = _gen(7)
    key = jax.random.PRNGKey(0)
    if name == "sample_uniform":
        x = P.sample_uniform(g, -1.5, 2.5, (M,))
        ref = J.sample_uniform(key, -1.5, 2.5, (4,))
        assert ((x >= -1.5) & (x < 2.5)).all()
        _moments_close(x, 0.5, 16 / 12, 4.0, name)
    elif name == "sample_log_uniform":
        x = P.sample_log_uniform(g, 0.1, 10.0, (M,))
        ref = J.sample_log_uniform(key, 0.1, 10.0, (4,))
        assert ((x >= 0.1 * (1 - 1e-6)) & (x <= 10.0 * (1 + 1e-6))).all()
        lx = torch.log(x)
        _moments_close(lx, 0.0, (2 * math.log(10)) ** 2 / 12, 2 * math.log(10), name)
    elif name == "sample_gaussian":
        x = P.sample_gaussian(g, 1.0, 0.5, (M,))
        ref = J.sample_gaussian(key, 1.0, 0.5, (4,))
        _moments_close(x, 1.0, 0.25, 0.5, name)
    elif name == "sample_triangle":
        x = P.sample_triangle(g, -1.0, 3.0, (M,))
        ref = J.sample_triangle(key, -1.0, 3.0, (4,))
        assert ((x >= -1.0) & (x <= 3.0)).all()
        # the JAX sampler's distribution: s = sign(r) sqrt(|r|), r uniform
        # on [-1, 1], has density |s| (V-shaped, heavy at the ends, not the
        # triangle its name says; ROADMAP.md queue 3): mean (a + b) / 2,
        # var (b - a)^2 / 8
        _moments_close(x, 1.0, 16 / 8, 4.0, name)
        assert float(((x - 1.0).abs() < 0.5).double().mean()) < 0.1  # little mass mid-range
    elif name == "sample_cylinder":
        x = P.sample_cylinder(g, 0.5, (0.1, 0.3), (M,))
        ref = J.sample_cylinder(key, 0.5, (0.1, 0.3), (4,))
        r2 = x[:, 0] ** 2 + x[:, 1] ** 2
        assert (r2 <= 0.25 + 1e-6).all() and ((x[:, 2] >= 0.1) & (x[:, 2] < 0.3)).all()
        _moments_close(r2 / 0.25, 0.5, 1 / 12, 1.0, name)  # r^2 / R^2 uniform
        _moments_close(x[:, 0], 0.0, 0.25 / 4, 0.5, name)
    elif name == "random_orientation":
        x = P.random_orientation(g, M)
        ref = J.random_orientation(key, 4)
        torch.testing.assert_close(torch.linalg.vector_norm(x.double(), dim=1),
                                   torch.ones(M, dtype=torch.float64), rtol=0, atol=1e-5)
        for i in range(4):  # uniform on S3: each component mean 0, var 1/4
            _moments_close(x[:, i], 0.0, 0.25, 1.0, f"{name}[{i}]")
    else:
        x = P.random_yaw_orientation(g, M)
        ref = J.random_yaw_orientation(key, 4)
        assert (x[:, 1:3] == 0).all()
        yaw = 2 * torch.atan2(x[:, 3], x[:, 0])
        assert ((yaw >= -math.pi - 1e-5) & (yaw <= math.pi + 1e-5)).all()
        _moments_close(yaw, 0.0, math.pi ** 2 / 3, math.pi, name)
    ref = np.asarray(ref)
    assert x.shape[1:] == ref.shape[1:] and str(x.dtype).split(".")[-1] == str(ref.dtype)
    assert torch.isfinite(x).all()


def test_samplers_follow_their_generator_and_device():
    """The same generator seed draws the same numbers; the draws are on
    the device asked for (the CPU here) at the dtype asked for."""
    a = P.sample_gaussian(_gen(3), 0.0, 1.0, (10,), dtype=torch.float64)
    b = P.sample_gaussian(_gen(3), 0.0, 1.0, (10,), dtype=torch.float64)
    assert a.dtype == torch.float64 and a.device.type == "cpu"
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    c = P.sample_uniform(_gen(4), 0.0, 1.0, (10,))
    assert not torch.equal(c, P.sample_uniform(_gen(5), 0.0, 1.0, (10,)))
