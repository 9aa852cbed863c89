"""The plain newton_assemble_solve (mjlab_tpu_torch.phys.solver_kernels)
against the JAX package's env-last Newton solver (lm/solver.solve_lm, the
CPU path of its hybrid step) at f32, from the same states.

Both sides build their own contact rows from the same qpos/qvel/ctrl; the
port runs its contact stack and hands the compact per-slot tensors to the
fused assembly + solve, the JAX side assembles dense rows and runs
solve_lm. Tolerances are the measured f32 sensitivity of the solve
(tests/test_pallas2_solver.py): 2e-3 relative on qacc and
qfrc_constraint, 6e-3 on the per-row forces, scale max(1, |ref|max).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.data import make_data as jax_make_data
from mjlab_tpu.phys.hybrid import _forward_hybrid_impl
from mjlab_tpu.sim.sim import model_in_axes
from mjlab_tpu_torch.phys import solver_kernels as sv
from mjlab_tpu_torch.phys.data import make_data
from mjlab_tpu_torch.phys.hybrid import forward_solve, step_envlast

from torch_port_common import (
    G1_NCONMAX, TOY_NCONMAX, ell_mj, g1_mj, model_pair, rel_err, state_np,
    tnp, toy_mj,
)

E = 128


def _states(m, mj, keyframe, settle=10):
    """Envs lowered into the ground, then settled for a few steps with the
    port's step: (nearly) every env in contact, at the regime the task runs in (a
    random state interpenetrates hard and is far more ill-conditioned)."""
    q, v, c = state_np(mj, E, keyframe=keyframe, dtype=np.float32)
    lo, hi = (0.05, 0.12) if keyframe else (0.03, 0.06)
    q[:, 2] -= np.linspace(lo, hi, E).astype(np.float32)
    d = make_data(m, E).replace(
        qpos=torch.as_tensor(q), qvel=torch.as_tensor(v), ctrl=torch.as_tensor(c)
    )
    for _ in range(settle):
        d = step_envlast(m, d)
    return d.qpos.numpy(), d.qvel.numpy(), c


def _jax_forward(jm, q, v, c):
    d0 = jax_make_data(jm, dtype=jnp.float32)
    dB = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), d0)
    dB = dB.replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v), ctrl=jnp.asarray(c))
    axes = model_in_axes(jm, frozenset())
    old = os.environ.get("MJLAB_TPU_SOLVER")
    os.environ["MJLAB_TPU_SOLVER"] = "pure"
    try:
        f = jax.jit(lambda dd: _forward_hybrid_impl(jm, frozenset(), dd, axes, True)[0])
        return f(dB)
    finally:
        if old is None:
            os.environ.pop("MJLAB_TPU_SOLVER")
        else:
            os.environ["MJLAB_TPU_SOLVER"] = old


def _plain_solve(m, q, v, c, iters=None):
    d = make_data(m, E).replace(
        qpos=torch.as_tensor(q), qvel=torch.as_tensor(v), ctrl=torch.as_tensor(c)
    )
    return forward_solve(m, d, iters=iters)[2]


def _assert_well_conditioned(m, q, v, c, qacc, tol, seed=0):
    """A few relative nudges of 2e-7 (random signs, seeded) to qpos and
    qvel move the plain solve's qacc by less than a third of ``tol`` in
    every env (relative to max(1, |qacc|max)): the comparison of two f32
    solves means something only where rounding cannot move them further."""
    rng = np.random.default_rng(seed)
    scale = max(1.0, float(qacc.abs().max()))
    for _ in range(3):
        nudge = lambda x: (x * (1 + 2e-7 * rng.choice([-1.0, 1.0], x.shape))).astype(x.dtype)  # noqa: E731
        moved = (_plain_solve(m, nudge(q), nudge(v), c)["qacc"] - qacc).abs().amax(0) / scale
        assert float(moved.max()) < tol / 3, f"env {int(moved.argmax())} moves {float(moved.max()):.3e}"


@pytest.mark.parametrize("name", ["toy", "g1", "ell_toy"])
def test_newton_plain_matches_solve_lm_f32(name):
    """ell_toy: the elliptic cone (condim 3 and 6, impratio 10) with a
    joint equality row, held against solve_lm's elliptic path. It settles
    for 30 steps: after 10, nudges of 2e-7 to qpos move its plain qacc by
    up to 0.2 of its scale, and the test turns on the machine's rounding."""
    mj, nconmax, keyframe, settle = {
        "toy": (toy_mj, TOY_NCONMAX, False, 10),
        "g1": (g1_mj, G1_NCONMAX, True, 10),
        "ell_toy": (ell_mj, TOY_NCONMAX, False, 30),
    }[name]
    mj = mj()
    jm, m = model_pair(mj, nconmax, np.float32)
    q, v, c = _states(m, mj, keyframe, settle=settle)
    ref = _jax_forward(jm, q, v, c)

    iters = torch.zeros(E, dtype=torch.int32)
    sol = _plain_solve(m, q, v, c, iters=iters)
    _assert_well_conditioned(m, q, v, c, sol["qacc"], 2e-3)
    touching = sol["k"]["con_sel_active"].any(dim=0).double().mean()
    assert float(touching) > 0.9, "the states must be in contact"
    np.testing.assert_array_equal(
        np.asarray(ref.con_sel), sol["k"]["con_sel"].T.numpy()
    )
    assert rel_err(ref.qacc_smooth, tnp(sol["qacc_smooth"].T)) < 2e-3
    assert rel_err(ref.qacc, tnp(sol["qacc"].T)) < 2e-3
    assert rel_err(ref.qfrc_constraint, tnp(sol["qfrc_constraint"].T)) < 2e-3
    assert rel_err(ref.efc_force, tnp(sol["efc_force"].T)) < 6e-3
    # the solve stops early for some envs and runs to the cap for none
    # or some, never beyond it
    assert int(iters.max()) <= m.opt.iterations and int(iters.min()) >= 1


def test_cholesky_solve_matches_numpy():
    """The Jacobi-scaled, ridged Cholesky solve of the kernel."""
    rng = np.random.default_rng(0)
    nv, Eb = 7, 5
    A = rng.standard_normal((Eb, nv, nv))
    A = A @ np.swapaxes(A, 1, 2) + nv * np.eye(nv)
    g = rng.standard_normal((Eb, nv))
    x = sv._chol_solve(
        torch.as_tensor(np.moveaxis(A, 0, -1)), torch.as_tensor(g.T)
    )
    ref = np.linalg.solve(A, g[..., None])[..., 0]
    # the 1e-6 ridge on the unit-diagonal scaled matrix
    np.testing.assert_allclose(x.numpy().T, ref, rtol=1e-5, atol=1e-6)


def test_wrapper_rejects_uncovered_options():
    """Row layouts the solve does not take: friction directions that do
    not match the cone, more than 6 rows per elliptic contact, more than 4
    pyramid rows per contact."""
    kw = dict(nv=1, K=1, R=4, ndirs=2, neq=0, nlim=1, lim_dofs=(0,),
              iterations=1, ls_iterations=8, tolerance=1e-8, do_int=False)
    z = torch.zeros(1, 1)
    args = (z,) * 23
    with pytest.raises(ValueError, match="ndirs"):
        sv.newton_assemble_solve(*args, **{**kw, "cone": 1})
    with pytest.raises(ValueError, match="ndirs"):
        sv.newton_assemble_solve(*args, **{**kw, "ndirs": 3})
    with pytest.raises(ValueError, match="rows per contact"):
        sv.newton_assemble_solve(*args, **{**kw, "cone": 1, "R": 7, "ndirs": 6})
    # pyramid rows along the frame's two tangents only: condim <= 3
    with pytest.raises(ValueError, match="condim"):
        sv.newton_assemble_solve(*args, **{**kw, "R": 10, "ndirs": 5})


def test_qfrc_errors_iteration_count_rule():
    """qfrc_constraint of a kernel against its plain version: SOLVE_TOL
    where the Newton iteration counts agree, FORCE_TOL where they differ;
    relative to qfrc's own scale under the pyramidal cone and to the row
    forces' scale under the elliptic one."""
    # float32 inputs: the errors carry f32 rounding of 1 + the difference
    q = torch.ones(3, 4)
    f = torch.full((5, 4), 10.0)
    ref = (None, f, f, q)
    got = (None, f, f, q + torch.tensor([0.0, 0.02, 0.001, 0.0]))
    it_ref = torch.tensor([2, 2, 3, 3], dtype=torch.int32)
    it_got = torch.tensor([2, 3, 3, 3], dtype=torch.int32)  # env 1 differs
    pyr = sv.qfrc_errors(ref[3], got[3], it_ref, it_got)
    assert pyr["equal iteration counts"] == (pytest.approx(0.001, rel=1e-4), sv.SOLVE_TOL)
    assert pyr["iteration counts differ"] == (pytest.approx(0.02, rel=1e-4), sv.FORCE_TOL)
    assert sv.row_force_scale(ref) == 10.0
    ell = sv.qfrc_errors(ref[3], got[3], it_ref, it_got, sv.row_force_scale(ref))
    assert ell["equal iteration counts"] == (pytest.approx(1e-4, rel=1e-4), sv.SOLVE_TOL)
    assert ell["iteration counts differ"] == (pytest.approx(2e-3, rel=1e-4), sv.FORCE_TOL)
    same = sv.qfrc_errors(ref[3], got[3], it_ref, it_ref)
    assert same["iteration counts differ"] == (0.0, sv.FORCE_TOL)
