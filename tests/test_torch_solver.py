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
    G1_NCONMAX, TOY_NCONMAX, g1_mj, model_pair, rel_err, state_np, tnp,
    toy_mj,
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


@pytest.mark.parametrize("name", ["toy", "g1"])
def test_newton_plain_matches_solve_lm_f32(name):
    mj, nconmax, keyframe = (
        (toy_mj(), TOY_NCONMAX, False) if name == "toy"
        else (g1_mj(), G1_NCONMAX, True)
    )
    jm, m = model_pair(mj, nconmax, np.float32)
    q, v, c = _states(m, mj, keyframe)
    ref = _jax_forward(jm, q, v, c)

    d = make_data(m, E).replace(
        qpos=torch.as_tensor(q), qvel=torch.as_tensor(v), ctrl=torch.as_tensor(c)
    )
    iters = torch.zeros(E, dtype=torch.int32)
    _, _, sol = forward_solve(m, d, iters=iters)
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
    kw = dict(nv=1, K=1, R=4, ndirs=2, neq=0, nlim=1, lim_dofs=(0,),
              iterations=1, ls_iterations=8, tolerance=1e-8, do_int=False)
    z = torch.zeros(1, 1)
    args = (z,) * 23
    with pytest.raises(NotImplementedError, match="elliptic"):
        sv.newton_assemble_solve(*args, **{**kw, "cone": 1})
    with pytest.raises(NotImplementedError, match="equality"):
        sv.newton_assemble_solve(*args, **{**kw, "neq": 1})
