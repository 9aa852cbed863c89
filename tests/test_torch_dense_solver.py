"""Kernel 6's plain version (phys/solver_dense_kernels.py) against the JAX
package's Pallas kernel (phys/solver_pallas.py), run in TPU interpret mode
on the CPU, at float32.

- newton_solve_dense_plain against newton_solve_pallas_envlast on the
  dense inputs of the toy's forward pass (128 envs: the Pallas kernel
  takes 128-env blocks), and of the elliptic toy under the pyramidal cone
  (a joint equality row: the equality row class);
- the port's forward() against JAX forward_hybrid(lean=False) under
  MJLAB_TPU_SOLVER=pallas, which runs the Pallas kernel inside JAX's
  forward pass, on the same toy states.

Tolerances are those of the solve kernels (phys/solver_kernels.py): 2e-3
on accelerations and qfrc_constraint, 6e-3 on row forces, relative to
max(1, |reference|max): two float32 solves that sum in other orders stop
a Newton step apart in some envs. The position and velocity stages before
the solve agree within 1e-4 (float32 rounding through the kinematic tree).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mjlab_tpu.phys.data import make_data as jax_make_data
from mjlab_tpu.phys.hybrid import forward_hybrid as jax_forward_hybrid
from mjlab_tpu.phys.solver_pallas import newton_solve_pallas_envlast
from mjlab_tpu.sim.sim import model_in_axes
from mjlab_tpu_torch.phys import data as pdata
from mjlab_tpu_torch.phys.hybrid import (
    forward_hybrid, forward_stages, solve_dense_inputs,
)
from mjlab_tpu_torch.phys.solver_dense_kernels import (
    newton_solve_dense, newton_solve_dense_plain, row_classes,
)
from mjlab_tpu_torch.phys.solver_kernels import FORCE_TOL, SOLVE_TOL

from torch_port_common import (
    TOY_NCONMAX, eq_mj, model_pair, rel_err, state_np, tnp, toy_mj,
)

E = 128


def _toy_batch(jm, mj, dtype=np.float32):
    """JAX Data of E toy envs lowered into the ground, and the same Data
    in the port (data_from_numpy)."""
    q, v, c = state_np(mj, E, dtype=dtype, qpos_noise=0.05)
    q[:, 2] -= np.linspace(0.0, 0.04, E).astype(dtype)
    d0 = jax_make_data(jm, dtype=jnp.dtype(dtype))
    dB = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), d0)
    dB = dB.replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v), ctrl=jnp.asarray(c))
    return dB, pdata.data_from_numpy(_fields(dB), device="cpu")


def _fields(dj) -> dict:
    return {n: np.array(dj.contact.packed if n == "contact" else getattr(dj, n))
            for n in pdata.tensor_fields()}


@pytest.fixture(scope="module")
def toy():
    mj = toy_mj()
    jm, m = model_pair(mj, TOY_NCONMAX, np.float32)
    dj, dp = _toy_batch(jm, mj)
    return mj, jm, m, dj, dp


def _plain_against_pallas(m, dp):
    """The plain version against the Pallas kernel on the dense inputs of
    dp's forward pass; returns the plain version's row forces."""
    d, k, _ = forward_stages(m, dp)
    args, kw = solve_dense_inputs(m, k, d)
    nc = m.neq_jnt + m.nv + m.nlimit
    assert int((k["efc_D"][nc:] > 0).sum()) > 0, "contacts must be active"
    iters = torch.zeros(E, dtype=torch.int32)
    x_p, f_p = newton_solve_dense_plain(*args, **kw, iters=iters)
    with pltpu.force_tpu_interpret_mode():
        x_j, f_j = newton_solve_pallas_envlast(
            *(jnp.asarray(a.numpy()) for a in args), **kw)
    assert int(iters.max()) > 1
    assert rel_err(np.asarray(x_j), tnp(x_p)) < SOLVE_TOL
    assert rel_err(np.asarray(f_j), tnp(f_p)) < FORCE_TOL
    # the wrapper takes the plain version for CPU tensors
    x_w, f_w = newton_solve_dense(*args, **kw)
    assert torch.equal(x_w, x_p) and torch.equal(f_w, f_p)
    return f_p


def test_plain_matches_pallas_kernel_interpret(toy):
    _, _, m, _, dp = toy
    _plain_against_pallas(m, dp)


def test_plain_matches_pallas_kernel_interpret_equality():
    """The elliptic toy under the pyramidal cone: its joint equality row
    (row 0) in the equality class, beside contact rows of condim 3 and 6."""
    mj = eq_mj()
    jm, m = model_pair(mj, TOY_NCONMAX, np.float32)
    assert m.neq_jnt == 1 and int(m.opt.cone) == 0
    _, dp = _toy_batch(jm, mj)
    f_p = _plain_against_pallas(m, dp)
    assert float(f_p[0].abs().min()) > 1e-3, "the equality row must carry a force"


def test_forward_matches_jax_pallas_forward_interpret(toy, monkeypatch):
    _, jm, m, dj, dp = toy
    monkeypatch.setenv("MJLAB_TPU_SOLVER", "pallas")
    axes = model_in_axes(jm, frozenset())
    with pltpu.force_tpu_interpret_mode():
        out = jax.jit(
            lambda dd: jax_forward_hybrid(jm, frozenset(), dd, axes, lean=False)
        )(dj)
    got = forward_hybrid(m, dp)
    for f, tol in (("qacc", SOLVE_TOL), ("qfrc_constraint", SOLVE_TOL),
                   ("efc_force", FORCE_TOL), ("con_force_c", FORCE_TOL),
                   ("qacc_smooth", 1e-4), ("efc_D", 1e-4), ("efc_aref", 1e-4),
                   ("efc_Jc", 1e-4), ("qM", 1e-4), ("geom_xpos", 1e-4)):
        err = rel_err(np.asarray(getattr(out, f)), tnp(getattr(got, f)))
        assert err < tol, f"{f}: {err:.2e}"
    np.testing.assert_array_equal(np.asarray(out.con_sel), got.con_sel.numpy())
    np.testing.assert_array_equal(np.asarray(out.efc_active), got.efc_active.numpy())


def test_row_classes():
    assert row_classes((0, 1, 0, 0), (1, 0, 0, 0), (0, 0, 1, 0)) == (1, 2, 0, 3)
    with pytest.raises(ValueError, match="more than one"):
        row_classes((1,), (1,), (0,))
