"""The YAM lift-cube physics step of the PyTorch port against the JAX
package at float32: the elliptic-cone solve (the plain version of kernel 5,
with the joint equality row) against solve_lm, and a few-step trajectory
against step_hybrid, both with MJLAB_TPU_SOLVER=pure.

128 envs, half at the task's reset state (the cube on the table), half
pinching the cube, settled for 10 steps with the port's step: a random
interpenetrating state is too ill-conditioned for an f32 comparison
(impratio 10 with condim-6 torsion and roll rows gives D ratios near
1e-5; PERF_NOTES.md).

Tolerances, relative to max(1, |ref|max): qacc 2e-3 and per-row forces
6e-3, the measured f32 sensitivity of the solve (tests/test_pallas2_solver.py);
qfrc_constraint 2e-3 of the row-force scale max(1, |efc_force|max): in a
pinch the finger forces cancel on the cube's dofs, so qfrc there is a
small difference of large row forces and its error is J^T of theirs
(on this state the row-force scale is 158.5 against qfrc's own 15.45, and
the error is 6.0e-4 of the first, 6.2e-3 of the second). The trajectory:
qpos 2e-4 and qvel 2e-2 after 5 steps, the chaos scale of
test_pallas2_matches_pure_elliptic_multistep. The active contact slots
are the same set in every env; mirror-symmetric fingertip slots that tie
to a few f32 ulps may be ordered differently, so row forces are compared
slot by slot.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.data import make_data as jax_make_data
from mjlab_tpu.phys.hybrid import step_hybrid
from mjlab_tpu.sim.sim import model_in_axes
from mjlab_tpu_torch.phys.data import make_data
from mjlab_tpu_torch.phys.hybrid import step_envlast

from torch_port_common import (
    YAM_NCONMAX, model_pair, rel_err, tnp, yam_mj, yam_states,
)

E = 128
STEPS = 5


@pytest.fixture(scope="module")
def runs():
    """(port Data list, JAX Data list): the settled state stepped STEPS
    times by each package (entry i is the Data after step i + 1)."""
    mj = yam_mj()
    jm, m = model_pair(mj, YAM_NCONMAX, np.float32)
    q, v, c, mp, mq = yam_states(m, E, dtype=np.float32)
    T = torch.as_tensor
    d = make_data(m, E).replace(
        qpos=T(q), qvel=T(v), ctrl=T(c), mocap_pos=T(mp), mocap_quat=T(mq)
    )
    for _ in range(10):
        d = step_envlast(m, d)
    d0 = jax_make_data(jm, dtype=jnp.float32)
    dj = jax.tree_util.tree_map(
        lambda x: jnp.broadcast_to(x, (E,) + x.shape), d0
    ).replace(
        **{f: jnp.asarray(getattr(d, f).numpy()) for f in (
            "qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat",
            "qacc_warmstart")}
    )
    axes = model_in_axes(jm, frozenset())
    old = os.environ.get("MJLAB_TPU_SOLVER")
    os.environ["MJLAB_TPU_SOLVER"] = "pure"
    try:
        step = jax.jit(lambda dd: step_hybrid(jm, frozenset(), dd, axes, lean=True))
        port, ref = [], []
        for _ in range(STEPS):
            dj = step(dj)
            d = step_envlast(m, d)
            ref.append(dj)
            port.append(d)
    finally:
        if old is None:
            os.environ.pop("MJLAB_TPU_SOLVER")
        else:
            os.environ["MJLAB_TPU_SOLVER"] = old
    return m, port, ref


def _aligned_contact_forces(m, ref, port):
    """The port's contact row forces reordered to the JAX slot order,
    after checking that the active slots are the same set in every env."""
    K, R = m.ncon_max, m.rows_per_con
    base = m.neq_jnt + m.nv + m.nlimit
    rs, ra = np.asarray(ref.con_sel), np.asarray(ref.con_sel_active)
    ps, pa = port.con_sel.numpy(), port.con_sel_active.numpy()
    fp = tnp(port.efc_force)
    rows = fp[:, base:base + K * R].reshape(E, K, R)
    out = np.zeros_like(rows)
    for e in range(E):
        assert sorted(rs[e][ra[e]]) == sorted(ps[e][pa[e]]), f"env {e}"
        where = {s: k for k, s in enumerate(ps[e]) if pa[e][k]}
        for k in np.flatnonzero(ra[e]):
            out[e, k] = rows[e, where[rs[e][k]]]
    return np.concatenate([fp[:, :base], out.reshape(E, K * R)], axis=1)


def test_yam_elliptic_solve_matches_solve_lm_f32(runs):
    """The first step's solve outputs from the same settled state."""
    m, port, ref = runs
    d, dj = port[0], ref[0]
    assert int(m.opt.cone) == 1 and m.neq_jnt == 1 and m.rows_per_con == 6
    assert float(d.con_sel_active.any(dim=1).double().mean()) > 0.9
    assert int(d.con_sel_active.sum()) > 4 * E, "the grasping envs must pinch"
    assert rel_err(dj.qacc_smooth, tnp(d.qacc_smooth)) < 2e-3
    assert rel_err(dj.qacc, tnp(d.qacc)) < 2e-3
    f_ref = np.asarray(dj.efc_force, np.float64)
    assert rel_err(f_ref, _aligned_contact_forces(m, dj, d)) < 6e-3
    force_scale = max(1.0, float(np.abs(f_ref).max()))
    qfrc_err = np.abs(np.asarray(dj.qfrc_constraint, np.float64)
                      - tnp(d.qfrc_constraint)).max()
    assert qfrc_err / force_scale < 2e-3
    # the joint-equality row (the first efc row) carries the finger coupling
    assert float(np.abs(f_ref[:, 0]).max()) > 0
    assert int(d.ncheck_reset.sum()) == 0


def test_yam_steps_match_step_hybrid_pure_f32(runs):
    """A 5-step trajectory of the lift-cube physics."""
    m, port, ref = runs
    d, dj = port[-1], ref[-1]
    for f, tol in (("qpos", 2e-4), ("qvel", 2e-2)):
        err = rel_err(getattr(dj, f), tnp(getattr(d, f)))
        assert err < tol, f"{f}: {err:.2e}"
    np.testing.assert_array_equal(
        np.asarray(dj.con_found), d.con_found.numpy()
    )
    assert int(d.ncheck_reset.sum()) == 0
    assert bool(torch.isfinite(d.qpos).all())


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("field", ["qpos", "qvel", "con_found"])
def test_yam_trajectory_step_matches_step_hybrid_pure_f32(runs, field, step):
    """Every step of the trajectory, not only the last: qpos and qvel
    within the trajectory's tolerances (the error grows with the steps, so
    the last step's tolerance holds at each), the same contacts found."""
    m, port, ref = runs
    d, dj = port[step], ref[step]
    if field == "con_found":
        np.testing.assert_array_equal(np.asarray(dj.con_found), d.con_found.numpy())
        return
    tol = {"qpos": 2e-4, "qvel": 2e-2}[field]
    err = rel_err(getattr(dj, field), tnp(getattr(d, field)))
    assert err < tol, f"step {step + 1} {field}: {err:.2e}"

