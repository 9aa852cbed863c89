"""The port's full forward pass (Simulation.forward(), phys/hybrid.py
forward_hybrid) and its batched stages against the JAX package.

Both packages start from the same Data, made from numpy seeds (the JAX
batch, handed to the port through data_from_numpy), on the toy (capsule
foot) and on the G1 flat-velocity model with 8 envs lowered into the
ground so that contacts and limits are active, and on the elliptic toy
under the pyramidal cone (eq_toy: a joint equality row in the dense solve).

- The env-first stages (phys/kinematics.py, smooth.py, forward.py) against
  the fields JAX's vmapped stages write inside forward_hybrid(lean=False),
  stage by stage, at float64 within 1e-9.
- make_constraint_lm(assemble_j=True) against JAX at float64: rows within
  1e-12, con_sel and the activity flags exactly equal, on the toy, the G1
  and the elliptic toy.
- Simulation(..., device="cpu").forward() against forward_hybrid(lean=
  False) on the toy, the G1 and eq_toy: every Data field at float64 (the
  solve's outputs within 1e-8: JAX's float64 solve is solve_lm, which
  recomputes the residuals at the end and zeroes a step whose initial
  slope is not negative, where the port carries the residuals as the TPU
  kernel does; both stop after the G1's 10 Newton iterations short of
  convergence, so their last iterates differ in the ninth digit), and at
  float32, against the same float64 pass, with the solve kernels'
  tolerances (2e-3 on accelerations and qfrc_constraint, 6e-3 on row and
  contact forces; 5e-5 on the fields before the solve, float32 rounding
  through the kinematic tree and the Cholesky).
- 3 steps of step_full against JAX step_hybrid(lean=False) on the toy at
  float64.
- The quaternion and spatial helpers (phys/math.py) against the JAX
  package's at float64.

The JAX compiles run once per module (fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.data import make_data as jax_make_data
from mjlab_tpu.phys.hybrid import forward_hybrid as jax_forward_hybrid
from mjlab_tpu.phys import forward as jax_fwd
from mjlab_tpu.sim.sim import model_in_axes
from mjlab_tpu_torch.phys import data as pdata
from mjlab_tpu_torch.phys import forward as pfwd
from mjlab_tpu_torch.phys import smooth as psmooth
from mjlab_tpu_torch.phys.hybrid import step_full
from mjlab_tpu_torch.phys.kinematics import com_pos, kinematics
from mjlab_tpu_torch.phys.lm import collision as pcol
from mjlab_tpu_torch.phys.lm import constraint as pcon
from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.phys.solver_kernels import FORCE_TOL, SOLVE_TOL
from mjlab_tpu_torch.sim.sim import MujocoCfg, Simulation, SimulationCfg
from mjlab_tpu_torch.tasks.velocity.config.g1.physics import sim_cfg

from torch_port_common import (
    G1_NCONMAX, TOY_NCONMAX, ell_mj, eq_mj, g1_mj, model_pair, rel_err,
    state_np, tnp, toy_mj,
)

E = 8

# the fields each stage writes
STAGES = {
    "kinematics": ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor",
                   "xaxis", "geom_xpos", "geom_xmat", "site_xpos", "site_xmat"),
    "com_pos": ("subtree_com", "cinert", "cdof"),
    "crb": ("qM", "qLD", "qLDinv"),
    "velocity": ("cvel", "cdof_dot", "qfrc_bias", "qfrc_passive"),
    "actuation": ("actuator_length", "actuator_moment", "actuator_velocity",
                  "actuator_force", "qfrc_actuator"),
    "acceleration": ("qfrc_smooth", "qacc_smooth"),
}
SOLVE_FIELDS = {
    "qacc": SOLVE_TOL, "qacc_warmstart": SOLVE_TOL,
    "qfrc_constraint": SOLVE_TOL, "efc_force": FORCE_TOL,
    "con_force_c": FORCE_TOL, "con_torque_c": FORCE_TOL,
}


def _states(name, mj, dtype):
    if name == "toy":
        q, v, c = state_np(mj, E, dtype=np.float64, qpos_noise=0.05)
        q[:, 2] -= np.linspace(0.0, 0.04, E)
    else:
        q, v, c = state_np(mj, E, keyframe=True, qpos_noise=0.05)
        q[:, 2] -= np.linspace(0.0, 0.1, E)
    return q.astype(dtype), v.astype(dtype), c.astype(dtype)


def _fields(dj) -> dict:
    return {n: np.array(dj.contact.packed if n == "contact" else getattr(dj, n))
            for n in pdata.tensor_fields()}


def _get(d, n):
    return d.contact.packed if n == "contact" else getattr(d, n)


class Run:
    """One model at one dtype: the port Model, the JAX input Data and JAX's
    forward_hybrid(lean=False) output, both as numpy fields."""

    def __init__(self, name, dtype):
        mj = {"toy": toy_mj, "g1": g1_mj, "ell_toy": ell_mj, "eq_toy": eq_mj}[name]()
        nconmax = G1_NCONMAX if name == "g1" else TOY_NCONMAX
        self.name, self.dtype, self.nconmax = name, dtype, nconmax
        with jax.enable_x64(dtype == np.float64):
            jm, self.m = model_pair(mj, nconmax, dtype)
            q, v, c = _states("g1" if name == "g1" else "toy", mj, dtype)
            d0 = jax_make_data(jm, dtype=jnp.dtype(dtype))
            dB = jax.tree_util.tree_map(
                lambda x: jnp.broadcast_to(x, (E,) + x.shape), d0)
            dB = dB.replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v),
                            ctrl=jnp.asarray(c))
            self.axes = model_in_axes(jm, frozenset())
            self.jax_forward = jax.jit(lambda dd: jax_forward_hybrid(
                jm, frozenset(), dd, self.axes, lean=False))
            self.inputs = _fields(dB)
            self.out = _fields(self.jax_forward(dB))
        self.jm, self.jax_inputs = jm, dB

    def data(self, dtype=None):
        dtype = dtype or self.dtype
        fields = {n: x.astype(dtype) if x.dtype == self.dtype else x
                  for n, x in self.inputs.items()}
        return pdata.data_from_numpy(fields, device="cpu")

    def simulation(self, dtype=None):
        """A Simulation of the run's model on the CPU holding its input
        Data (at ``dtype``, the run's own by default)."""
        dtype = dtype or self.dtype
        if self.name != "g1":
            mujoco = MujocoCfg(timestep=0.002, iterations=8, ls_iterations=12)
        else:
            mujoco = sim_cfg().mujoco
        dt = "float64" if dtype == np.float64 else "float32"
        sim = Simulation(E, SimulationCfg(nconmax=self.nconmax, mujoco=mujoco,
                                          dtype=dt), self.m, device="cpu")
        sim.data = self.data(dtype)
        return sim


@pytest.fixture(scope="module")
def runs():
    cache = {}

    def get(name, dtype):
        if (name, dtype) not in cache:
            cache[name, dtype] = Run(name, dtype)
        return cache[name, dtype]

    return get


@pytest.mark.parametrize("stage", list(STAGES))
@pytest.mark.parametrize("name", ["toy", "g1"])
def test_stages_match_jax_vmapped_f64(runs, name, stage):
    """The port's stages, run in order up to ``stage``, against the
    fields JAX's vmapped stages write."""
    run = runs(name, np.float64)
    m, d = run.m, run.data()
    order = (
        ("kinematics", lambda d: kinematics(m, d)),
        ("com_pos", lambda d: com_pos(m, d)),
        ("crb", lambda d: psmooth.crb(m, d, factor=True)),
        ("velocity", lambda d: psmooth.passive(m, psmooth.rne(m, psmooth.com_vel(m, d)))),
        ("actuation", lambda d: psmooth.fwd_actuation(m, psmooth.transmission(m, d))),
        ("acceleration", lambda d: pfwd.fwd_acceleration(m, d)),
    )
    for s, fn in order:
        d = fn(d)
        if s == stage:
            break
    for f in STAGES[stage]:
        ref, got = run.out[f], tnp(_get(d, f))
        assert ref.shape == got.shape, f
        assert rel_err(ref, got) < 1e-9, f"{f}: {rel_err(ref, got):.2e}"


@pytest.mark.parametrize("name", ["toy", "g1", "ell_toy"])
def test_constraint_assemble_j_matches_jax_f64(runs, name):
    """The port's rows, from its own kinematics on the same state, against
    the rows JAX's forward_hybrid(lean=False) writes (its
    make_constraint_lm with assemble_j)."""
    run = runs(name, np.float64)
    m = run.m
    d = com_pos(m, kinematics(m, run.data()))
    env_last = lambda x: torch.movedim(x, 0, -1).contiguous()  # noqa: E731
    P = Params(m, E)
    k = pcol.collision_lm(
        m, P, env_last(d.geom_xpos), env_last(d.geom_xmat.reshape(E, m.ngeom, 9)),
        {"subtree_com": env_last(d.subtree_com), "cdof": env_last(d.cdof)},
    )
    k = pcon.make_constraint_lm(
        m, P, k, tuple(d.qpos.T), tuple(d.qvel.T), torch.float64, assemble_j=True,
    )
    ef = lambda x: tnp(torch.movedim(x, -1, 0))  # noqa: E731
    for key in ("con_sel", "con_sel_active", "efc_active"):
        np.testing.assert_array_equal(
            run.out[key], ef(k[key]).astype(run.out[key].dtype), err_msg=key)
    rows = {"efc_Jc": "efc_Jc", "efc_D": "efc_D", "efc_aref": "efc_aref",
            "efc_frictionloss": "efc_fl", "efc_pos": "efc_pos",
            "efc_margin": "efc_margin", "efc_Jeq": "efc_Jeq",
            "efc_lim_side": "efc_lim_side"}
    for field, key in rows.items():
        ref, got = run.out[field], ef(k[key])
        assert ref.shape == got.shape, key
        assert rel_err(ref, got) < 1e-12, f"{key}: {rel_err(ref, got):.2e}"
    # the compacted slot record, in con_packed_c's column order
    cpk = torch.cat([k["con_dist_k"][:, None], k["con_margin_k"][:, None],
                     k["con_pos_k"], k["con_mu_k"], k["con_solref_k"],
                     k["con_solimp_k"], k["con_frame_k"], k["con_dim_k"][:, None]],
                    dim=1)
    assert rel_err(run.out["con_packed_c"], ef(cpk)) < 1e-12
    assert run.out["con_sel_active"].any() and np.abs(run.out["efc_Jc"]).max() > 0


EXACT = ("con_sel", "con_sel_active", "con_found", "efc_active",
         "ncheck_reset", "ncon_overflow")


def _check_forward(run, d, f64=True):
    for n in pdata.tensor_fields():
        ref, got = run.out[n], _get(d, n).numpy()
        assert ref.shape == got.shape, n
        if n in EXACT:
            np.testing.assert_array_equal(ref, got.astype(ref.dtype), err_msg=n)
        elif n in SOLVE_FIELDS:
            tol = 1e-8 if f64 else SOLVE_FIELDS[n]
            assert rel_err(ref, got) < tol, f"{n}: {rel_err(ref, got):.2e}"
        else:
            tol = 1e-9 if f64 else 5e-5
            assert rel_err(ref, got) < tol, f"{n}: {rel_err(ref, got):.2e}"
    assert run.out["con_sel_active"].any() and run.out["efc_active"].any()
    neq = run.m.neq_jnt
    if neq:  # the equality rows carry a force: the dense solve's equality class
        assert np.abs(run.out["efc_force"][:, :neq]).min() > 1e-3


@pytest.mark.parametrize("name", ["toy", "g1", "eq_toy"])
def test_simulation_forward_matches_jax_f64(runs, name):
    run = runs(name, np.float64)
    sim = run.simulation()
    sim.forward()
    _check_forward(run, sim.data)


@pytest.mark.parametrize("name", ["toy", "g1", "eq_toy"])
def test_simulation_forward_matches_jax_f32(runs, name):
    """The port's float32 pass against JAX's float64 pass, the reference
    a float32 one approximates (one JAX compile per model instead of two),
    with the float32 tolerances."""
    run = runs(name, np.float64)
    sim = run.simulation(dtype=np.float32)
    sim.forward()
    _check_forward(run, sim.data, f64=False)


def test_forward_data_roundtrips_through_numpy(runs):
    """Every field forward() writes survives data_from_numpy."""
    sim = runs("toy", np.float64).simulation()
    sim.forward()
    fields = {n: _get(sim.data, n).numpy().copy() for n in pdata.tensor_fields()}
    d2 = pdata.data_from_numpy(fields, device="cpu")
    for n in pdata.tensor_fields():
        assert torch.equal(_get(d2, n), _get(sim.data, n)), n


def test_step_hybrid_full_matches_jax_f64(runs):
    """3 steps of step_full against JAX step_hybrid(lean=False): the full
    forward pass, then the batched implicitfast integrator."""
    run = runs("toy", np.float64)
    d, jm, dB = run.data(), run.jm, run.jax_inputs
    with jax.enable_x64(True):
        # step_hybrid(lean=False) is forward_hybrid(lean=False) then the
        # vmapped integrate; the forward pass reuses the fixture's compile
        integrate = jax.jit(jax.vmap(jax_fwd.integrate, in_axes=(run.axes, 0)))
        for _ in range(3):
            dB = integrate(jm, run.jax_forward(dB))
            d = step_full(run.m, d)
        out = _fields(dB)
    for n in ("qpos", "qvel", "qacc", "qacc_warmstart", "time", "efc_force",
              "qfrc_constraint", "xpos", "qM", "efc_Jc", "contact"):
        assert rel_err(out[n], tnp(_get(d, n))) < 1e-8, n
    np.testing.assert_array_equal(out["con_sel"], d.con_sel.numpy())
    np.testing.assert_array_equal(out["ncheck_reset"], d.ncheck_reset.numpy())


def test_forward_raises_on_elliptic():
    sim = Simulation(2, SimulationCfg(nconmax=TOY_NCONMAX,
                                      mujoco=MujocoCfg(cone="elliptic")),
                     ell_mj(), device="cpu")
    with pytest.raises(NotImplementedError, match="elliptic"):
        sim.forward()


MATH_CASES = {
    "mul_quat": ("q", "q"), "conj_quat": ("q",), "normalize_quat": ("q4",),
    "rot_vec_quat": ("v", "q"), "quat_to_mat": ("q",),
    "quat_integrate": ("q", "v", "dt"), "quat_sub": ("q", "q"),
    "motion_cross": ("s", "s"), "force_cross": ("s", "s"),
    "offset_motion": ("s", "v"), "offset_force": ("s", "v"), "skew": ("v",),
    "spatial_inertia": ("m", "I", "v"), "transform_motion": ("s", "R", "v"),
}


@pytest.mark.parametrize("fn", list(MATH_CASES))
def test_math_helpers_match_jax_f64(fn):
    from mjlab_tpu.phys import math as jmath
    from mjlab_tpu_torch.phys import math as pmath

    rng = np.random.default_rng(len(fn))
    q = rng.standard_normal((5, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    make = {
        "q": lambda: q[rng.permutation(5)], "q4": lambda: 3.0 * q,
        "v": lambda: rng.standard_normal((5, 3)),
        "s": lambda: rng.standard_normal((5, 6)), "dt": lambda: 0.01,
        "m": lambda: rng.uniform(0.5, 2.0, 5),
        "I": lambda: rng.standard_normal((5, 3, 3)),
        "R": lambda: np.array(jmath.quat_to_mat(q)),
    }
    with jax.enable_x64(True):
        args = [make[a]() for a in MATH_CASES[fn]]
        ref = np.asarray(getattr(jmath, fn)(*[
            jnp.asarray(a) if isinstance(a, np.ndarray) else a for a in args]))
    got = getattr(pmath, fn)(*[
        torch.as_tensor(a) if isinstance(a, np.ndarray) else a for a in args])
    assert ref.shape == tuple(got.shape)
    assert rel_err(ref, tnp(got)) < 1e-12
