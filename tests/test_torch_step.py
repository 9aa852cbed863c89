"""The port's Simulation (one engine: the env-last kernel path, plain
PyTorch versions on the CPU) against the JAX package end to end.

- step(): 3 steps against JAX step_hybrid(lean=True) at f32, with the
  tolerances of tests/test_smooth_pallas.py (qpos 1e-4, qvel 1e-3, qacc
  5e-3: the f32 Newton solve's input sensitivity carried through the
  integrator) and the contact selection exactly equal;
- refresh(): every field the env-last refresh writes against the vmapped
  kinematics + com_pos + com_vel refresh (sim/sim.py refresh_fn) at f64,
  within 1e-9;
- reset(mask): masked envs return to the fresh state, the others keep
  theirs.
"""

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.data import make_data as jax_make_data
from mjlab_tpu.phys.hybrid import step_hybrid
from mjlab_tpu.phys.kinematics import com_pos, kinematics
from mjlab_tpu.phys.model import put_model as jax_put_model
from mjlab_tpu.phys.smooth import com_vel
from mjlab_tpu.sim.sim import model_in_axes
from mjlab_tpu_torch.phys.data import make_data, tensor_fields
from mjlab_tpu_torch.phys.hybrid import refresh_envlast
from mjlab_tpu_torch.phys.model import put_model
from mjlab_tpu_torch.sim.sim import MujocoCfg, Simulation, SimulationCfg

from torch_port_common import (
    G1_NCONMAX, TOY_NCONMAX, g1_mj, rel_err, state_np, tnp, toy_mj,
)

# the toy's own solver options (test_hybrid_parity.TOY_XML)
TOY_CFG = dict(timestep=0.002, iterations=8, ls_iterations=12)
G1_CFG = dict(timestep=0.005, iterations=10, ls_iterations=20)


def _jax_batch(jm, q, v, c, dtype):
    E = q.shape[0]
    d0 = jax_make_data(jm, dtype=dtype)
    dB = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), d0)
    return dB.replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v), ctrl=jnp.asarray(c))


def _set_state(sim, q, v, c):
    t = lambda x: torch.as_tensor(x, dtype=sim.dtype)  # noqa: E731
    sim.data = sim.data.replace(qpos=t(q), qvel=t(v), ctrl=t(c))


def test_simulation_steps_match_step_hybrid_f32():
    E = 128
    sim = Simulation(
        E, SimulationCfg(nconmax=TOY_NCONMAX, mujoco=MujocoCfg(**TOY_CFG)),
        toy_mj(), device="cpu",
    )
    q, v, c = state_np(sim.mj_model, E, dtype=np.float32)
    _set_state(sim, q, v, c)
    jm = jax_put_model(sim.mj_model, dtype=jnp.float32, nconmax=TOY_NCONMAX)
    axes = model_in_axes(jm, frozenset())
    step = jax.jit(lambda dd: step_hybrid(jm, frozenset(), dd, axes, lean=True))
    dj = _jax_batch(jm, q, v, c, jnp.float32)
    for _ in range(3):
        dj = step(dj)
        sim.step()
    d = sim.data
    for f, tol in (("qpos", 1e-4), ("qvel", 1e-3), ("qacc", 5e-3),
                   ("qacc_warmstart", 5e-3), ("qfrc_constraint", 5e-3),
                   ("efc_force", 5e-3), ("condist", 1e-4),
                   ("con_packed_c", 1e-3), ("con_force_c", 5e-3),
                   ("time", 1e-6)):
        err = rel_err(getattr(dj, f), tnp(getattr(d, f)))
        assert err < tol, f"{f}: {err:.2e}"
    np.testing.assert_array_equal(np.asarray(dj.con_found), d.con_found.numpy())
    np.testing.assert_array_equal(np.asarray(dj.con_sel), d.con_sel.numpy())
    np.testing.assert_array_equal(
        np.asarray(dj.con_sel_active), d.con_sel_active.numpy()
    )
    np.testing.assert_array_equal(
        np.asarray(dj.ncon_overflow), d.ncon_overflow.numpy()
    )
    assert int(d.ncheck_reset.sum()) == 0
    assert d.con_sel_active.any()


# free + ball + hinge + slide joints, a site, a multi-geom body: every
# cdof_dot accumulation case of mj_comVel (tests/test_refresh_envlast.py
# without its mocap body)
REFRESH_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="base" pos="0 0 0.5">
      <freejoint/>
      <geom type="sphere" size="0.08" pos="0.02 0.01 0"/>
      <geom type="capsule" size="0.03" fromto="-0.05 0 0.03 0.02 0.01 0.05"/>
      <site name="imu" pos="0.01 0.02 0.03" quat="0.9 0.1 0.3 0.2"/>
      <body name="arm" pos="0.1 0 0">
        <joint name="shoulder" type="ball" damping="0.1"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0.2 0 0"/>
        <body name="wrist" pos="0.2 0 0">
          <joint name="flex" type="hinge" axis="0 1 0" damping="0.05"/>
          <joint name="ext" type="slide" axis="1 0 0" damping="0.05"/>
          <geom type="sphere" size="0.03"/>
          <site name="tip" pos="0.03 0 0"/>
        </body>
      </body>
    </body>
  </worldbody>
</mujoco>
"""

REFRESH_FIELDS = (
    "xpos", "xquat", "xmat", "xipos", "ximat", "geom_xpos", "geom_xmat",
    "site_xpos", "site_xmat", "subtree_com", "cinert", "cdof", "cvel",
    "cdof_dot",
)


def _vmapped_refresh(jm, dB):
    axes = model_in_axes(jm, frozenset())

    def refresh(mm, dd):
        return com_vel(mm, com_pos(mm, kinematics(mm, dd)))

    return jax.jit(jax.vmap(refresh, in_axes=(axes, 0)))(jm, dB)


def _assert_refresh_equal(dj, d, fields=REFRESH_FIELDS):
    for f in fields:
        a = np.asarray(getattr(dj, f))
        b = tnp(getattr(d, f))
        assert a.shape == b.shape, f"{f}: {a.shape} vs {b.shape}"
        assert rel_err(a, b) < 1e-9, f"{f}: {rel_err(a, b):.2e}"


@pytest.mark.parametrize("name", ["toy", "g1"])
def test_simulation_refresh_matches_vmapped_f64(name):
    E = 8
    mj, nconmax, cfg, keyframe = (
        (toy_mj(), TOY_NCONMAX, TOY_CFG, False) if name == "toy"
        else (g1_mj(), G1_NCONMAX, G1_CFG, True)
    )
    sim = Simulation(
        E, SimulationCfg(nconmax=nconmax, mujoco=MujocoCfg(**cfg),
                         dtype="float64"),
        mj, device="cpu",
    )
    q, v, c = state_np(sim.mj_model, E, keyframe=keyframe)
    _set_state(sim, q, v, c)
    sim.refresh()
    with jax.enable_x64(True):
        jm = jax_put_model(sim.mj_model, dtype=jnp.float64, nconmax=nconmax)
        dj = _vmapped_refresh(jm, _jax_batch(jm, q, v, c, jnp.float64))
        _assert_refresh_equal(dj, sim.data)


def test_refresh_envlast_every_joint_type_f64():
    mj = mujoco.MjModel.from_xml_string(REFRESH_XML)
    E = 8
    q, v, c = state_np(mj, E, qpos_noise=0.2, qvel_noise=1.0)
    # the ball joint's quaternion renormalised too
    for j in range(mj.njnt):
        if mj.jnt_type[j] == mujoco.mjtJoint.mjJNT_BALL:
            a = mj.jnt_qposadr[j]
            q[:, a:a + 4] /= np.linalg.norm(q[:, a:a + 4], axis=1, keepdims=True)
    m = put_model(mj, dtype=torch.float64, device="cpu")
    d = make_data(m, E).replace(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v))
    d = refresh_envlast(m, d)
    with jax.enable_x64(True):
        jm = jax_put_model(mj, dtype=jnp.float64)
        dj = _vmapped_refresh(jm, _jax_batch(jm, q, v, c, jnp.float64))
        _assert_refresh_equal(dj, d)


def test_reset_mask():
    E = 6
    sim = Simulation(
        E, SimulationCfg(nconmax=TOY_NCONMAX, mujoco=MujocoCfg(**TOY_CFG)),
        toy_mj(), device="cpu",
    )
    q, v, c = state_np(sim.mj_model, E, dtype=np.float32)
    _set_state(sim, q, v, c)
    for _ in range(2):
        sim.step()
    sim.refresh()
    before = sim.data
    mask = np.array([True, False, True, False, False, True])
    sim.reset(mask)
    fresh = make_data(sim.model, E)
    for name in tensor_fields():
        get = lambda dd: dd.contact.packed if name == "contact" else getattr(dd, name)  # noqa: E731
        new = get(sim.data)
        for e in range(E):
            want = get(fresh)[e] if mask[e] else get(before)[e]
            assert torch.equal(new[e], want), f"{name}[{e}]"
    # a reset env steps again from qpos0
    sim.step()
    assert torch.isfinite(sim.data.qpos).all()
    assert int(sim.data.ncheck_reset.sum()) == 0
    sim.reset()
    assert torch.equal(sim.data.qpos, fresh.qpos)
