"""Per-env smooth model fields (the smooth kernels' per-env planes) in the
port against the JAX package, on the CPU.

The fields a domain randomisation event writes (phys/model.py
PER_ENV_SMOOTH_FIELDS: body_mass, body_ipos, body_inertia, geom_pos,
dof_damping, dof_armature, jnt_stiffness, qpos0, actuator_gainprm,
actuator_biasprm, actuator_forcerange) may carry a leading env axis; the plain versions of
kernels 1-3 then read each env's value through Params.plane, as the
kernels read it through mcv (csrc/smooth_tree.cuh).

- 3 physics steps of the toy with a mocap body (the box foot on the plane,
  a position actuator and a motor, implicitfast; the mocap frames per env)
  with per-env fields (the actuators force-limited, per-env force ranges
  that saturate some of them: the force clip and the implicit diagonal's
  saturation test) against the JAX package's step_hybrid with those
  fields in ``bf`` (its vmapped smooth stages: the JAX tests of the Pallas
  path with DR planes are marked slow), at float32 within the step
  tolerances of tests/test_smooth_pallas.py:209 (qpos 1e-4, qvel 1e-3,
  qacc 5e-3): each field alone, body_ipos with dof_damping (that test's
  case), and all eleven at once;
- the refresh with per-env body_ipos, body_mass and geom_pos against the
  vmapped JAX refresh (tests/test_refresh_envlast.py:138) within its 5e-6;
- a write of a per-env field between two steps is read by the next step;
- a masked reset puts each env at its own qpos0;
- a per-env smooth field outside PER_ENV_SMOOTH_FIELDS still raises,
  naming the field, in expand_model_fields, check_supported and the
  kernels' DeviceTables.

The JAX step is compiled once for the mocap toy with all eleven fields
batched; a case with fewer per-env fields gives the JAX Model the shared
value in every env for the others.
"""

import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.hybrid import step_hybrid
from mjlab_tpu.phys.kinematics import com_pos as jcom_pos
from mjlab_tpu.phys.kinematics import kinematics as jkinematics
from mjlab_tpu.phys.smooth import com_vel as jcom_vel
from mjlab_tpu.sim.sim import model_in_axes
from mjlab_tpu_torch.phys import smooth_kernels as sk
from mjlab_tpu_torch.phys.hybrid import refresh_envlast
from mjlab_tpu_torch.phys.model import PER_ENV_SMOOTH_FIELDS, per_env_smooth
from mjlab_tpu_torch.sim.sim import MujocoCfg, Simulation, SimulationCfg, check_supported

from test_hybrid_parity import TOY_XML
from torch_port_common import (
    TOY_NCONMAX, jax_data_from_port, jax_put_model, rel_err, state_np, tnp,
)

E = 16
FIELDS = tuple(sorted(PER_ENV_SMOOTH_FIELDS))
STEP_TOL = (("qpos", 1e-4), ("qvel", 1e-3), ("qacc", 5e-3))

# tests/test_smooth_pallas.py MOCAP_XML: the toy with a mocap body, its two
# actuators force-limited at +-1000 (never reached with the shared range;
# the per-env draws of actuator_forcerange saturate some)
MOCAP_XML = TOY_XML.replace(
    'kp="30" kv="2"/>', 'kp="30" kv="2" forcelimited="true" forcerange="-1000 1000"/>',
).replace(
    'gear="1.5"/>', 'gear="1.5" forcelimited="true" forcerange="-1000 1000"/>',
).replace(
    "</worldbody>",
    """    <body name="target" mocap="true" pos="1 0 0.5">
      <geom type="sphere" size="0.02" contype="0" conaffinity="0"
            mass="0.1"/>
    </body>
  </worldbody>""",
)
# the toy's own options (its XML)
TOY_CFG = MujocoCfg(timestep=0.002, integrator="implicitfast", iterations=8,
                    ls_iterations=12)


def _draw(name: str, shared: np.ndarray, rng) -> np.ndarray:
    """Per-env values (E, ...) around the shared ones, of a size a
    randomisation event gives: offsets of centimetres, scales of +-20-50 %,
    springs on joints that have none."""
    out = np.broadcast_to(shared, (E,) + shared.shape).astype(np.float32).copy()
    n = lambda s: rng.standard_normal(out.shape).astype(np.float32) * s  # noqa: E731
    u = lambda lo, hi: rng.uniform(lo, hi, out.shape).astype(np.float32)  # noqa: E731
    if name in ("body_ipos", "geom_pos"):
        out += n(0.02)
    elif name in ("body_mass", "body_inertia"):
        out *= u(0.8, 1.2)
    elif name == "dof_damping":
        out = out * u(0.5, 1.5) + u(0.0, 0.1)
    elif name == "dof_armature":
        out += u(0.0, 0.05)
    elif name == "jnt_stiffness":
        out += u(0.0, 5.0)
    elif name == "qpos0":
        out += n(0.05)
    elif name == "actuator_forcerange":
        # +-(0.5-6) per env and actuator: some of the toy's forces saturate
        hi = u(0.5, 6.0)[..., :1]
        out = np.concatenate([-hi, hi], -1)
    else:  # actuator_gainprm, actuator_biasprm: the three parameters read
        out[..., :3] *= u(0.8, 1.2)[..., :3]
    return out


@pytest.fixture(scope="module")
def toy():
    """(MjModel, JAX Model, the jitted JAX step over (per-env fields,
    Data) with all ten fields batched)."""
    mj = mujoco.MjModel.from_xml_string(MOCAP_XML)
    TOY_CFG.apply(mj)
    jm = jax_put_model(mj, dtype=jnp.float32, nconmax=TOY_NCONMAX)
    assert jm.nmocap == 1
    bf = frozenset(FIELDS)
    full = jm.replace(**{
        n: jnp.broadcast_to(getattr(jm, n), (E,) + getattr(jm, n).shape) for n in FIELDS
    })
    axes = model_in_axes(full, bf)
    step = jax.jit(lambda fields, dd: step_hybrid(full.replace(**fields), bf, dd, axes,
                                                  lean=True))
    return mj, jm, step


def _port_sim(mj, fields: dict[str, np.ndarray], seed=0) -> Simulation:
    """The port's Simulation of the toy on a seeded state, the mocap
    frames per env, with ``fields`` per env."""
    cfg = SimulationCfg(nconmax=TOY_NCONMAX, dtype="float32", mujoco=TOY_CFG)
    sim = Simulation(E, cfg, mj, device="cpu")
    q, v, c = state_np(mj, E, seed=seed, dtype=np.float32)
    rng = np.random.default_rng(seed + 100)
    mq = rng.standard_normal((E, 1, 4)).astype(np.float32)
    mq /= np.linalg.norm(mq, axis=-1, keepdims=True)
    t = torch.as_tensor
    sim.data = sim.data.replace(
        qpos=t(q), qvel=t(v), ctrl=t(c),
        mocap_pos=t(rng.uniform(-1, 1, (E, 1, 3)).astype(np.float32)), mocap_quat=t(mq),
    )
    sim.expand_model_fields(list(fields))
    for name, value in fields.items():
        getattr(sim.model, name).copy_(t(value))  # an event's write, in place
    return sim


def _jax_fields(jm, fields: dict[str, np.ndarray]) -> dict:
    """All ten fields per env for the JAX step: the drawn ones, the shared
    value in every env for the others."""
    return {
        n: jnp.asarray(fields[n]) if n in fields
        else jnp.broadcast_to(getattr(jm, n), (E,) + getattr(jm, n).shape)
        for n in FIELDS
    }


def _check_steps(toy, fields: dict[str, np.ndarray], steps=3):
    mj, jm, jstep = toy
    sim = _port_sim(mj, fields)
    assert per_env_smooth(sim.model) == tuple(sorted(fields))
    jf = _jax_fields(jm, fields)
    dj = jax_data_from_port(sim.data)
    for _ in range(steps):
        dj = jstep(jf, dj)
        sim.step()
    for f, tol in STEP_TOL:
        err = rel_err(np.asarray(getattr(dj, f)), tnp(getattr(sim.data, f)))
        assert err < tol, f"{f}: {err:.2e} >= {tol:.0e}"
    np.testing.assert_array_equal(np.asarray(dj.con_sel_active), sim.data.con_sel_active.numpy())
    return sim


CASES = {n: (n,) for n in FIELDS}
CASES["body_ipos+dof_damping"] = ("body_ipos", "dof_damping")
CASES["all"] = FIELDS


@pytest.mark.parametrize("case", list(CASES))
def test_step_with_per_env_fields_matches_jax(toy, case):
    mj, jm, _ = toy
    rng = np.random.default_rng(len(case) + 7 * len(CASES[case]))
    fields = {n: _draw(n, np.asarray(getattr(jm, n)), rng) for n in CASES[case]}
    sim = _check_steps(toy, fields)
    # the per-env values moved the envs apart: the same state with the
    # shared values steps elsewhere
    shared = _port_sim(mj, {})
    for _ in range(3):
        shared.step()
    moved = (sim.data.qacc - shared.data.qacc).abs().amax(1)
    assert int((moved > 1e-4).sum()) >= E // 2, case
    if "actuator_forcerange" in CASES[case]:
        # some forces sit at their env's bound, others inside it
        hi = sim.model.actuator_forcerange[..., 1]
        at = (sim.data.actuator_force.abs() - hi).abs() < 1e-6
        assert 0 < int(at.sum()) < at.numel(), case


def test_write_between_steps_is_read_by_the_next_step(toy):
    """A step, an in-place write of new per-env body_ipos and dof_damping,
    a step: the JAX step with the new values in its second call agrees."""
    mj, jm, jstep = toy
    rng = np.random.default_rng(11)
    first = {n: _draw(n, np.asarray(getattr(jm, n)), rng) for n in ("body_ipos", "dof_damping")}
    second = {n: _draw(n, np.asarray(getattr(jm, n)), rng) for n in first}
    sim = _port_sim(mj, first)
    dj = jstep(_jax_fields(jm, first), jax_data_from_port(sim.data))
    sim.step()
    for name, value in second.items():
        getattr(sim.model, name).copy_(torch.as_tensor(value))
    dj = jstep(_jax_fields(jm, second), dj)
    sim.step()
    for f, tol in STEP_TOL:
        err = rel_err(np.asarray(getattr(dj, f)), tnp(getattr(sim.data, f)))
        assert err < tol, f"{f}: {err:.2e} >= {tol:.0e}"


# tests/test_refresh_envlast.py XML: free, ball, hinge and slide joints, a
# site, a multi-geom body and a mocap body
REFRESH_XML = """
<mujoco>
  <option timestep="0.002"/>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body name="base" pos="0 0 0.5">
      <freejoint/>
      <geom type="sphere" size="0.08" pos="0.02 0.01 0"/>
      <geom type="box" size="0.04 0.03 0.02" pos="-0.05 0 0.03"
            quat="0.97 0.1 0.2 0.05"/>
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
    <body name="target" mocap="true" pos="0.5 0 0.4">
      <geom type="sphere" size="0.02" contype="0" conaffinity="0"/>
    </body>
  </worldbody>
</mujoco>
"""
REFRESH_FIELDS = ("xpos", "xquat", "xmat", "xipos", "ximat", "geom_xpos", "geom_xmat",
                  "site_xpos", "site_xmat", "subtree_com", "cinert", "cdof", "cvel",
                  "cdof_dot")


def test_refresh_with_per_env_fields_matches_vmapped_jax():
    """body_ipos (kin_com), body_mass (kin_com and the cinert matrix) and
    geom_pos (every geom's frame) per env land in the refreshed frames."""
    mj = mujoco.MjModel.from_xml_string(REFRESH_XML)
    cfg = SimulationCfg(nconmax=8, dtype="float32", mujoco=MujocoCfg(timestep=0.002))
    sim = Simulation(E, cfg, mj, device="cpu")
    jm = jax_put_model(mj, dtype=jnp.float32, nconmax=8)
    rng = np.random.default_rng(7)
    names = ("body_ipos", "body_mass", "geom_pos")
    fields = {n: _draw(n, np.asarray(getattr(jm, n)), rng) for n in names}
    sim.expand_model_fields(list(names))
    for n, value in fields.items():
        getattr(sim.model, n).copy_(torch.as_tensor(value))
    q, v, _ = state_np(mj, E, seed=1, dtype=np.float32, qpos_noise=0.05, qvel_noise=0.5)
    for j in range(mj.njnt):
        if mj.jnt_type[j] == 1:  # ball: renormalise its quaternion too
            a = mj.jnt_qposadr[j]
            q[:, a:a + 4] /= np.linalg.norm(q[:, a:a + 4], axis=1, keepdims=True)
    mq = rng.standard_normal((E, 1, 4)).astype(np.float32)
    mq /= np.linalg.norm(mq, axis=-1, keepdims=True)
    t = torch.as_tensor
    sim.data = sim.data.replace(qpos=t(q), qvel=t(v), mocap_quat=t(mq))
    d = refresh_envlast(sim.model, sim.data)

    bf = frozenset(names)
    jmB = jm.replace(**{n: jnp.asarray(fields[n]) for n in names})
    axes = model_in_axes(jmB, bf)

    def refresh(mm, dd):
        return jcom_vel(mm, jcom_pos(mm, jkinematics(mm, dd)))

    ref = jax.jit(jax.vmap(refresh, in_axes=(axes, 0)))(jmB, jax_data_from_port(sim.data))
    for f in REFRESH_FIELDS:
        err = rel_err(np.asarray(getattr(ref, f)), tnp(getattr(d, f)))
        assert err < 5e-6, f"{f}: rel err {err:.2e}"
    # the per-env values are what the frames read: env 0 and env 1 differ
    assert not torch.equal(d.xipos[0, 1:], d.xipos[1, 1:])


@pytest.mark.parametrize("name", ["body_pos", "geom_quat", "actuator_gear"])
def test_other_per_env_smooth_fields_still_raise(toy, name):
    mj, _, _ = toy
    cfg = SimulationCfg(nconmax=TOY_NCONMAX, dtype="float32", mujoco=TOY_CFG)
    sim = Simulation(E, cfg, mj, device="cpu")
    with pytest.raises(NotImplementedError, match=name):
        sim.expand_model_fields([name])
    val = getattr(sim.model, name)
    m = dataclasses.replace(sim.model, **{name: val.expand((E,) + tuple(val.shape)).clone()})
    with pytest.raises(NotImplementedError, match=name):
        check_supported(m)
    with pytest.raises(NotImplementedError, match=name):
        sk.DeviceTables(m)


def test_device_tables_take_per_env_fields_out_of_the_constants(toy):
    """The packed constant of a per-env field is NaN, so a kernel that
    read it instead of the env's value would show; the shared ones keep
    their values."""
    mj, _, _ = toy
    sim = _port_sim(mj, {"body_ipos": np.zeros((E, mj.nbody, 3), np.float32)})
    tab = sk.DeviceTables(sim.model)
    floats = tab.floats.numpy()
    s = tab.struct
    at = lambda name: (getattr(s, name) - tab.floats.data_ptr()) // 4  # noqa: E731
    ipos = floats[at("body_ipos"):at("body_ipos") + 3 * mj.nbody]
    assert np.isnan(ipos).all()
    iquat = floats[at("body_iquat"):at("body_iquat") + 4 * mj.nbody]
    np.testing.assert_array_equal(iquat, sim.model.body_iquat.numpy().reshape(-1))
    mass = floats[at("body_mass"):at("body_mass") + mj.nbody]
    np.testing.assert_array_equal(mass, sim.model.body_mass.numpy())


def test_reset_takes_each_envs_own_qpos0(toy):
    """With qpos0 per env, a masked reset puts each reset env at its own
    qpos0 and leaves the others (phys/data.py reset_data)."""
    mj, jm, _ = toy
    qpos0 = _draw("qpos0", np.asarray(jm.qpos0), np.random.default_rng(5))
    sim = _port_sim(mj, {"qpos0": qpos0})
    before = sim.data.qpos.clone()
    mask = torch.arange(E) % 3 == 0
    sim.reset(mask)
    np.testing.assert_array_equal(sim.data.qpos[mask].numpy(), qpos0[mask.numpy()])
    assert torch.equal(sim.data.qpos[~mask], before[~mask])
