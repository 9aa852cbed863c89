"""Per-env model fields (domain randomisation) in the port against the JAX
package.

- Simulation.expand_model_fields / get_default_field: the field gets a
  leading env axis, the others stay shared, the default stays the
  pre-expansion value (tests/test_domain_randomization.py's checks, on the
  port's Simulation); a foot-friction draw as the G1 task's startup event
  makes it (0.3-1.2 on the foot geoms) lands per env;
- slot_params with geom_friction (and the other slot-parameter fields)
  expanded: the per-env mixing on the device against the JAX package's
  traced DR path (mjlab_tpu/phys/lm/collision.py:98-149) at float64,
  within 1e-9, explicit <pair> overrides included; not cached: a write
  between steps is read by the next one;
- a 3-substep G1 trajectory with per-env friction against the JAX
  package's step_hybrid with geom_friction batched, at float32 within the
  step tolerances of tests/test_torch_step.py (qpos 1e-4, qvel 1e-3, qacc
  5e-3), the active contact slots equal;
- the port's SimulationCfg built with exactly the keyword arguments of the
  JAX task configs (velocity_env_cfg.py:303-308,
  lift_cube_env_cfg.py:230-241).
"""

import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.hybrid import step_hybrid
from mjlab_tpu.phys.lm import base as jbase
from mjlab_tpu.phys.lm import collision as jcol
from mjlab_tpu.sim.sim import model_in_axes
from mjlab_tpu_torch.phys.lm import collision as pcol
from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.sim.sim import MujocoCfg, Simulation, SimulationCfg

from torch_port_common import (
    G1_NCONMAX, TOY_CAPSULE_XML, TOY_NCONMAX, g1_mj, jax_data_from_port,
    model_pair, rel_err, state_np, tnp, yam_mj, YAM_NCONMAX,
)

# the toy with named geoms and an explicit <pair> carrying its own
# friction, solref, solimp and margin
PAIR_XML = TOY_CAPSULE_XML.replace(
    '<geom type="plane" size="5 5 0.1"/>', '<geom name="floor" type="plane" size="5 5 0.1"/>'
).replace(
    '<geom type="sphere" size="0.1" pos="0.02 0.01 0.0"/>',
    '<geom name="ball" type="sphere" size="0.1" pos="0.02 0.01 0.0"/>',
).replace("</actuator>", """</actuator>
  <contact>
    <pair geom1="floor" geom2="ball" friction="0.3 0.3 0.005 0.0001 0.0001"
          solref="0.01 1" solimp="0.8 0.9 0.001 0.5 2" margin="0.01"/>
  </contact>""")

MODELS = {
    "g1": (g1_mj, G1_NCONMAX),
    "yam": (yam_mj, YAM_NCONMAX),
    "pair_toy": (lambda: mujoco.MjModel.from_xml_string(PAIR_XML), TOY_NCONMAX),
}
FIELD_SETS = {
    "friction": ("geom_friction",),
    "friction_solref_solmix": ("geom_friction", "geom_solref", "geom_solmix"),
    "solimp_margin_gap": ("geom_solimp", "geom_margin", "geom_gap"),
}
E = 8


def _draw(values: np.ndarray, name: str, rng) -> np.ndarray:
    """Per-env values around the shared ones (E, ...): a friction event's
    range 0.3-1.2 on the sliding coefficient, scaled draws elsewhere, a
    solmix of 0 in some geoms (the weight's edge cases)."""
    out = np.broadcast_to(values, (E,) + values.shape).copy()
    if name == "geom_friction":
        out[..., 0] = rng.uniform(0.3, 1.2, out.shape[:-1])
    elif name == "geom_solmix":
        out = rng.uniform(0.0, 2.0, out.shape) * (rng.random(out.shape) > 0.3)
    elif name in ("geom_margin", "geom_gap"):
        out = rng.uniform(0.0, 0.01, out.shape)
    else:
        out = out * rng.uniform(0.8, 1.2, out.shape)
    return out


@pytest.fixture(scope="module")
def pairs():
    """(JAX Model, port Model) at float64 of each model, built once."""
    out = {}

    def get(name):
        if name not in out:
            make, nconmax = MODELS[name]
            with jax.enable_x64(True):
                out[name] = model_pair(make(), nconmax, np.float64)
        return out[name]

    return get


@pytest.mark.parametrize("model", list(MODELS))
@pytest.mark.parametrize("fields", list(FIELD_SETS))
def test_slot_params_per_env_match_jax(pairs, model, fields):
    rng = np.random.default_rng(11)
    with jax.enable_x64(True):
        jm, m = pairs(model)
        upd_j, upd_p = {}, {}
        for name in FIELD_SETS[fields]:
            v = _draw(np.asarray(getattr(jm, name)), name, rng)
            upd_j[name], upd_p[name] = jnp.asarray(v), torch.as_tensor(v)
        jm = jm.replace(**upd_j)
        m = dataclasses.replace(m, **upd_p)
        ref = jcol.slot_params(jm, jbase.Params(jm, frozenset(upd_j), E), jnp.float64)
        got = pcol.slot_params(m, Params(m, E), torch.float64)
    assert pcol.per_env_params(m) == frozenset(upd_p)
    for name, r, g in zip(("friction5", "solref", "solimp", "includemargin"), ref, got):
        r, g = np.asarray(r), tnp(g)
        assert r.shape == g.shape, name  # (S, k, E) where a mixed field is per env
        assert rel_err(r, g) < 1e-9, f"{name}: {rel_err(r, g):.2e}"


def test_shared_slot_params_equal_the_per_env_path(pairs):
    """The host mixing (every env shares the geom parameters) and the
    device mixing agree where the per-env values equal the shared ones."""
    _, m = pairs("g1")
    shared = pcol.slot_params(m, Params(m, E), torch.float64)
    gf = m.geom_friction.expand(E, -1, -1).clone()
    per_env = pcol.slot_params(dataclasses.replace(m, geom_friction=gf), Params(m, E),
                               torch.float64)
    assert per_env[0].shape[-1] == E  # friction5 per env, the others shared
    for s, p in zip(shared, per_env):
        assert rel_err(np.broadcast_to(tnp(s), p.shape), tnp(p)) < 1e-15


def _g1_sim(dtype="float64", num_envs=E):
    cfg = SimulationCfg(nconmax=G1_NCONMAX, dtype=dtype,
                        mujoco=MujocoCfg(timestep=0.005, iterations=10, ls_iterations=20))
    return Simulation(num_envs, cfg, g1_mj(), device="cpu")


def _foot_geoms(sim) -> list[int]:
    return [i for i, n in enumerate(sim.model.geom_names)
            if n.startswith("robot/") and "_foot" in n and n.endswith("_collision")]


def test_expand_model_fields_like_jax():
    sim = _g1_sim()
    shared = sim.model.geom_friction.clone()
    sim.expand_model_fields(["geom_friction"])
    gf = sim.model.geom_friction
    assert gf.shape == (E,) + tuple(shared.shape)
    assert torch.equal(sim.get_default_field("geom_friction"), shared)
    assert sim.model.body_mass.ndim == 1  # not randomised: no env axis
    feet = _foot_geoms(sim)
    assert len(feet) == 14
    draw = np.random.default_rng(0).uniform(0.3, 1.2, (E, len(feet)))
    gf[:, feet, 0] = torch.as_tensor(draw)  # the startup event's write, in place
    vals = gf[:, feet, 0].numpy()
    assert ((vals >= 0.3) & (vals <= 1.2)).all()
    assert np.unique(vals.round(6), axis=0).shape[0] > 1
    others = [g for g in range(gf.shape[1]) if g not in feet]
    assert torch.equal(gf[:, others], shared[others].expand(E, -1, -1))
    sim.expand_model_fields(["geom_friction"])  # again: no change
    assert sim.model.geom_friction is gf


@pytest.mark.parametrize("name", ["body_mass", "jnt_range"])
def test_expand_refuses_fields_not_ported(name):
    sim = _g1_sim()
    with pytest.raises(NotImplementedError, match=name):
        sim.expand_model_fields([name])


def test_per_env_friction_is_read_by_the_next_step():
    """A domain randomisation write between two steps changes the next
    step's contact friction: the slot parameters are not cached."""
    sim = _g1_sim(num_envs=4)
    q, v, c = state_np(sim.mj_model, 4, keyframe=True)
    sim.data = sim.data.replace(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v),
                                ctrl=torch.as_tensor(c))
    sim.expand_model_fields(["geom_friction"])
    feet = _foot_geoms(sim)
    for value in (0.4, 1.1):
        sim.model.geom_friction[:, feet, 0] = value
        sim.step()
        d = sim.data
        active = d.con_sel_active
        assert active.any()
        mu = d.con_packed_c[..., 5][active]  # the slots' sliding friction
        assert torch.allclose(mu, torch.full_like(mu, value))


def test_g1_trajectory_with_per_env_friction_matches_jax():
    """3 physics steps of the G1 with per-env foot friction (the task's
    startup event's range) against JAX step_hybrid with geom_friction
    batched, float32."""
    n = 16
    sim = _g1_sim("float32", n)
    mj = sim.mj_model
    q, v, c = state_np(mj, n, dtype=np.float32, keyframe=True)
    sim.data = sim.data.replace(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v),
                                ctrl=torch.as_tensor(c))
    sim.expand_model_fields(["geom_friction"])
    feet = _foot_geoms(sim)
    draw = np.random.default_rng(1).uniform(0.3, 1.2, (n, len(feet))).astype(np.float32)
    sim.model.geom_friction[:, feet, 0] = torch.as_tensor(draw)

    from torch_port_common import jax_put_model

    jm = jax_put_model(mj, dtype=jnp.float32, nconmax=G1_NCONMAX)
    jm = jm.replace(geom_friction=jnp.asarray(sim.model.geom_friction.numpy()))
    bf = frozenset({"geom_friction"})
    axes = model_in_axes(jm, bf)
    step = jax.jit(lambda dd: step_hybrid(jm, bf, dd, axes, lean=True))
    dj = jax_data_from_port(sim.data)
    for _ in range(3):
        dj = step(dj)
        sim.step()
    d = sim.data
    for f, tol in (("qpos", 1e-4), ("qvel", 1e-3), ("qacc", 5e-3),
                   ("con_force_c", 5e-3), ("condist", 1e-4)):
        err = rel_err(np.asarray(getattr(dj, f)), tnp(getattr(d, f)))
        assert err < tol, f"{f}: {err:.2e} >= {tol:.0e}"
    np.testing.assert_array_equal(np.asarray(dj.con_sel_active), d.con_sel_active.numpy())
    assert d.con_sel_active.any()
    # the per-env friction reached the contact rows
    mu = d.con_packed_c[..., 5]
    assert rel_err(np.asarray(dj.con_packed_c[..., 5]), tnp(mu)) < 1e-6
    assert len(np.unique(tnp(mu)[d.con_sel_active.numpy()].round(5))) > 2


@pytest.mark.parametrize("task", ["Mjlab-Velocity-Flat-Unitree-G1", "Mjlab-Lift-Cube-Yam"])
def test_sim_cfg_takes_the_task_configs_keywords(task):
    """The port's SimulationCfg and MujocoCfg built from the JAX task
    config's own keyword arguments, field for field."""
    import mjlab_tpu.tasks  # noqa: F401  (registers the tasks)
    from mjlab_tpu.tasks.registry import load_env_cfg

    jcfg = load_env_cfg(task).sim
    mj_kw = {f.name: getattr(jcfg.mujoco, f.name) for f in dataclasses.fields(jcfg.mujoco)}
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "mujoco"}
    cfg = SimulationCfg(mujoco=MujocoCfg(**mj_kw), **kw)
    for k, v in kw.items():
        assert getattr(cfg, k) == v, k
    for k, v in mj_kw.items():
        assert getattr(cfg.mujoco, k) == v, k
    assert cfg.njmax in (300, 600)


@pytest.mark.parametrize("kw", [
    dict(nconmax=35, njmax=300,
         mujoco=dict(timestep=0.005, iterations=10, ls_iterations=20)),
    dict(nconmax=55, njmax=600,
         mujoco=dict(timestep=0.005, iterations=10, ls_iterations=20, impratio=10,
                     cone="elliptic")),
])
def test_sim_cfg_takes_the_task_files_arguments(kw):
    """Exactly the arguments velocity_env_cfg.py:303-308 and
    lift_cube_env_cfg.py:230-241 pass."""
    kw = dict(kw)
    cfg = SimulationCfg(mujoco=MujocoCfg(**kw.pop("mujoco")), **kw)
    assert cfg.njmax == kw["njmax"] and cfg.nconmax == kw["nconmax"]
