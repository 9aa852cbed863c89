"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

The port (mjlab_tpu_torch) and the JAX package get the same inputs, made
from numpy seeds, and their outputs are compared as numpy arrays. The JAX
package's Model leaves become the port's Model through model_from_numpy.
"""

from __future__ import annotations

import dataclasses
import os
import weakref

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.phys import constraint as _jax_constraint
from mjlab_tpu.phys import smooth as _jax_smooth
from mjlab_tpu.phys.model import put_model as _jax_put_model
from mjlab_tpu_torch.phys import model as pm
from mjlab_tpu_torch.scene.scene import (
    g1_velocity_flat_model, yam_lift_cube_model,
)
from mjlab_tpu_torch.tasks.manipulation.config.yam import physics as yam
from mjlab_tpu_torch.tasks.velocity.config.g1.physics import sim_cfg

from test_hybrid_parity import TOY_XML

from test_pallas2_solver import ELL_XML

# One CPU thread for the port's torch ops, here and in the child processes
# the tests start (CHILD_THREADS). The tests run in several pytest-xdist
# workers at once, and torch's OpenMP pool (8 threads per process) spins
# at its barriers: six processes stepping the YAM's 128 envs with 8
# threads each did not finish 5 steps in 180 s, with one thread each all
# six took 7.2-8.3 s, as one process alone with 8 (7.5 s). The shapes of
# these tests are small: one thread loses nothing.
torch.set_num_threads(1)
CHILD_THREADS = {"OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
# the limit of a child process the tests start: each takes 5-10 s alone
# (a MuJoCo-blocked env build and step, one train CLI iteration), so a
# stuck child fails its test in 2 minutes rather than hold a worker for
# half the suite's time
CHILD_TIMEOUT_S = 120

# The toy's foot is a box. The port's narrowphase carries the pair families
# of the G1 velocity task (plane/sphere/capsule); the box family waits for a
# later slice, so the contact, solver and step gates use the toy with a
# capsule foot.
TOY_CAPSULE_XML = TOY_XML.replace(
    '<geom type="box" size="0.05 0.03 0.02"/>',
    '<geom type="capsule" size="0.03" fromto="-0.05 0 0 0.05 0 0"/>',
)

# the elliptic toy (box foot, condim 3 and 6 contacts, a joint equality)
# under the pyramidal cone
EQ_XML = ELL_XML.replace('cone="elliptic" impratio="10" ', "")

# free + ball + hinge + slide joints, a site, a multi-geom body: every
# cdof_dot accumulation case of mj_comVel (tests/test_refresh_envlast.py
# without its mocap body); the refresh model of tests/test_torch_step.py
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

# the G1 flat-velocity and YAM lift-cube tasks' contact capacities
# (velocity_env_cfg.py, lift_cube_env_cfg.py)
G1_NCONMAX = sim_cfg().nconmax
YAM_NCONMAX = yam.sim_cfg().nconmax
TOY_NCONMAX = 12


def rel_err(a, b) -> float:
    """max |a - b| / max(1, max |a|), a the reference."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    scale = max(1.0, float(np.abs(a).max()))
    return float(np.abs(a - b).max()) / scale


def tnp(x) -> np.ndarray:
    """A torch tensor (or anything array-like) as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def toy_mj(capsule: bool = True) -> mujoco.MjModel:
    return mujoco.MjModel.from_xml_string(TOY_CAPSULE_XML if capsule else TOY_XML)


def g1_mj() -> mujoco.MjModel:
    """The G1 flat-velocity model with the task's solver options applied."""
    mj = g1_velocity_flat_model()
    sim_cfg().mujoco.apply(mj)
    return mj


def ell_mj() -> mujoco.MjModel:
    """The elliptic toy: condim 3 and 6 contacts, impratio 10, a joint
    equality (tests/test_pallas2_solver.py ELL_XML)."""
    return mujoco.MjModel.from_xml_string(ELL_XML)


def eq_mj() -> mujoco.MjModel:
    """The elliptic toy under the pyramidal cone (impratio 1): a joint
    equality row in the pyramidal solves."""
    return mujoco.MjModel.from_xml_string(EQ_XML)


def yam_mj() -> mujoco.MjModel:
    """The YAM lift-cube model with the task's solver options applied."""
    mj = yam_lift_cube_model()
    yam.sim_cfg().mujoco.apply(mj)
    return mj


def yam_states(m, E: int, seed: int = 0, dtype=np.float64):
    """(qpos, qvel, ctrl, mocap_pos, mocap_quat) numpy arrays for E envs of
    the port's YAM Model m (yam.task_states: half at the reset state, half
    pinching the cube)."""
    _, st = yam.load_saved_model(dtype=torch.float64, device="cpu")
    b = yam.task_states(m, st, E, seed)
    return tuple(b[k].astype(dtype) for k in (
        "qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat"))


# The JAX package memoises host tables by the id() of a Model member:
# phys/smooth.py _ancestor_mask_cache and _crb_static_cache by
# id(m.body_parentid), phys/constraint.py _contact_static_cache by
# id(m.pairs). Once that member is freed, CPython may give the same id to a
# member of the next Model, and the table of the freed model then comes
# back for it: an IndexError in smooth_pallas._crb_pairs where the sizes
# differ, a wrong table where they agree. Which model was freed before
# depends on which test files ran earlier in the same process. So every
# JAX Model these tests build drops those tables when it is made and when
# its keyed members are freed.
_JAX_ID_CACHES = (
    _jax_smooth._ancestor_mask_cache, _jax_smooth._crb_static_cache,
    _jax_constraint._contact_static_cache,
)


def _drop_jax_id_caches() -> None:
    for cache in _JAX_ID_CACHES:
        cache.clear()


def jax_put_model(mj, **kw):
    """mjlab_tpu.phys.model.put_model, with the JAX package's id-keyed
    tables dropped before and when the Model's keyed members are freed."""
    _drop_jax_id_caches()
    jm = _jax_put_model(mj, **kw)
    for member in (jm.body_parentid, jm.pairs):
        weakref.finalize(member, _drop_jax_id_caches)
    return jm


def model_pair(mj, nconmax, dtype):
    """(JAX Model, port Model) of one MjModel; the port's is built from
    the JAX leaves with model_from_numpy. dtype is a numpy dtype."""
    jm = jax_put_model(mj, dtype=jnp.dtype(dtype), nconmax=nconmax)
    return jm, port_model_from_jax(jm, dtype)


def port_model_from_jax(jm, dtype) -> pm.Model:
    fields = {n: np.asarray(getattr(jm, n)) for n in pm.tensor_fields()}
    for n in pm.OPTION_TENSOR_FIELDS:
        fields[f"opt_{n}"] = np.asarray(getattr(jm.opt, n))
    static = {n: getattr(jm, n) for n in pm.static_fields()}
    static["pairs"] = {
        f.name: getattr(jm.pairs, f.name)
        for f in dataclasses.fields(pm.PairTable)
    }
    for n in pm.OPTION_STATIC_FIELDS:
        static[f"opt_{n}"] = getattr(jm.opt, n)
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    return pm.model_from_numpy(fields, static, dtype=tdtype, device="cpu")


def state_np(mj, E: int, seed: int = 0, dtype=np.float64, keyframe=False,
             qpos_noise=0.03, qvel_noise=0.3, ctrl_noise=0.2):
    """(qpos, qvel, ctrl) numpy arrays (E, n): qpos0 (or keyframe 0) plus
    seeded noise, free-joint quaternions renormalised."""
    rng = np.random.default_rng(seed)
    base = mj.key_qpos[0] if keyframe else mj.qpos0
    qpos = np.tile(np.asarray(base, np.float64), (E, 1))
    qpos += qpos_noise * rng.standard_normal(qpos.shape)
    for j in range(mj.njnt):
        if mj.jnt_type[j] == 0:
            a = mj.jnt_qposadr[j] + 3
            qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                               keepdims=True)
    qvel = qvel_noise * rng.standard_normal((E, mj.nv))
    ctrl = ctrl_noise * rng.standard_normal((E, mj.nu))
    if keyframe:
        ctrl += mj.key_ctrl[0]
    return qpos.astype(dtype), qvel.astype(dtype), ctrl.astype(dtype)


def jax_data_from_port(d):
    """The JAX package's Data holding the port Data d's values (numpy
    copies of every field; float64 needs jax.enable_x64)."""
    from mjlab_tpu.phys.data import Contact as JaxContact
    from mjlab_tpu.phys.data import Data as JaxData
    from mjlab_tpu_torch.phys.data import tensor_fields

    # copies: a JAX array may share a numpy array's memory, and the port
    # writes its Data in place
    kw = {n: jnp.asarray(np.array(tnp(getattr(d, n))) if getattr(d, n).is_floating_point()
                         else getattr(d, n).numpy().copy())
          for n in tensor_fields() if n != "contact"}
    return JaxData(contact=JaxContact(packed=jnp.asarray(np.array(tnp(d.contact.packed)))),
                   **kw)


def g1_scenes(E: int, steps: int = 2, seed: int = 0):
    """The G1 velocity task's scene in both packages on one float64 state:
    (JAX scene, JAX SimContext, port Simulation, port Scene). The JAX
    scene is the task's own (terrain plane, robot, its two contact
    sensors, the XML's builtin sensors); the port's Simulation runs on the
    MjModel that scene compiles. The state is the keyframe plus seeded
    noise after ``steps`` port steps and a refresh, so that the feet touch
    the ground; the JAX context holds the same Data (call under
    jax.enable_x64)."""
    import jax

    import mjlab_tpu.tasks  # noqa: F401  (registers the tasks)
    from mjlab_tpu.scene.scene import Scene as JaxScene
    from mjlab_tpu.scene.scene import SimContext as JaxSimContext
    from mjlab_tpu.tasks.registry import load_env_cfg
    from mjlab_tpu_torch.scene.scene import xml_sensors
    from mjlab_tpu_torch.sim.sim import Simulation

    cfg = load_env_cfg("Mjlab-Velocity-Flat-Unitree-G1")
    cfg.scene.num_envs = E
    jscene = JaxScene(cfg.scene)
    mj = jscene.compile()
    sim_cfg().mujoco.apply(mj)
    port_cfg = sim_cfg()
    port_cfg.dtype = "float64"
    sim = Simulation(E, port_cfg, mj, device="cpu")
    q, v, c = state_np(mj, E, seed=seed, keyframe=True)
    sim.data = sim.data.replace(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v),
                                ctrl=torch.as_tensor(c))
    for _ in range(steps):
        sim.step()
    sim.refresh()
    from mjlab_tpu_torch.tasks.velocity.config.g1.physics import make_scene

    scene = make_scene(sim, xml_sensors(mj))
    jm = jax_put_model(mj, dtype=jnp.float64, nconmax=G1_NCONMAX)
    ctx = JaxSimContext(jm, jax_data_from_port(sim.data))
    jscene.initialize(mj, ctx, jax.random.PRNGKey(0))
    return jscene, ctx, sim, scene


# ---------------------------------------------------------------------------
# random draws: the JAX package's, recorded, played back to the port
# ---------------------------------------------------------------------------


class JaxDraws:
    """Records every jax.random.uniform / normal / randint / categorical /
    permutation draw made while active (eager calls only: the values must
    be concrete; a learn_iteration runs under jax.disable_jit()), in order,
    as ("uniform", unit draws in [0, 1)), ("normal", draws), ("integers",
    draws), ("categorical", the indices drawn) or ("permutation", a
    permutation of range(n)). ``with JaxDraws()
    as draws: ...`` then ``ReplayRng(draws)`` hands the same numbers to the
    port, whose every draw goes through Rng.draw."""

    def __init__(self):
        self.log: list[tuple[str, np.ndarray]] = []

    def __enter__(self):
        import jax

        self._orig = (jax.random.uniform, jax.random.normal, jax.random.randint,
                      jax.random.permutation, jax.random.categorical)
        uniform, normal, randint, permutation, categorical = self._orig

        def rec_uniform(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
            self.log.append(("uniform", np.asarray(uniform(key, shape, dtype))))
            return uniform(key, shape, dtype, minval, maxval)

        def rec_normal(key, shape=(), dtype=float):
            out = normal(key, shape, dtype)
            self.log.append(("normal", np.asarray(out)))
            return out

        def rec_randint(key, shape, minval, maxval, dtype=int):
            out = randint(key, shape, minval, maxval, dtype)
            self.log.append(("integers", np.asarray(out)))
            return out

        def rec_permutation(key, x, *args, **kw):
            out = permutation(key, x, *args, **kw)
            self.log.append(("permutation", np.asarray(out)))
            return out

        def rec_categorical(key, logits, *args, **kw):
            out = categorical(key, logits, *args, **kw)
            self.log.append(("categorical", np.asarray(out)))
            return out

        (jax.random.uniform, jax.random.normal, jax.random.randint,
         jax.random.permutation, jax.random.categorical) = (
            rec_uniform, rec_normal, rec_randint, rec_permutation, rec_categorical)
        return self

    def __exit__(self, *exc):
        import jax

        (jax.random.uniform, jax.random.normal, jax.random.randint,
         jax.random.permutation, jax.random.categorical) = self._orig
        return False


class ReplayRng:
    """A port Rng (mjlab_tpu_torch/utils/random.py) whose draws are the
    recorded JAX ones, in order; each must match the kind and shape the
    port asks for."""

    def __init__(self, draws: JaxDraws, device="cpu"):
        from mjlab_tpu_torch.utils.random import Rng

        self._rng = Rng(0, device)
        self._rng.draw = self.draw
        self.queue = list(draws.log)
        self.device = torch.device(device)

    def draw(self, kind, shape, dtype, low=0, high=1, probs=None):
        assert self.queue, f"the port draws {kind} {shape}: JAX drew no more"
        jkind, value = self.queue.pop(0)
        assert (jkind, tuple(value.shape)) == (kind, tuple(shape)), (
            f"the port draws {kind} {tuple(shape)}, JAX drew {jkind} {value.shape}")
        return torch.as_tensor(np.array(value), device=self.device).to(dtype)

    def __getattr__(self, name):
        return getattr(self._rng, name)

    def done(self) -> bool:
        return not self.queue


# ---------------------------------------------------------------------------
# the G1 flat-velocity env in both packages on one state
# ---------------------------------------------------------------------------

G1_TASK = "Mjlab-Velocity-Flat-Unitree-G1"


def env_pair(task: str, E: int, dtype: str = "float32", edit=None):
    """(JAX env, port env on the CPU) of ``task``, each from its own
    registry, with ``edit(cfg)`` applied to both configs; the JAX env at
    its float32 default, the port's Simulation at ``dtype``."""
    import os

    os.environ.setdefault("MJLAB_QUIET", "1")
    import mjlab_tpu.tasks as jtasks
    from mjlab_tpu.envs import ManagerBasedRlEnv as JaxEnv
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv as PortEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    cfgs = [jtasks.load_env_cfg(task), load_env_cfg(task)]
    for cfg in cfgs:
        cfg.scene.num_envs = E
        if edit is not None:
            edit(cfg)
    cfgs[1].sim.dtype = dtype
    return JaxEnv(cfgs[0]), PortEnv(cfgs[1], device="cpu")


def collapse_velocity_ranges(cfg, terrain_rows: int = 2, terrain_cols: int = 2):
    """Every random range of a velocity task's config at a point (reset
    poses, the command's ranges with rel_standing_envs 0 and
    rel_heading_envs 1, the curriculum's stage, the push, the friction;
    the policy group's corruption off), the resampling and push intervals
    short enough that a resample and a push fire within 5 steps; a
    generated terrain cut to terrain_rows x terrain_cols sub-terrains with
    seed 0."""
    ev = cfg.events
    ev["reset_base"].params["pose_range"] = {}
    ev["reset_base"].params["velocity_range"] = {}
    ev["push_robot"].interval_range_s = (0.05, 0.05)
    ev["push_robot"].params["velocity_range"] = {"x": (0.3, 0.3), "y": (-0.2, -0.2)}
    ev["foot_friction"].params["ranges"] = (0.7, 0.7)
    c = cfg.commands["twist"]
    c.resampling_time_range = (0.05, 0.05)
    c.rel_standing_envs = 0.0
    c.rel_heading_envs = 1.0
    c.ranges.lin_vel_x = (0.4, 0.4)
    c.ranges.lin_vel_y = (0.1, 0.1)
    c.ranges.heading = (0.3, 0.3)  # ang_vel_z: the heading controller's
    cfg.curriculum["command_vel"].params["velocity_stages"] = [
        {"step": 0, "lin_vel_x": (0.4, 0.4), "ang_vel_z": (-0.5, 0.5)}]
    cfg.observations["policy"].enable_corruption = False
    gen = cfg.scene.terrain.terrain_generator
    if gen is not None:
        gen.num_rows, gen.num_cols, gen.seed = terrain_rows, terrain_cols, 0


def tip_and_time_out(jenv, penv) -> None:
    """Env 0 tipped 80 degrees (past fell_over's 70), env 1 one step before
    its time-out, in both envs: the next step resets both."""
    import math

    a = math.radians(80.0) / 2
    q = np.array([math.cos(a), math.sin(a), 0.0, 0.0], np.float32)
    st = jenv._state
    jenv._state = st.replace(
        data=st.data.replace(qpos=st.data.qpos.at[0, 3:7].set(q)),
        episode_length=st.episode_length.at[1].set(jenv.max_episode_length - 1))
    qpos = penv.sim.data.qpos.clone()
    qpos[0, 3:7] = torch.as_tensor(q)
    penv.sim.data = penv.sim.data.replace(qpos=qpos)
    penv.episode_length_buf[1] = penv.max_episode_length - 1


def _f64(x):
    return np.array(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def run_velocity_env_pair(task: str, E: int, steps: int, edit=None, prepare=None,
                          between=None, command=("twist", "command"), action_std=0.3,
                          nudge: float | None = None):
    """A task's JAX env (the env-last hybrid physics, MJLAB_TPU_ENGINE=
    hybrid, whose substep the port's step is held against in
    tests/test_torch_step.py) and the port's, both float32 with ``edit``
    applied, reset, ``prepare(jenv, penv)`` applied, then the same
    ``steps`` seeded actions (action_std N(0, 1)), ``between(t, jenv,
    penv)`` after step t: (jenv, penv, {"jax": [...], "port": [...]}),
    each step's outputs, state, episode sums, logs, the command term's
    state entry ``command`` (term name, key) and, on a generated terrain,
    the terrain levels and origins. ``nudge``: the JAX env also runs the
    same steps from the same prepared state with every action times (1 +
    nudge), recorded as out["jax_nudged"] (``between`` is not called
    there): where one JAX step is ill-conditioned at float32 (its outputs
    move past the tolerance under an ulp-sized nudge of its inputs), the
    checks hold the port to the nearer of the two references, env by env
    (ill_conditioned lists those steps)."""
    cname, ckey = command
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MJLAB_TPU_ENGINE", "hybrid")
        jenv, penv = env_pair(task, E, "float32", edit=edit)
        jenv.reset()
        penv.reset()
        if prepare is not None:
            prepare(jenv, penv)
        A = penv.action_manager.total_action_dim
        terrain = penv.scene.terrain
        generated = terrain is not None and terrain.generator is not None
        rs = np.random.default_rng(0)
        acts = [(action_std * rs.standard_normal((E, A))).astype(np.float32)
                for _ in range(steps)]

        def jax_step(act):
            jo, jr, jterm, jtrunc, jex = jenv.step(jnp.asarray(act))
            js = jenv._state
            return dict(
                policy=_f64(jo["policy"]), critic=_f64(jo["critic"]), reward=_f64(jr),
                terminated=np.asarray(jterm), truncated=np.asarray(jtrunc),
                episode_length=np.asarray(js.episode_length),
                command=_f64(js.command_state[cname][ckey]),
                qpos=_f64(js.data.qpos), qvel=_f64(js.data.qvel), ctrl=_f64(js.data.ctrl),
                sums={k: _f64(v) for k, v in js.reward_state["episode_sums"].items()},
                log={k: _f64(v) for k, v in jex["log"].items()},
                **({"levels": np.asarray(js.terrain_state["levels"]),
                    "origins": np.asarray(js.terrain_state["origins"])} if generated else {}))

        # a copy of the prepared JAX state (a step donates its input buffers)
        start = jax.tree.map(np.array, jenv._state) if nudge is not None else None
        out = {"jax": [], "port": []}
        for act in acts:
            out["jax"].append(jax_step(act))
            po, pr, pterm, ptrunc, pex = penv.step(torch.as_tensor(act))
            rm = penv.reward_manager
            out["port"].append(dict(
                policy=_f64(po["policy"]), critic=_f64(po["critic"]), reward=_f64(pr),
                terminated=pterm.numpy().copy(), truncated=ptrunc.numpy().copy(),
                episode_length=penv.episode_length_buf.numpy().copy(),
                command=_f64(penv.command_manager.get_term(cname).state[ckey]),
                qpos=_f64(penv.sim.data.qpos), qvel=_f64(penv.sim.data.qvel),
                ctrl=_f64(penv.sim.data.ctrl),
                sums={k: _f64(v) for k, v in rm.episode_sums.items()},
                step_values={k: _f64(v) for k, v in rm.step_values.items()},
                log={k: _f64(v) for k, v in pex["log"].items()},
                **({"levels": terrain.levels.numpy().copy(),
                    "origins": terrain.origins.numpy().copy()} if generated else {})))
            if between is not None:
                between(len(out["port"]) - 1, jenv, penv)
        if nudge is not None:
            jenv._state = jax.tree.map(jnp.asarray, start)
            out["jax_nudged"] = [jax_step(act * np.float32(1.0 + nudge)) for act in acts]
    return jenv, penv, out


def sync_jax_env(jenv, penv) -> None:
    """Put the port env's state into the JAX env's context: the Data, the
    robot's targets and encoder bias, the air-time states, the action
    history, the command terms' state, the episode counters, terminated
    and the per-env friction (call under jax.enable_x64 for a float64
    port)."""
    from mjlab_tpu.managers.action_manager import ActionState
    from mjlab_tpu.sensor.contact_sensor import ContactSensorState

    def j(t):  # a copy: the port writes its tensors in place
        return jnp.asarray(t.detach().cpu().numpy().copy())

    ctx = jenv.ctx
    ctx.data = jax_data_from_port(penv.sim.data)
    for name, ent in penv.scene.entities.items():
        st = ent.state
        ctx.entity_states[name] = ctx.entity_states[name].replace(
            joint_pos_target=j(st.joint_pos_target), joint_vel_target=j(st.joint_vel_target),
            joint_effort_target=j(st.joint_effort_target), encoder_bias=j(st.encoder_bias))
    for name, s in list(ctx.sensor_states.items()):
        if isinstance(s, ContactSensorState):
            p = penv.scene.ctx.sensor_states[name]
            ctx.sensor_states[name] = ContactSensorState(
                j(p.current_air_time), j(p.current_contact_time), j(p.last_air_time),
                j(p.last_contact_time))
    am = penv.action_manager
    ctx.action_state = ActionState(action=j(am.action), prev_action=j(am.prev_action),
                                   prev_prev_action=j(am.prev_prev_action))
    for name in jenv.command_manager.active_terms:
        ctx.command_state[name] = jax.tree_util.tree_map(
            j, penv.command_manager.get_term(name).state)
    ctx.episode_length = j(penv.episode_length_buf)
    ctx.common_step = j(penv.common_step_counter)
    jenv.termination_manager.terminated = j(penv.termination_manager.terminated)
    jenv.termination_manager.truncated = j(penv.termination_manager.truncated)
    for field in penv.sim._default_fields:
        cur = getattr(ctx.model, field)
        ctx.model = ctx.model.replace(
            **{field: jnp.asarray(tnp(getattr(penv.sim.model, field)), cur.dtype)})
    ctx.extras_log = {}


# ---------------------------------------------------------------------------
# the PPO learner: one JAX learn_iteration, its internals recorded
# ---------------------------------------------------------------------------


class RecordingRng:
    """A port Rng whose draws are recorded, in order, as (kind, numpy)."""

    def __init__(self, rng):
        self._rng = rng
        self.log: list[tuple[str, np.ndarray]] = []
        rng_draw = rng.draw

        def draw(kind, shape, dtype, low=0, high=1, probs=None):
            out = rng_draw(kind, shape, dtype, low, high, probs)
            self.log.append((kind, out.detach().cpu().numpy().copy()))
            return out

        rng.draw = draw

    def __getattr__(self, name):
        return getattr(self._rng, name)


class DrawsIntoJax:
    """While active, jax.random.normal and jax.random.permutation return the
    recorded draws of a port learner (RecordingRng.log), in order; each
    must match the kind and shape JAX asks for."""

    def __init__(self, log):
        self.queue = list(log)

    def _pop(self, kind, shape):
        assert self.queue, f"JAX draws {kind} {shape}: the port drew no more"
        k, value = self.queue.pop(0)
        assert (k, tuple(value.shape)) == (kind, tuple(shape)), (
            f"JAX draws {kind} {tuple(shape)}, the port drew {k} {value.shape}")
        return jnp.asarray(value)

    def __enter__(self):
        import jax

        self._orig = (jax.random.normal, jax.random.permutation)
        jax.random.normal = lambda key, shape=(), dtype=float: self._pop("normal", shape)
        jax.random.permutation = lambda key, x, *a, **kw: self._pop("permutation", (int(x),))
        return self

    def __exit__(self, *exc):
        import jax

        jax.random.normal, jax.random.permutation = self._orig
        return False


def jax_learn_iteration(jppo, state, obs, env_state):
    """One mjlab_tpu.rl.ppo.PPO.learn_iteration under jax.disable_jit()
    (lax.scan a Python loop, every draw concrete): ((state, env_state,
    obs), metrics, rec). rec["scan"][name] holds the stacked outputs of
    each lax.scan by its body's name (rollout_step: the trajectory and
    logs; gae_step: the advantages, last step first; epoch: each
    minibatch's losses and KL), rec["lr"] the learning rate of each
    minibatch's optimiser step. The JAX package is not changed: the test
    wraps jax.lax.scan and the PPO instance's optax transformation."""
    import jax

    rec = {"scan": {}, "lr": []}
    scan, tx = jax.lax.scan, jppo.tx

    def recording_scan(f, init, xs=None, length=None, **kw):
        carry, ys = scan(f, init, xs, length=length, **kw)
        rec["scan"].setdefault(f.__name__, []).append(
            jax.tree_util.tree_map(lambda a: np.array(a), ys))
        return carry, ys

    class RecordingTx:
        init = tx.init

        def update(self, grads, opt_state, params=None):
            rec["lr"].append(float(opt_state[1].hyperparams["learning_rate"]))
            return tx.update(grads, opt_state, params)

    jax.lax.scan, jppo.tx = recording_scan, RecordingTx()
    try:
        with jax.disable_jit():
            carry, metrics = jppo.learn_iteration((state, env_state, obs))
    finally:
        jax.lax.scan, jppo.tx = scan, tx
    return carry, {k: np.asarray(v) for k, v in metrics.items()}, rec


def jax_learner_payload(state, noise_std_type="scalar") -> dict:
    """The JAX PPO state's params, normalisers and Adam moments in the
    port's names (rl/interop.py params_from_numpy): {"model": rsl-rl
    model_state_dict, "mu": ..., "nu": ... (by parameter name), "count",
    "lr"}."""
    import jax

    from mjlab_tpu_torch.rl.interop import params_from_numpy

    get = jax.device_get
    sd = params_from_numpy(get(state.params), get(state.actor_norm), get(state.critic_norm),
                           noise_std_type)["model_state_dict"]
    adam = state.opt_state[1].inner_state[0]
    mom = {k: params_from_numpy(get(getattr(adam, k)), noise_std_type=noise_std_type)
           ["model_state_dict"] for k in ("mu", "nu")}
    return {"model": sd, "mu": mom["mu"], "nu": mom["nu"], "count": int(adam.count),
            "lr": float(state.lr)}


def promote_demote_and_fall(jenv, penv) -> None:
    """On a generated terrain of 2 x 2 sub-terrains and 4 envs (types 0, 0,
    1, 1: a flat column and a stairs column), in both envs: the levels set
    to 0, 1, 0, 1 with their origins; env 0 placed 4.5 m along +x from its
    origin (past half a sub-terrain, on the flat row above) and env 1 0.3 m
    from its origin, both one step before their time-out, so that the
    terrain curriculum promotes env 0 and demotes env 1 as they reset; env
    2 tipped 80 degrees on its stairs (it falls over and resets, level 0
    held at 0); env 3 stays on level 1 of the stairs. Each root at its
    origin plus the robot's default position plus the offset, as float32
    numbers computed once."""
    import math

    jt, pt = jenv.scene.terrain, penv.scene.terrain
    table = np.asarray(jt.terrain_origins)
    np.testing.assert_array_equal(table, pt.terrain_origins.numpy())
    types = np.asarray(jenv._state.terrain_state["types"])
    np.testing.assert_array_equal(types, pt.types.numpy())
    assert types.tolist() == [0, 0, 1, 1]
    levels = np.array([0, 1, 0, 1], np.int32)
    origins = table[levels, types].astype(np.float32)
    default = penv.scene["robot"].data.default_root_state[0, :3].numpy().astype(np.float32)
    root = origins + default + np.array([[4.5, 0, 0], [0.3, 0, 0], [0, 0, 0], [0, 0, 0]],
                                        np.float32)
    a = math.radians(80.0) / 2
    tip = np.array([math.cos(a), math.sin(a), 0.0, 0.0], np.float32)
    late = np.array([True, True, False, False])

    st = jenv._state
    qpos = st.data.qpos.at[:, 0:3].set(jnp.asarray(root)).at[2, 3:7].set(jnp.asarray(tip))
    ep = jnp.where(jnp.asarray(late), jenv.max_episode_length - 1, st.episode_length)
    jenv._state = st.replace(
        data=st.data.replace(qpos=qpos), episode_length=ep,
        terrain_state={"levels": jnp.asarray(levels), "types": jnp.asarray(types),
                       "origins": jnp.asarray(origins)})

    pt.levels.copy_(torch.as_tensor(levels))
    pt.origins.copy_(torch.as_tensor(origins))
    q = penv.sim.data.qpos.clone()
    q[:, 0:3] = torch.as_tensor(root)
    q[2, 3:7] = torch.as_tensor(tip)
    penv.sim.data = penv.sim.data.replace(qpos=q)
    penv.episode_length_buf[torch.as_tensor(late)] = penv.max_episode_length - 1


# every random draw at a point, in both packages: jax.random.uniform
# patched to 0.5 of its range and jax.random.categorical to the arg max of
# its logits (while the JAX env compiles its step: the draws are constants
# of the jit), the port's Rng.draw likewise (a unit uniform at 0.5, a
# categorical at the arg max of its probabilities)


def point_uniform(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
    dtype = jax.dtypes.canonicalize_dtype(dtype)
    minval = jnp.asarray(minval, dtype)
    maxval = jnp.asarray(maxval, dtype)
    return jnp.maximum(minval, jnp.full(shape, 0.5, dtype) * (maxval - minval) + minval)


def point_categorical(key, logits, axis=-1, shape=None):
    mode = jnp.argmax(logits, axis=axis)
    return mode if shape is None else jnp.broadcast_to(mode, shape)


def point_draw(rng, kind, shape, dtype, low=0, high=1, probs=None):
    if kind == "uniform":
        return torch.full(shape, 0.5, dtype=dtype)
    assert kind == "categorical", f"the env draws a {kind}"
    return torch.argmax(probs).expand(shape)


def rotation_x(deg: float) -> np.ndarray:
    """The unit quaternion (w, x, y, z) of a rotation by ``deg`` about x."""
    import math

    a = math.radians(deg) / 2
    return np.array([math.cos(a), math.sin(a), 0.0, 0.0], np.float32)


def set_env_state(jenv, penv, qpos=None, qvel=None, episode_length=None,
                  common_step=None) -> None:
    """Write the same state into both envs: {env: {address: value}} of
    qpos and qvel entries (the value a number or a vector from the
    address on), {env: length} of episode counters, the global step
    count."""
    st = jenv._state
    d = st.data
    pd = penv.sim.data
    jq, jv, pq, pv = d.qpos, d.qvel, pd.qpos.clone(), pd.qvel.clone()
    for entries, (j, p) in (((qpos or {}), ("q", "q")), ((qvel or {}), ("v", "v"))):
        for env, items in entries.items():
            for adr, val in items.items():
                val = np.atleast_1d(np.asarray(val, np.float32))
                sl = slice(adr, adr + val.shape[0])
                if j == "q":
                    jq = jq.at[env, sl].set(jnp.asarray(val))
                    pq[env, sl] = torch.as_tensor(val)
                else:
                    jv = jv.at[env, sl].set(jnp.asarray(val))
                    pv[env, sl] = torch.as_tensor(val)
    el = st.episode_length
    for env, n in (episode_length or {}).items():
        el = el.at[env].set(n)
        penv.episode_length_buf[env] = n
    cs = st.common_step
    if common_step is not None:
        cs = jnp.asarray(common_step, jnp.int32)
        penv.common_step_counter.fill_(common_step)
    jenv._state = st.replace(data=d.replace(qpos=jq, qvel=jv), episode_length=el,
                             common_step=cs)
    penv.sim.data = pd.replace(qpos=pq, qvel=pv)


# the env-pair tolerances (tests/test_torch_env.py, by what each output
# reads): qpos 1e-4, qvel 1e-3; the policy observations 1e-3; the critic
# observations and the logs 5e-3 (the feet's contact forces); the reward,
# each term's step value and the episode sums 1e-3; the command 1e-4; ctrl
# 1e-6; all relative to max(1, |JAX|max)
VELOCITY_ENV_TOL = {"qpos": 1e-4, "qvel": 1e-3, "ctrl": 1e-6, "policy": 1e-3, "critic": 5e-3,
                    "reward": 1e-3, "step_value": 1e-3, "episode_sum": 1e-3, "command": 1e-4,
                    "log": 5e-3}


def _nearer(want: np.ndarray, other: np.ndarray, got: np.ndarray) -> np.ndarray:
    """Env by env (row by row, or the scalar), whichever of two references
    is nearer to ``got``."""
    if want.ndim == 0:
        return want if abs(want - got) <= abs(other - got) else other
    axes = tuple(range(1, want.ndim))
    far = (np.abs(want - got).max(axis=axes, initial=0.0)
           > np.abs(other - got).max(axis=axes, initial=0.0))
    return np.where(far.reshape((-1,) + (1,) * len(axes)), other, want)


def _reference(out, step: int, get, got: np.ndarray) -> np.ndarray:
    """The JAX value ``get(out["jax"][step])``; with a nudged JAX run, the
    nearer of the two to ``got``, env by env."""
    want = get(out["jax"][step])
    if "jax_nudged" not in out:
        return want
    return _nearer(want, get(out["jax_nudged"][step]), got)


def ill_conditioned(out, what: str, tol: float) -> list[tuple[int, int]]:
    """(step, env) of the JAX steps whose output ``what`` the nudge moves
    past ``tol`` (relative to max(1, |JAX|max), as rel_err)."""
    found = []
    for t, (a, b) in enumerate(zip(out["jax"], out["jax_nudged"])):
        scale = max(1.0, float(np.abs(a[what]).max()))
        d = np.abs(a[what] - b[what]).reshape(a[what].shape[0], -1).max(1) / scale
        found += [(t, int(e)) for e in np.flatnonzero(d >= tol)]
    return found


def check_env_output(out, what: str, step: int) -> None:
    """One output of run_velocity_env_pair's step within VELOCITY_ENV_TOL."""
    got = out["port"][step][what]
    want = _reference(out, step, lambda o: o[what], got)
    assert want.shape == got.shape
    assert rel_err(want, got) < VELOCITY_ENV_TOL[what], rel_err(want, got)


def check_env_equal(out, step: int, keys) -> None:
    for k in keys:
        np.testing.assert_array_equal(out["jax"][step][k], out["port"][step][k], err_msg=k)


def check_reward_term(out, term: str) -> None:
    """A reward term's value in every step (the JAX episode sum's
    increment, in the envs that did not reset), and its episode sum."""
    jax_out, port_out = out["jax"], out["port"]
    runs = [jax_out] + ([out["jax_nudged"]] if "jax_nudged" in out else [])
    for t in range(len(jax_out)):
        kept = ~(jax_out[t]["terminated"] | jax_out[t]["truncated"])
        got = port_out[t]["step_values"][term]
        incs = [r[t]["sums"][term] - (r[t - 1]["sums"][term] if t else 0.0) for r in runs]
        inc = incs[0] if len(incs) == 1 else _nearer(incs[0], incs[1], got)
        assert rel_err(inc[kept], got[kept]) < VELOCITY_ENV_TOL["step_value"], t
        sums = _reference(out, t, lambda o: o["sums"][term], port_out[t]["sums"][term])
        assert rel_err(sums, port_out[t]["sums"][term]) < VELOCITY_ENV_TOL["episode_sum"]


def check_env_logs(out, step: int) -> None:
    want, got = out["jax"][step]["log"], out["port"][step]["log"]
    assert set(want) == set(got)
    for k in want:
        ref = _reference(out, step, lambda o: o["log"][k], got[k])
        assert rel_err(ref, got[k]) < VELOCITY_ENV_TOL["log"], k


# ---------------------------------------------------------------------------
# the G1 env with explicit actuator groups (tasks/velocity/config/g1/
# explicit.py) and its JAX twin
# ---------------------------------------------------------------------------


class JitDraws:
    """Records every jax.random.uniform / normal / randint draw in the order
    the JAX program makes them, inside jitted code too (an ordered
    jax.debug.callback per draw, so a scan's draws come once per
    iteration), as JaxDraws does: ("uniform", the unit draws), ("normal",
    draws), ("integers", draws). Patch while the JAX env traces its step
    and reset (``with JitDraws() as draws``); ``take()`` hands the draws so
    far to a ReplayRng and starts a new list."""

    def __init__(self):
        self.log: list[tuple[str, np.ndarray]] = []

    def _rec(self, kind, x):
        jax.debug.callback(lambda v: self.log.append((kind, np.array(v))), x, ordered=True)

    def __enter__(self):
        self._orig = (jax.random.uniform, jax.random.normal, jax.random.randint)
        uniform, normal, randint = self._orig

        def rec_uniform(key, shape=(), dtype=float, minval=0.0, maxval=1.0):
            self._rec("uniform", uniform(key, shape, dtype))
            return uniform(key, shape, dtype, minval, maxval)

        def rec_normal(key, shape=(), dtype=float):
            out = normal(key, shape, dtype)
            self._rec("normal", out)
            return out

        def rec_randint(key, shape, minval, maxval, dtype=int):
            out = randint(key, shape, minval, maxval, dtype)
            self._rec("integers", out)
            return out

        jax.random.uniform, jax.random.normal, jax.random.randint = (
            rec_uniform, rec_normal, rec_randint)
        return self

    def __exit__(self, *exc):
        jax.random.uniform, jax.random.normal, jax.random.randint = self._orig
        return False

    def take(self) -> "JitDraws":
        jax.effects_barrier()
        out = JitDraws()
        out.log, self.log = self.log, []
        return out


def jax_explicit_env_cfg(E: int, buffer_size: int = 100):
    """The JAX package's twin of the port's explicit G1 env config
    (explicit.py): the JAX flat G1 config with the same groups, events,
    termination and NaN guard, built from explicit.py's plain data."""
    os.environ.setdefault("MJLAB_QUIET", "1")
    import mjlab_tpu.tasks as jtasks
    from mjlab_tpu.actuator import (
        BuiltinPositionActuatorCfg, DcMotorActuatorCfg, DelayedActuatorCfg, IdealPdActuatorCfg,
    )
    from mjlab_tpu.envs.mdp import events, terminations
    from mjlab_tpu.managers.manager_term_config import EventTermCfg, TerminationTermCfg
    from mjlab_tpu.managers.scene_entity_config import SceneEntityCfg
    from mjlab_tpu.utils.nan_guard import NanGuardCfg
    from mjlab_tpu_torch.tasks.velocity.config.g1 import explicit as X

    cfg = jtasks.load_env_cfg(G1_TASK)
    cfg.scene.num_envs = E
    groups = []
    for kind, a, vmax in X.GROUPS:
        common = dict(joint_names_expr=a.joint_names_expr, stiffness=a.stiffness,
                      damping=a.damping, effort_limit=a.effort_limit, armature=a.armature)
        if kind == "builtin":
            groups.append(BuiltinPositionActuatorCfg(**common))
        elif kind == "pd":
            groups.append(IdealPdActuatorCfg(**common))
        else:
            base = DcMotorActuatorCfg(**common, saturation_effort=a.effort_limit,
                                      velocity_limit=vmax)
            groups.append(DelayedActuatorCfg(joint_names_expr=a.joint_names_expr,
                                             base_cfg=base, **X.DELAY_PARAMS))
    # a copy: the JAX G1 configs share one articulation object
    robot = cfg.scene.entities["robot"]
    robot.articulation = dataclasses.replace(robot.articulation, actuators=tuple(groups))
    cfg.events["pd_gains"] = EventTermCfg(
        func=events.randomize_pd_gains, mode="reset", params=dict(X.PD_GAIN_PARAMS))
    cfg.events["effort_limits"] = EventTermCfg(
        func=events.randomize_effort_limits, mode="reset", params=dict(X.EFFORT_PARAMS))
    cfg.events["actuator_delays"] = EventTermCfg(
        func=events.sync_actuator_delays, mode="startup", params=dict(X.LAG_PARAMS))
    cfg.events["external_wrench"] = EventTermCfg(
        func=events.apply_external_force_torque, mode="interval",
        interval_range_s=X.WRENCH_INTERVAL_S,
        params=dict(X.WRENCH_PARAMS, asset_cfg=SceneEntityCfg("robot",
                                                              body_names=(X.WRENCH_BODY,))))
    cfg.terminations["nan_term"] = TerminationTermCfg(func=terminations.nan_detection)
    cfg.sim.nan_guard = NanGuardCfg(enabled=True, buffer_size=buffer_size)
    return cfg


def jax_expand_actuator_fields(jenv) -> None:
    """explicit.expand_actuator_fields on the JAX env (its Simulation, its
    context and its state)."""
    from mjlab_tpu_torch.tasks.velocity.config.g1.explicit import EXPANDED_FIELDS

    jenv.sim.expand_model_fields(list(EXPANDED_FIELDS))
    jenv.ctx.model = jenv.sim.model
    jenv._state = jenv._state.replace(model=jenv.sim.model)


# ---------------------------------------------------------------------------
# the G1 env whose critic reads every sensor type (tasks/velocity/config/
# g1/sensors.py) and its JAX twin
# ---------------------------------------------------------------------------


def jax_contact_fields(env, sensor_name: str):
    """The JAX twin of sensors.contact_fields."""
    from mjlab_tpu_torch.tasks.velocity.config.g1.sensors import CONTACT_FIELDS

    data = env.scene[sensor_name].data
    parts = [jnp.reshape(x, (x.shape[0], -1)).astype(jnp.float32)
             for x in (getattr(data, f) for f in CONTACT_FIELDS) if x is not None]
    return jnp.concatenate(parts, axis=-1)


def jax_add_sensor_suite(cfg):
    """The JAX package's twin of sensors.add_sensor_suite, in place: the
    same rangefinder site, builtin and contact sensors and critic terms,
    built from sensors.py's plain data."""
    from mjlab_tpu.envs.mdp import observations
    from mjlab_tpu.managers.manager_term_config import ObservationTermCfg
    from mjlab_tpu.sensor.builtin_sensor import BuiltinSensorCfg, ObjRef
    from mjlab_tpu.sensor.contact_sensor import ContactMatch, ContactSensorCfg
    from mjlab_tpu_torch.tasks.velocity.config.g1 import sensors as S

    robot = cfg.scene.entities["robot"]
    spec_fn = robot.spec_fn
    cfg.scene.entities["robot"] = dataclasses.replace(
        robot, spec_fn=lambda: S.add_rangefinder_site(spec_fn()))

    def ref(o):
        return None if o is None else ObjRef(type=o[0], name=o[1], entity="robot")

    builtin = tuple(BuiltinSensorCfg(name=n, sensor_type=t, obj=ref(o), ref=ref(r), cutoff=c)
                    for n, t, o, r, c in S.BUILTIN_SENSORS)
    contact = tuple(ContactSensorCfg(
        name=n, primary=ContactMatch(mode="subtree", pattern=S.FEET, entity="robot"),
        secondary=ContactMatch(mode="body", pattern="terrain/terrain"), fields=f,
        reduce=r, num_slots=k, global_frame=g) for n, r, f, k, g in S.CONTACT_SENSORS)
    cfg.scene.sensors = tuple(cfg.scene.sensors) + builtin + contact
    terms = cfg.observations["critic"].terms
    for name in S.XML_SENSORS + tuple(s[0] for s in S.BUILTIN_SENSORS):
        terms[f"sensor/{name}"] = ObservationTermCfg(
            func=observations.builtin_sensor, params={"sensor_name": name})
    for name, *_ in S.CONTACT_SENSORS:
        terms[f"contact/{name}"] = ObservationTermCfg(
            func=jax_contact_fields, params={"sensor_name": name})
    return cfg


def jax_sensors_env_cfg(E: int):
    """The JAX package's twin of the port's sensor-suite G1 env config
    (sensors.g1_sensors_env_cfg): the JAX flat G1 config with the suite."""
    os.environ.setdefault("MJLAB_QUIET", "1")
    import mjlab_tpu.tasks as jtasks

    cfg = jtasks.load_env_cfg(G1_TASK)
    cfg.scene.num_envs = E
    return jax_add_sensor_suite(cfg)
