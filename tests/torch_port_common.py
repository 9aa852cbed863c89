"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

The port (mjlab_tpu_torch) and the JAX package get the same inputs, made
from numpy seeds, and their outputs are compared as numpy arrays. The JAX
package's Model leaves become the port's Model through model_from_numpy.
"""

from __future__ import annotations

import dataclasses
import weakref

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
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
    """Records every jax.random.uniform / normal / randint draw made while
    active (eager calls only: the values must be concrete), in order, as
    ("uniform", unit draws in [0, 1)), ("normal", draws) or ("integers",
    draws). ``with JaxDraws() as draws: ...`` then ``ReplayRng(draws)``
    hands the same numbers to the port, whose every draw goes through
    Rng.draw."""

    def __init__(self):
        self.log: list[tuple[str, np.ndarray]] = []

    def __enter__(self):
        import jax

        self._orig = (jax.random.uniform, jax.random.normal, jax.random.randint)
        uniform, normal, randint = self._orig

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

        jax.random.uniform, jax.random.normal, jax.random.randint = (
            rec_uniform, rec_normal, rec_randint)
        return self

    def __exit__(self, *exc):
        import jax

        jax.random.uniform, jax.random.normal, jax.random.randint = self._orig
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

    def draw(self, kind, shape, dtype, low=0, high=1):
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


def g1_env_pair(E: int, dtype: str = "float32", edit=None):
    """(JAX env, port env on the CPU) of the G1 flat-velocity task, each
    from its own registry, with ``edit(cfg)`` applied to both configs; the
    JAX env at its float32 default, the port's Simulation at ``dtype``."""
    import os

    os.environ.setdefault("MJLAB_QUIET", "1")
    import mjlab_tpu.tasks as jtasks
    from mjlab_tpu.envs import ManagerBasedRlEnv as JaxEnv
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv as PortEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    cfgs = [jtasks.load_env_cfg(G1_TASK), load_env_cfg(G1_TASK)]
    for cfg in cfgs:
        cfg.scene.num_envs = E
        if edit is not None:
            edit(cfg)
    cfgs[1].sim.dtype = dtype
    return JaxEnv(cfgs[0]), PortEnv(cfgs[1], device="cpu")


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
