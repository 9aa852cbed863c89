"""The port's MDP terms and the G1 velocity task's terms, command and
curriculum (mjlab_tpu_torch/envs/mdp/, tasks/velocity/mdp/) against the
JAX package's on one float64 state of the G1 flat-velocity env, and the
terrain curriculum (terrain_levels_vel) and terrain event
(randomize_terrain) on a generated terrain.

The port's env (float64 Simulation, CPU) is reset and stepped with random
actions, so that the feet touch the ground, air times run and commands,
actions and targets are set; its whole state is then put into the JAX
env's context (torch_port_common.sync_jax_env) and each term is
evaluated in both, the JAX package's eagerly under jax.enable_x64. A term
that draws gets the JAX package's draws played back
(torch_port_common.ReplayRng). Tolerance: 1e-6 relative, and 1e-9
absolute for values near 0 (float64 state; some constants are float32 in
both); where draws were played back, 1e-6 absolute (the unit draws are
float32 in the port, float64 in JAX under enable_x64).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    G1_TASK, JaxDraws, ReplayRng, env_pair, jax_data_from_port, rel_err, sync_jax_env, tnp,
)

E = 4
TOL = 1e-6
ATOL = 1e-9
# a played-back draw is float32 in the port, float64 in JAX: a value near
# the middle of its range (u (hi - lo) + lo cancels) is off by up to half
# an f32 ulp of the range's scale
DRAW_ATOL = 1e-6
STEPS = 3

OBS_TERMS = ("base_lin_vel", "base_ang_vel", "projected_gravity", "joint_pos", "joint_vel",
             "actions", "command", "foot_height", "foot_air_time", "foot_contact",
             "foot_contact_forces")
REWARD_TERMS = ("track_linear_velocity", "track_angular_velocity", "upright", "pose",
                "body_ang_vel", "angular_momentum", "dof_pos_limits", "action_rate_l2",
                "air_time", "foot_clearance", "foot_swing_height", "foot_slip",
                "soft_landing", "self_collisions")
TERMINATION_TERMS = ("time_out", "fell_over")


@pytest.fixture(scope="module")
def envs():
    jenv, penv = env_pair(G1_TASK, E, "float64")
    penv.reset()
    rs = np.random.default_rng(0)
    for _ in range(STEPS):
        penv.step(torch.as_tensor(0.5 * rs.standard_normal((E, 29)), dtype=torch.float32))
    # a non-zero encoder bias for the terms that read it; env 0 sliding
    # (its feet slip), env 1 with joints past their soft limits, then one
    # more step and a refresh
    robot = penv.scene["robot"]
    robot.state.encoder_bias.copy_(torch.as_tensor(0.01 * rs.standard_normal((E, 29))))
    vel = robot.data.root_link_vel_w.clone()
    vel[0, 0] += 1.5
    robot.data.write_root_velocity(vel)
    lim = robot.data.soft_joint_pos_limits[0]
    q = robot.data.joint_pos.clone()
    q[1, ::3] = lim[::3, 1] + 0.05
    q[1, 1::3] = lim[1::3, 0] - 0.05
    robot.data.write_joint_position(q)
    # then steps until a foot lands in the last one (the first-contact
    # terms read it)
    rm = penv.reward_manager
    landing = rm._term_cfgs[rm._term_names.index("soft_landing")]
    for _ in range(8):
        penv.step(torch.as_tensor(0.5 * rs.standard_normal((E, 29)), dtype=torch.float32))
        if float(landing.func(penv, **landing.params).abs().max()) > 0:
            break
    yield jenv, penv


def _both(envs, fn_j, fn_p):
    """fn_j(jenv) under x64 on the synced state, fn_p(penv)."""
    jenv, penv = envs
    with jax.enable_x64(True):
        sync_jax_env(jenv, penv)
        want = jax.tree_util.tree_map(np.array, fn_j(jenv))
    return want, fn_p(penv)


def _close(want, got, tol=TOL, key="", atol=None):
    atol = ATOL if atol is None else atol
    if isinstance(want, dict):
        for k in want:
            _close(want[k], got[k], tol, f"{key}/{k}", atol)
        return
    got = tnp(got)
    want = np.asarray(want, np.float64)
    assert want.shape == got.shape, (key, want.shape, got.shape)
    # relative, and absolute for the small values (terms near 0)
    np.testing.assert_allclose(got, want, rtol=tol, atol=atol, err_msg=key)


def _cfg_term(env, manager, group, name):
    m = getattr(env, manager)
    if manager == "observation_manager":
        return m._group_terms[group][name]
    return m._term_cfgs[m._term_names.index(name)]


@pytest.mark.parametrize("name", OBS_TERMS)
def test_g1_observation_term_matches_jax(envs, name):
    def call(env):
        c = _cfg_term(env, "observation_manager", "critic", name)
        return c.func(env, **c.params)
    _close(*_both(envs, call, call))


@pytest.mark.parametrize("name", REWARD_TERMS)
def test_g1_reward_term_matches_jax(envs, name):
    def call(env):
        c = _cfg_term(env, "reward_manager", None, name)
        return c.func(env, **c.params)
    want, got = _both(envs, call, call)
    _close(want, got)
    assert np.isfinite(want).all()
    # the state makes every term but these non-zero somewhere
    assert name in ("air_time", "self_collisions") or np.abs(want).max() > 1e-6, want


def test_g1_reward_term_logs_match_jax(envs):
    """The Metrics/ logs the foot terms write into extras["log"]."""
    def call(env):
        for name in ("air_time", "foot_slip", "soft_landing"):
            c = _cfg_term(env, "reward_manager", None, name)
            c.func(env, **c.params)
        return dict(env.extras["log"])
    want, got = _both(envs, call, call)
    assert set(want) == set(got) == {"Metrics/air_time_mean", "Metrics/slip_velocity_mean",
                                     "Metrics/landing_force_mean"}
    _close(want, got)


@pytest.mark.parametrize("name", TERMINATION_TERMS)
def test_g1_termination_term_matches_jax(envs, name):
    def call(env):
        c = _cfg_term(env, "termination_manager", None, name)
        return c.func(env, **c.params)
    want, got = _both(envs, call, call)
    np.testing.assert_array_equal(want, tnp(got).astype(bool))


# library terms the G1 flat task does not configure
LIBRARY = {
    "obs/base_lin_vel": ("observations", "base_lin_vel", {}),
    "obs/base_ang_vel": ("observations", "base_ang_vel", {}),
    "obs/joint_pos_rel_unbiased": ("observations", "joint_pos_rel", {"biased": False}),
    "rew/is_alive": ("rewards", "is_alive", {}),
    "rew/is_terminated": ("rewards", "is_terminated", {}),
    "rew/joint_torques_l2": ("rewards", "joint_torques_l2", {}),
    "rew/joint_vel_l2": ("rewards", "joint_vel_l2", {}),
    "rew/joint_acc_l2": ("rewards", "joint_acc_l2", {}),
    "rew/action_acc_l2": ("rewards", "action_acc_l2", {}),
    "rew/flat_orientation_l2": ("rewards", "flat_orientation_l2", {}),
    "term/root_height_below_minimum": ("terminations", "root_height_below_minimum",
                                       {"minimum_height": 0.7}),
    "term/nan_detection": ("terminations", "nan_detection", {}),
    "vel/body_angular_velocity_penalty": ("velocity", "body_angular_velocity_penalty", {}),
    "vel/feet_air_time_no_command": ("velocity", "feet_air_time",
                                     {"sensor_name": "feet_ground_contact"}),
}


def _lib(module, jax_side):
    import importlib

    root = "mjlab_tpu" if jax_side else "mjlab_tpu_torch"
    path = {"velocity": "tasks.velocity.mdp.rewards"}.get(module, f"envs.mdp.{module}")
    return importlib.import_module(f"{root}.{path}")


@pytest.mark.parametrize("case", list(LIBRARY))
def test_library_term_matches_jax(envs, case):
    module, fn, params = LIBRARY[case]
    want, got = _both(envs, lambda e: getattr(_lib(module, True), fn)(e, **params),
                      lambda e: getattr(_lib(module, False), fn)(e, **params))
    _close(want, tnp(got).astype(want.dtype) if want.dtype == bool else got)


@pytest.mark.parametrize("cls", ["posture", "electrical_power_cost"])
def test_library_class_term_matches_jax(envs, cls):
    params = {"std": {".*_knee_joint": 0.3, ".*_hip_.*": 0.5}} if cls == "posture" else {}

    def call(env, jax_side):
        mod = _lib("rewards", jax_side)
        cfg_mod = (__import__("mjlab_tpu.managers.manager_term_config", fromlist=["x"])
                   if jax_side else
                   __import__("mjlab_tpu_torch.managers.manager_term_config", fromlist=["x"]))
        cfg = cfg_mod.RewardTermCfg(func=getattr(mod, cls), weight=1.0, params=params)
        return getattr(mod, cls)(cfg, env)(env, **params)
    _close(*_both(envs, lambda e: call(e, True), lambda e: call(e, False)))


def test_terrain_levels_on_a_plane_matches_jax(envs):
    from mjlab_tpu.tasks.velocity.mdp.curriculums import terrain_levels_vel as jt
    from mjlab_tpu_torch.tasks.velocity.mdp.curriculums import terrain_levels_vel as pt

    mask = np.ones(E, bool)
    want, got = _both(envs, lambda e: jt(e, jnp.asarray(mask), "twist"),
                      lambda e: pt(e, torch.as_tensor(mask), "twist"))
    _close(want, got)


def test_commands_vel_curriculum_matches_jax(envs):
    """The staged widening of the command ranges, by the step counter,
    written in place; its logged value."""
    from mjlab_tpu.tasks.velocity.mdp.curriculums import commands_vel as jc
    from mjlab_tpu_torch.tasks.velocity.mdp.curriculums import commands_vel as pc

    stages = [{"step": 0, "lin_vel_x": (-1.0, 1.0), "ang_vel_z": (-0.5, 0.5)},
              {"step": 2, "lin_vel_x": (-1.5, 2.0), "lin_vel_y": (-0.3, 0.3)},
              {"step": 10 ** 6, "lin_vel_x": (-2.0, 3.0)}]
    mask = np.ones(E, bool)

    def run_j(e):
        v = jc(e, jnp.asarray(mask), "twist", stages)
        return {"value": v, **e.command_manager.get_term("twist").state["ranges"]}

    def run_p(e):
        v = pc(e, torch.as_tensor(mask), "twist", stages)
        return {"value": v.clone(), **{k: t.clone() for k, t in
                                       e.command_manager.get_term("twist").state["ranges"].items()}}
    want, got = _both(envs, run_j, run_p)
    _close(want, got)
    assert float(want["value"]) == 2.0


def _draws_pair(envs, run_j, run_p):
    """run_j(jenv) recording the JAX draws, run_p(penv) with them played
    back; both return what to compare."""
    jenv, penv = envs
    with jax.enable_x64(True):
        sync_jax_env(jenv, penv)
        with JaxDraws() as draws:
            want = jax.tree_util.tree_map(np.array, run_j(jenv))
    rng = penv.rng
    penv.rng = ReplayRng(draws)
    try:
        got = run_p(penv)
        assert penv.rng.done(), "the port drew fewer numbers than JAX"
    finally:
        penv.rng = rng
    return want, got


MASK = np.array([True, False, True, True])
EVENTS = {
    "reset_base": {},
    "reset_robot_joints": {"position_range": (-0.1, 0.1), "velocity_range": (-0.5, 0.5)},
    "push_robot": {},
    "foot_friction": {},
    "foot_friction_scale_gaussian": {"operation": "scale", "distribution": "gaussian",
                                     "ranges": (1.0, 0.1)},
    "foot_friction_dict_ranges": {"ranges": {0: (0.4, 0.9), 2: (1e-4, 2e-4)}},
}


@pytest.mark.parametrize("case", list(EVENTS))
def test_g1_event_matches_jax(envs, case):
    """Each event of the G1 flat config (and randomize_field's other
    operations and ranges) on a mask: the state it writes."""
    term = case.split("_scale")[0].split("_dict")[0]

    def run(e, jax_side):
        cfg = e.event_manager
        c = next(c for mode in cfg._modes.values() for n, c in mode if n == term)
        params = {**c.params, **EVENTS[case]}
        mask = jnp.asarray(MASK) if jax_side else torch.as_tensor(MASK)
        c.func(e, mask, **params)
        d = e.ctx.data if jax_side else e.sim.data
        model = e.ctx.model if jax_side else e.sim.model
        return {"qpos": d.qpos, "qvel": d.qvel, "friction": model.geom_friction}
    want, got = _draws_pair(envs, lambda e: run(e, True), lambda e: run(e, False))
    _close(want, got, atol=DRAW_ATOL)


def test_reset_scene_to_default_matches_jax(envs):
    from mjlab_tpu.envs.mdp.events import reset_scene_to_default as jr
    from mjlab_tpu_torch.envs.mdp.events import reset_scene_to_default as pr

    def run(e, f, mask):
        f(e, mask)
        d = e.ctx.data if hasattr(e, "ctx") else e.sim.data
        return {"qpos": d.qpos, "qvel": d.qvel}
    want, got = _both(envs, lambda e: run(e, jr, jnp.asarray(MASK)),
                      lambda e: run(e, pr, torch.as_tensor(MASK)))
    _close(want, got)


@pytest.mark.parametrize("name", ["randomize_terrain"])
def test_unported_event_raises_naming_itself(envs, name):
    """Every event term of the JAX file is ported. randomize_terrain
    (test_randomize_terrain_matches_jax): on the flat env's plane it draws
    nothing and changes no state, as the JAX term does there. The four
    actuator and wrench terms: test_actuator_event_on_builtin_groups_matches_jax
    here and tests/test_torch_env_explicit.py on explicit groups;
    randomize_encoder_bias: test_randomize_encoder_bias_matches_jax."""
    from mjlab_tpu_torch.envs.mdp import events

    penv = envs[1]
    state = torch.get_rng_state(), penv.rng.generator.get_state()
    getattr(events, name)(penv, torch.ones(E, dtype=torch.bool))
    assert penv.scene.terrain.generator is None
    assert torch.equal(penv.rng.generator.get_state(), state[1])


@pytest.mark.parametrize("name", ["apply_external_force_torque", "randomize_pd_gains",
                                  "randomize_effort_limits", "sync_actuator_delays"])
def test_actuator_event_on_builtin_groups_matches_jax(envs, name):
    """The four actuator and wrench terms on the registered G1 (every group
    a builtin position actuator, no field expanded), against the JAX terms
    with their draws played back: the wrench on the torso of the masked
    envs (xfrc_applied); randomize_pd_gains raises RuntimeError (the gains
    are not per env); randomize_effort_limits is a silent no-op that draws
    nothing (forcerange shared); sync_actuator_delays finds no delayed
    group."""
    from mjlab_tpu.envs.mdp import events as jev
    from mjlab_tpu.managers.scene_entity_config import SceneEntityCfg as JCfg
    from mjlab_tpu_torch.envs.mdp import events as pev
    from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg as PCfg

    params = {"apply_external_force_torque": dict(force_range=(-20.0, 20.0),
                                                  torque_range=(-5.0, 5.0)),
              "randomize_pd_gains": dict(stiffness_scale=(0.8, 1.2),
                                         damping_scale=(0.8, 1.2)),
              "randomize_effort_limits": dict(scale=(0.8, 1.2)),
              "sync_actuator_delays": dict(min_lag=0, max_lag=2)}[name]

    def run(e, jax_side):
        cfg = (JCfg if jax_side else PCfg)("robot", body_names=("torso_link",))
        cfg.resolve(e.scene)
        mask = jnp.asarray(MASK) if jax_side else torch.as_tensor(MASK)
        fn = getattr(jev if jax_side else pev, name)
        if name == "randomize_pd_gains":
            with pytest.raises(RuntimeError, match="not env-expanded"):
                fn(e, mask, asset_cfg=cfg, **params)
        else:
            fn(e, mask, asset_cfg=cfg, **params)
        d = e.ctx.data if jax_side else e.sim.data
        model = e.ctx.model if jax_side else e.sim.model
        out = {"xfrc": d.xfrc_applied, "forcerange": model.actuator_forcerange,
               "gainprm": model.actuator_gainprm}
        return out if jax_side else {k: v.clone() for k, v in out.items()}
    penv = envs[1]
    xfrc = penv.sim.data.xfrc_applied.clone()
    want, got = _draws_pair(envs, lambda e: run(e, True), lambda e: run(e, False))
    # the shared envs' later tests see the state they saw before
    penv.sim.data = penv.sim.data.replace(xfrc_applied=xfrc)
    _close(want, got, atol=DRAW_ATOL)
    if name == "apply_external_force_torque":
        assert np.abs(tnp(got["xfrc"])).max() > 0


def _command_state(env, jax_side):
    s = env.command_manager.get_term("twist").state
    out = {k: s[k] for k in ("command", "heading_target", "is_heading_env",
                             "is_standing_env", "time_left")}
    out.update({f"metric/{k}": v for k, v in s["metrics"].items()})
    if not jax_side:
        out = {k: v.clone() for k, v in out.items()}
    return out


@pytest.mark.parametrize("what", ["resample", "compute", "reset", "init_velocity"])
def test_velocity_command_matches_jax(envs, what):
    """The command's _resample (with a mask), its per-step compute (metrics,
    the time-based resample, heading control, standing envs) and its reset
    (with the Metrics/ logs); init_velocity samples the root velocity."""
    mask = np.array([True, True, False, True])

    def run(e, jax_side):
        term = e.command_manager.get_term("twist")
        term.cfg.init_velocity_prob = 0.7 if what == "init_velocity" else 0.0
        term.cfg.rel_standing_envs = 0.3
        m = jnp.asarray(mask) if jax_side else torch.as_tensor(mask)
        logs = {}
        if what in ("resample", "init_velocity"):
            if jax_side:
                term.state = term._resample(dict(term.state), m, e.ctx.next_key())
            else:
                term._resample(m)
        elif what == "compute":
            term.compute(e.step_dt)
        else:
            logs = term.reset(m)
        out = _command_state(e, jax_side)
        out.update(logs)
        d = e.ctx.data if jax_side else e.sim.data
        out["qvel"] = d.qvel if jax_side else d.qvel.clone()
        term.cfg.init_velocity_prob = 0.0
        return out
    want, got = _draws_pair(envs, lambda e: run(e, True), lambda e: run(e, False))
    _close(want, got, atol=DRAW_ATOL)


def test_action_terms_match_jax(envs):
    """The action manager's processing (scale, default offset) and the
    position targets written per substep (encoder-bias compensated)."""
    jenv, penv = envs
    act = np.random.default_rng(3).standard_normal((E, 29)).astype(np.float32)
    jam, pam = jenv.action_manager, penv.action_manager
    with jax.enable_x64(True):
        sync_jax_env(jenv, penv)
        jam.process_action(jnp.asarray(act))
        jam.apply_action()
        want = {"processed": np.array(jam.get_term("joint_pos").processed_actions),
                "target": np.array(jenv.ctx.entity_states["robot"].joint_pos_target),
                "prev": np.array(jenv.ctx.action_state.prev_action)}
    pam.process_action(torch.as_tensor(act))
    pam.apply_action()
    got = {"processed": pam.get_term("joint_pos").processed_actions,
           "target": penv.scene["robot"].state.joint_pos_target,
           "prev": pam.prev_action}
    _close(want, got)
    np.testing.assert_array_equal(np.asarray(jam.get_term("joint_pos").scale),
                                  pam.get_term("joint_pos").scale.numpy())


def test_data_sync_roundtrip(envs):
    """The synced JAX context holds the port's Data (the comparisons above
    read the same state)."""
    jenv, penv = envs
    with jax.enable_x64(True):
        sync_jax_env(jenv, penv)
        d = jax_data_from_port(penv.sim.data)
        assert rel_err(jenv.ctx.data.qpos, d.qpos) == 0.0
        assert jenv.ctx.data.qpos.dtype == jnp.float64


def _angles(seed):
    return np.random.default_rng(seed).uniform(-7.0, 7.0, size=(3, 64))


MATH_CASES = {
    "yaw_quat": lambda: (np.random.default_rng(1).normal(size=(64, 4)),),
    "quat_from_euler_xyz": lambda: tuple(_angles(2)),
    "euler_xyz_from_quat": lambda: (np.random.default_rng(3).normal(size=(64, 4)),),
    "wrap_to_pi": lambda: (np.random.default_rng(4).uniform(-20.0, 20.0, size=(256,)),),
}


@pytest.mark.parametrize("fn", list(MATH_CASES))
def test_math_helper_matches_jax(fn):
    """The helpers utils/math.py gained for the terms, float64."""
    from mjlab_tpu.utils import math as jmath
    from mjlab_tpu_torch.utils import math as pmath

    args = MATH_CASES[fn]()
    if fn.endswith("from_quat") or fn == "yaw_quat":
        args = (args[0] / np.linalg.norm(args[0], axis=-1, keepdims=True),)
    with jax.enable_x64(True):
        want = jax.tree_util.tree_map(np.array, getattr(jmath, fn)(*map(jnp.asarray, args)))
    got = getattr(pmath, fn)(*(torch.as_tensor(a) for a in args))
    if isinstance(want, tuple):
        for w, g in zip(want, got):
            np.testing.assert_allclose(tnp(g), w, rtol=0, atol=1e-12)
    else:
        np.testing.assert_allclose(tnp(got), want, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["JointPositionActionCfg", "JointVelocityActionCfg",
                                  "JointEffortActionCfg"])
def test_joint_action_term_matches_jax(envs, kind):
    """Each joint action term on a subset of the actuators, with a scale
    dict and an offset: the processed actions and the target it writes."""
    import mjlab_tpu.envs.mdp.actions as jact
    import mjlab_tpu_torch.envs.mdp.actions as pact

    jenv, penv = envs
    kw = dict(actuator_names=(".*_knee_joint", ".*_elbow_joint", "waist_.*"),
              scale={".*_knee_joint": 0.3, ".*_elbow_joint": 0.7})
    if kind != "JointPositionActionCfg":
        kw["offset"] = 0.1
    target = {"JointPositionActionCfg": "joint_pos_target",
              "JointVelocityActionCfg": "joint_vel_target",
              "JointEffortActionCfg": "joint_effort_target"}[kind]
    act = np.random.default_rng(5).standard_normal((E, 7)).astype(np.float32)
    with jax.enable_x64(True):
        sync_jax_env(jenv, penv)
        jt = getattr(jact, kind)(**kw)
        jt = jt.class_type(jt, jenv)
        jt.process_actions(jnp.asarray(act))
        jt.apply_actions()
        want = {"processed": np.array(jt.processed_actions),
                "target": np.array(getattr(jenv.ctx.entity_states["robot"], target))}
    pt = getattr(pact, kind)(**kw)
    pt = pt.class_type(pt, penv)
    pt.process_actions(torch.as_tensor(act))
    pt.apply_actions()
    got = {"processed": pt.processed_actions,
           "target": getattr(penv.scene["robot"].state, target)}
    _close(want, got)


# -- the terrain curriculum and the terrain event, on a generated terrain --
#
# These two terms read only the terrain, the robot's root position and the
# command, so both packages run them on a small stand-in env (a generated
# terrain of 3 x 4 sub-terrains, 32 envs), the port's with the JAX draws
# played back; levels, types and origins are equal, the mean level within
# 1e-6.


class _Robot:
    def __init__(self, pos):
        self.data = type("D", (), {"root_link_pos_w": pos})()


class _TerrainEnv:
    """The parts of an env the terrain terms read."""

    def __init__(self, terrain, pos, command, rng=None):
        env = self

        class _Scene:
            def __getitem__(self, key):
                return env._robot

            @property
            def env_origins(self):
                return env.scene.terrain.env_origins

        self.scene = _Scene()
        self.scene.terrain = terrain
        self._robot = _Robot(pos)
        self._command = command
        self.command_manager = self
        self.max_episode_length_s = 20.0
        self.rng = rng
        self.ctx = self  # the JAX terms draw env.ctx.next_key()
        self._key = jax.random.PRNGKey(7)

    def get_command(self, name):
        return self._command

    def next_key(self):
        self._key, k = jax.random.split(self._key)
        return k


def _terrain_pair(E=32):
    import mjlab_tpu.terrains as jt_
    import mjlab_tpu_torch.terrains as pt_

    def cfg(pkg):
        subs = {"flat": pkg.BoxFlatTerrainCfg(proportion=0.5),
                "stairs": pkg.BoxPyramidStairsTerrainCfg(
                    proportion=0.5, step_height_range=(0.0, 0.1), step_width=0.3,
                    platform_width=1.0, border_width=0.5)}
        return pkg.TerrainImporterCfg(
            terrain_type="generator", max_init_terrain_level=None,
            terrain_generator=pkg.TerrainGeneratorCfg(
                size=(4.0, 4.0), border_width=2.0, num_rows=3, num_cols=4, seed=3,
                curriculum=True, sub_terrains=subs))

    class _Ctx:
        terrain_state = {}

    ctx = _Ctx()
    jimp = jt_.TerrainImporter(cfg(jt_), E)
    jimp.initialize(E, ctx)
    pimp = pt_.TerrainImporter(cfg(pt_))
    pimp.initialize(E, torch.device("cpu"))
    return jimp, ctx, pimp


def _terrain_inputs(rs, origins, E=32):
    """Root positions at distances from the origins across both thresholds
    (half a sub-terrain, 2 m; half the commanded distance), commands and a
    reset mask."""
    ang = rs.uniform(0, 2 * np.pi, E)
    dist = rs.choice([0.3, 1.5, 2.5, 4.0], E)
    pos = np.array(origins, np.float64)
    pos[:, 0] += dist * np.cos(ang)
    pos[:, 1] += dist * np.sin(ang)
    cmd = np.stack([rs.uniform(-0.3, 0.3, E), rs.uniform(-0.2, 0.2, E), rs.uniform(-1, 1, E)], 1)
    mask = rs.random(E) < 0.7
    return pos.astype(np.float32), cmd.astype(np.float32), mask


def test_terrain_levels_vel_matches_jax():
    """Three rounds of the curriculum on the resetting envs: promotions
    (past the top row to a random level), demotions, envs held; JAX's
    draws played back."""
    from mjlab_tpu.tasks.velocity.mdp import curriculums as jcur
    from mjlab_tpu_torch.tasks.velocity.mdp import curriculums as pcur

    E = 32
    jimp, ctx, pimp = _terrain_pair(E)
    rounds = []
    with JaxDraws() as draws:
        ctx.terrain_state = jimp.init_state(E, jax.random.PRNGKey(0))
        rs = np.random.default_rng(4)
        for _ in range(3):
            pos, cmd, mask = _terrain_inputs(rs, np.asarray(ctx.terrain_state["origins"]))
            env = _TerrainEnv(jimp, jnp.asarray(pos), jnp.asarray(cmd))
            mean = jcur.terrain_levels_vel(env, jnp.asarray(mask), command_name="twist")
            rounds.append((pos, cmd, mask, float(mean),
                           {k: np.asarray(v).copy() for k, v in ctx.terrain_state.items()}))
    rng = ReplayRng(draws)
    pimp.init_state(rng)
    for pos, cmd, mask, mean, state in rounds:
        env = _TerrainEnv(pimp, torch.as_tensor(pos), torch.as_tensor(cmd), rng)
        got = pcur.terrain_levels_vel(env, torch.as_tensor(mask), command_name="twist")
        assert abs(float(got) - mean) < 1e-6
        np.testing.assert_array_equal(state["levels"], pimp.levels.numpy())
        np.testing.assert_array_equal(state["origins"], pimp.origins.numpy())
    assert rng.done()
    moved = [r[4]["levels"] for r in rounds]
    assert any((a != b).any() for a, b in zip(moved, moved[1:]))


def test_randomize_terrain_matches_jax():
    """The play variants' reset event: a random level and type for the
    masked envs, two draws (levels, then types), JAX's played back."""
    from mjlab_tpu.envs.mdp import events as jev
    from mjlab_tpu_torch.envs.mdp import events as pev

    E = 32
    jimp, ctx, pimp = _terrain_pair(E)
    mask = np.arange(E) % 4 != 0
    with JaxDraws() as draws:
        ctx.terrain_state = jimp.init_state(E, jax.random.PRNGKey(1))
        jev.randomize_terrain(_TerrainEnv(jimp, None, None), jnp.asarray(mask))
    rng = ReplayRng(draws)
    pimp.init_state(rng)
    pev.randomize_terrain(_TerrainEnv(pimp, None, None, rng), torch.as_tensor(mask))
    assert rng.done()
    for k in ("levels", "types", "origins"):
        np.testing.assert_array_equal(np.asarray(ctx.terrain_state[k]),
                                      getattr(pimp, k).numpy(), err_msg=k)
    assert (pimp.types.numpy()[mask] != np.arange(E)[mask] * 4 // E).any()


def test_terrain_terms_on_a_plane():
    """On a plane the curriculum returns 0 and the event changes nothing,
    in both packages."""
    from mjlab_tpu.tasks.velocity.mdp import curriculums as jcur
    from mjlab_tpu_torch.tasks.velocity.mdp import curriculums as pcur

    import mjlab_tpu.terrains as jt_
    import mjlab_tpu_torch.terrains as pt_

    jimp = jt_.TerrainImporter(jt_.TerrainImporterCfg(), 4)
    pimp = pt_.TerrainImporter(pt_.TerrainImporterCfg())
    pimp.initialize(4, torch.device("cpu"))
    env = _TerrainEnv(pimp, None, None)
    env.const = lambda v: torch.tensor(v)
    assert float(jcur.terrain_levels_vel(_TerrainEnv(jimp, None, None), None, "twist")) == 0
    assert float(pcur.terrain_levels_vel(env, None, "twist")) == 0
    assert pimp.state_tensors() == []


# ---------------------------------------------------------------------------
# the lift-cube task (Mjlab-Lift-Cube-Yam): its terms, command, curriculum
# and fingertip friction events
# ---------------------------------------------------------------------------

YAM_TASK = "Mjlab-Lift-Cube-Yam"
YAM_OBS_TERMS = ("joint_pos", "joint_vel", "ee_to_cube", "cube_to_goal", "actions")
YAM_REWARD_TERMS = ("lift", "lift_precise", "action_rate_l2", "joint_pos_limits",
                    "joint_vel_hinge")
YAM_FRICTION_EVENTS = ("fingertip_friction_slide", "fingertip_friction_spin",
                       "fingertip_friction_roll")


@pytest.fixture(scope="module")
def yam_envs():
    """The YAM env pair, the port's at float64: reset, 3 steps of N(0, 1)
    actions (joint speeds past the hinge's 0.5 rad/s), then env 1's arm
    lowered into the table (joint2 1.75, joint3 0.8) and one more step,
    whose last substep's contacts the ground sensor reads (env 1 reset
    after it), env 2's cube lifted 0.2 m toward its target and env 3's
    joint1 0.05 past its soft limit (0.9 of the range)."""
    jenv, penv = env_pair(YAM_TASK, E, "float64")
    penv.reset()
    rs = np.random.default_rng(1)
    for _ in range(STEPS):
        penv.step(torch.as_tensor(rs.standard_normal((E, 7)), dtype=torch.float32))
    q = penv.sim.data.qpos.clone()
    q[1, 1], q[1, 2] = 1.75, 0.8
    penv.sim.data = penv.sim.data.replace(qpos=q)
    penv.step(torch.as_tensor(rs.standard_normal((E, 7)), dtype=torch.float32))
    q = penv.sim.data.qpos.clone()
    q[2, 10] += 0.2
    q[3, 0] = penv.scene["robot"].data.soft_joint_pos_limits[0, 0, 1] + 0.05
    penv.sim.data = penv.sim.data.replace(qpos=q)
    penv.sim.refresh()
    yield jenv, penv


@pytest.mark.parametrize("name", YAM_OBS_TERMS)
def test_yam_observation_term_matches_jax(yam_envs, name):
    def call(env):
        c = _cfg_term(env, "observation_manager", "critic", name)
        return c.func(env, **c.params)
    want, got = _both(yam_envs, call, call)
    _close(want, got)
    assert np.abs(want).max() > 1e-3


@pytest.mark.parametrize("name", YAM_REWARD_TERMS)
def test_yam_reward_term_matches_jax(yam_envs, name):
    def call(env):
        c = _cfg_term(env, "reward_manager", None, name)
        return c.func(env, **c.params)
    want, got = _both(yam_envs, call, call)
    _close(want, got)
    assert np.isfinite(want).all()
    # the cube is far from its target
    assert name == "lift_precise" or np.abs(want).max() > 1e-6, want


@pytest.mark.parametrize("name", ["time_out", "ee_ground_collision"])
def test_yam_termination_term_matches_jax(yam_envs, name):
    def call(env):
        c = _cfg_term(env, "termination_manager", None, name)
        return c.func(env, **c.params)
    want, got = _both(yam_envs, call, call)
    np.testing.assert_array_equal(want, tnp(got).astype(bool))
    if name == "ee_ground_collision":
        assert want.tolist() == [False, True, False, False]


@pytest.mark.parametrize("counter", [0, 24000, 24001, 36001])
def test_yam_reward_weight_curriculum_matches_jax(yam_envs, counter):
    """The joint_vel_hinge weight's stages by the global step count (past
    0: -0.01, past 24,000: -0.1, past 36,000: -1.0), written into the
    reward manager in place; the logged value."""
    from mjlab_tpu.tasks.manipulation.mdp import reward_weight as jw
    from mjlab_tpu_torch.tasks.manipulation.mdp import reward_weight as pw

    jenv, penv = yam_envs
    cfg = _cfg_term(penv, "curriculum_manager", None, "joint_vel_hinge_weight")
    mask = np.ones(E, bool)
    penv.common_step_counter.fill_(counter)
    try:
        def run_j(e):
            v = jw(e, jnp.asarray(mask), **cfg.params)
            return {"value": v, "weight": e.ctx.reward_state["weights"]["joint_vel_hinge"]}

        def run_p(e):
            v = pw(e, torch.as_tensor(mask), **cfg.params)
            return {"value": v.clone(),
                    "weight": e.reward_manager.weights["joint_vel_hinge"].clone()}
        want, got = _both(yam_envs, run_j, run_p)
    finally:
        penv.common_step_counter.fill_(STEPS + 1)
        penv.reward_manager.set_weight("joint_vel_hinge", -0.01)
    _close(want, got)
    stage = -0.01 if counter <= 24000 else (-0.1 if counter <= 36000 else -1.0)
    assert float(got["weight"]) == np.float32(stage)


def _lift_state(env, jax_side):
    s = env.command_manager.get_term("lift_height").state
    out = {k: s[k] for k in ("target_pos", "episode_success", "time_left")}
    out.update({f"metric/{k}": v for k, v in s["metrics"].items()})
    d = env.ctx.data if jax_side else env.sim.data
    out.update(qpos=d.qpos, qvel=d.qvel)
    return out if jax_side else {k: v.clone() for k, v in out.items()}


@pytest.mark.parametrize("what", ["resample", "compute", "reset"])
def test_lifting_command_matches_jax(yam_envs, what):
    """The lifting command's _resample on a mask (the target, then the
    cube's position and yaw, written to its free joint at rest), its
    per-step compute (the metrics, the time-based resample of the envs
    whose time ran out: 0 and 2 here) and its reset (with the Metrics/
    logs), with JAX's draws played back."""
    mask = np.array([True, False, True, True])
    jenv, penv = yam_envs
    term = penv.command_manager.get_term("lift_height")
    saved = _lift_state(penv, False)
    term.state["time_left"][0] = 0.01
    term.state["time_left"][2] = 0.01
    term.state["episode_success"][1] = 1.0

    def run(e, jax_side):
        t = e.command_manager.get_term("lift_height")
        m = jnp.asarray(mask) if jax_side else torch.as_tensor(mask)
        logs = {}
        if what == "resample":
            if jax_side:
                t.state = t._resample(dict(t.state), m, e.ctx.next_key())
            else:
                t._resample(m)
        elif what == "compute":
            t.compute(e.step_dt)
        else:
            logs = t.reset(m)
        out = _lift_state(e, jax_side)
        out.update(logs)
        return out
    try:
        want, got = _draws_pair(yam_envs, lambda e: run(e, True), lambda e: run(e, False))
    finally:
        for k in ("target_pos", "episode_success", "time_left"):
            term.state[k].copy_(saved[k])
        penv.sim.data = penv.sim.data.replace(qpos=saved["qpos"], qvel=saved["qvel"])
    _close(want, got, atol=DRAW_ATOL)
    moved = np.abs(want["qpos"][:, 8:15] - tnp(saved["qpos"])[:, 8:15]).max(1) > 0
    assert moved.tolist() == ([True, False, True, True] if what != "compute"
                              else [True, False, True, False])


FRICTION_RANGES = {"fingertip_friction_slide": (0, 0.3, 1.5),
                   "fingertip_friction_spin": (1, 1e-4, 2e-2),
                   "fingertip_friction_roll": (2, 1e-5, 5e-3)}


def _friction_events_f32(yam_envs, names):
    """The startup events ``names`` in order on every env, in the JAX
    env's float32 arithmetic (no x64) and in the port with JAX's draws
    played back: (JAX geom_friction, the port's as float32, the fingertip
    geoms, the defaults)."""
    jenv, penv = yam_envs
    mask = np.ones(E, bool)

    def run(e, jax_side):
        for name in names:
            c = next(c for mode in e.event_manager._modes.values() for n, c in mode
                     if n == name)
            c.func(e, jnp.asarray(mask) if jax_side else torch.as_tensor(mask), **c.params)
        return np.array(e.ctx.model.geom_friction if jax_side
                        else tnp(e.sim.model.geom_friction))

    with JaxDraws() as draws:
        want = run(jenv, True)
    rng = penv.rng
    penv.rng = ReplayRng(draws)
    try:
        got = run(penv, False).astype(np.float32)
        assert penv.rng.done(), "the port drew fewer numbers than JAX"
    finally:
        penv.rng = rng
    assert want.dtype == np.float32 and want.shape == got.shape
    cfg = penv.event_manager._modes["startup"][0][1].params["asset_cfg"]
    geoms = penv.scene["robot"].indexing.geom_ids[cfg.geom_ids].numpy()
    default = penv.sim.get_default_field("geom_friction").numpy().astype(np.float32)
    return want, got, geoms, default


@pytest.mark.parametrize("name", YAM_FRICTION_EVENTS)
def test_yam_friction_event_matches_jax_float32(yam_envs, name):
    """Each fingertip friction event alone: slide uniform in [0.3, 1.5) on
    axis 0, spin and roll log_uniform in [1e-4, 2e-2) and [1e-5, 5e-3) on
    axes 1 and 2, on the 12 fingertip geoms of every env, everything else
    at its default. Within one float32 ulp of JAX's: the log_uniform's exp
    rounds differently in XLA and torch in about a tenth of the entries
    (the logs and their difference are float32 in both)."""
    want, got, geoms, default = _friction_events_f32(yam_envs, (name,))
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    axis, lo, hi = FRICTION_RANGES[name]
    assert len(geoms) == 12
    v = got[:, geoms, axis]
    assert lo <= v.min() and v.max() <= hi and np.unique(v).size == v.size
    rest = got.copy()
    rest[:, geoms, axis] = default[geoms, axis]
    np.testing.assert_array_equal(rest, np.broadcast_to(default, got.shape))


def test_yam_friction_events_in_order_keep_the_last_axis(yam_envs):
    """The three events in the task's order, as the JAX package applies
    them: each writes its axis and puts the field's other axes back at
    their defaults, so after the three only the roll axis (the last
    event's) is drawn per env; slide and spin read their defaults. The
    port keeps this (ROADMAP queue 3)."""
    want, got, geoms, default = _friction_events_f32(yam_envs, YAM_FRICTION_EVENTS)
    np.testing.assert_array_max_ulp(got, want, maxulp=1)
    np.testing.assert_array_equal(got[:, :, :2], np.broadcast_to(default[:, :2], got[:, :, :2].shape))
    assert np.unique(got[:, geoms, 2]).size == E * len(geoms)


# ---------------------------------------------------------------------------
# the G1 motion-tracking task (tasks/tracking/)
# ---------------------------------------------------------------------------

TRACK_TASK = "Mjlab-Tracking-Flat-Unitree-G1"
TRACK_OBS_TERMS = ("command", "motion_anchor_pos_b", "motion_anchor_ori_b", "body_pos",
                   "body_ori", "joint_pos")
TRACK_REWARD_TERMS = ("motion_global_root_pos", "motion_global_root_ori", "motion_body_pos",
                      "motion_body_ori", "motion_body_lin_vel", "motion_body_ang_vel",
                      "action_rate_l2", "joint_limit", "self_collisions")
TRACK_TERMINATION_TERMS = ("time_out", "anchor_pos", "anchor_ori", "ee_body_pos")
TRACK_EE = ("left_ankle_roll_link", "right_wrist_yaw_link")
TRACK_LIBRARY = {
    "bad_anchor_pos": {"threshold": 0.25},
    "bad_motion_body_pos": {"threshold": 0.25, "body_names": TRACK_EE},
    "mpkpe": {},
    "root_relative_mpkpe": {},
    "joint_velocity_error": {},
    "ee_position_error": {"body_names": TRACK_EE},
    "ee_orientation_error": {"body_names": TRACK_EE},
}


@pytest.fixture(scope="module")
def track_envs():
    """The tracking env pair on evidence/tracking_r4/motion.npz, the port's
    at float64: reset, 3 steps of 0.5 N(0, 1) actions; then env 0 lifted
    0.4 m (the anchor's height), env 2 rolled 90 degrees (the anchor's
    orientation), env 3's left arm raised (the end effectors), the
    failure counts' moving average and the encoder bias random, and a
    refresh."""
    import math
    import os

    motion = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                          "evidence", "tracking_r4", "motion.npz")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MJLAB_TPU_MOTION_FILE", motion)
        jenv, penv = env_pair(TRACK_TASK, E, "float64")
    penv.reset()
    rs = np.random.default_rng(2)
    for _ in range(STEPS):
        penv.step(torch.as_tensor(0.5 * rs.standard_normal((E, 29)), dtype=torch.float32))
    q = penv.sim.data.qpos.clone()
    q[0, 2] += 0.4
    a = math.radians(90.0) / 2
    q[2, 3:7] = torch.as_tensor([math.cos(a), math.sin(a), 0.0, 0.0])
    q[3, 22] = -2.8
    penv.sim.data = penv.sim.data.replace(qpos=q)
    penv.sim.refresh()
    cmd = penv.command_manager.get_term("motion")
    cmd.state["bin_failed_count"].copy_(torch.as_tensor(rs.uniform(0, 0.2, cmd.bin_count)))
    penv.scene["robot"].state.encoder_bias.copy_(
        torch.as_tensor(0.01 * rs.standard_normal((E, 29))))
    yield jenv, penv


@pytest.mark.parametrize("name", TRACK_OBS_TERMS)
def test_tracking_observation_term_matches_jax(track_envs, name):
    def call(env):
        group = "policy" if name == "joint_pos" else "critic"
        c = _cfg_term(env, "observation_manager", group, name)
        return c.func(env, **c.params)
    want, got = _both(track_envs, call, call)
    _close(want, got)
    assert np.abs(want).max() > 1e-3


@pytest.mark.parametrize("name", TRACK_REWARD_TERMS)
def test_tracking_reward_term_matches_jax(track_envs, name):
    def call(env):
        c = _cfg_term(env, "reward_manager", None, name)
        return c.func(env, **c.params)
    want, got = _both(track_envs, call, call)
    _close(want, got)
    assert np.isfinite(want).all()


@pytest.mark.parametrize("name", TRACK_TERMINATION_TERMS)
def test_tracking_termination_term_matches_jax(track_envs, name):
    def call(env):
        c = _cfg_term(env, "termination_manager", None, name)
        return c.func(env, **c.params)
    want, got = _both(track_envs, call, call)
    np.testing.assert_array_equal(want, tnp(got).astype(bool))
    fired = {"anchor_pos": 0, "anchor_ori": 2, "ee_body_pos": 3}
    if name in fired:
        assert want[fired[name]], (name, want)


@pytest.mark.parametrize("name", list(TRACK_LIBRARY))
def test_tracking_library_term_matches_jax(track_envs, name):
    """The tracking terms no config uses (bad_anchor_pos,
    bad_motion_body_pos) and the evaluation metrics."""
    import mjlab_tpu.tasks.tracking.mdp as jmdp
    import mjlab_tpu_torch.tasks.tracking.mdp as pmdp

    params = {"command_name": "motion", **TRACK_LIBRARY[name]}
    want, got = _both(track_envs, lambda e: getattr(jmdp, name)(e, **params),
                      lambda e: getattr(pmdp, name)(e, **params))
    if want.dtype == bool:
        np.testing.assert_array_equal(want, tnp(got).astype(bool))
    else:
        _close(want, got)


def _motion_state(env, jax_side):
    s = env.command_manager.get_term("motion").state
    out = {k: s[k] for k in ("time_steps", "body_pos_relative_w", "body_quat_relative_w",
                             "bin_failed_count", "current_bin_failed", "time_left")}
    out.update({f"metric/{k}": v for k, v in s["metrics"].items()})
    d = env.ctx.data if jax_side else env.sim.data
    out.update(qpos=d.qpos, qvel=d.qvel)
    return out if jax_side else {k: v.clone() for k, v in out.items()}


@pytest.mark.parametrize("what", ["resample_adaptive", "resample_uniform", "resample_start",
                                  "compute", "reset"])
def test_motion_command_matches_jax(track_envs, what):
    """The motion command's _resample on a mask in each sampling mode (the
    frames: adaptive with envs 0 and 2 failed, their bins counted, a
    categorical draw per env and a uniform offset; then the robot at the
    drawn frames with pose, velocity and joint noise), its per-step
    compute (the metrics, the frames advanced, env 1 past the motion's
    end resampled, the reference re-expressed around the anchor, the
    failure counts' moving average) and its reset (with the Metrics/
    logs), with JAX's draws played back (the categorical draw's indices
    among them)."""
    mask = np.array([True, False, True, True])
    jenv, penv = track_envs
    term = penv.command_manager.get_term("motion")
    T = term.motion.time_step_total
    saved = _motion_state(penv, False)
    saved_term = penv.termination_manager.terminated.clone()
    mode = term.cfg.sampling_mode
    term.state["time_steps"][1] = T - 1
    penv.termination_manager.terminated.copy_(torch.as_tensor([True, True, True, False]))
    if what.startswith("resample_"):
        term.cfg.sampling_mode = what.split("_")[1]

    def run(e, jax_side):
        t = e.command_manager.get_term("motion")
        t.cfg.sampling_mode = term.cfg.sampling_mode
        m = jnp.asarray(mask) if jax_side else torch.as_tensor(mask)
        logs = {}
        if what.startswith("resample"):
            if jax_side:
                t.state = t._resample(dict(t.state), m, e.ctx.next_key())
            else:
                t._resample(m)
        elif what == "compute":
            t.compute(e.step_dt)
        else:
            logs = t.reset(m)
        out = _motion_state(e, jax_side)
        out.update(logs)
        return out
    try:
        want, got = _draws_pair(track_envs, lambda e: run(e, True), lambda e: run(e, False))
    finally:
        term.cfg.sampling_mode = mode
        jenv.command_manager.get_term("motion").cfg.sampling_mode = mode
        for k in ("time_steps", "body_pos_relative_w", "body_quat_relative_w",
                  "bin_failed_count", "current_bin_failed", "time_left"):
            term.state[k].copy_(saved[k])
        for k, v in term.state["metrics"].items():
            v.copy_(saved[f"metric/{k}"])
        penv.termination_manager.terminated.copy_(saved_term)
        penv.sim.data = penv.sim.data.replace(qpos=saved["qpos"], qvel=saved["qvel"])
    np.testing.assert_array_equal(want.pop("time_steps"), got.pop("time_steps").numpy())
    _close(want, got, atol=DRAW_ATOL)
    # env 1 runs past the motion's end in the update of compute and reset
    moved = np.abs(want["qpos"][:, :7] - tnp(saved["qpos"])[:, :7]).max(1) > 0
    assert moved.tolist() == {"compute": [False, True, False, False],
                              "reset": [True] * 4}.get(what, mask.tolist())
    if what == "resample_adaptive":
        assert want["current_bin_failed"].sum() == 2.0


@pytest.mark.parametrize("joints", ["all", "knees"])
def test_randomize_encoder_bias_matches_jax(track_envs, joints):
    """The per-episode encoder offset on a mask, for every joint and for a
    subset (the others keep theirs), with JAX's draws played back."""
    from mjlab_tpu.envs.mdp.events import randomize_encoder_bias as jev
    from mjlab_tpu.managers.scene_entity_config import SceneEntityCfg as JCfg
    from mjlab_tpu_torch.envs.mdp.events import randomize_encoder_bias as pev
    from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg as PCfg

    jenv, penv = track_envs
    names = (".*",) if joints == "all" else (".*_knee_joint",)
    saved = penv.scene["robot"].state.encoder_bias.clone()

    def run(e, jax_side):
        cfg = (JCfg if jax_side else PCfg)("robot", joint_names=names)
        cfg.resolve(e.scene)
        m = jnp.asarray(MASK) if jax_side else torch.as_tensor(MASK)
        (jev if jax_side else pev)(e, m, bias_range=(-0.01, 0.01), asset_cfg=cfg)
        if jax_side:
            return e.ctx.entity_states["robot"].encoder_bias
        return e.scene["robot"].data.encoder_bias.clone()
    try:
        want, got = _draws_pair(track_envs, lambda e: run(e, True), lambda e: run(e, False))
    finally:
        penv.scene["robot"].state.encoder_bias.copy_(saved)
    _close(want, got, atol=DRAW_ATOL)
    changed = tnp(got) != tnp(saved)
    assert changed.any(1).tolist() == MASK.tolist()
    if joints == "knees":
        assert changed.sum(1).max() == 2


# ---------------------------------------------------------------------------
# the jump and jumping tasks
# ---------------------------------------------------------------------------

JUMP_TASK = "Mjlab-Jump-Flat-Unitree-G1"
JUMPING_TASK = "Mjlab-Jumping-Flat-Unitree-G1"
JUMP_OBS_TERMS = ("height_above_ground", "vertical_velocity", "contact_state", "time_in_air",
                  "command", "foot_height", "foot_contact_forces")
JUMP_REWARD_TERMS = ("explosive_takeoff", "synchronized_extension", "vertical_impulse",
                     "air_time_bonus", "upright_in_flight", "angular_momentum_control",
                     "soft_landing", "symmetric_landing")
JUMP_TERMINATION_TERMS = ("time_out", "fell_over", "height_too_low", "excessive_impact")
JUMPING_OBS_TERMS = ("command", "pelvis_height", "pelvis_vertical_velocity", "foot_contact")
JUMPING_REWARD_TERMS = ("continuous_height", "launch_velocity", "upright", "stable_landing",
                        "soft_landing", "horizontal_drift", "flight_rotation", "foot_slip")
JUMPING_TERMINATION_TERMS = ("time_out", "fell_over", "fell_down")
# the drop that makes a landing: env 1 lifted (m) and falling (m/s)
JUMP_DROP = {JUMP_TASK: (0.18, -3.13), JUMPING_TASK: (0.05, -1.0)}


def _jump_pair(task, seed):
    """The task's env pair, the port's at float64: reset, 3 steps of 0.5
    N(0, 1) actions; then env 1 lifted and falling (JUMP_DROP: it flies,
    then lands within a few steps), env 2's root at rest (the
    landing-balance timer runs), env 3 rolled 75 degrees (past both
    tasks' fell_over limits) and lowered 0.25 m (below the jump task's
    height limit), and a refresh."""
    import math

    jenv, penv = env_pair(task, E, "float64")
    penv.reset()
    rs = np.random.default_rng(seed)
    for _ in range(STEPS):
        penv.step(torch.as_tensor(0.5 * rs.standard_normal((E, 29)), dtype=torch.float32))
    q, v = penv.sim.data.qpos.clone(), penv.sim.data.qvel.clone()
    lift, vz = JUMP_DROP[task]
    q[1, 2] += lift
    v[1, 2] = vz
    v[2, :6] = 0.0
    a = math.radians(75.0) / 2
    q[3, 3:7] = torch.as_tensor([math.cos(a), math.sin(a), 0.0, 0.0])
    q[3, 2] -= 0.25
    penv.sim.data = penv.sim.data.replace(qpos=q, qvel=v)
    penv.sim.refresh()
    return jenv, penv


@pytest.fixture(scope="module")
def jump_envs():
    yield _jump_pair(JUMP_TASK, 3)


@pytest.fixture(scope="module")
def jumping_envs():
    yield _jump_pair(JUMPING_TASK, 4)


def _envs_of(request, task):
    return request.getfixturevalue("jump_envs" if task == JUMP_TASK else "jumping_envs")


@pytest.mark.parametrize("task,name", [(JUMP_TASK, n) for n in JUMP_OBS_TERMS]
                         + [(JUMPING_TASK, n) for n in JUMPING_OBS_TERMS])
def test_jump_observation_term_matches_jax(request, task, name):
    def call(env):
        c = _cfg_term(env, "observation_manager", "critic", name)
        return c.func(env, **c.params)
    want, got = _both(_envs_of(request, task), call, call)
    _close(want, got)


@pytest.mark.parametrize("name", ["pelvis_height_relative", "feet_in_contact",
                                  "both_feet_in_contact"])
def test_jumping_library_observation_matches_jax(jumping_envs, name):
    """The jumping observations no config uses."""
    import mjlab_tpu.tasks.jumping.mdp as jmdp
    import mjlab_tpu_torch.tasks.jumping.mdp as pmdp

    params = {} if name == "pelvis_height_relative" else {"sensor_name": "feet_ground_contact"}
    want, got = _both(jumping_envs, lambda e: getattr(jmdp, name)(e, **params),
                      lambda e: getattr(pmdp, name)(e, **params))
    _close(want, got)


@pytest.mark.parametrize("task,name", [(JUMP_TASK, n) for n in JUMP_REWARD_TERMS]
                         + [(JUMPING_TASK, n) for n in JUMPING_REWARD_TERMS])
def test_jump_reward_term_matches_jax(request, task, name):
    """Each stateless reward term of the two tasks, with its Metrics/ logs."""
    def call(env):
        c = _cfg_term(env, "reward_manager", None, name)
        log = env.extras["log"]
        log.clear()
        value = c.func(env, **c.params)
        return {"value": value, **{k: v for k, v in log.items()}}
    want, got = _both(_envs_of(request, task), call, call)
    assert set(want) == set(got)
    _close(want, got)
    assert np.isfinite(want["value"]).all()


def test_synchronized_extension_is_the_population_variance(jump_envs):
    """jnp.var divides by n: the port's torch.var takes correction=0 (the
    sample variance, n - 1, would be 29/28 of it on the G1's joints)."""
    from mjlab_tpu_torch.tasks.jump.mdp import synchronized_extension

    penv = jump_envs[1]
    jv = penv.scene["robot"].data.joint_vel
    got = synchronized_extension(penv)
    assert (jv.std(1) > 0.1).all() and (jv - jv.mean(1, keepdim=True)).abs().max() > 0.1
    torch.testing.assert_close(got, jv.var(1, correction=1) * 28 / 29, rtol=1e-12, atol=0)
    assert not torch.allclose(got, jv.var(1, correction=1), rtol=1e-3)


@pytest.mark.parametrize("task,name", [(JUMP_TASK, n) for n in JUMP_TERMINATION_TERMS]
                         + [(JUMPING_TASK, n) for n in JUMPING_TERMINATION_TERMS])
def test_jump_termination_term_matches_jax(request, task, name):
    def call(env):
        c = _cfg_term(env, "termination_manager", None, name)
        return c.func(env, **c.params)
    want, got = _both(_envs_of(request, task), call, call)
    np.testing.assert_array_equal(want, tnp(got).astype(bool))
    if name in ("fell_over", "height_too_low"):
        assert want[3], (name, want)


def _term_state(state) -> dict:
    return {k: v.detach().cpu().numpy().copy() for k, v in state.items()}


@pytest.mark.parametrize("task,name", [(JUMP_TASK, "jump_height"),
                                       (JUMP_TASK, "landing_stability"),
                                       (JUMPING_TASK, "jump_height")])
def test_jump_stateful_reward_term_matches_jax(request, task, name):
    """A stateful term (the jump-height tracker, the landing-balance timer,
    the sparse landing reward) over 5 calls, the port env stepping between
    them (its own call of the term undone) and JAX carrying its own state
    from call to call on the synced Data; before the third call a masked
    reset of envs 0 and 2 in both. The values, the logs and the state
    after each call; env 1's landing shows in the flags."""
    envs = _envs_of(request, task)
    jenv, penv = envs
    pcfg = _cfg_term(penv, "reward_manager", None, name)
    jcfg = _cfg_term(jenv, "reward_manager", None, name)
    pterm = pcfg.func
    saved = {k: v.clone() for k, v in pterm.state.items()}
    saved_data = penv.sim.data
    mask = np.array([True, False, True, False])
    rs = np.random.default_rng(6)
    jstate = _term_state(pterm.state)
    seen = []
    try:
        for k in range(5):
            if k:
                keep = {n: v.clone() for n, v in pterm.state.items()}
                penv.step(torch.as_tensor(0.3 * rs.standard_normal((E, 29)),
                                          dtype=torch.float32))
                for n, v in keep.items():
                    pterm.state[n].copy_(v)
                # env 2 at rest again: upright, slow and on the ground
                # (the landing-balance timer runs)
                v = penv.sim.data.qvel.clone()
                v[2] = 0.0
                penv.sim.data = penv.sim.data.replace(qvel=v)
            if k == 2:
                pterm.reset(torch.as_tensor(mask))

            def run_j(e, k=k):
                jcfg.func.state = {n: jnp.asarray(v) for n, v in jstate.items()}
                if k == 2:
                    jcfg.func.reset(jnp.asarray(mask))
                value = jcfg.func(e, **jcfg.params)
                return {"value": value, "log": dict(e.extras["log"]),
                        "state": dict(jcfg.func.state)}

            def run_p(e):
                log = e.extras["log"]
                log.clear()
                value = pterm(e, **pcfg.params)
                return {"value": value.clone(), "log": {n: v.clone() for n, v in log.items()},
                        "state": {n: v.clone() for n, v in pterm.state.items()}}
            want, got = _both(envs, run_j, run_p)
            jstate = want["state"]
            for n in want["state"]:
                if want["state"][n].dtype == bool:
                    np.testing.assert_array_equal(want["state"][n], tnp(got["state"][n]), n)
            _close({"value": want["value"], **want["log"],
                    **{n: v for n, v in want["state"].items() if v.dtype != bool}},
                   {"value": got["value"], **got["log"],
                    **{n: v for n, v in got["state"].items() if v.dtype != bool}})
            seen.append(got["state"])
    finally:
        for n, v in saved.items():
            pterm.state[n].copy_(v)
        penv.sim.data = saved_data
    if task == JUMP_TASK and name == "jump_height":
        # the reset envs restart their peak and initial height at the call
        assert all(bool(s["initialized"].all()) for s in seen)
        torch.testing.assert_close(seen[2]["peak"][mask], seen[2]["initial"][mask])
        assert (seen[1]["peak"][mask] > seen[1]["initial"][mask]).all()
    else:
        # env 1 flies, then lands
        flag = {"jump_height": "was_in_flight", "landing_stability": "was_in_air"}[name]
        f = [bool(s[flag][1]) for s in seen]
        assert True in f and not f[-1], (name, f)
    if name == "landing_stability":
        assert float(seen[-1]["timer"][2]) > 0, seen[-1]["timer"]


@pytest.mark.parametrize("counter", [0, 1, 240_001, 400_000, 900_000])
def test_jump_curricula_match_jax(jump_envs, counter):
    """progressive_jump_height and progressive_stability_requirement by the
    global step count (strictly past each stage's step), written in place
    into the jump command's 0-d target and tolerance and the reward
    weight; the logged values."""
    import mjlab_tpu.tasks.jump.mdp as jmdp
    import mjlab_tpu_torch.tasks.jump.mdp as pmdp

    jenv, penv = jump_envs
    term = penv.command_manager.get_term("jump")
    targets = (term.state["target_height"], term.state["height_tolerance"],
               penv.reward_manager.weights["landing_stability"])
    cfgs = {n: _cfg_term(penv, "curriculum_manager", None, n)
            for n in ("jump_height_progression", "landing_stability_progression")}
    fns = {"jump_height_progression": "progressive_jump_height",
           "landing_stability_progression": "progressive_stability_requirement"}
    mask = np.ones(E, bool)
    saved = [t.clone() for t in targets]
    penv.common_step_counter.fill_(counter)
    try:
        # the config's values, as at the env's first reset
        for t, v in zip(targets, (0.25, 0.05, 4.0)):
            t.fill_(v)

        def run(e, mdp, m):
            out = {n: getattr(mdp, fns[n])(e, m, **c.params) for n, c in cfgs.items()}
            if mdp is jmdp:
                s = e.ctx.command_state["jump"]
                w = e.ctx.reward_state["weights"]["landing_stability"]
                return dict(out, target=s["target_height"], tolerance=s["height_tolerance"],
                            weight=w)
            # the same tensors, written in place
            s = e.command_manager.get_term("jump").state
            assert s["target_height"] is targets[0] and s["height_tolerance"] is targets[1]
            assert e.reward_manager.weights["landing_stability"] is targets[2]
            return {n: v.clone() for n, v in dict(out, target=targets[0], tolerance=targets[1],
                                                   weight=targets[2]).items()}
        want, got = _both(jump_envs, lambda e: run(e, jmdp, jnp.asarray(mask)),
                          lambda e: run(e, pmdp, torch.as_tensor(mask)))
        stage = {0: (0.25, 0.05, 4.0), 1: (0.10, 0.05, 1.0), 240_001: (0.15, 0.05, 1.0),
                 400_000: (0.15, 0.05, 2.5), 900_000: (0.25, 0.08, 4.0)}[counter]
        np.testing.assert_allclose([float(got[k]) for k in ("target", "tolerance", "weight")],
                                   stage, rtol=1e-7)
    finally:
        penv.common_step_counter.fill_(STEPS)
        for t, v in zip(targets, saved):
            t.copy_(v)
    _close({k: np.float64(v) for k, v in want.items()}, {k: v for k, v in got.items()})


@pytest.mark.parametrize("counter", [0, 120_001, 360_001, 720_001])
def test_jumping_curriculum_matches_jax(jumping_envs, counter):
    """jump_height_curriculum: the command's 2-element target range by the
    global step count, written in place; the logged upper end."""
    import mjlab_tpu.tasks.jumping.mdp as jmdp
    import mjlab_tpu_torch.tasks.jumping.mdp as pmdp

    jenv, penv = jumping_envs
    rng = penv.command_manager.get_term("jump").state["ranges"]["target_height"]
    params = _cfg_term(penv, "curriculum_manager", None, "jump_height").params
    mask = np.ones(E, bool)
    saved = rng.clone()
    penv.common_step_counter.fill_(counter)
    try:
        rng.copy_(torch.tensor([0.02, 0.05]))

        def run(e, mdp, m):
            v = mdp.jump_height_curriculum(e, m, **params)
            if mdp is jmdp:
                return {"value": v, "range": e.ctx.command_state["jump"]["ranges"]["target_height"]}
            # the same tensor, written in place
            assert e.command_manager.get_term("jump").state["ranges"]["target_height"] is rng
            return {"value": v.clone(), "range": rng.clone()}
        want, got = _both(jumping_envs, lambda e: run(e, jmdp, jnp.asarray(mask)),
                          lambda e: run(e, pmdp, torch.as_tensor(mask)))
        stage = {0: (0.02, 0.05), 120_001: (0.05, 0.10), 360_001: (0.08, 0.15),
                 720_001: (0.10, 0.25)}[counter]
        np.testing.assert_array_equal(tnp(got["range"]), np.float32(stage))
    finally:
        penv.common_step_counter.fill_(STEPS)
        rng.copy_(saved)
    _close(want, got)


def _jump_command_state(env, jax_side):
    s = env.command_manager.get_term("jump").state
    out = {k: v for k, v in s.items() if k not in ("metrics", "ranges")}
    out.update({f"metric/{k}": v for k, v in s["metrics"].items()})
    return out if jax_side else {k: v.clone() for k, v in out.items()}


@pytest.mark.parametrize("task,what", [(t, w) for t in (JUMP_TASK, JUMPING_TASK)
                                       for w in ("resample", "compute", "reset")])
def test_jump_command_matches_jax(request, task, what):
    """Each task's jump command: _resample on a mask (jump: the current
    target, moved to 0.15 as a curriculum would, into the masked envs;
    jumping: one uniform per env in the range, the trigger at 1, the
    flags cleared), its per-step compute (the metrics, the time-based
    resample of env 0, whose time ran out (jumping), the flight and
    landing latches and the trigger's decay) and its reset with the
    Metrics/ logs; JAX's draws played back."""
    envs = _envs_of(request, task)
    jenv, penv = envs
    mask = np.array([True, False, True, True])
    term = penv.command_manager.get_term("jump")
    saved = _jump_command_state(penv, False)
    if task == JUMP_TASK:
        term.state["target_height"].fill_(0.15)
    else:
        term.state["time_left"][0] = 0.01
        term.state["command"][:, 0] = torch.tensor([1.0, 0.5, 1.0, 0.9])
        term.state["was_in_flight"].copy_(torch.tensor([False, True, True, False]))
        term.state["jump_completed"].copy_(torch.tensor([False, False, True, False]))

    def run(e, jax_side):
        t = e.command_manager.get_term("jump")
        m = jnp.asarray(mask) if jax_side else torch.as_tensor(mask)
        logs = {}
        if what == "resample":
            if jax_side:
                t.state = t._resample(dict(t.state), m, e.ctx.next_key())
            else:
                t._resample(m)
        elif what == "compute":
            t.compute(e.step_dt)
        else:
            logs = t.reset(m)
        out = _jump_command_state(e, jax_side)
        out.update(logs)
        return out
    try:
        want, got = _draws_pair(envs, lambda e: run(e, True), lambda e: run(e, False))
    finally:
        s = term.state
        for k, v in saved.items():
            (s["metrics"][k[7:]] if k.startswith("metric/") else s[k]).copy_(v)
    for k in [k for k in want if want[k].dtype == bool]:
        np.testing.assert_array_equal(want.pop(k), tnp(got.pop(k)), k)
    _close(want, got, atol=DRAW_ATOL)
    if task == JUMP_TASK and what != "compute":
        np.testing.assert_allclose(tnp(got["command"])[:, 0], np.where(mask, 0.15, 0.25),
                                   rtol=1e-7)
