"""The port's MDP terms and the G1 velocity task's terms, command and
curriculum (mjlab_tpu_torch/envs/mdp/, tasks/velocity/mdp/) against the
JAX package's on one float64 state of the G1 flat-velocity env.

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
    JaxDraws, ReplayRng, g1_env_pair, jax_data_from_port, rel_err, sync_jax_env, tnp,
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
    jenv, penv = g1_env_pair(E, "float64")
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


@pytest.mark.parametrize("name", ["apply_external_force_torque", "randomize_pd_gains",
                                  "randomize_effort_limits", "randomize_encoder_bias",
                                  "sync_actuator_delays", "randomize_terrain"])
def test_unported_event_raises_naming_itself(envs, name):
    from mjlab_tpu_torch.envs.mdp import events

    with pytest.raises(NotImplementedError, match=name):
        getattr(events, name)(envs[1], torch.ones(E, dtype=torch.bool))


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
