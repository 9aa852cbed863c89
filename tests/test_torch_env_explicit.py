"""The G1 flat-velocity env with mixed explicit actuator groups
(mjlab_tpu_torch/tasks/velocity/config/g1/explicit.py: delayed DC legs,
ideal-PD arms and waist, builtin wrists with per-env force range, gains
and biases; the PD-gain, effort-limit, lag and external-wrench events; the
nan_detection termination; the NaN guard) against its JAX twin
(torch_port_common.jax_explicit_env_cfg), 5 control steps at E = 4 on the
CPU, one fixture.

Every draw is the JAX env's: the JAX env records its draws in program
order inside its jitted reset and step (torch_port_common.JitDraws: the
delay buffers' phases at build, their candidate lags and holds at every
physics substep, the reset's lags, gains, effort limits and poses, the
interval events, the commands, the observation noise), and the port
replays them (ReplayRng), at build too. Both reset (every env draws its
gains and effort limits); the external wrench's interval is set to fire in
step 1 in both; env 2's first wrist gain (a per-env model field) is set to
NaN before step 3 in both, so that its accelerations go NaN, the
nan_detection termination ends it in that step and the NaN guards
(buffer_size 3) dump their windows, the JAX env from its host callback and
the port at close(); env 1's qvel is set to NaN before step 1, which the
engines' own bad-state reset absorbs inside the step (no termination). The
JAX env runs a second time from the same start with its joints nudged
(qpos 1e-6, qvel 1e-5): one env-step of this run is ill-conditioned at
float32 in the JAX env itself (env 0's step 3: the nudge moves its qvel
7.6e-3 relative), so the continuous outputs are held, env by env, to the
nearer of the two JAX runs (as the jump env's pair does,
tests/test_torch_env_jump.py), and
test_explicit_env_ill_conditioned_steps_are_few bounds such steps.

Tolerances, those of tests/test_torch_env.py:52 by what each output reads
(VELOCITY_ENV_TOL): qpos 1e-4, qvel 1e-3, the policy 1e-3, the critic
5e-3, the reward 1e-3; ctrl 1e-6 where it is a target passed through (the
builtin wrists) and qvel's 1e-3 where it is a torque the group computes
from qpos and qvel (kp and kd times their errors); non-finite entries must
be the same entries in both; the lags, terminated, truncated and the
episode lengths equal; the per-env gains, effort limits and force ranges
relative 1e-6 (float32 scalings of the same draws); the NaN dumps' bad
envs equal and their windows at qpos's, qvel's and (ctrl) qvel's
tolerance, held to the nearer JAX run too.
"""

import os

import numpy as np
import pytest
import torch

from torch_port_common import (
    VELOCITY_ENV_TOL, JaxDraws, JitDraws, ReplayRng, _nearer, jax_expand_actuator_fields,
    jax_explicit_env_cfg,
)

E = 4
STEPS = 5
NAN_STEP, NAN_ENV = 3, 2  # NaN in the env's first wrist gain
QVEL_NAN_STEP, QVEL_NAN_ENV = 1, 1  # NaN in the env's qvel
WRENCH_STEP = 1
BUFFER = 3
TORQUE_TOL = VELOCITY_ENV_TOL["qvel"]
QPOS_NUDGE, QVEL_NUDGE = 1e-6, 1e-5


def _np(x):
    return np.array(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x, np.float64)


def _actuator_state(states: dict, get) -> dict:
    """The groups' per-env state worth comparing, by name."""
    out = {}
    for i, s in states.items():
        for name, v in get(s).items():
            out[f"{i}.{name}"] = _np(v)
    return out


def _jax_groups(s):
    if hasattr(s, "buffers"):
        return {"lag": s.buffers["position"].lag, "stiffness": s.base.stiffness,
                "effort_limit": s.base.effort_limit}
    if hasattr(s, "stiffness"):
        return {"stiffness": s.stiffness, "damping": s.damping, "effort_limit": s.effort_limit}
    return {}


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    import mjlab_tpu_torch.envs.manager_based_rl_env as penv_mod
    from mjlab_tpu.envs import ManagerBasedRlEnv as JaxEnv
    from mjlab_tpu.utils.buffers import circular_buffer_window
    from mjlab_tpu_torch.tasks.velocity.config.g1 import explicit as X

    jdir = str(tmp_path_factory.mktemp("jax_nan"))
    pdir = str(tmp_path_factory.mktemp("port_nan"))
    os.environ.setdefault("MJLAB_QUIET", "1")
    rs = np.random.default_rng(0)
    acts = [(0.3 * rs.standard_normal((E, 29))).astype(np.float32) for _ in range(STEPS)]
    out = {"jax": [], "port": []}
    with pytest.MonkeyPatch.context() as mp, JitDraws() as rec:
        mp.setenv("MJLAB_TPU_ENGINE", "hybrid")
        jcfg = jax_explicit_env_cfg(E, buffer_size=BUFFER)
        jcfg.sim.nan_guard.output_dir = jdir
        jenv = JaxEnv(jcfg)
        init = rec.take()
        # the port env built on the JAX build's draws
        mp.setattr(penv_mod, "Rng", lambda seed, device: ReplayRng(init))
        pcfg = X.g1_explicit_env_cfg()
        pcfg.sim.nan_guard.buffer_size = BUFFER
        penv = X.make_g1_explicit_env(E, device="cpu", capture=False, nan_dir=pdir, cfg=pcfg)
        assert penv.rng.done()
        jax_expand_actuator_fields(jenv)
        jenv.reset()
        penv.rng = ReplayRng(rec.take())
        penv.reset()
        assert penv.rng.done()
        robot = penv.scene["robot"]
        out["reset"] = {
            "jax": _actuator_state(jenv._state.entity_states["robot"].actuator_states,
                                   _jax_groups),
            "port": _actuator_state(robot.state.actuator_states, _jax_groups),
            "jax_model": {f: _np(getattr(jenv._state.model, f)) for f in X.EXPANDED_FIELDS},
            "port_model": {f: _np(getattr(penv.sim.model, f)) for f in X.EXPANDED_FIELDS},
        }
        # the external wrench fires in step WRENCH_STEP in both envs
        left = 0.02 * (WRENCH_STEP + 0.5)
        st = jenv._state
        ev = dict(st.event_state)
        ev["interval_left"] = dict(ev["interval_left"], external_wrench=jnp.full((E,), left))
        jenv._state = st.replace(event_state=ev)
        penv.event_manager.interval_left["external_wrench"].fill_(left)
        start = jax.tree.map(np.array, jenv._state)  # a step donates its input

        wrist = int(robot.actuators[3].ctrl_ids[0])

        def jax_step(t, act):
            st = jenv._state
            if t == NAN_STEP:
                gain = st.model.actuator_gainprm.at[NAN_ENV, wrist, 0].set(jnp.nan)
                jenv._state = st.replace(model=st.model.replace(actuator_gainprm=gain))
            if t == QVEL_NAN_STEP:
                jenv._state = st.replace(data=st.data.replace(
                    qvel=st.data.qvel.at[QVEL_NAN_ENV].set(jnp.nan)))
            jo, jr, jterm, jtrunc, _ = jenv.step(jnp.asarray(act))
            js = jenv._state
            return dict(
                policy=_np(jo["policy"]), critic=_np(jo["critic"]), reward=_np(jr),
                terminated=np.asarray(jterm), truncated=np.asarray(jtrunc),
                episode_length=np.asarray(js.episode_length), qpos=_np(js.data.qpos),
                qvel=_np(js.data.qvel), ctrl=_np(js.data.ctrl),
                xfrc=_np(js.data.xfrc_applied),
                groups=_actuator_state(js.entity_states["robot"].actuator_states, _jax_groups),
                model={f: _np(getattr(js.model, f)) for f in X.EXPANDED_FIELDS},
                window={k: np.asarray(circular_buffer_window(b))
                        for k, b in js.sensor_states["_nan_guard"].items()})

        for t, act in enumerate(acts):
            out["jax"].append(jax_step(t, act))
            if t == NAN_STEP:
                penv.sim.model.actuator_gainprm[NAN_ENV, wrist, 0] = float("nan")
            if t == QVEL_NAN_STEP:
                qvel = penv.sim.data.qvel.clone()
                qvel[QVEL_NAN_ENV] = float("nan")
                penv.sim.data = penv.sim.data.replace(qvel=qvel)
            penv.rng = ReplayRng(rec.take())
            po, pr, pterm, ptrunc, _ = penv.step(torch.as_tensor(act))
            assert penv.rng.done(), f"step {t}: the port drew less than the JAX env"
            out["port"].append(dict(
                policy=_np(po["policy"]), critic=_np(po["critic"]), reward=_np(pr),
                terminated=pterm.numpy().copy(), truncated=ptrunc.numpy().copy(),
                episode_length=penv.episode_length_buf.numpy().copy(),
                qpos=_np(penv.sim.data.qpos), qvel=_np(penv.sim.data.qvel),
                ctrl=_np(penv.sim.data.ctrl), xfrc=_np(penv.sim.data.xfrc_applied),
                groups=_actuator_state(robot.state.actuator_states, _jax_groups),
                model={f: _np(getattr(penv.sim.model, f)) for f in X.EXPANDED_FIELDS}))
        # the JAX env again from the same start, its joints nudged (the
        # reference's own spread where a step is ill-conditioned)
        st = jax.tree.map(jnp.asarray, start)
        d = st.data
        jenv._state = st.replace(data=d.replace(qpos=d.qpos.at[:, 7:].add(QPOS_NUDGE),
                                                qvel=d.qvel.at[:, 6:].add(QVEL_NUDGE)))
        out["jax_nudged"] = [jax_step(t, act) for t, act in enumerate(acts)]
        rec.take()
        jax.effects_barrier()
    jdumps = sorted(f for f in os.listdir(jdir) if f.startswith("nan_dump"))
    assert not [f for f in os.listdir(pdir) if f.startswith("nan_dump")]  # not before close()
    penv.close()
    penv.close()  # written once
    pdumps = sorted(f for f in os.listdir(pdir) if f.startswith("nan_dump"))
    out["dumps"] = (jdir, jdumps, pdir, pdumps)
    out["passthrough"] = torch.cat([a.ctrl_ids for a in robot.actuators
                                    if a.is_passthrough]).numpy()
    out["envs"] = (jenv, penv)
    return out


def _ref(run, step, get):
    """The JAX value ``get(out)`` of the step, env by env the nearer (to
    the port's) of the JAX run and the nudged one."""
    got = get(run["port"][step])
    return _nearer(get(run["jax"][step]), get(run["jax_nudged"][step]), got), got


def _held(want, got, tol, what):
    """Non-finite entries the same, the finite ones within tol relative to
    max(1, |JAX|max)."""
    assert want.shape == got.shape, what
    bad = ~np.isfinite(want)
    np.testing.assert_array_equal(bad, ~np.isfinite(got), err_msg=f"{what}: non-finite entries")
    if (~bad).any():
        w, g = want[~bad], got[~bad]
        err = np.abs(w - g).max() / max(1.0, np.abs(w).max())
        assert err < tol, f"{what}: rel err {err:.3e} >= {tol:.0e}"


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "policy", "critic", "reward"])
def test_explicit_env_step_matches_jax(run, what, step):
    _held(*_ref(run, step, lambda o: o[what]), VELOCITY_ENV_TOL[what], what)


@pytest.mark.parametrize("step", range(STEPS))
def test_explicit_env_ctrl_matches_jax(run, step):
    """ctrl: the builtin wrists' targets at 1e-6, the torques of the PD
    and delayed DC groups at qvel's tolerance."""
    want, got = _ref(run, step, lambda o: o["ctrl"])
    through = np.zeros(want.shape[1], bool)
    through[run["passthrough"]] = True
    _held(want[:, through], got[:, through], VELOCITY_ENV_TOL["ctrl"], "ctrl targets")
    _held(want[:, ~through], got[:, ~through], TORQUE_TOL, "ctrl torques")


@pytest.mark.parametrize("step", range(STEPS))
def test_explicit_env_dones_lags_and_wrench_match_jax(run, step):
    """terminated, truncated, the episode lengths and every delayed
    group's lags equal; the external wrench on the torso equal (written in
    step WRENCH_STEP, held after)."""
    j, p = run["jax"][step], run["port"][step]
    for k in ("terminated", "truncated", "episode_length"):
        np.testing.assert_array_equal(j[k], p[k], err_msg=k)
    for k in j["groups"]:
        if k.endswith("lag"):
            np.testing.assert_array_equal(j["groups"][k], p["groups"][k], err_msg=k)
    _held(j["xfrc"], p["xfrc"], 1e-6, "xfrc_applied")
    assert (np.abs(p["xfrc"]).max() > 0) == (step >= WRENCH_STEP)


@pytest.mark.parametrize("step", range(STEPS))
def test_explicit_env_per_env_fields_match_jax(run, step):
    """The PD groups' gains and effort limits and the per-env force range,
    gain and bias (the reset draws; the NaN env's reset redraws its own)."""
    j, p = run["jax"][step], run["port"][step]
    for k in j["groups"]:
        if not k.endswith("lag"):
            _held(j["groups"][k], p["groups"][k], 1e-6, k)
    for f in j["model"]:
        _held(j["model"][f], p["model"][f], 1e-6, f)


def test_explicit_env_reset_draws_gains_and_limits(run):
    """The reset drew per-env PD gains and effort limits in both packages
    (the values differ between envs), the builtin wrists' gain, bias and
    force range per env, and the delayed groups' force range (the JAX
    effort-limit event's builtin branch takes every group that is not an
    ideal PD)."""
    r = run["reset"]
    assert set(r["jax"]) == set(r["port"])
    for k in r["jax"]:
        if k.endswith("lag"):
            np.testing.assert_array_equal(r["jax"][k], r["port"][k], err_msg=k)
        else:
            _held(r["jax"][k], r["port"][k], 1e-6, k)
    assert np.ptp(r["port"]["0.stiffness"], axis=0).min() > 0
    for f in r["jax_model"]:
        _held(r["jax_model"][f], r["port_model"][f], 1e-6, f)
    fr = r["port_model"]["actuator_forcerange"]
    assert np.ptp(fr[:, :, 1], axis=0).max() > 0


def test_explicit_env_ill_conditioned_steps_are_few(run):
    """The steps the nudge moves past qvel's tolerance (the JAX env's own
    float32 spread: a 1e-6 nudge of the joints' qpos and 1e-5 of their
    qvel at the start) are at most 2 of the 20 env-steps; every other
    env-step of the JAX run and the nudged one agree, and the dones and
    lags of the two runs are equal."""
    tol = VELOCITY_ENV_TOL["qvel"]
    far = []
    for t, (a, b) in enumerate(zip(run["jax"], run["jax_nudged"])):
        fin = np.isfinite(a["qvel"]) & np.isfinite(b["qvel"])
        d = np.where(fin, np.abs(a["qvel"] - b["qvel"]), 0).max(1)
        far += [(t, e) for e in np.flatnonzero(d / max(1.0, np.abs(a["qvel"][fin]).max()) >= tol)]
        for k in ("terminated", "truncated", "episode_length"):
            np.testing.assert_array_equal(a[k], b[k])
    assert len(far) <= 2, far


def test_explicit_env_nan_terminates_the_env(run):
    """A NaN in env 2's wrist gain makes its accelerations NaN: the
    nan_detection termination ends env 2 alone in that step (the dones
    equal the JAX env's: test_explicit_env_dones_lags_and_wrench_match_jax)
    and its reset's PD-gain event draws the gain anew, so the next step is
    finite. A NaN in env 1's qvel never reaches the termination: both
    engines restart a diverged world at qpos0 with zero velocity inside
    the step (mj_checkPos/Vel/Acc), so env 1 runs on, not terminated."""
    p = run["port"][NAN_STEP]
    assert p["terminated"].tolist() == [e == NAN_ENV for e in range(E)]
    assert np.isfinite(p["policy"]).all() and np.isfinite(p["qpos"]).all()
    nxt = run["port"][NAN_STEP + 1]
    assert np.isfinite(nxt["reward"]).all() and not nxt["terminated"].any()
    assert np.isfinite(nxt["model"]["actuator_gainprm"]).all()
    q = run["port"][QVEL_NAN_STEP]
    assert not q["terminated"].any() and np.isfinite(q["qvel"]).all()


def test_explicit_env_nan_dump_matches_jax(run):
    """One dump each; the port's npz holds the JAX dump's arrays: bad_envs
    equal ([2]: the qvel NaN of env 1 never left its step), the qpos,
    qvel and ctrl windows (E, buffer_size, n) of the detection step
    (qpos at 1e-4, qvel at 1e-3, ctrl by what it reads), the
    non-finite entries the same; latest.npz names it and the Model
    beside it loads."""
    from mjlab_tpu_torch.phys.model import load_model

    jdir, jdumps, pdir, pdumps = run["dumps"]
    jn = [f for f in jdumps if f.endswith(".npz")]
    pn = [f for f in pdumps if f.endswith(".npz") and not f.endswith("_model.npz")]
    assert len(jn) == 1 and len(pn) == 1
    with np.load(os.path.join(jdir, jn[0])) as a, np.load(os.path.join(pdir, pn[0])) as b:
        assert set(a.files) == set(b.files) == {"bad_envs", "qpos", "qvel", "ctrl"}
        np.testing.assert_array_equal(a["bad_envs"], b["bad_envs"])
        assert b["bad_envs"].tolist() == [NAN_ENV]
        for k, tol in (("qpos", 1e-4), ("qvel", 1e-3), ("ctrl", TORQUE_TOL)):
            assert a[k].shape == b[k].shape == (E, BUFFER, a[k].shape[2])
            # the JAX dump is the JAX run's window of the detection step;
            # the port's is held env by env to the nearer JAX run's
            np.testing.assert_array_equal(a[k], run["jax"][NAN_STEP]["window"][k])
            want = _nearer(a[k], run["jax_nudged"][NAN_STEP]["window"][k], b[k])
            _held(want, b[k], tol, k)
    assert os.path.realpath(os.path.join(pdir, "latest.npz")) == os.path.join(pdir, pn[0])
    load_model(os.path.join(pdir, pn[0][:-4] + "_model.npz"), device="cpu")


EVENT_MASK = np.array([True, False, True, True])


@pytest.mark.parametrize("name", ["apply_external_force_torque", "randomize_pd_gains",
                                  "randomize_effort_limits", "sync_actuator_delays"])
def test_actuator_event_matches_jax(run, name):
    """Each of the four terms on the explicit groups, called on both envs
    after the run with a mask, the JAX draws played back: the torso wrench
    (xfrc_applied); the PD groups' gains and the wrists' per-env gain and
    bias (the delayed groups keep theirs: the JAX term takes ideal PD
    groups only); the PD groups' effort limits and, for every other group,
    the per-env force range; the delayed groups' lag range (1, 2)."""
    from mjlab_tpu.envs.mdp import events as jev
    from mjlab_tpu.managers.scene_entity_config import SceneEntityCfg as JCfg
    from mjlab_tpu_torch.envs.mdp import events as pev
    from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg as PCfg
    from mjlab_tpu_torch.tasks.velocity.config.g1 import explicit as X

    jenv, penv = run["envs"]
    params = {"apply_external_force_torque": X.WRENCH_PARAMS,
              "randomize_pd_gains": X.PD_GAIN_PARAMS,
              "randomize_effort_limits": X.EFFORT_PARAMS,
              "sync_actuator_delays": dict(min_lag=1, max_lag=2)}[name]

    def state(e, jax_side):
        groups = (e.ctx.entity_states if jax_side else
                  {"robot": e.scene["robot"].state}).get("robot").actuator_states
        out = {}
        for i, g in groups.items():
            if hasattr(g, "buffers"):
                b = g.buffers["position"]
                out[f"{i}.lags"] = [np.broadcast_to(_np(b.min_lag), (E,)),
                                    np.broadcast_to(_np(b.max_lag), (E,))]
                g = g.base
            if hasattr(g, "stiffness"):
                out[f"{i}.pd"] = [_np(g.stiffness), _np(g.damping), _np(g.effort_limit)]
        model = e.ctx.model if jax_side else e.sim.model
        data = e.ctx.data if jax_side else e.sim.data
        for f in X.EXPANDED_FIELDS:
            out[f] = _np(getattr(model, f))
        out["xfrc"] = _np(data.xfrc_applied)
        return out

    before = state(penv, False)
    jcfg, pcfg = JCfg("robot", body_names=(X.WRENCH_BODY,)), PCfg("robot",
                                                                  body_names=(X.WRENCH_BODY,))
    jcfg.resolve(jenv.scene)
    pcfg.resolve(penv.scene)
    with JaxDraws() as draws:
        getattr(jev, name)(jenv, jnp_mask(), asset_cfg=jcfg, **params)
    penv.rng = ReplayRng(draws)
    getattr(pev, name)(penv, torch.as_tensor(EVENT_MASK), asset_cfg=pcfg, **params)
    assert penv.rng.done()
    want, got = state(jenv, True), state(penv, False)
    assert set(want) == set(got)
    changed = []
    for k in want:
        for a, b, c in zip(np.atleast_2d(want[k]) if k.endswith("lags") else [want[k]],
                           np.atleast_2d(got[k]) if k.endswith("lags") else [got[k]],
                           np.atleast_2d(before[k]) if k.endswith("lags") else [before[k]]):
            if k.endswith(".pd") or k.endswith("lags"):
                for x, y, z in zip(a, b, c):
                    _held(np.asarray(x, np.float64), np.asarray(y, np.float64), 1e-6, k)
                    changed.append((k, not np.array_equal(np.asarray(y), np.asarray(z))))
            else:
                _held(a, b, 1e-6, k)
                changed.append((k, not np.array_equal(b, c)))
    moved = {k for k, c in changed if c}
    expect = {"apply_external_force_torque": {"xfrc"},
              "randomize_pd_gains": {"0.pd", "4.pd", "actuator_gainprm", "actuator_biasprm"},
              "randomize_effort_limits": {"0.pd", "4.pd", "actuator_forcerange"},
              "sync_actuator_delays": {"1.lags", "2.lags", "5.lags"}}[name]
    assert moved == expect, moved


def jnp_mask():
    import jax.numpy as jnp

    return jnp.asarray(EVENT_MASK)
