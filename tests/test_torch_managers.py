"""The port's managers (mjlab_tpu_torch/managers/) against the JAX
package's on stub envs whose terms return given per-env values, so that
each manager's own logic is what is compared:

- the observation pipeline (noise, clip, scale, delay, history, group
  concatenation and the additive bias's reset), several steps with a
  masked reset between, the port drawing the JAX package's numbers played
  back (torch_port_common.ReplayRng): equal to 1e-6 relative;
- the reward manager (weights times dt, non-finite values scrubbed, the
  episode sums and their time-normalised reset logs) and the termination
  manager (terminated and truncated, the episode counts and their logs):
  equal to 1e-6 relative;
- the event manager's interval timers (per env and global) and the
  min-step gate of reset events, in the form of
  tests/test_event_intervals.py: the same firing masks at every step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.managers import manager_term_config as jcfgs
from mjlab_tpu.managers.event_manager import EventManager as JEventManager
from mjlab_tpu.managers.observation_manager import ObservationManager as JObsManager
from mjlab_tpu.managers.reward_manager import RewardManager as JRewardManager
from mjlab_tpu.managers.termination_manager import TerminationManager as JTermManager
from mjlab_tpu.utils import noise as jn
from mjlab_tpu_torch.managers import manager_term_config as pcfgs
from mjlab_tpu_torch.managers.event_manager import EventManager as PEventManager
from mjlab_tpu_torch.managers.observation_manager import ObservationManager as PObsManager
from mjlab_tpu_torch.managers.reward_manager import RewardManager as PRewardManager
from mjlab_tpu_torch.managers.termination_manager import TerminationManager as PTermManager
from mjlab_tpu_torch.utils import noise as pn

from torch_port_common import JaxDraws, ReplayRng, rel_err, tnp

E = 6
TOL = 1e-6


class _JCtx:
    def __init__(self, seed=0):
        self.rng = jax.random.PRNGKey(seed)
        self.obs_state, self.reward_state, self.termination_state = {}, {}, {}
        self.event_state, self.extras_log = {}, {}

    def next_key(self):
        self.rng, k = jax.random.split(self.rng)
        return k


class _JEnv:
    """What the JAX managers read of an env; ``value[name]`` is the term
    ``name``'s output this step."""

    def __init__(self):
        self.num_envs, self.device, self.scene = E, None, None
        self.ctx = _JCtx()
        self.value = {}
        self.common_step_counter = 0
        self.max_episode_length_s = 4.0


class _PEnv:
    def __init__(self, rng):
        self.num_envs, self.device, self.scene = E, torch.device("cpu"), None
        self.rng = rng
        self.value = {}
        self.common_step_counter = 0
        self.max_episode_length_s = 4.0

    def const(self, value, dtype=torch.float32):
        return torch.as_tensor(np.asarray(value)).to(dtype)


def _term(name, jax_side):
    if jax_side:
        return lambda env, **kw: jnp.asarray(env.value[name])
    return lambda env, **kw: torch.as_tensor(env.value[name])


def _values(t, shapes, seed=0):
    rs = np.random.default_rng(100 * seed + t)
    return {n: (3.0 * rs.standard_normal((E,) + s)).astype(np.float32)
            for n, s in shapes.items()}


# each case: group kwargs, {term: (shape, term kwargs)}
def _u(**kw):
    return (jn.UniformNoiseCfg(**kw), pn.UniformNoiseCfg(**kw))


def _g(**kw):
    return (jn.GaussianNoiseCfg(**kw), pn.GaussianNoiseCfg(**kw))


def _bias():
    return (jn.NoiseModelWithAdditiveBiasCfg(noise_cfg=jn.UniformNoiseCfg(n_min=-0.1, n_max=0.1),
                                             bias_noise_cfg=jn.GaussianNoiseCfg(std=0.3)),
            pn.NoiseModelWithAdditiveBiasCfg(noise_cfg=pn.UniformNoiseCfg(n_min=-0.1, n_max=0.1),
                                             bias_noise_cfg=pn.GaussianNoiseCfg(std=0.3)))


OBS_CASES = {
    "noise_clip_scale": (dict(enable_corruption=True), {
        "a": ((3,), dict(noise=_u(n_min=-0.5, n_max=0.5), clip=(-2.0, 2.0), scale=0.5)),
        "b": ((2,), dict(noise=_g(std=0.2, operation="scale"), scale=(1.0, -2.0))),
        "c": ((4,), dict(noise=_bias())),
    }),
    "corruption_off": (dict(enable_corruption=False), {
        "a": ((3,), dict(noise=_u(n_min=-0.5, n_max=0.5), clip=(-1.0, 1.0))),
    }),
    "delay": (dict(), {
        "a": ((2,), dict(delay_min_lag=1, delay_max_lag=3)),
        "b": ((1,), dict(delay_min_lag=0, delay_max_lag=4, delay_update_period=3,
                         delay_hold_prob=0.3)),
    }),
    "term_history": (dict(), {
        "a": ((2,), dict(history_length=3)),
        "b": ((3,), dict()),
    }),
    "group_history": (dict(history_length=2), {
        "a": ((2,), dict(history_length=5)),
        "b": ((1,), dict(delay_max_lag=2, delay_min_lag=2)),
    }),
    "history_not_flattened": (dict(history_length=3, flatten_history_dim=False,
                                   concatenate_dim=-1), {
        "a": ((2,), dict()),
        "b": ((2,), dict()),
    }),
    "not_concatenated": (dict(concatenate_terms=False, enable_corruption=True), {
        "a": ((2,), dict(noise=_u(n_min=-1.0, n_max=1.0), history_length=2)),
        "b": ((3,), dict(clip=(0.0, 1.0))),
    }),
}


def _obs_cfg(case, jax_side):
    gkw, terms = OBS_CASES[case]
    mod = jcfgs if jax_side else pcfgs
    tcfgs = {}
    for name, (_, kw) in terms.items():
        kw = dict(kw)
        if "noise" in kw:
            kw["noise"] = kw["noise"][0 if jax_side else 1]
        tcfgs[name] = mod.ObservationTermCfg(func=_term(name, jax_side), **kw)
    return {"g": mod.ObservationGroupCfg(terms=tcfgs, **gkw)}


@pytest.mark.parametrize("case", list(OBS_CASES))
def test_observation_pipeline_matches_jax(case):
    shapes = {n: s for n, (s, _) in OBS_CASES[case][1].items()}
    mask = np.arange(E) % 2 == 0
    jenv = _JEnv()
    jenv.value = _values(0, shapes)
    outs = []
    with JaxDraws() as draws:
        jm = JObsManager(_obs_cfg(case, True), jenv)
        jenv.ctx.obs_state = jm.init_state(E, jax.random.PRNGKey(1))
        for t in range(6):
            jenv.value = _values(t, shapes)
            if t == 3:
                jm.reset(jnp.asarray(mask))
            outs.append(jax.tree_util.tree_map(np.asarray, jm.compute(update_history=True)))
    penv = _PEnv(ReplayRng(draws))
    penv.value = _values(0, shapes)
    pm = PObsManager(_obs_cfg(case, False), penv)
    pm.init_state(E)
    assert pm.group_obs_dim("g") == jm.group_obs_dim("g")
    for t in range(6):
        penv.value = _values(t, shapes)
        if t == 3:
            pm.reset(torch.as_tensor(mask))
        got = pm.compute(update_history=True)
        want = outs[t]
        if isinstance(want["g"], dict):
            for name in want["g"]:
                assert rel_err(want["g"][name], tnp(got["g"][name])) < TOL, (t, name)
        else:
            assert want["g"].shape == tuple(got["g"].shape)
            assert rel_err(want["g"], tnp(got["g"])) < TOL, t
    assert penv.rng.done()


REWARDS = {"a": 2.0, "b": -0.5, "zero": 0.0, "bad": 1.0}


def _reward_cfg(jax_side):
    mod = jcfgs if jax_side else pcfgs
    return {n: mod.RewardTermCfg(func=_term(n, jax_side), weight=w) for n, w in REWARDS.items()}


def _reward_values(t):
    v = _values(t, {n: () for n in REWARDS})
    v["bad"][0], v["bad"][1], v["bad"][2] = np.nan, np.inf, 1e9  # scrubbed, clamped
    return v


def test_reward_manager_matches_jax():
    dt = 0.02
    mask = np.array([True, False, True, False, False, True])
    jenv, penv = _JEnv(), _PEnv(None)
    jm, pm = JRewardManager(_reward_cfg(True), jenv), PRewardManager(_reward_cfg(False), penv)
    jenv.ctx.reward_state = jm.init_state(E)
    pm.init_state(E)
    for t in range(4):
        jenv.value = penv.value = _reward_values(t)
        want = np.asarray(jm.compute(dt))
        got = pm.compute(dt)
        assert rel_err(want, tnp(got)) < TOL, t
        for n in REWARDS:
            assert rel_err(jenv.ctx.reward_step_values[n], tnp(pm.step_values[n])) < TOL
        if t == 2:
            jlogs, plogs = jm.reset(jnp.asarray(mask)), pm.reset(torch.as_tensor(mask))
            assert set(jlogs) == set(plogs)
            for k in jlogs:
                assert rel_err(jlogs[k], tnp(plogs[k])) < TOL, k
    for n in REWARDS:
        sums = jenv.ctx.reward_state["episode_sums"][n]
        assert rel_err(sums, tnp(pm.episode_sums[n])) < TOL, n


def test_termination_manager_matches_jax():
    names = {"time_out": True, "fell": False, "other": False}
    mask = np.array([True, True, False, False, True, False])

    def cfg(jax_side):
        mod = jcfgs if jax_side else pcfgs
        return {n: mod.TerminationTermCfg(func=_term(n, jax_side), time_out=to)
                for n, to in names.items()}

    jenv, penv = _JEnv(), _PEnv(None)
    jm, pm = JTermManager(cfg(True), jenv), PTermManager(cfg(False), penv)
    jenv.ctx.termination_state = jm.init_state(E)
    pm.init_state(E)
    for t in range(4):
        rs = np.random.default_rng(t)
        jenv.value = penv.value = {n: rs.random(E) < 0.4 for n in names}
        jt, jtr = jm.compute()
        pt, ptr = pm.compute()
        np.testing.assert_array_equal(np.asarray(jt), pt.numpy())
        np.testing.assert_array_equal(np.asarray(jtr), ptr.numpy())
        for n in names:
            np.testing.assert_array_equal(np.asarray(jm.get_term(n)), pm.get_term(n).numpy())
        if t == 2:
            jlogs, plogs = jm.reset(jnp.asarray(mask)), pm.reset(torch.as_tensor(mask))
            for k in jlogs:
                assert rel_err(jlogs[k], tnp(plogs[k])) < TOL, k
    for n in names:
        assert rel_err(jenv.ctx.termination_state["episode_counts"][n],
                       tnp(pm.episode_counts[n])) < TOL


DT = 0.05


def _recording_term(log):
    def f(env, mask):
        log.append(np.asarray(mask).copy() if not isinstance(mask, torch.Tensor)
                   else mask.numpy().copy())
    return f


EVENT_CASES = {
    "interval_per_env": dict(mode="interval", interval_range_s=(0.1, 0.3)),
    "interval_global": dict(mode="interval", interval_range_s=(0.1, 0.3), is_global_time=True),
}


@pytest.mark.parametrize("case", list(EVENT_CASES))
def test_interval_timers_match_jax(case):
    """60 steps of the interval timers: the same firing masks in both."""
    jlog, plog = [], []
    jenv = _JEnv()
    with JaxDraws() as draws:
        jm = JEventManager({"ev": jcfgs.EventTermCfg(func=_recording_term(jlog),
                                                     **EVENT_CASES[case])}, jenv)
        jenv.ctx.event_state = jm.init_state(E, jax.random.PRNGKey(7))
        for _ in range(60):
            jm.apply_interval(DT)
            jenv.ctx.event_state = jenv.ctx.event_state  # the manager rebinds it
    penv = _PEnv(ReplayRng(draws))
    pm = PEventManager({"ev": pcfgs.EventTermCfg(func=_recording_term(plog),
                                                 **EVENT_CASES[case])}, penv)
    pm.init_state(E)
    for _ in range(60):
        pm.apply_interval(DT)
    assert penv.rng.done()
    np.testing.assert_array_equal(np.stack(jlog), np.stack(plog))
    # every env fired several times, at gaps inside the sampled range
    assert (np.stack(plog).sum(0) >= 8).all()


@pytest.mark.parametrize("min_steps", [0, 5])
def test_reset_gating_matches_jax(min_steps):
    """Reset events with and without the min-step gate, over a sequence of
    (step, mask) calls: the same masks reach the term."""
    full = np.ones(E, bool)
    half = np.arange(E) < E // 2
    calls = [(0, full), (3, full), (5, half), (8, full), (9, ~half), (20, full)]
    jlog, plog = [], []
    jenv, penv = _JEnv(), _PEnv(None)
    jm = JEventManager({"dr": jcfgs.EventTermCfg(
        mode="reset", func=_recording_term(jlog),
        min_step_count_between_reset=min_steps)}, jenv)
    jenv.ctx.event_state = jm.init_state(E, jax.random.PRNGKey(0))
    pm = PEventManager({"dr": pcfgs.EventTermCfg(
        mode="reset", func=_recording_term(plog),
        min_step_count_between_reset=min_steps)}, penv)
    pm.init_state(E)
    for step, mask in calls:
        jenv.common_step_counter = step
        penv.common_step_counter = torch.tensor(step, dtype=torch.int32)
        jm.apply_reset(jnp.asarray(mask))
        pm.apply_reset(torch.as_tensor(mask))
    np.testing.assert_array_equal(np.stack(jlog), np.stack(plog))
    if min_steps:
        assert not np.array_equal(np.stack(plog), np.stack([m for _, m in calls]))
