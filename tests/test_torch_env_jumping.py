"""The port's Mjlab-Jumping-Flat-Unitree-G1 env against the JAX package's,
end to end on the CPU.

One module-scoped pair of 8-env envs, both float32, the task's config in
each with the reset pose collapsed to a point (the root 5 cm along x and
yawed 0.05 rad) and the policy group's corruption off. Every draw is at a
point (jax.random.uniform patched to 0.5 while the JAX env compiles; the
port's Rng.draw replaced): the command's resampling time is 4.5 s and its
target the middle of its range. The JAX env runs its env-last hybrid
physics (MJLAB_TPU_ENGINE=hybrid). After the reset, in both:

- env 0 is rolled 80 degrees about x (past fell_over's 70);
- env 1 lies on its side (rolled 90 degrees, its root at 0.15 m): below
  fell_down's 0.3 (and past fell_over's limit; an upright robot put that
  low is pushed back above 0.3 m within the step's 20 ms);
- env 2 is one step before its time-out;
- env 3's command has 0.01 s left: it resamples mid-episode in step 1
  (a new target, the trigger back at 1, the flags cleared);
- env 4 is lifted 5 cm and falls at 1 m/s: it lands on both feet after a
  flight, the sparse landing reward fires, the peak restarts, and the
  command's trigger decays from then on: by 0.95 per update, and the
  command updates twice per control step (in the masked reset, whose
  update runs for every env, and in the step's own), as in the JAX
  package;
- the global step count is past the range curriculum's second stage
  (200,000: the target range (0.05, 0.10) in place of (0.02, 0.05)): the
  resampled envs' targets are 0.075.

Then both take the same 5 actions, 0.3 N(0, 1). Tolerances are the flat
G1 env's (torch_port_common.VELOCITY_ENV_TOL); terminated, truncated, the
episode lengths, the command (trigger and target), its flags and range,
and the landing reward's flight flags are equal; its peaks within the
qpos tolerance.
"""

import jax
import numpy as np
import pytest

from torch_port_common import (
    VELOCITY_ENV_TOL, check_env_equal, check_env_logs, check_env_output, check_reward_term,
    point_draw, point_uniform, rel_err, rotation_x, run_velocity_env_pair, set_env_state,
)

TASK = "Mjlab-Jumping-Flat-Unitree-G1"
E = 8
STEPS = 5
TERMS = ("jump_height", "continuous_height", "launch_velocity", "upright", "stable_landing",
         "soft_landing", "action_rate_l2", "dof_pos_limits", "horizontal_drift",
         "flight_rotation", "foot_slip")
COUNTER = 200_000
DROP = (0.05, -1.0)  # env 4's lift (m) and vertical velocity (m/s)


def collapse_jumping_ranges(cfg) -> None:
    cfg.events["reset_base"].params["pose_range"] = {"x": (0.05, 0.05), "yaw": (0.05, 0.05)}
    cfg.observations["policy"].enable_corruption = False


def force_events(jenv, penv) -> None:
    z = float(penv.sim.data.qpos[4, 2])
    set_env_state(jenv, penv, qpos={0: {3: rotation_x(80.0)}, 1: {2: [0.15, *rotation_x(90.0)]},
                                    4: {2: z + DROP[0]}},
                  qvel={4: {2: DROP[1]}}, episode_length={2: jenv.max_episode_length - 1},
                  common_step=COUNTER)
    st = jenv._state
    cs = dict(st.command_state)
    cs["jump"] = dict(cs["jump"], time_left=cs["jump"]["time_left"].at[3].set(0.01))
    jenv._state = st.replace(command_state=cs)
    penv.command_manager.get_term("jump").state["time_left"][3] = 0.01


def _state(jenv, penv) -> dict:
    """The command's flags and range, the landing reward's state, as numpy."""
    f = lambda x: np.array(x.detach().numpy() if hasattr(x, "detach") else x)  # noqa: E731
    js = jenv._state
    jc, pc = js.command_state["jump"], penv.command_manager.get_term("jump").state
    jr = js.reward_state["terms"]["jump_height"]
    pr = penv.reward_manager.get_term_cfg("jump_height").func.state
    out = {}
    for side, cmd, rew in (("jax", jc, jr), ("port", pc, pr)):
        out[side] = {"range": f(cmd["ranges"]["target_height"]),
                     **{k: f(cmd[k]) for k in ("jump_active", "jump_completed", "was_in_flight",
                                               "time_left")},
                     **{f"reward/{k}": f(v) for k, v in rew.items()}}
    return out


@pytest.fixture(scope="module")
def run():
    store = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", point_uniform)
        import mjlab_tpu_torch.utils.random as prandom

        mp.setattr(prandom.Rng, "draw", point_draw)
        jenv, penv, out = run_velocity_env_pair(
            TASK, E, STEPS, edit=collapse_jumping_ranges, prepare=force_events,
            between=lambda t, jenv, penv: store.append(_state(jenv, penv)),
            command=("jump", "command"), action_std=0.3)
    yield jenv, penv, out, store


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "ctrl", "policy", "critic", "reward"])
def test_jumping_env_step_matches_jax(run, what, step):
    check_env_output(run[2], what, step)


@pytest.mark.parametrize("step", range(STEPS))
def test_jumping_env_dones_and_command_match_jax(run, step):
    check_env_equal(run[2], step, ("terminated", "truncated", "episode_length", "command"))


@pytest.mark.parametrize("step", range(STEPS))
def test_jumping_command_and_term_state_match_jax(run, step):
    """The command's flags, time left and target range, and the landing
    reward's flight flags, equal; its peaks within the qpos tolerance."""
    j, p = run[3][step]["jax"], run[3][step]["port"]
    assert set(j) == set(p)
    for k in j:
        if k == "reward/peak":
            assert rel_err(j[k], p[k]) < VELOCITY_ENV_TOL["qpos"], k
        else:
            np.testing.assert_array_equal(j[k], p[k], err_msg=k)


def test_jumping_forced_events(run):
    """Step 1 ends env 0 (fell_over) and env 1 (fell_down) and times out
    env 2; the three reset envs and env 3 (its command run out) resample a
    target of 0.075 (the middle of the curriculum's second range) with the
    trigger at 1; env 4 lands after its flight: the sparse reward fires,
    its peak restarts at the current height and its trigger decays by
    0.95^2 per control step from there. In both packages."""
    jenv, penv, out, store = run
    for side in ("jax", "port"):
        s = out[side][0]
        assert s["terminated"][:2].tolist() == [True, True], side
        assert s["truncated"].tolist() == [False, False, True] + [False] * 5, side
        assert s["log"]["Episode_Termination/fell_over"] > 0, side
        assert s["log"]["Episode_Termination/fell_down"] > 0, side
        np.testing.assert_allclose(s["command"][:4, 1], 0.075, rtol=1e-6)
        np.testing.assert_array_equal(store[0][side]["range"], np.float32([0.05, 0.10]))
        assert store[0][side]["time_left"][3] == np.float32(4.5), side
        trig = np.array([out[side][t]["command"][4, 0] for t in range(STEPS)])
        sums = np.array([out[side][t]["sums"]["jump_height"][4] for t in range(STEPS)])
        t0 = int(np.flatnonzero(sums > 0)[0])  # the landing's step: the sparse reward
        assert store[t0][side]["jump_completed"][4] and t0 < STEPS - 1, (side, sums)
        assert not store[t0][side]["reward/was_in_flight"][4], side
        assert (trig[:t0] == 1.0).all() and trig[t0] < 1.0, (side, trig)
        np.testing.assert_allclose(trig[t0 + 1:] / trig[t0:-1], 0.95 ** 2, rtol=1e-6)


@pytest.mark.parametrize("term", TERMS)
def test_jumping_env_reward_terms_match_jax(run, term):
    check_reward_term(run[2], term)


@pytest.mark.parametrize("step", range(STEPS))
def test_jumping_env_logs_match_jax(run, step):
    check_env_logs(run[2], step)

