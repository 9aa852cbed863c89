"""The port's Mjlab-Jump-Flat-Unitree-G1 env against the JAX package's, end
to end on the CPU: the first task at dt 0.002 and decimation 2.

One module-scoped pair of 8-env envs, both float32, the task's config in
each with the reset ranges collapsed to a point (the root 5 cm along x and
yawed 0.05 rad, every joint 0.02 rad off its crouched default) and the
policy group's corruption off. Every draw is at a point (jax.random.uniform
patched to 0.5 while the JAX env compiles; the port's Rng.draw replaced).
The JAX env runs its env-last hybrid physics (MJLAB_TPU_ENGINE=hybrid).
After the reset, in both:

- env 0 is rolled 70 degrees about x (past fell_over's 60);
- env 1's root is at 0.30 m (below height_too_low's 0.35; its crouched
  legs deep in the floor);
- env 2 is one step before its time-out;
- env 3 is lifted 0.18 m and falls at 3.13 m/s (a drop from 0.5 m): its
  feet leave the ground in step 1, one lands in step 4 and the other in
  step 5 (flight, the air time, first contact, the landing-balance
  timer's reset);
- the global step count is past the second stage of both curricula
  (400,000: the target height 0.15 in place of the config's 0.25, the
  landing_stability weight 2.5 in place of 4.0): the curricula write the
  command's 0-d state and the reward weight in place, and the envs reset
  in step 1 take the new target (tests/test_torch_mdp.py runs the
  curricula through every stage).

Then both take the same 5 actions, 0.3 N(0, 1). Tolerances are the flat
G1 env's (torch_port_common.VELOCITY_ENV_TOL); terminated, truncated, the
episode lengths, the command, the curriculum's state and the stateful
terms' flags are equal; their heights and timers within the qpos
tolerance.

The crouched start puts the feet ~13 cm into the floor, and the first
step after a reset is ill-conditioned at float32: nudging the actions by
one part in 10^6 moves the JAX env's reward of env 0 in step 2 by 0.028
(-21.651 to -21.623; the port gives -21.623 at float32 and float64). So
the JAX env also runs the steps with the actions times 1 + 1e-6 (NUDGE),
and every output is held to the nearer of the two JAX runs, env by env;
test_jump_env_ill_conditioned_steps_are_few lists the env-steps where
the two runs differ past the tolerance.
"""

import jax
import numpy as np
import pytest

from torch_port_common import (
    VELOCITY_ENV_TOL, check_env_equal, check_env_logs, check_env_output, check_reward_term,
    ill_conditioned, point_draw, point_uniform, rel_err, rotation_x, run_velocity_env_pair,
    set_env_state,
)

TASK = "Mjlab-Jump-Flat-Unitree-G1"
E = 8
STEPS = 5
TERMS = ("jump_height", "explosive_takeoff", "synchronized_extension", "vertical_impulse",
         "air_time_bonus", "upright_in_flight", "angular_momentum_control", "soft_landing",
         "landing_stability", "symmetric_landing", "action_rate_l2", "action_smoothness",
         "joint_torques_l2", "dof_pos_limits", "alive")
COUNTER = 400_000
NUDGE = 1e-6
DROP = (0.18, -3.13)  # env 3's lift (m) and vertical velocity (m/s)


def collapse_jump_ranges(cfg) -> None:
    ev = cfg.events
    ev["reset_base"].params["pose_range"] = {"x": (0.05, 0.05), "yaw": (0.05, 0.05)}
    ev["reset_robot_joints"].params["position_range"] = (0.02, 0.02)
    cfg.observations["policy"].enable_corruption = False


def force_events(jenv, penv) -> None:
    z = float(penv.sim.data.qpos[3, 2])
    set_env_state(jenv, penv, qpos={0: {3: rotation_x(70.0)}, 1: {2: 0.30}, 3: {2: z + DROP[0]}},
                  qvel={3: {2: DROP[1]}}, episode_length={2: jenv.max_episode_length - 1},
                  common_step=COUNTER)


def _state(jenv, penv) -> dict:
    """The curriculum's state, the stateful terms' state and the feet's air
    times of both envs, as numpy."""
    f = lambda x: np.array(x.detach().numpy() if hasattr(x, "detach") else x)  # noqa: E731
    js, rm = jenv._state, penv.reward_manager
    jc, pc = js.command_state["jump"], penv.command_manager.get_term("jump").state
    out = {}
    for side, cmd, weight, terms, air in (
            ("jax", jc, js.reward_state["weights"]["landing_stability"],
             {n: js.reward_state["terms"][n] for n in ("jump_height", "landing_stability")},
             js.sensor_states["feet_ground_contact"].current_air_time),
            ("port", pc, rm.weights["landing_stability"],
             {n: rm.get_term_cfg(n).func.state for n in ("jump_height", "landing_stability")},
             penv.scene["feet_ground_contact"].data.current_air_time)):
        out[side] = {"target_height": f(cmd["target_height"]),
                     "height_tolerance": f(cmd["height_tolerance"]), "weight": f(weight),
                     "air": f(air), **{f"{n}/{k}": f(v) for n, st in terms.items()
                                      for k, v in st.items()}}
    return out




@pytest.fixture(scope="module")
def run():
    store = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax.random, "uniform", point_uniform)
        import mjlab_tpu_torch.utils.random as prandom

        mp.setattr(prandom.Rng, "draw", point_draw)
        jenv, penv, out = run_velocity_env_pair(
            TASK, E, STEPS, edit=collapse_jump_ranges, prepare=force_events,
            between=lambda t, jenv, penv: store.append(_state(jenv, penv)),
            command=("jump", "command"), action_std=0.3, nudge=NUDGE)
    yield jenv, penv, out, store


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "ctrl", "policy", "critic", "reward"])
def test_jump_env_step_matches_jax(run, what, step):
    check_env_output(run[2], what, step)


@pytest.mark.parametrize("step", range(STEPS))
def test_jump_env_dones_and_command_match_jax(run, step):
    check_env_equal(run[2], step, ("terminated", "truncated", "episode_length", "command"))


@pytest.mark.parametrize("step", range(STEPS))
def test_jump_curriculum_and_term_state_match_jax(run, step):
    """The command's target and tolerance and the reward weight equal; the
    jump-height tracker's and the landing-balance timer's flags equal,
    their heights and timers, and the feet's air times, within the qpos
    tolerance."""
    j, p = run[3][step]["jax"], run[3][step]["port"]
    assert set(j) == set(p)
    for k in j:
        if j[k].dtype == bool or k in ("target_height", "height_tolerance", "weight"):
            np.testing.assert_array_equal(j[k], p[k], err_msg=k)
        else:
            assert rel_err(j[k], p[k]) < VELOCITY_ENV_TOL["qpos"], k


def test_jump_forced_events(run):
    """Step 1 ends env 0 (fell_over), env 1 (height_too_low) and times out
    env 2; env 3 flies in steps 1-3 and lands in steps 4-5; the curricula move
    the target to 0.15 and the weight to 2.5 in step 1. In both
    packages."""
    jenv, penv, out, store = run
    for side in ("jax", "port"):
        s = out[side][0]
        assert s["terminated"][:2].tolist() == [True, True], side
        assert s["truncated"].tolist() == [False, False, True] + [False] * 5, side
        log = s["log"]
        assert log["Episode_Termination/fell_over"] > 0, side
        assert log["Episode_Termination/height_too_low"] > 0, side
        air = [store[t][side]["air"][3] for t in range(STEPS)]
        assert all((a > 0).all() for a in air[:3]), (side, air)
        assert (air[3] == 0).any() and (air[4] == 0).all(), (side, air)
        assert not any(out[side][t]["terminated"][3] for t in range(STEPS)), side
        cur = [(float(store[t][side]["target_height"]), float(store[t][side]["height_tolerance"]),
                float(store[t][side]["weight"])) for t in range(STEPS)]
        np.testing.assert_allclose(cur, [(0.15, 0.05, 2.5)] * STEPS, rtol=1e-7)
        # the reset envs' command takes the target of the step's curriculum
        np.testing.assert_allclose(s["command"][:3, 0], 0.15, rtol=1e-7)


@pytest.mark.parametrize("term", TERMS)
def test_jump_env_reward_terms_match_jax(run, term):
    check_reward_term(run[2], term)


@pytest.mark.parametrize("step", range(STEPS))
def test_jump_env_logs_match_jax(run, step):
    check_env_logs(run[2], step)


def test_jump_env_physics_options(run):
    """Both envs step at dt 0.002 with decimation 2 (a control step of
    0.004 s, 1,250 per 5 s episode); the port's Simulation holds the
    timestep the config applied to the model file's 0.005."""
    jenv, penv, _, _ = run
    assert float(penv.sim.model.opt.timestep) == np.float32(0.002)
    assert float(jenv._state.model.opt.timestep) == np.float32(0.002)
    assert penv.cfg.decimation == jenv.cfg.decimation == 2
    assert penv.step_dt == jenv.step_dt == 0.004
    assert penv.max_episode_length == jenv.max_episode_length == 1250
    np.testing.assert_allclose(np.asarray(jenv._state.data.time),
                               penv.sim.data.time.numpy(), rtol=1e-6)


def test_jump_env_ill_conditioned_steps_are_few(run):
    """The two JAX runs (NUDGE) end, reset and time out the same envs; their
    rewards and critic observations (the feet's contact forces) differ past
    the tolerance in at most 2 of the 40 env-steps, each in an env's first
    step after a reset (the crouched start)."""
    out = run[2]
    for t in range(STEPS):
        check_env_equal({"jax": out["jax"], "port": out["jax_nudged"]}, t,
                        ("terminated", "truncated", "episode_length"))
    found = sorted(set(ill_conditioned(out, "reward", VELOCITY_ENV_TOL["reward"])
                       + ill_conditioned(out, "critic", VELOCITY_ENV_TOL["critic"])))
    assert len(found) <= 2, found
    for t, e in found:
        assert t > 0 and (out["jax"][t - 1]["terminated"][e] or out["jax"][t - 1]["truncated"][e])
