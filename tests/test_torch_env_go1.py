"""The port's Mjlab-Velocity-Flat-Unitree-Go1 env against the JAX
package's, end to end on the CPU.

One module-scoped pair of 4-env envs, both float32, the task's config in
each with every random range collapsed to a point, the JAX env on its
env-last hybrid physics. After the reset env 0 is tipped past fell_over's
limit and env 1 set one step before its time-out (torch_port_common
tip_and_time_out), so that step 1 resets both; then the same 5 actions in
both. The Go1 is the port's third model shape after the G1 and the YAM
(nq 19, nv 18, nu 12, 17 contact slots: plane against its four foot
spheres, a sphere, capsules and a box).

Tolerances are the flat G1 env's (torch_port_common.VELOCITY_ENV_TOL);
terminated, truncated and the episode lengths are equal.
"""

import pytest

from torch_port_common import (
    check_env_equal, check_env_logs, check_env_output, check_reward_term,
    collapse_velocity_ranges, run_velocity_env_pair, tip_and_time_out,
)

TASK = "Mjlab-Velocity-Flat-Unitree-Go1"
E = 4
STEPS = 5
TERMS = ("track_linear_velocity", "track_angular_velocity", "upright", "pose",
         "body_ang_vel", "angular_momentum", "dof_pos_limits", "action_rate_l2",
         "air_time", "foot_clearance", "foot_swing_height", "foot_slip", "soft_landing")


@pytest.fixture(scope="module")
def run():
    yield run_velocity_env_pair(TASK, E, STEPS, edit=collapse_velocity_ranges,
                                prepare=tip_and_time_out)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "ctrl", "policy", "critic", "reward",
                                  "command"])
def test_go1_env_step_matches_jax(run, what, step):
    check_env_output(run[2], what, step)


@pytest.mark.parametrize("step", range(STEPS))
def test_go1_env_dones_match_jax(run, step):
    check_env_equal(run[2], step, ("terminated", "truncated", "episode_length"))


def test_go1_first_step_resets_the_fallen_and_timed_out_envs(run):
    for side in ("jax", "port"):
        s = run[2][side][0]
        assert s["terminated"].tolist() == [True, False, False, False], side
        assert s["truncated"].tolist() == [False, True, False, False], side
        assert s["episode_length"].tolist() == [0, 0, 1, 1], side


@pytest.mark.parametrize("term", TERMS)
def test_go1_env_reward_terms_match_jax(run, term):
    check_reward_term(run[2], term)


@pytest.mark.parametrize("step", range(STEPS))
def test_go1_env_logs_match_jax(run, step):
    check_env_logs(run[2], step)


def test_go1_model_and_dims_match_jax(run):
    """The Go1's sizes, contact families, action and observation dims,
    soft limits and default joint positions, in both packages."""
    import numpy as np

    jenv, penv, _ = run
    mj, pm = jenv.mj_model, penv.sim.model
    assert (mj.nq, mj.nv, mj.nu) == (pm.nq, pm.nv, pm.nu) == (19, 18, 12)
    assert pm.pairs.ncon == 17 and pm.ncon_max == 17
    fams = {}
    for a, b in zip(pm.pairs.geom1, pm.pairs.geom2):
        key = (int(pm.geom_type[a]), int(pm.geom_type[b]))
        fams[key] = fams.get(key, 0) + 1
    assert fams == {(0, 2): 5, (0, 3): 4, (0, 6): 1}, fams
    assert penv.action_manager.total_action_dim == 12
    for g in ("policy", "critic"):
        assert penv.observation_manager.group_obs_dim(g) == \
            jenv.observation_manager.group_obs_dim(g)
    jr, pr = jenv.scene["robot"], penv.scene["robot"]
    np.testing.assert_array_equal(np.asarray(jr.data.soft_joint_pos_limits),
                                  pr.data.soft_joint_pos_limits.numpy())
    np.testing.assert_array_equal(np.asarray(jr.data.default_joint_pos),
                                  pr.data.default_joint_pos.numpy())
    assert jr.joint_names == pr.joint_names
