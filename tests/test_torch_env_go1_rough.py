"""The port's Mjlab-Velocity-Rough-Unitree-Go1 env against the JAX
package's, end to end on the CPU, through the terrain curriculum.

The setting of tests/test_torch_env_rough.py on the Go1: 4 envs, float32,
every random range collapsed to a point, the terrain cut to 2 x 2
sub-terrains (seed 0), then torch_port_common.promote_demote_and_fall (a
promotion, a demotion, a fall, an env walking on stairs) and the same 5
actions in both. The Go1 is the one model whose terrain contacts include
the height-field box family (its trunk box; the foot spheres and leg
capsules are the other two families).

Tolerances are the flat G1 env's (torch_port_common.VELOCITY_ENV_TOL);
the terrain levels and origins, terminated, truncated and the episode
lengths are equal.
"""

import numpy as np
import pytest

from torch_port_common import (
    check_env_equal, check_env_logs, check_env_output, check_reward_term,
    collapse_velocity_ranges, promote_demote_and_fall, run_velocity_env_pair,
)

TASK = "Mjlab-Velocity-Rough-Unitree-Go1"
E = 4
STEPS = 5
TERMS = ("track_linear_velocity", "track_angular_velocity", "upright", "pose",
         "body_ang_vel", "angular_momentum", "dof_pos_limits", "action_rate_l2",
         "air_time", "foot_clearance", "foot_swing_height", "foot_slip", "soft_landing")


@pytest.fixture(scope="module")
def run():
    yield run_velocity_env_pair(TASK, E, STEPS, edit=collapse_velocity_ranges,
                                prepare=promote_demote_and_fall)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "ctrl", "policy", "critic", "reward",
                                  "command"])
def test_go1_rough_env_step_matches_jax(run, what, step):
    check_env_output(run[2], what, step)


@pytest.mark.parametrize("step", range(STEPS))
def test_go1_rough_env_dones_and_terrain_state_match_jax(run, step):
    check_env_equal(run[2], step, ("terminated", "truncated", "episode_length", "levels",
                                   "origins"))


def test_go1_curriculum_promotes_demotes_and_resets(run):
    for side in ("jax", "port"):
        s = run[2][side][0]
        assert s["terminated"].tolist() == [False, False, True, False], side
        assert s["truncated"].tolist() == [True, True, False, False], side
        assert s["levels"].tolist() == [1, 0, 0, 1], side
        assert s["log"]["Curriculum/terrain_levels"] == pytest.approx(0.5)


@pytest.mark.parametrize("term", TERMS)
def test_go1_rough_env_reward_terms_match_jax(run, term):
    check_reward_term(run[2], term)


@pytest.mark.parametrize("step", range(STEPS))
def test_go1_rough_env_logs_match_jax(run, step):
    check_env_logs(run[2], step)


def test_go1_rough_contact_families(run):
    """The Go1's 17 slots are the three height-field families, and the
    JAX env's height field is the port's."""
    jenv, penv, _ = run
    pm = penv.sim.model
    fams = {}
    for a, b in zip(pm.pairs.geom1, pm.pairs.geom2):
        key = (int(pm.geom_type[a]), int(pm.geom_type[b]))
        fams[key] = fams.get(key, 0) + 1
    assert fams == {(1, 2): 5, (1, 3): 4, (1, 6): 1}, fams
    assert pm.pairs.ncon == 17
    np.testing.assert_array_equal(np.asarray(jenv.sim.model.hfield_data),
                                  pm.hfield_data.numpy())
