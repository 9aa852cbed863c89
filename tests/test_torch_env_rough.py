"""The port's Mjlab-Velocity-Rough-Unitree-G1 env against the JAX
package's, end to end on the CPU, through the terrain curriculum.

One module-scoped pair of 4-env envs, both float32, the task's rough
config in each with every random range collapsed to a point and the
generated terrain cut to 2 x 2 sub-terrains (seed 0: a flat column and a
pyramid-stairs column), the JAX env on its env-last hybrid physics (the
height-field families of tests/test_torch_hfield.py). After the reset,
torch_port_common.promote_demote_and_fall sets the terrain levels and the
robots in both: at step 1 env 0 times out 4.5 m from its origin and is
promoted, env 1 times out near its origin and is demoted, env 2 falls
over on its stairs, env 3 walks on level 1 of the stairs; then the same 5
actions in both.

Tolerances are the flat env's (tests/test_torch_env.py); the terrain
levels and origins, terminated, truncated and the episode lengths are
equal.
"""

import numpy as np
import pytest

from torch_port_common import (
    check_env_equal, check_env_logs, check_env_output, check_reward_term,
    collapse_velocity_ranges, promote_demote_and_fall, run_velocity_env_pair,
)

TASK = "Mjlab-Velocity-Rough-Unitree-G1"
E = 4
STEPS = 5
TERMS = ("track_linear_velocity", "track_angular_velocity", "upright", "pose",
         "body_ang_vel", "angular_momentum", "dof_pos_limits", "action_rate_l2",
         "air_time", "foot_clearance", "foot_swing_height", "foot_slip", "soft_landing",
         "self_collisions")


@pytest.fixture(scope="module")
def run():
    yield run_velocity_env_pair(TASK, E, STEPS, edit=collapse_velocity_ranges,
                                prepare=promote_demote_and_fall)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "ctrl", "policy", "critic", "reward",
                                  "command"])
def test_rough_env_step_matches_jax(run, what, step):
    check_env_output(run[2], what, step)


@pytest.mark.parametrize("step", range(STEPS))
def test_rough_env_dones_and_terrain_state_match_jax(run, step):
    check_env_equal(run[2], step, ("terminated", "truncated", "episode_length", "levels",
                                   "origins"))


def test_curriculum_promotes_demotes_and_resets(run):
    """At step 1 env 0 is promoted (level 0 -> 1), env 1 demoted (1 -> 0),
    env 2 falls and stays at level 0, env 3 keeps level 1; the three reset
    at their new origins; the logged mean level is JAX's."""
    jenv, penv, out = run
    for side in ("jax", "port"):
        s = out[side][0]
        assert s["terminated"].tolist() == [False, False, True, False], side
        assert s["truncated"].tolist() == [True, True, False, False], side
        assert s["levels"].tolist() == [1, 0, 0, 1], side
        assert s["episode_length"].tolist() == [0, 0, 0, 1], side
    table = penv.scene.terrain.terrain_origins.numpy()
    s = out["port"][0]
    np.testing.assert_array_equal(s["origins"], table[s["levels"], [0, 0, 1, 1]])
    # the reset envs stand at their new origins (xy), env 0 on row 1
    np.testing.assert_allclose(s["qpos"][:3, :2], s["origins"][:3, :2], atol=0.05)
    assert out["port"][0]["log"]["Curriculum/terrain_levels"] == pytest.approx(0.5)
    assert out["jax"][0]["log"]["Curriculum/terrain_levels"] == pytest.approx(0.5)


@pytest.mark.parametrize("term", TERMS)
def test_rough_env_reward_terms_match_jax(run, term):
    check_reward_term(run[2], term)


@pytest.mark.parametrize("step", range(STEPS))
def test_rough_env_logs_match_jax(run, step):
    check_env_logs(run[2], step)


def test_rough_env_terrain_and_contacts(run):
    """The port's Model carries the JAX env's height field (the same
    generated terrain: nrow, ncol, size and data equal), and the feet's
    contact sensor matches the height-field slots."""
    jenv, penv, _ = run
    jm, pm = jenv.sim.model, penv.sim.model
    assert (pm.hfield_nrow, pm.hfield_ncol) == (jm.hfield_nrow, jm.hfield_ncol) == (561, 561)
    np.testing.assert_array_equal(np.asarray(jm.hfield_data), pm.hfield_data.numpy())
    np.testing.assert_array_equal(np.asarray(jm.hfield_size), pm.hfield_size.numpy())
    np.testing.assert_array_equal(np.asarray(jm.geom_pos), pm.geom_pos.numpy())
    feet = penv.scene["feet_ground_contact"]
    hf = pm.geom_names.index("terrain/terrain")
    slots = feet.slot_table[feet.slot_mask].numpy()
    assert len(slots) and (pm.pairs.con_geom1[slots] == hf).all()
    assert {(1, 2), (1, 3)} <= {(int(pm.geom_type[a]), int(pm.geom_type[b]))
                                for a, b in zip(pm.pairs.geom1, pm.pairs.geom2)}
