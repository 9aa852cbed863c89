"""The port's Mjlab-Lift-Cube-Yam env against the JAX package's, end to
end on the CPU.

One module-scoped pair of 8-env envs, both float32, the task's config in
each with every random range collapsed to a point (the fingertip
friction: slide 0.8, spin 5e-3 and roll 1e-3, the last two through
log_uniform; the lifting command's target box, the cube's position box
and yaw, and its resampling time; the policy group's corruption off), the
JAX env on its env-last hybrid physics, which solves the elliptic cone
with solve_lm on the CPU (the port's plain elliptic solve is held against
solve_lm in tests/test_torch_yam_step.py). After the reset, in both:

- env 0's arm is lowered (joint2 1.75, joint3 0.8) until link_6's subtree
  meets the table: the ee_ground_collision sensor finds the contact and
  illegal_contact terminates it in step 1;
- env 1 is one step before its time-out;
- env 2's cube is moved 5 cm along x and its command's time left set to
  0.01 s: step 1 resamples its target and puts the cube back at the
  (collapsed) drawn pose, mid-episode, through write_root_pose and
  write_root_velocity;
- the global step counter is set to 24,000, and to 36,000 after step 3:
  the curriculum's three stages of the joint_vel_hinge weight (-0.01,
  -0.1, -1.0) weigh the rewards of steps 1, 2-4 and 5.

Then both take the same 5 actions, N(0, 1) (the arm's joint speeds pass
the hinge's 0.5 rad/s). Tolerances are the flat G1 env's
(torch_port_common.VELOCITY_ENV_TOL: the f32 step tolerances by what each
output reads); terminated, truncated, the episode lengths and the
curriculum's weights are equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest

from torch_port_common import (
    check_env_equal, check_env_logs, check_env_output, check_reward_term,
    run_velocity_env_pair,
)

TASK = "Mjlab-Lift-Cube-Yam"
E = 8
STEPS = 5
TERMS = ("lift", "lift_precise", "action_rate_l2", "joint_pos_limits", "joint_vel_hinge")
# env 0's arm pushed into the table; env 2's cube moved before its resample
GROUND_ARM = {1: 1.75, 2: 0.8}
CUBE_SHIFT_X = 0.05
CUBE_QPOS = 8  # the cube's free joint follows the arm's 8 joints
STAGES = ((0, 24000), (2, 36000))  # (before step t + 1, the counter)


def collapse_lift_ranges(cfg) -> None:
    ev = cfg.events
    ev["fingertip_friction_slide"].params["ranges"] = (0.8, 0.8)
    ev["fingertip_friction_spin"].params["ranges"] = (5e-3, 5e-3)
    ev["fingertip_friction_roll"].params["ranges"] = (1e-3, 1e-3)
    c = cfg.commands["lift_height"]
    c.resampling_time_range = (10.0, 10.0)
    t = c.target_position_range
    t.x, t.y, t.z = (0.35, 0.35), (0.05, 0.05), (0.25, 0.25)
    r = c.object_pose_range
    r.x, r.y, r.z, r.yaw = (0.3, 0.3), (0.0, 0.0), (0.02, 0.02), (0.4, 0.4)
    cfg.observations["policy"].enable_corruption = False


def ground_late_and_resample(jenv, penv) -> None:
    st = jenv._state
    q = st.data.qpos.at[2, CUBE_QPOS].add(CUBE_SHIFT_X)
    for j, v in GROUND_ARM.items():
        q = q.at[0, j].set(v)
    cs = dict(st.command_state)
    lh = dict(cs["lift_height"])
    lh["time_left"] = lh["time_left"].at[2].set(0.01)
    cs["lift_height"] = lh
    jenv._state = st.replace(
        data=st.data.replace(qpos=q), command_state=cs,
        episode_length=st.episode_length.at[1].set(jenv.max_episode_length - 1),
        common_step=jnp.asarray(STAGES[0][1], jnp.int32))

    qp = penv.sim.data.qpos.clone()
    qp[2, CUBE_QPOS] += CUBE_SHIFT_X
    for j, v in GROUND_ARM.items():
        qp[0, j] = v
    penv.sim.data = penv.sim.data.replace(qpos=qp)
    penv.command_manager.get_term("lift_height").state["time_left"][2] = 0.01
    penv.episode_length_buf[1] = penv.max_episode_length - 1
    penv.common_step_counter.fill_(STAGES[0][1])


def next_stage(t, jenv, penv) -> None:
    if t == STAGES[1][0]:
        jenv._state = jenv._state.replace(common_step=jnp.asarray(STAGES[1][1], jnp.int32))
        penv.common_step_counter.fill_(STAGES[1][1])


@pytest.fixture(scope="module")
def run():
    yield run_velocity_env_pair(TASK, E, STEPS, edit=collapse_lift_ranges,
                                prepare=ground_late_and_resample, between=next_stage,
                                command=("lift_height", "target_pos"), action_std=1.0)


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "ctrl", "policy", "critic", "reward",
                                  "command"])
def test_yam_env_step_matches_jax(run, what, step):
    check_env_output(run[2], what, step)


@pytest.mark.parametrize("step", range(STEPS))
def test_yam_env_dones_match_jax(run, step):
    check_env_equal(run[2], step, ("terminated", "truncated", "episode_length"))


def test_yam_first_step_grounds_times_out_and_resamples(run):
    """Step 1 terminates env 0 on the ground contact and times out env 1,
    and resets both; env 2's cube is back at the drawn pose (the
    resample's write, seen by the refresh and the observations after it),
    at rest; in both packages."""
    jenv, penv, out = run
    jt = jenv.termination_manager
    for side in ("jax", "port"):
        s = out[side][0]
        assert s["terminated"].tolist() == [True] + [False] * 7, side
        assert s["truncated"].tolist() == [False, True] + [False] * 6, side
        assert s["episode_length"].tolist() == [0, 0] + [1] * 6, side
        assert s["log"]["Episode_Termination/ee_ground_collision"] == 0.5, side
        cube = s["qpos"][2, CUBE_QPOS:CUBE_QPOS + 3] - s["qpos"][3, CUBE_QPOS:CUBE_QPOS + 3]
        np.testing.assert_allclose(cube[:2], penv.scene.env_origins[2, :2].numpy()
                                   - penv.scene.env_origins[3, :2].numpy(), atol=1e-6)
    assert "ee_ground_collision" in jt.active_terms
    found = penv.scene["ee_ground_collision"].data.found
    assert found.shape == (E, 1)


def test_yam_curriculum_stages_match_jax(run):
    """The joint_vel_hinge weight after each step: -0.1 past step 24,000,
    -1.0 past 36,000, equal in both packages."""
    out = run[2]
    key = "Curriculum/joint_vel_hinge_weight"
    for side in ("jax", "port"):
        w = [float(np.float32(s["log"][key])) for s in out[side]]
        assert w == [np.float32(-0.1)] * 3 + [np.float32(-1.0)] * 2, (side, w)


@pytest.mark.parametrize("term", TERMS)
def test_yam_env_reward_terms_match_jax(run, term):
    check_reward_term(run[2], term)


@pytest.mark.parametrize("step", range(STEPS))
def test_yam_env_logs_match_jax(run, step):
    check_env_logs(run[2], step)


def test_yam_model_and_dims_match_jax(run):
    """The YAM scene's sizes and contact slots, the action and observation
    dims, the action's joints (actuator i drives joint i: the arm's first
    seven joints in the actuators' order; right_finger follows through the
    equality), the soft limits, default joint positions and the per-env
    fingertip friction of both."""
    jenv, penv, _ = run
    mj, pm = jenv.mj_model, penv.sim.model
    assert (mj.nq, mj.nv, mj.nu) == (pm.nq, pm.nv, pm.nu) == (15, 14, 7)
    assert pm.pairs.ncon == 313 and pm.ncon_max == 55 and pm.rows_per_con == 6
    assert penv.action_manager.total_action_dim == 7
    for g in ("policy", "critic"):
        assert penv.observation_manager.group_obs_dim(g) == \
            jenv.observation_manager.group_obs_dim(g) == 29
    jr, pr = jenv.scene["robot"], penv.scene["robot"]
    assert jr.joint_names == pr.joint_names
    assert jr.actuator_joint_names == pr.actuator_joint_names == pr.joint_names[:7]
    np.testing.assert_array_equal(np.asarray(jr.data.soft_joint_pos_limits),
                                  pr.data.soft_joint_pos_limits.numpy())
    np.testing.assert_array_equal(np.asarray(jr.data.default_joint_pos),
                                  pr.data.default_joint_pos.numpy())
    jf = np.asarray(jenv._state.model.geom_friction)
    pf = penv.sim.model.geom_friction.numpy()
    np.testing.assert_allclose(pf, jf, rtol=2.4e-7, atol=0)
