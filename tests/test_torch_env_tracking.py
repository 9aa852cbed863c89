"""The port's Mjlab-Tracking-Flat-Unitree-G1 env against the JAX package's,
end to end on the CPU.

One module-scoped pair of 8-env envs, both float32, the task's config in
each with the motion evidence/tracking_r4/motion.npz and every random
range collapsed to a point: the motion command's pose, velocity and joint
noise, the push (every 0.05 s), the foot friction, the encoder bias, and
the base_com event's torso offset at a NON-zero point (1, -2 and 3 cm), so
that body_ipos is carried per env and the smooth kernels' plain versions
read the plane, not the constant; the policy group's corruption off. Every
draw is at a point: the unit uniform draws at 0.5 (jax.random.uniform
patched in the JAX env; the port's Rng.draw replaced), and the adaptive
sampler's categorical draw at its mode (jax.random.categorical patched to
the arg max of its logits, the port's draw to the arg max of its
probabilities). The JAX env runs its env-last hybrid physics
(MJLAB_TPU_ENGINE=hybrid). After the reset, in both:

- env 0 is lifted 40 cm: the anchor-height termination (and the ankles'
  end-effector one) ends it in step 1;
- env 1's left arm is raised (shoulder pitch -2.8): its wrist is past the
  end-effector threshold;
- env 2 is one step before its time-out;
- env 3 is rolled 90 degrees about x: the anchor-orientation termination;
- env 4's motion is two frames from its end: step 1 runs it past the end
  (every env advances in the update of step 1's reset, then in the
  step's own) and it resamples in the command's update;
- the failure counts' moving average holds 0.5 in bin 5: the adaptive
  resample of the failed envs in step 1 draws bin 5 (the mode), and the
  step's failures land in the counts.

Then both take the same 5 actions, 0.3 N(0, 1). Tolerances are the flat
G1 env's (torch_port_common.VELOCITY_ENV_TOL); terminated, truncated, the
episode lengths and the command's time steps are equal; the failure
counts within 1e-6 relative; the metrics at the critic observations'
5e-3 (they read the same frames). The -No-State-Estimation variant's
policy observations, on the port env's last state, are the full
variant's JAX observations without motion_anchor_pos_b and base_lin_vel.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import (
    VELOCITY_ENV_TOL, check_env_equal, check_env_logs, check_env_output, check_reward_term,
    point_categorical, point_draw, point_uniform, rel_err, rotation_x, run_velocity_env_pair,
)

TASK = "Mjlab-Tracking-Flat-Unitree-G1"
NSE_TASK = "Mjlab-Tracking-Flat-Unitree-G1-No-State-Estimation"
MOTION = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "evidence", "tracking_r4", "motion.npz")
E = 8
STEPS = 5
TERMS = ("motion_global_root_pos", "motion_global_root_ori", "motion_body_pos",
         "motion_body_ori", "motion_body_lin_vel", "motion_body_ang_vel", "action_rate_l2",
         "joint_limit", "self_collisions")
BASE_COM = {0: (0.01, 0.01), 1: (-0.02, -0.02), 2: (0.03, 0.03)}
LEFT_SHOULDER_PITCH = 22  # qpos address
PRIOR = (5, 0.5)  # (bin, the failure counts' moving average there)


def collapse_tracking_ranges(cfg) -> None:
    c = cfg.commands["motion"]
    c.pose_range = {"x": (0.01, 0.01), "yaw": (0.05, 0.05)}
    c.velocity_range = {"z": (0.1, 0.1)}
    c.joint_position_range = (0.02, 0.02)
    ev = cfg.events
    ev["push_robot"].interval_range_s = (0.05, 0.05)
    ev["push_robot"].params["velocity_range"] = {"x": (0.2, 0.2), "yaw": (-0.1, -0.1)}
    ev["base_com"].params["ranges"] = dict(BASE_COM)
    ev["encoder_bias"].params["bias_range"] = (0.005, 0.005)
    ev["foot_friction"].params["ranges"] = (0.7, 0.7)
    cfg.observations["policy"].enable_corruption = False


def force_failures(jenv, penv) -> None:
    T = penv.command_manager.get_term("motion").motion.time_step_total
    st = jenv._state
    q = st.data.qpos.at[0, 2].add(0.4)
    q = q.at[1, LEFT_SHOULDER_PITCH].set(-2.8)
    q = q.at[3, 3:7].set(jnp.asarray(rotation_x(90.0)))
    cs = dict(st.command_state)
    mo = dict(cs["motion"])
    mo["time_steps"] = mo["time_steps"].at[4].set(T - 2)
    mo["bin_failed_count"] = mo["bin_failed_count"].at[PRIOR[0]].set(PRIOR[1])
    cs["motion"] = mo
    jenv._state = st.replace(
        data=st.data.replace(qpos=q), command_state=cs,
        episode_length=st.episode_length.at[2].set(jenv.max_episode_length - 1))

    qp = penv.sim.data.qpos.clone()
    qp[0, 2] += 0.4
    qp[1, LEFT_SHOULDER_PITCH] = -2.8
    qp[3, 3:7] = torch.as_tensor(rotation_x(90.0))
    penv.sim.data = penv.sim.data.replace(qpos=qp)
    s = penv.command_manager.get_term("motion").state
    s["time_steps"][4] = T - 2
    s["bin_failed_count"][PRIOR[0]] = PRIOR[1]
    penv.episode_length_buf[2] = penv.max_episode_length - 1


def _record(store):
    """A `between` that keeps the motion command's state of both envs."""

    def between(t, jenv, penv):
        j = jenv._state.command_state["motion"]
        p = penv.command_manager.get_term("motion").state
        f = lambda x: np.array(x.detach().numpy() if isinstance(x, torch.Tensor) else x)  # noqa: E731
        store.append({side: {
            "time_steps": f(s["time_steps"]), "bin_failed_count": f(s["bin_failed_count"]),
            "body_pos_relative_w": f(s["body_pos_relative_w"]),
            "metrics": {k: f(v) for k, v in s["metrics"].items()}}
            for side, s in (("jax", j), ("port", p))})
        store[-1]["ipos"] = (np.asarray(jenv._state.model.body_ipos),
                             penv.sim.model.body_ipos.numpy().copy())

    return between


@pytest.fixture(scope="module")
def run():
    store = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MJLAB_TPU_MOTION_FILE", MOTION)
        mp.setattr(jax.random, "uniform", point_uniform)
        mp.setattr(jax.random, "categorical", point_categorical)
        import mjlab_tpu_torch.utils.random as prandom

        mp.setattr(prandom.Rng, "draw", point_draw)
        jenv, penv, out = run_velocity_env_pair(
            TASK, E, STEPS, edit=collapse_tracking_ranges, prepare=force_failures,
            between=_record(store), command=("motion", "time_steps"), action_std=0.3)
    yield jenv, penv, out, store


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "ctrl", "policy", "critic", "reward"])
def test_tracking_env_step_matches_jax(run, what, step):
    check_env_output(run[2], what, step)


@pytest.mark.parametrize("step", range(STEPS))
def test_tracking_env_dones_and_frames_match_jax(run, step):
    check_env_equal(run[2], step, ("terminated", "truncated", "episode_length", "command"))


@pytest.mark.parametrize("step", range(STEPS))
def test_tracking_command_state_matches_jax(run, step):
    """The failure counts, the anchor-relative reference bodies and the
    command's metrics after each step."""
    s = run[3][step]
    j, p = s["jax"], s["port"]
    assert rel_err(j["bin_failed_count"], p["bin_failed_count"]) < 1e-6
    assert rel_err(j["body_pos_relative_w"], p["body_pos_relative_w"]) < \
        VELOCITY_ENV_TOL["command"]
    assert set(j["metrics"]) == set(p["metrics"])
    for k in j["metrics"]:
        assert rel_err(j["metrics"][k], p["metrics"][k]) < VELOCITY_ENV_TOL["critic"], k


def test_tracking_forced_events(run):
    """Step 1 ends envs 0, 1 and 3 (anchor height, end effector, anchor
    orientation) and times out env 2; the failed envs' adaptive resample
    drew bin 5 (the prior's mode); the failures' bins entered the moving
    average; env 4 ran past the motion's end and resampled in the
    command's update. In both packages."""
    jenv, penv, out, store = run
    T = penv.command_manager.get_term("motion").motion.time_step_total
    nb = penv.command_manager.get_term("motion").bin_count
    frame5 = int((PRIOR[0] + 0.5) / nb * (T - 1))
    for side in ("jax", "port"):
        s = out[side][0]
        assert s["terminated"].tolist() == [True, True, False, True] + [False] * 4, side
        assert s["truncated"].tolist() == [False, False, True] + [False] * 5, side
        log = s["log"]
        assert log["Episode_Termination/anchor_pos"] > 0, side
        assert log["Episode_Termination/anchor_ori"] > 0, side
        assert log["Episode_Termination/ee_body_pos"] > 0, side
        ts = store[0][side]["time_steps"]
        # reset, resampled at the mode's frame, then the update and the step
        assert ts[[0, 1, 2, 3]].tolist() == [frame5 + 2] * 4, (side, ts)
        assert ts[4] == frame5, (side, ts)
        counts = store[0][side]["bin_failed_count"]
        assert counts[PRIOR[0]] < PRIOR[1] and (counts > 0).sum() >= 2, (side, counts)
        assert abs(store[0][side]["metrics"]["sampling_top1_bin"][0] - PRIOR[0] / nb) < 1e-6


def test_tracking_base_com_is_per_env_and_non_zero(run):
    """The base_com event's offset sits in the torso's body_ipos of every
    env, in both packages, and the port carries it per env."""
    jenv, penv, _, store = run
    from mjlab_tpu_torch.phys.model import per_env_smooth

    assert per_env_smooth(penv.sim.model) == ("body_ipos",)
    torso = penv.sim.model.body_names.index("robot/torso_link")
    jip, pip = store[-1]["ipos"]
    np.testing.assert_allclose(pip, jip, rtol=0, atol=1e-7)
    default = penv.sim.get_default_field("body_ipos")[torso].numpy()
    offset = pip[:, torso] - default
    np.testing.assert_allclose(offset, np.tile([0.01, -0.02, 0.03], (E, 1)), atol=1e-7)


@pytest.mark.parametrize("term", TERMS)
def test_tracking_env_reward_terms_match_jax(run, term):
    check_reward_term(run[2], term)


@pytest.mark.parametrize("step", range(STEPS))
def test_tracking_env_logs_match_jax(run, step):
    check_env_logs(run[2], step)


@pytest.mark.parametrize("variant", ["full", "no_state_estimation"])
def test_tracking_policy_observation_layout(run, variant):
    """Each variant's policy terms and dims equal the JAX package's; the
    No-State-Estimation policy group, computed on the port env's last
    state, is the full group's last JAX observations without
    motion_anchor_pos_b (3) and base_lin_vel (3)."""
    import mjlab_tpu.tasks as jtasks
    from mjlab_tpu_torch.managers.observation_manager import ObservationManager
    from mjlab_tpu_torch.tasks import load_env_cfg

    jenv, penv, out, _ = run
    task = TASK if variant == "full" else NSE_TASK
    pcfg, jcfg = load_env_cfg(task), jtasks.load_env_cfg(task)
    pterms = list(pcfg.observations["policy"].terms)
    assert pterms == list(jcfg.observations["policy"].terms)
    if variant == "full":
        assert penv.observation_manager.group_obs_dim("policy") == \
            jenv.observation_manager.group_obs_dim("policy") == 160
        assert penv.observation_manager.group_obs_dim("critic") == \
            jenv.observation_manager.group_obs_dim("critic") == 286
        return
    assert pterms == ["command", "motion_anchor_ori_b", "base_ang_vel", "joint_pos",
                      "joint_vel", "actions"]
    obs_cfg = {"policy": pcfg.observations["policy"]}
    obs_cfg["policy"].enable_corruption = False
    om = ObservationManager(obs_cfg, penv)
    om.init_state(E)
    got = om.compute(update_history=False)["policy"].numpy()
    full = out["jax"][-1]["policy"]
    keep = np.ones(full.shape[1], bool)
    keep[58:61] = False  # motion_anchor_pos_b, after the 58 command columns
    keep[67:70] = False  # base_lin_vel, after motion_anchor_ori_b's 6
    assert got.shape == (E, 154)
    assert rel_err(full[:, keep], got) < VELOCITY_ENV_TOL["policy"]
