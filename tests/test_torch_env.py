"""The port's G1 flat-velocity env (mjlab_tpu_torch/envs/
manager_based_rl_env.py, the task from mjlab_tpu_torch/tasks) against the
JAX package's env, end to end on the CPU.

One module-scoped pair of 4-env envs, both float32, the same config in
each with every random range collapsed to a point (reset poses, the
command's ranges with rel_standing_envs 0 and rel_heading_envs 1, the
curriculum's stage, the push, the friction; the policy group's
corruption off), the resampling and push intervals short enough that a
resample and a push fire inside the run. The JAX env steps with the
env-last hybrid physics (MJLAB_TPU_ENGINE=hybrid), whose substep the
port's step is held against in tests/test_torch_step.py. Both reset; env 0
is then tipped 80 degrees (past fell_over's 70) and env 1 set one step
before its time-out, so that the first step resets both through the
masked reset and its refresh; then both take the same 5 actions.

Tolerances (the f32 step tolerances of tests/test_torch_step.py, by what
each output reads): qpos 1e-4, qvel 1e-3; the policy observations 1e-3
(joint velocities: qvel's); the critic observations and the logs 5e-3
(the feet's contact forces: con_force_c's); the reward, each term's step
value and the episode sums 1e-3 (velocities); the command 1e-4 (the
heading reads the root orientation: qpos's); ctrl, the processed actions
the builtin actuators pass through, 1e-6; all relative to max(1,
|JAX|max). terminated, truncated and the episode lengths are equal.

The file also checks the quantities the terms read of the two Models
(the port's from g1_velocity_flat.npz, the JAX env's from MuJoCo), that
the port env builds with MuJoCo blocked and runs on CUDA unless asked for
the CPU, the registry, and what is not ported (rough terrain, the NaN
guard).
"""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import G1_TASK, g1_env_pair, rel_err

E = 4
STEPS = 5
TOL = {"qpos": 1e-4, "qvel": 1e-3, "ctrl": 1e-6, "policy": 1e-3, "critic": 5e-3, "reward": 1e-3,
       "step_value": 1e-3, "episode_sum": 1e-3, "command": 1e-4, "log": 5e-3}
TERMS = ("track_linear_velocity", "track_angular_velocity", "upright", "pose",
         "body_ang_vel", "angular_momentum", "dof_pos_limits", "action_rate_l2",
         "air_time", "foot_clearance", "foot_swing_height", "foot_slip", "soft_landing",
         "self_collisions")


def collapse(cfg):
    """Every random range of the config at a point."""
    ev = cfg.events
    ev["reset_base"].params["pose_range"] = {}
    ev["reset_base"].params["velocity_range"] = {}
    ev["push_robot"].interval_range_s = (0.05, 0.05)
    ev["push_robot"].params["velocity_range"] = {"x": (0.3, 0.3), "y": (-0.2, -0.2)}
    ev["foot_friction"].params["ranges"] = (0.7, 0.7)
    c = cfg.commands["twist"]
    c.resampling_time_range = (0.05, 0.05)
    c.rel_standing_envs = 0.0
    c.rel_heading_envs = 1.0
    c.ranges.lin_vel_x = (0.4, 0.4)
    c.ranges.lin_vel_y = (0.1, 0.1)
    c.ranges.heading = (0.3, 0.3)  # ang_vel_z: the heading controller's
    cfg.curriculum["command_vel"].params["velocity_stages"] = [
        {"step": 0, "lin_vel_x": (0.4, 0.4), "ang_vel_z": (-0.5, 0.5)}]
    cfg.observations["policy"].enable_corruption = False


def _np(x):
    return np.array(x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x,
                    np.float64)


@pytest.fixture(scope="module")
def run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MJLAB_TPU_ENGINE", "hybrid")
        jenv, penv = g1_env_pair(E, "float32", edit=collapse)
        jenv.reset()
        penv.reset()
        # env 0 tipped past fell_over's limit, env 1 one step before its
        # time-out
        a = math.radians(80.0) / 2
        q = np.array([math.cos(a), math.sin(a), 0.0, 0.0], np.float32)
        st = jenv._state
        jenv._state = st.replace(
            data=st.data.replace(qpos=st.data.qpos.at[0, 3:7].set(q)),
            episode_length=st.episode_length.at[1].set(jenv.max_episode_length - 1))
        qpos = penv.sim.data.qpos.clone()
        qpos[0, 3:7] = torch.as_tensor(q)
        penv.sim.data = penv.sim.data.replace(qpos=qpos)
        penv.episode_length_buf[1] = penv.max_episode_length - 1
        rs = np.random.default_rng(0)
        out = {"jax": [], "port": []}
        for _ in range(STEPS):
            act = (0.3 * rs.standard_normal((E, 29))).astype(np.float32)
            jo, jr, jterm, jtrunc, jex = jenv.step(jnp.asarray(act))
            po, pr, pterm, ptrunc, pex = penv.step(torch.as_tensor(act))
            js = jenv._state
            out["jax"].append(dict(
                policy=_np(jo["policy"]), critic=_np(jo["critic"]), reward=_np(jr),
                terminated=np.asarray(jterm), truncated=np.asarray(jtrunc),
                episode_length=np.asarray(js.episode_length),
                command=_np(js.command_state["twist"]["command"]),
                qpos=_np(js.data.qpos), qvel=_np(js.data.qvel), ctrl=_np(js.data.ctrl),
                sums={k: _np(v) for k, v in js.reward_state["episode_sums"].items()},
                log={k: _np(v) for k, v in jex["log"].items()}))
            rm = penv.reward_manager
            out["port"].append(dict(
                policy=_np(po["policy"]), critic=_np(po["critic"]), reward=_np(pr),
                terminated=pterm.numpy().copy(), truncated=ptrunc.numpy().copy(),
                episode_length=penv.episode_length_buf.numpy().copy(),
                command=_np(penv.command_manager.get_command("twist")),
                qpos=_np(penv.sim.data.qpos), qvel=_np(penv.sim.data.qvel),
                ctrl=_np(penv.sim.data.ctrl),
                sums={k: _np(v) for k, v in rm.episode_sums.items()},
                step_values={k: _np(v) for k, v in rm.step_values.items()},
                log={k: _np(v) for k, v in pex["log"].items()}))
        yield jenv, penv, out


@pytest.mark.parametrize("step", range(STEPS))
@pytest.mark.parametrize("what", ["qpos", "qvel", "ctrl", "policy", "critic", "reward",
                                  "command"])
def test_env_step_matches_jax(run, what, step):
    want, got = run[2]["jax"][step][what], run[2]["port"][step][what]
    assert want.shape == got.shape
    assert rel_err(want, got) < TOL[what], rel_err(want, got)


@pytest.mark.parametrize("step", range(STEPS))
def test_env_dones_and_episode_lengths_match_jax(run, step):
    want, got = run[2]["jax"][step], run[2]["port"][step]
    for k in ("terminated", "truncated", "episode_length"):
        np.testing.assert_array_equal(want[k], got[k], err_msg=k)


def test_first_step_resets_the_fallen_and_timed_out_envs(run):
    """fell_over fires for the tipped env, time_out for the late one, and
    the masked reset starts both episodes again, in both packages."""
    for side in ("jax", "port"):
        s = run[2][side][0]
        assert s["terminated"].tolist() == [True, False, False, False], side
        assert s["truncated"].tolist() == [False, True, False, False], side
        assert s["episode_length"].tolist() == [0, 0, 1, 1], side
    assert run[2]["port"][0]["log"]["Episode_Termination/fell_over"] == 0.5
    assert run[2]["port"][0]["log"]["Episode_Termination/time_out"] == 0.5


@pytest.mark.parametrize("term", TERMS)
def test_env_reward_terms_match_jax(run, term):
    """Each term's value in every step (the JAX episode sum's increment,
    in the envs that did not reset), and its episode sum."""
    jax_out, port_out = run[2]["jax"], run[2]["port"]
    prev = np.zeros(E)
    for t in range(STEPS):
        kept = ~(jax_out[t]["terminated"] | jax_out[t]["truncated"])
        inc = jax_out[t]["sums"][term] - prev
        got = port_out[t]["step_values"][term]
        assert rel_err(inc[kept], got[kept]) < TOL["step_value"], t
        assert rel_err(jax_out[t]["sums"][term], port_out[t]["sums"][term]) < TOL["episode_sum"]
        prev = jax_out[t]["sums"][term]


@pytest.mark.parametrize("step", range(STEPS))
def test_env_logs_match_jax(run, step):
    want, got = run[2]["jax"][step]["log"], run[2]["port"][step]["log"]
    assert set(want) == set(got)
    for k in want:
        assert rel_err(want[k], got[k]) < TOL["log"], k


def test_push_and_resample_fired(run):
    """The short intervals fired inside the run: the push's timer (0.05 s,
    0.02 s a step) went 0.03, 0.01, fire, 0.05, 0.03, 0.01; the command's
    (the reset and each step count it down) fired at step 2, and at step
    4 in envs 0 and 1, which restarted at step 1. Both equal JAX's."""
    jenv, penv, _ = run
    left = penv.event_manager.interval_left["push_robot"].numpy()
    np.testing.assert_allclose(left, 0.01, atol=1e-6)
    np.testing.assert_allclose(
        left, np.asarray(jenv._state.event_state["interval_left"]["push_robot"]), atol=1e-7)
    tl = penv.command_manager.get_term("twist").state["time_left"].numpy()
    np.testing.assert_allclose(tl, [0.01, 0.01, 0.05, 0.05], atol=1e-6)
    np.testing.assert_allclose(
        tl, np.asarray(jenv._state.command_state["twist"]["time_left"]), atol=1e-7)
    assert int(penv.common_step_counter) == STEPS


def test_command_flows_into_the_policy_observation(run):
    """The policy group ends with the 3-dim command term (tests/
    test_velocity_command.py), in both packages."""
    for side in ("jax", "port"):
        s = run[2][side][-1]
        np.testing.assert_allclose(s["policy"][:, -3:], s["command"], atol=1e-6)
        assert s["ctrl"].shape == (E, 29) and np.isfinite(s["ctrl"]).all()


def test_models_carry_the_same_quantities(run):
    """What the terms read of the two Models, named one by one: sizes,
    sensor rows, foot geoms, soft joint limits and default joint
    positions are equal."""
    jenv, penv, _ = run
    mj, pm = jenv.mj_model, penv.sim.model
    assert (mj.nq, mj.nv, mj.nu) == (pm.nq, pm.nv, pm.nu) == (36, 35, 29)
    assert sorted(jenv.scene.sensors) == sorted(penv.scene.sensors)
    for name, s in penv.scene.sensors.items():
        js = jenv.scene[name]
        if hasattr(js.cfg, "sensor_type"):
            assert (js.cfg.sensor_type, js.cfg.obj.name) == (s.cfg.sensor_type, s.cfg.obj.name)
    jr, pr = jenv.scene["robot"], penv.scene["robot"]
    jf = jenv.event_manager._modes["startup"][0][1].params["asset_cfg"]
    pf = penv.event_manager._modes["startup"][0][1].params["asset_cfg"]
    np.testing.assert_array_equal(np.asarray(jr.indexing.geom_ids)[np.asarray(jf.geom_ids)],
                                  pr.indexing.geom_ids[pf.geom_ids].numpy())
    assert jf.geom_names == pf.geom_names and len(pf.geom_names) == 14
    np.testing.assert_array_equal(np.asarray(jr.data.soft_joint_pos_limits),
                                  pr.data.soft_joint_pos_limits.numpy())
    np.testing.assert_array_equal(np.asarray(jr.data.default_joint_pos),
                                  pr.data.default_joint_pos.numpy())
    assert jr.joint_names == pr.joint_names and jr.actuator_joint_names == pr.actuator_joint_names


def test_dims_match_jax(run):
    jenv, penv, _ = run
    assert penv.action_manager.total_action_dim == 29
    assert penv.observation_manager.group_obs_dim("policy") == 99
    assert penv.observation_manager.group_obs_dim("critic") == \
        jenv.observation_manager.group_obs_dim("critic")
    assert penv.single_observation_space["critic"].shape == (
        jenv.observation_manager.group_obs_dim("critic"),)
    assert penv.max_episode_length == jenv.max_episode_length == 1000
    assert penv.step_dt == jenv.step_dt


def test_env_builds_and_steps_without_mujoco():
    """The port's env, from its registry, in a Python where importing
    mujoco fails (the card's machine has none): the Model comes from
    g1_velocity_flat.npz."""
    code = (
        "import sys; sys.modules['mujoco'] = None\n"
        "import torch\n"
        "from mjlab_tpu_torch.tasks import load_env_cfg\n"
        "from mjlab_tpu_torch.envs import ManagerBasedRlEnv\n"
        f"cfg = load_env_cfg({G1_TASK!r}); cfg.scene.num_envs = 2\n"
        "env = ManagerBasedRlEnv(cfg, device='cpu')\n"
        "obs, _ = env.reset()\n"
        "obs, rew, term, trunc, ex = env.step(torch.zeros(2, 29))\n"
        "assert obs['policy'].shape == (2, 99) and bool(torch.isfinite(rew).all())\n"
        "assert sys.modules['mujoco'] is None\n"
        "print('ok')\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=300, env={**os.environ, "MJLAB_QUIET": "1"})
    assert r.returncode == 0 and r.stdout.strip().endswith("ok"), r.stderr[-2000:]


def test_env_defaults_to_cuda():
    """Without a device the env runs on the card; with none it refuses
    rather than moving to the CPU."""
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    cfg = load_env_cfg(G1_TASK)
    cfg.scene.num_envs = 2
    if torch.cuda.is_available():
        assert ManagerBasedRlEnv(cfg).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            ManagerBasedRlEnv(cfg)


def test_registry_matches_jax():
    import mjlab_tpu.tasks as jtasks
    from mjlab_tpu_torch import tasks

    assert set(tasks.list_tasks()) <= set(jtasks.list_tasks())
    assert G1_TASK in tasks.list_tasks()
    play = tasks.load_env_cfg(G1_TASK, play=True)
    assert play.episode_length_s > 1e6
    assert play.observations["policy"].enable_corruption is False
    assert "push_robot" not in play.events and "randomize_terrain" not in play.events
    assert tasks.load_env_cfg(G1_TASK) is not tasks.load_env_cfg(G1_TASK)
    with pytest.raises(NotImplementedError):
        tasks.load_rl_cfg(G1_TASK)


def test_rough_terrain_and_nan_guard_raise():
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    cfg = load_env_cfg("Mjlab-Velocity-Rough-Unitree-G1")
    with pytest.raises(NotImplementedError, match="terrain"):
        ManagerBasedRlEnv(cfg, device="cpu")

    class _Guard:
        enabled = True

    cfg = load_env_cfg(G1_TASK)
    cfg.sim.nan_guard = _Guard()
    with pytest.raises(NotImplementedError, match="NaN guard"):
        ManagerBasedRlEnv(cfg, device="cpu")
