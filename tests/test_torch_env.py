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
the port env of each of the four velocity tasks, with its play variant,
builds, resets and steps with MuJoCo blocked, that it runs on CUDA unless
asked for the CPU, the registry and the learners' configs, the ONNX
deployment metadata, what is not ported (a terrain type other than
plane and generator), and that an enabled NaN guard builds. The rough G1 and the Go1 envs are
held against the JAX package in tests/test_torch_env_rough.py and
tests/test_torch_env_go1.py.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from torch_port_common import (
    CHILD_THREADS, CHILD_TIMEOUT_S, G1_TASK, collapse_velocity_ranges, rel_err,
    run_velocity_env_pair, tip_and_time_out,
)

E = 4
STEPS = 5
TOL = {"qpos": 1e-4, "qvel": 1e-3, "ctrl": 1e-6, "policy": 1e-3, "critic": 5e-3, "reward": 1e-3,
       "step_value": 1e-3, "episode_sum": 1e-3, "command": 1e-4, "log": 5e-3}
TERMS = ("track_linear_velocity", "track_angular_velocity", "upright", "pose",
         "body_ang_vel", "angular_momentum", "dof_pos_limits", "action_rate_l2",
         "air_time", "foot_clearance", "foot_swing_height", "foot_slip", "soft_landing",
         "self_collisions")


@pytest.fixture(scope="module")
def run():
    yield run_velocity_env_pair(G1_TASK, E, STEPS, edit=collapse_velocity_ranges,
                                prepare=tip_and_time_out)


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


def test_base_metadata_matches_jax(run):
    """The ONNX deployment metadata: the port's from its Model (no
    MuJoCo), the JAX package's from the MjModel."""
    from mjlab_tpu.rl.exporter import get_base_metadata as jax_metadata
    from mjlab_tpu_torch.rl.exporter import get_base_metadata

    jenv, penv, _ = run
    want, got = jax_metadata(jenv, run_path="r"), get_base_metadata(penv, run_path="r")
    assert len(got["joint_names"]) == 29 and len(got["joint_stiffness"]) == 29
    assert got == want


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


VELOCITY_TASKS = ("Mjlab-Velocity-Flat-Unitree-G1", "Mjlab-Velocity-Rough-Unitree-G1",
                  "Mjlab-Velocity-Flat-Unitree-Go1", "Mjlab-Velocity-Rough-Unitree-Go1")
YAM_TASK = "Mjlab-Lift-Cube-Yam"
TRACKING_TASKS = ("Mjlab-Tracking-Flat-Unitree-G1",
                  "Mjlab-Tracking-Flat-Unitree-G1-No-State-Estimation")
JUMP_TASKS = ("Mjlab-Jump-Flat-Unitree-G1", "Mjlab-Jumping-Flat-Unitree-G1")
MOTION = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                      "evidence", "tracking_r4", "motion.npz")
# (action dim, policy obs dim) of each task's env, the JAX env's
# (tests/test_torch_env_yam.py holds the YAM's against it)
TASK_DIMS = {"G1": (29, 99), "Go1": (12, 48), "Yam": (7, 29),
             TRACKING_TASKS[0]: (29, 160), JUMP_TASKS[0]: (29, 103), JUMP_TASKS[1]: (29, 100)}


@pytest.mark.parametrize("task", VELOCITY_TASKS + (YAM_TASK, TRACKING_TASKS[0]) + JUMP_TASKS)
def test_env_builds_and_steps_without_mujoco(task):
    """The port's env of each ported task and its play variant, from its
    registry, in a Python where importing mujoco fails (the card's machine
    has none) and jax is never imported: the Model comes from the task's
    model file, a rough task's height field from the terrain the env
    generates, the tracking task's motion from MJLAB_TPU_MOTION_FILE."""
    code = (
        "import sys; sys.modules['mujoco'] = None\n"
        "import torch\n"
        "from mjlab_tpu_torch.tasks import load_env_cfg\n"
        "from mjlab_tpu_torch.envs import ManagerBasedRlEnv\n"
        "for play in (False, True):\n"
        f"    cfg = load_env_cfg({task!r}, play=play); cfg.scene.num_envs = 2\n"
        "    env = ManagerBasedRlEnv(cfg, device='cpu')\n"
        "    A = env.action_manager.total_action_dim\n"
        "    obs, _ = env.reset()\n"
        "    obs, rew, term, trunc, ex = env.step(torch.zeros(2, A))\n"
        "    assert bool(torch.isfinite(obs['policy']).all() and torch.isfinite(rew).all())\n"
        "    assert (env.sim.model.nhfield == 1) == ('rough' in env.cfg.scene.model_file.name)\n"
        "assert sys.modules['mujoco'] is None and 'jax' not in sys.modules\n"
        "print('ok', A, obs['policy'].shape[1])\n"
    )
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT_S,
                       env={**os.environ, "MJLAB_QUIET": "1", "MJLAB_TPU_MOTION_FILE": MOTION,
                            **CHILD_THREADS})
    assert r.returncode == 0 and r.stdout.strip().startswith("ok"), r.stderr[-2000:]
    want = TASK_DIMS.get(task) or TASK_DIMS[task.rsplit("-", 1)[1]]
    assert tuple(int(x) for x in r.stdout.split()[1:3]) == want


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

    # all nine of the JAX package's tasks
    assert set(tasks.list_tasks()) == set(jtasks.list_tasks())
    assert set(tasks.list_tasks()) == (set(VELOCITY_TASKS) | {YAM_TASK} | set(TRACKING_TASKS)
                                       | set(JUMP_TASKS))
    assert [t for t in jtasks.list_tasks() if "Velocity" in t] == sorted(VELOCITY_TASKS)
    assert [t for t in jtasks.list_tasks() if "Tracking" in t] == sorted(TRACKING_TASKS)
    for task in VELOCITY_TASKS + (YAM_TASK,) + TRACKING_TASKS + JUMP_TASKS:
        play = tasks.load_env_cfg(task, play=True)
        assert play.episode_length_s > 1e6
        assert play.observations["policy"].enable_corruption is False
        assert tasks.load_env_cfg(task).observations["policy"].enable_corruption is True
        assert "push_robot" not in play.events
        assert ("randomize_terrain" in play.events) == ("Rough" in task)
        assert tasks.load_env_cfg(task) is not tasks.load_env_cfg(task)
    # the YAM's play variant changes nothing else of the JAX package's
    jplay, play = jtasks.load_env_cfg(YAM_TASK, play=True), tasks.load_env_cfg(YAM_TASK, play=True)
    assert play.episode_length_s == jplay.episode_length_s == int(1e9)
    assert sorted(play.events) == sorted(jplay.events)
    assert play.observations["critic"].enable_corruption is False
    # the jump tasks: the JAX package's events (the jump play variant
    # clears them all), observation terms and simulation options (the jump
    # task at dt 0.002 and decimation 2, its episode 5 s)
    for task in JUMP_TASKS:
        for is_play in (False, True):
            jc, pc = (t.load_env_cfg(task, play=is_play) for t in (jtasks, tasks))
            assert sorted(jc.events) == sorted(pc.events)
            for g in ("policy", "critic"):
                assert list(jc.observations[g].terms) == list(pc.observations[g].terms)
            assert list(jc.rewards) == list(pc.rewards)
            assert {n: r.weight for n, r in jc.rewards.items()} == \
                {n: r.weight for n, r in pc.rewards.items()}
            assert list(jc.terminations) == list(pc.terminations)
            assert {n: c.params for n, c in jc.curriculum.items()} == \
                {n: c.params for n, c in pc.curriculum.items()}
            jm, pm_ = jc.sim.mujoco, pc.sim.mujoco
            assert (jc.sim.nconmax, jc.sim.njmax, jm.timestep, jc.decimation,
                    jc.episode_length_s, jc.scene.num_envs) == \
                (pc.sim.nconmax, pc.sim.njmax, pm_.timestep, pc.decimation,
                 pc.episode_length_s, pc.scene.num_envs)
    assert tasks.load_env_cfg(JUMP_TASKS[0], play=True).events == {}
    assert tasks.load_env_cfg(JUMP_TASKS[0]).decimation == 2
    # the tracking tasks' play variants: the motion from its start, no
    # noise; the observation groups the JAX package's, term for term
    for task in TRACKING_TASKS:
        for is_play in (False, True):
            jc, pc = (t.load_env_cfg(task, play=is_play) for t in (jtasks, tasks))
            jm, pmo = jc.commands["motion"], pc.commands["motion"]
            for f in ("sampling_mode", "pose_range", "velocity_range", "joint_position_range",
                      "anchor_body_name", "body_names", "adaptive_kernel_size",
                      "adaptive_lambda", "adaptive_uniform_ratio", "adaptive_alpha"):
                assert getattr(jm, f) == getattr(pmo, f), (task, f)
            assert sorted(jc.events) == sorted(pc.events)
            for g in ("policy", "critic"):
                assert list(jc.observations[g].terms) == list(pc.observations[g].terms)
            assert (jc.sim.nconmax, jc.sim.njmax) == (pc.sim.nconmax, pc.sim.njmax) == (35, 250)
        assert tasks.load_env_cfg(task, play=True).commands["motion"].sampling_mode == "start"
    # the learner's config and runner: the JAX task's, field for field, but
    # for the checkpoint file the port writes
    import dataclasses

    from mjlab_tpu_torch.tasks import registry
    from mjlab_tpu_torch.tasks.tracking.rl import MotionTrackingOnPolicyRunner
    from mjlab_tpu_torch.tasks.velocity.rl import VelocityOnPolicyRunner

    runners = {YAM_TASK: None, **{t: MotionTrackingOnPolicyRunner for t in TRACKING_TASKS},
               **{t: None for t in JUMP_TASKS}}
    for task in VELOCITY_TASKS + (YAM_TASK,) + TRACKING_TASKS + JUMP_TASKS:
        want = dataclasses.asdict(jtasks.load_rl_cfg(task))
        got = dataclasses.asdict(tasks.load_rl_cfg(task))
        assert want.pop("load_checkpoint") == "model_.*.ckpt"
        assert got.pop("load_checkpoint") == "model_.*.pt"
        assert got == want, task
        # the YAM and the jump tasks register no runner class (the train
        # CLI's OnPolicyRunner)
        assert tasks.load_runner_cls(task) is runners.get(task, VelocityOnPolicyRunner)
        assert (jtasks.load_runner_cls(task) is None) == (runners.get(task, 1) is None)
    # a task registered without a PPO config
    with pytest.MonkeyPatch.context() as mp:
        mp.setitem(registry._REGISTRY, "No-Learner",
                   registry.TaskEntry(env_cfg=dict, play_env_cfg=dict))
        with pytest.raises(NotImplementedError, match="no PPO config"):
            tasks.load_rl_cfg("No-Learner")


def test_rough_terrain_and_nan_guard_raise():
    """What the port's env refuses: a terrain type other than plane and
    generator, and a model file whose terrain is not the scene's. (Rough
    terrain itself builds: the rough tasks run in
    tests/test_torch_env_rough.py.) An enabled NaN guard, which the env
    refused until the guard was ported, builds."""
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    cfg = load_env_cfg("Mjlab-Velocity-Rough-Unitree-G1")
    cfg.scene.num_envs = 2
    cfg.scene.terrain.terrain_type = "mesh"
    with pytest.raises(NotImplementedError, match="terrain type 'mesh'"):
        ManagerBasedRlEnv(cfg, device="cpu")
    cfg = load_env_cfg("Mjlab-Velocity-Rough-Unitree-G1")
    cfg.scene.num_envs = 2
    cfg.scene.model_file = load_env_cfg(G1_TASK).scene.model_file
    with pytest.raises(ValueError, match="height fields"):
        ManagerBasedRlEnv(cfg, device="cpu")

    # an enabled NaN guard builds (it was refused before the guard was
    # ported): its windows are empty and nothing is detected yet
    from mjlab_tpu_torch.utils.nan_guard import NanGuardCfg

    cfg = load_env_cfg(G1_TASK)
    cfg.scene.num_envs = 2
    cfg.sim.nan_guard = NanGuardCfg(enabled=True, buffer_size=5)
    env = ManagerBasedRlEnv(cfg, device="cpu", capture=False)
    assert env.nan_guard is not None and not bool(env.nan_guard.stopped)
    assert env.nan_guard.windows()["qpos"].shape == (2, 5, env.sim.model.nq)
    assert env.nan_guard.dump_if_detected() is None
