"""The control step (sim/sim.py ControlStep) on the CPU: its eager form, the
static Data buffers a captured graph reads and writes, and the G1's
env-side control step (tasks/velocity/config/g1/physics.py).

- ControlStep.eager() equals, bit for bit, four Simulation.step() calls and
  a refresh() of a twin Simulation (the G1 and the YAM physics), and the
  G1's env-side step equals the same calls written out (the robot's
  actuator controls, the step and the sensors' update per substep);
- once static, every write to sim.data (a step, a reset of a mask, a
  replace by the caller) lands in the same buffers, and a per-env field a
  DR event writes in place is the tensor the next step reads;
- capture() needs a CUDA device and replay() a capture; both raise
  otherwise (the captured graph itself runs on the card: tests/
  test_torch_cuda.py).
"""

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.phys.data import tensor_fields
from mjlab_tpu_torch.sim.sim import ControlStep, Simulation
from mjlab_tpu_torch.tasks.manipulation.config.yam import physics as yam
from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

E = 4


def _field(d, name):
    return d.contact.packed if name == "contact" else getattr(d, name)


def _g1_sim(seed=0):
    m, key_qpos, key_ctrl = physics.load_saved_model(dtype=torch.float64, device="cpu")
    sim = Simulation(E, physics.sim_cfg(), m, device="cpu")
    rng = np.random.default_rng(seed)
    q = np.tile(key_qpos, (E, 1))
    q[:, 7:] += 0.05 * rng.standard_normal((E, m.nq - 7))
    c = np.tile(key_ctrl, (E, 1))
    t = lambda x: torch.as_tensor(x, dtype=sim.dtype)  # noqa: E731
    sim.data = sim.data.replace(qpos=t(q), qvel=t(0.1 * rng.standard_normal((E, m.nv))),
                                ctrl=t(c))
    return sim


def _yam_sim(seed=0):
    m, st = yam.load_saved_model(dtype=torch.float64, device="cpu")
    sim = Simulation(E, yam.sim_cfg(), m, device="cpu")
    b = yam.task_states(sim.model, st, E, seed)
    sim.data = sim.data.replace(**{k: torch.as_tensor(v, dtype=sim.dtype)
                                   for k, v in b.items()})
    return sim


def _assert_data_equal(a, b):
    for name in tensor_fields():
        assert torch.equal(_field(a, name), _field(b, name)), name


@pytest.mark.parametrize("make", [_g1_sim, _yam_sim], ids=["g1", "yam"])
def test_eager_control_step_equals_four_steps_and_refresh(make):
    sim, twin = make(), make()
    step = ControlStep(sim, 4)
    for _ in range(2):
        step.eager()
        for _ in range(4):
            twin.step()
        twin.refresh()
    _assert_data_equal(sim.data, twin.data)
    assert int(sim.data.ncheck_reset.sum()) == 0


def test_g1_env_control_step_equals_its_calls():
    """physics.control_step: per substep the robot's actuator controls
    (ctrl from the joint position targets), the step and the sensors'
    update (air time), then the refresh."""
    sims = [_g1_sim(1), _g1_sim(1)]
    scenes = [physics.make_scene(s) for s in sims]
    rng = np.random.default_rng(2)
    target = torch.as_tensor(sims[0].data.ctrl.numpy()
                             + 0.2 * rng.standard_normal((E, 29)), dtype=torch.float32)
    for sc in scenes:
        sc["robot"].data.set_joint_position_target(target)
    step = physics.control_step(sims[0], scenes[0])
    assert step.decimation == physics.DECIMATION == 4
    step.eager()
    sim, scene = sims[1], scenes[1]
    for _ in range(4):
        scene.write_data_to_sim()
        sim.step()
        scene.update(0.005)
    sim.refresh()
    _assert_data_equal(sims[0].data, sim.data)
    for a, b in zip(scenes[0].state_tensors(), scene.state_tensors()):
        assert torch.equal(a, b)
    # ctrl holds the targets (the position actuators pass them through),
    # each actuator group's joints at its actuators' ids
    robot = scenes[0]["robot"]
    joints = [j for a in robot.actuators for j in a.joint_ids]
    ctrl = sims[0].data.ctrl[:, robot.indexing.ctrl_ids]
    assert torch.equal(ctrl, target[:, joints].double())


def test_static_data_is_written_in_place():
    sim = _g1_sim()
    step = ControlStep(sim, 4)
    ptrs = {n: _field(sim.data, n).data_ptr() for n in tensor_fields()}
    d_before = sim.data
    step.eager()
    sim.reset(np.array([True, False, True, False]))
    sim.data = sim.data.replace(ctrl=sim.data.ctrl + 0.1)
    assert sim.data is d_before
    assert {n: _field(sim.data, n).data_ptr() for n in tensor_fields()} == ptrs
    # the reset landed in the buffers: masked envs at qpos0, at rest
    assert torch.equal(sim.data.qpos[0], sim.model.qpos0)
    assert not torch.equal(sim.data.qpos[1], sim.model.qpos0)
    assert float(sim.data.qvel[2].abs().max()) == 0.0


def test_dr_write_between_steps_reaches_the_static_step():
    sim = _g1_sim()
    sim.expand_model_fields(["geom_friction"])
    step = ControlStep(sim, 4)
    gf = sim.model.geom_friction
    feet = [i for i, n in enumerate(sim.model.geom_names) if "_foot" in n]
    for value in (0.35, 1.15):
        gf[:, feet, 0] = value  # the event's in-place write
        step.eager()
        mu = sim.data.con_packed_c[..., 5][sim.data.con_sel_active]
        assert mu.numel() and torch.allclose(mu, torch.full_like(mu, value))
    assert sim.model.geom_friction is gf


def test_capture_needs_cuda_and_replay_needs_capture():
    sim = _yam_sim()
    step = ControlStep(sim, 4)
    with pytest.raises(RuntimeError, match="capture"):
        step.replay()
    with pytest.raises(RuntimeError, match="CUDA"):
        step.capture()


def test_warm_state_snapshot_covers_scene_state():
    """The buffers capture() puts back after its warm-up steps: every Data
    field and every entity and sensor state tensor."""
    sim = _g1_sim()
    scene = physics.make_scene(sim)
    step = physics.control_step(sim, scene)
    bufs = step._buffers()
    ids = {id(t) for t in bufs}
    assert len(bufs) == len(tensor_fields()) + len(scene.state_tensors())
    assert all(id(t) in ids for t in scene.state_tensors())


# ---------------------------------------------------------------------------
# the env's step on ControlStep (envs/manager_based_rl_env.py)
# ---------------------------------------------------------------------------


def test_control_step_hooks_run_in_order():
    """before(), decimation x (pre, step, post), after(); the default
    after() is the refresh (g1_capture's and yam_capture's order)."""
    sim = _g1_sim()
    calls = []
    step = ControlStep(sim, 4, pre_substep=lambda: calls.append("pre"),
                       post_substep=lambda: calls.append("post"),
                       before=lambda: calls.append("before"),
                       after=lambda: calls.append("after"))
    step.eager()
    assert calls == ["before"] + ["pre", "post"] * 4 + ["after"]
    assert ControlStep(_g1_sim(), 4).after.__func__ is Simulation.refresh


def test_last_substep_frames_are_the_start_state_refreshed():
    """frames_last: the last substep writes the frames of the state it
    started from (what mj_step leaves), equal to a refresh of that state;
    qpos and the rest of the step are those of a plain step."""
    a, b = _g1_sim(3), _g1_sim(3)
    before = _g1_sim(3)
    for s in (a, b, before):
        for _ in range(3):
            s.step()
    a.step(frames=True)
    b.step()
    before.refresh()
    for name in ("qpos", "qvel", "qacc", "con_sel", "con_force_c"):
        assert torch.equal(getattr(a.data, name), getattr(b.data, name)), name
    for name in ("xpos", "xquat", "xmat", "xipos", "ximat", "geom_xpos", "site_xpos",
                 "subtree_com", "cinert", "cdof", "cvel", "cdof_dot"):
        assert torch.equal(getattr(a.data, name), getattr(before.data, name)), name


def _env(seed=0, E=3):
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    cfg = load_env_cfg("Mjlab-Velocity-Flat-Unitree-G1")
    cfg.scene.num_envs = E
    cfg.seed = seed
    return ManagerBasedRlEnv(cfg, device="cpu")


def test_env_step_outputs_are_fixed_buffers():
    """step() returns the same tensors every step, written in place (a
    captured step's outputs); the action is copied into a fixed input."""
    env = _env()
    env.reset()
    act = torch.zeros(3, 29)
    first = env.step(act)
    ptrs = [first[0]["policy"].data_ptr(), first[0]["critic"].data_ptr(),
            first[1].data_ptr(), first[2].data_ptr(), first[3].data_ptr()]
    logs = {k: v.data_ptr() for k, v in first[4]["log"].items()}
    policy = first[0]["policy"].clone()
    second = env.step(act + 0.5)
    assert ptrs == [second[0]["policy"].data_ptr(), second[0]["critic"].data_ptr(),
                    second[1].data_ptr(), second[2].data_ptr(), second[3].data_ptr()]
    assert logs == {k: v.data_ptr() for k, v in second[4]["log"].items()}
    assert not torch.equal(policy, second[0]["policy"])
    assert torch.equal(env._action_in, act + 0.5)


def test_env_state_snapshot_covers_what_a_step_writes():
    """What capture() puts back after its warm-up steps (the Data and the
    env's state tensors, and the generator's state) is all a step
    changes: two steps, put back, then a step equals a twin's first."""
    env, twin = _env(seed=4), _env(seed=4)
    for e in (env, twin):
        e.reset()
    acts = [torch.full((3, 29), 0.3 * i) for i in range(3)]
    saved = [t.clone() for t in env._step._buffers()]
    drawn = env.rng.generator.get_state()
    env.step(acts[1])
    env.step(acts[2])
    for t, s in zip(env._step._buffers(), saved):
        t.copy_(s)
    env.rng.generator.set_state(drawn)
    out, want = env.step(acts[0]), twin.step(acts[0])
    for k in ("policy", "critic"):
        assert torch.equal(out[0][k], want[0][k]), k
    for i in (1, 2, 3):
        assert torch.equal(out[i], want[i])
    assert torch.equal(env.sim.data.qpos, twin.sim.data.qpos)
    assert {k: float(v) for k, v in out[4]["log"].items()} == \
        {k: float(v) for k, v in want[4]["log"].items()}


def test_env_captures_only_on_cuda():
    """On the CPU the env steps op by op; asking its ControlStep to capture
    raises (the graph runs on the card: tests/test_torch_cuda.py)."""
    env = _env()
    env.reset()
    env.step(torch.zeros(3, 29))
    assert not env.captured
    with pytest.raises(RuntimeError, match="CUDA"):
        env._step.capture()
