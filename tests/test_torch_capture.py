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
