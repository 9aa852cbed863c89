"""The PyTorch port's model and data conversion against the JAX package.

mjlab_tpu_torch.phys.model.put_model and phys.data.make_data must produce
the same arrays as mjlab_tpu's put_model / make_data (array for array),
the port's scene must compile the same G1 flat-velocity MjModel as the JAX
Scene, and model_from_numpy / data_from_numpy must round-trip.
"""

import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.data import make_data as jax_make_data
from mjlab_tpu.phys.model import limit_rows_static as jax_limit_rows_static
from mjlab_tpu_torch.phys import data as pdata
from mjlab_tpu_torch.phys import model as pm
from mjlab_tpu_torch.scene.scene import g1_velocity_flat_model
from mjlab_tpu_torch.sim.sim import Simulation, SimulationCfg, check_supported

from torch_port_common import (
    G1_NCONMAX, TOY_NCONMAX, g1_mj, jax_put_model, port_model_from_jax, toy_mj,
)


@pytest.fixture
def x64():
    with jax.enable_x64(True):
        yield


def _models():
    return {
        "toy": (lambda: toy_mj(capsule=False), TOY_NCONMAX),
        "toy_capsule": (toy_mj, TOY_NCONMAX),
        "g1": (g1_mj, G1_NCONMAX),
    }


def _assert_static_equal(a, b, name):
    if isinstance(a, np.ndarray) or isinstance(b, np.ndarray):
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape, f"{name}: shape {a.shape} != {b.shape}"
        assert a.dtype == b.dtype, f"{name}: dtype {a.dtype} != {b.dtype}"
        np.testing.assert_array_equal(a, b, err_msg=name)
    else:
        assert a == b, f"{name}: {a!r} != {b!r}"


def assert_models_equal(jm, m):
    """Every array and every structural field of the JAX Model equals the
    port's, value and shape; float fields compared at the models' dtype."""
    for n in pm.tensor_fields():
        a = np.asarray(getattr(jm, n))
        b = getattr(m, n).numpy()
        assert a.shape == b.shape, f"{n}: shape {a.shape} != {b.shape}"
        np.testing.assert_array_equal(a, b, err_msg=n)
    for n in pm.static_fields():
        if n == "pairs":
            continue
        _assert_static_equal(getattr(jm, n), getattr(m, n), n)
    for f in dataclasses.fields(pm.PairTable):
        _assert_static_equal(
            getattr(jm.pairs, f.name), getattr(m.pairs, f.name),
            f"pairs.{f.name}",
        )
    for n in pm.OPTION_TENSOR_FIELDS:
        np.testing.assert_array_equal(
            np.asarray(getattr(jm.opt, n)), getattr(m.opt, n).numpy(), err_msg=n
        )
    for n in pm.OPTION_STATIC_FIELDS:
        assert getattr(jm.opt, n) == getattr(m.opt, n), f"opt.{n}"


@pytest.mark.parametrize("name", ["toy", "toy_capsule", "g1"])
def test_put_model_matches_jax_f64(name, x64):
    make, nconmax = _models()[name]
    mj = make()
    jm = jax_put_model(mj, dtype=jnp.float64, nconmax=nconmax)
    m = pm.put_model(mj, dtype=torch.float64, nconmax=nconmax, device="cpu")
    assert_models_equal(jm, m)


@pytest.mark.parametrize("name", ["toy", "g1"])
def test_put_model_matches_jax_f32(name):
    make, nconmax = _models()[name]
    mj = make()
    jm = jax_put_model(mj, dtype=jnp.float32, nconmax=nconmax)
    m = pm.put_model(mj, dtype=torch.float32, nconmax=nconmax, device="cpu")
    assert m.dtype == torch.float32 and m.device.type == "cpu"
    assert_models_equal(jm, m)


@pytest.mark.parametrize("name", ["toy", "g1"])
def test_limit_rows_static_matches_jax(name):
    make, nconmax = _models()[name]
    mj = make()
    jm = jax_put_model(mj, dtype=jnp.float32, nconmax=nconmax)
    m = pm.put_model(mj, dtype=torch.float32, nconmax=nconmax, device="cpu")
    got = pm.limit_rows_static(m)
    assert got.shape == (m.nlimit + m.nlimit_ten, m.nv) and m.nlimit
    np.testing.assert_array_equal(jax_limit_rows_static(jm), got)


def test_g1_model_sizes():
    """The G1 flat-velocity model as the slice runs it."""
    m = pm.put_model(g1_mj(), nconmax=G1_NCONMAX, device="cpu")
    assert (m.nq, m.nv, m.nu, m.nbody, m.ngeom) == (36, 35, 29, 32, 69)
    assert m.pairs.ncon == 533 and m.ncon_max == 35 and m.rows_per_con == 4
    assert m.nlimit == 29 and m.neq_jnt == 0 and m.nefc == 204
    assert int(m.opt.integrator) == pm.INT_IMPLICITFAST
    assert (m.opt.iterations, m.opt.ls_iterations) == (10, 20)
    assert float(m.opt.timestep) == pytest.approx(0.005)
    check_supported(m)


@pytest.mark.parametrize("name", ["toy", "g1"])
def test_make_data_matches_jax(name, x64):
    make, nconmax = _models()[name]
    mj = make()
    jm = jax_put_model(mj, dtype=jnp.float64, nconmax=nconmax)
    m = pm.put_model(mj, dtype=torch.float64, nconmax=nconmax, device="cpu")
    E = 3
    jd = jax_make_data(jm, dtype=jnp.float64)
    d = pdata.make_data(m, E)
    for name_ in pdata.tensor_fields():
        a = np.asarray(jd.contact.packed if name_ == "contact" else getattr(jd, name_))
        b = (d.contact.packed if name_ == "contact" else getattr(d, name_)).numpy()
        assert b.shape == (E,) + a.shape, f"{name_}: {b.shape} vs {a.shape}"
        assert b.dtype == np.dtype(a.dtype), f"{name_}: {b.dtype} vs {a.dtype}"
        for e in range(E):
            np.testing.assert_array_equal(a, b[e], err_msg=name_)


def test_g1_scene_matches_jax_scene():
    """g1_velocity_flat_model() compiles the MjModel the JAX Scene compiles
    for Mjlab-Velocity-Flat-Unitree-G1: every array put_model reads (and
    every other array attribute of MjModel) is equal."""
    import mjlab_tpu.tasks  # noqa: F401  (registers the tasks)
    from mjlab_tpu.scene.scene import Scene
    from mjlab_tpu.tasks.registry import load_env_cfg

    cfg = load_env_cfg("Mjlab-Velocity-Flat-Unitree-G1")
    mj_ref = Scene(cfg.scene).compile()
    mj = g1_velocity_flat_model()
    differ, n = [], 0
    for name in dir(mj_ref):
        if name.startswith("_"):
            continue
        a = getattr(mj_ref, name)
        if not isinstance(a, np.ndarray):
            continue
        n += 1
        b = getattr(mj, name)
        if a.shape != b.shape or not np.array_equal(a, b):
            differ.append(name)
    assert n > 100
    assert not differ, f"arrays differ: {differ}"
    # and the task's solver options applied the same way
    cfg.sim.mujoco.apply(mj_ref)
    mj_port = g1_mj()
    for f in ("timestep", "iterations", "ls_iterations", "integrator", "cone",
              "tolerance", "impratio"):
        assert getattr(mj_ref.opt, f) == getattr(mj_port.opt, f), f


def test_model_from_numpy_roundtrip():
    m = pm.put_model(toy_mj(), dtype=torch.float64, nconmax=TOY_NCONMAX,
                     device="cpu")
    fields, static = pm.model_to_numpy(m)
    m2 = pm.model_from_numpy(fields, static, dtype=torch.float64, device="cpu")
    for n in pm.tensor_fields():
        assert torch.equal(getattr(m, n), getattr(m2, n)), n
    for n in pm.static_fields():
        if n != "pairs":
            _assert_static_equal(getattr(m, n), getattr(m2, n), n)
    for f in dataclasses.fields(pm.PairTable):
        _assert_static_equal(getattr(m.pairs, f.name), getattr(m2.pairs, f.name), f.name)
    for n in pm.OPTION_TENSOR_FIELDS:
        assert torch.equal(getattr(m.opt, n), getattr(m2.opt, n)), n
    for n in pm.OPTION_STATIC_FIELDS:
        assert getattr(m.opt, n) == getattr(m2.opt, n), n


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_model_from_jax_leaves_matches_put_model(dtype):
    """The tests' route (JAX leaves -> model_from_numpy) and the port's own
    put_model give the same Model."""
    mj = g1_mj()
    with jax.enable_x64(dtype == np.float64):
        jm = jax_put_model(mj, dtype=jnp.dtype(dtype), nconmax=G1_NCONMAX)
        m_jax = port_model_from_jax(jm, dtype)
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    m = pm.put_model(mj, dtype=tdt, nconmax=G1_NCONMAX, device="cpu")
    for n in pm.tensor_fields():
        assert torch.equal(getattr(m, n), getattr(m_jax, n)), n


def test_data_from_numpy_roundtrip():
    m = pm.put_model(toy_mj(), nconmax=TOY_NCONMAX, device="cpu")
    d = pdata.make_data(m, 4)
    rng = np.random.default_rng(0)
    fields = {}
    for n in pdata.tensor_fields():
        x = (d.contact.packed if n == "contact" else getattr(d, n)).numpy().copy()
        if x.dtype == np.float32:
            x = x + rng.standard_normal(x.shape).astype(np.float32)
        fields[n] = x
    d2 = pdata.data_from_numpy(fields, device="cpu")
    for n in pdata.tensor_fields():
        got = (d2.contact.packed if n == "contact" else getattr(d2, n)).numpy()
        np.testing.assert_array_equal(got, fields[n], err_msg=n)
        assert got.dtype == fields[n].dtype


def test_cuda_device_is_explicit():
    """Entry points default to CUDA and never fall back to the CPU."""
    mj = toy_mj()
    if torch.cuda.is_available():
        m = pm.put_model(mj, nconmax=TOY_NCONMAX)
        assert m.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="cuda"):
            pm.put_model(mj, nconmax=TOY_NCONMAX)
        with pytest.raises(RuntimeError, match="cuda"):
            Simulation(4, SimulationCfg(nconmax=TOY_NCONMAX), mj)


_TENDON_XML = """
<mujoco>
  <worldbody>
    <geom type="plane" size="5 5 0.1"/>
    <body pos="0 0 0.5">
      <freejoint/>
      <geom type="sphere" size="0.1"/>
      <body pos="0.1 0 0">
        <joint name="a" type="hinge" axis="0 1 0" range="-1 1"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0 0 -0.3"/>
      </body>
    </body>
  </worldbody>
  <tendon><fixed name="t"><joint joint="a" coef="1"/></fixed></tendon>
  <actuator><motor joint="a"/></actuator>
</mujoco>
"""


_HFIELD_XML = """
<mujoco>
  <asset><hfield name="h" nrow="4" ncol="4" size="1 1 0.1 0.1"/></asset>
  <worldbody>
    <geom type="hfield" hfield="h"/>
    <body pos="0 0 0.3">
      <freejoint/>
      <geom type="sphere" size="0.05"/>
      <body pos="0.1 0 0">
        <joint name="a" type="hinge" axis="0 1 0" range="-1 1"/>
        <geom type="capsule" size="0.03" fromto="0 0 0 0 0 -0.3"/>
      </body>
    </body>
  </worldbody>
  <actuator><motor joint="a"/></actuator>
</mujoco>
"""

_WELD_XML = _TENDON_XML.replace(
    '<tendon><fixed name="t"><joint joint="a" coef="1"/></fixed></tendon>',
    '<equality><weld body1="world" body2="b"/></equality>',
).replace('<body pos="0.1 0 0">', '<body name="b" pos="0.1 0 0">')


@pytest.mark.parametrize(
    "case", ["tendon", "hfield_pair", "weld_equality", "activation"]
)
def test_simulation_raises_on_uncovered_models(case):
    """What the port does not carry yet: tendons, more than one height
    field (the port's height-field pair families take the one terrain, as
    the JAX package's), weld (and connect) equalities, activation
    states."""
    cfg = SimulationCfg(nconmax=8)
    if case == "tendon":
        mj = mujoco.MjModel.from_xml_string(_TENDON_XML)
    elif case == "hfield_pair":
        mj = mujoco.MjModel.from_xml_string(_HFIELD_XML.replace(
            "<asset>", '<asset><hfield name="h2" nrow="3" ncol="3" size="1 1 0.1 0.1"/>')
            .replace("<worldbody>", '<worldbody><geom type="hfield" hfield="h2" pos="3 0 0"/>'))
    elif case == "weld_equality":
        mj = mujoco.MjModel.from_xml_string(_WELD_XML)
    else:
        mj = mujoco.MjModel.from_xml_string(
            _TENDON_XML.replace('<tendon><fixed name="t"><joint joint="a" coef="1"/></fixed></tendon>', "")
            .replace('<motor joint="a"/>', '<general joint="a" dyntype="filter" dynprm="0.1"/>')
        )
    with pytest.raises(NotImplementedError):
        Simulation(2, cfg, mj, device="cpu")


@pytest.mark.parametrize("case", ["box_pair", "elliptic", "equality_mocap", "hfield_pair"])
def test_simulation_accepts_ported_features(case):
    """The box pair families, the elliptic cone, joint equalities, mocap
    bodies and the height-field pair families step on the CPU and stay
    finite."""
    from torch_port_common import yam_mj

    cfg = SimulationCfg(nconmax=TOY_NCONMAX)
    if case == "box_pair":
        mj = toy_mj(capsule=False)
    elif case == "elliptic":
        mj = toy_mj()
        cfg.mujoco.cone = "elliptic"
    elif case == "hfield_pair":
        mj = mujoco.MjModel.from_xml_string(_HFIELD_XML)
    else:
        mj = yam_mj()
        cfg = SimulationCfg(nconmax=55, mujoco=dataclasses.replace(
            cfg.mujoco, cone="elliptic", impratio=10.0))
        assert mj.nmocap == 1 and mj.neq == 1
    sim = Simulation(4, cfg, mj, device="cpu")
    for _ in range(2):
        sim.step()
    sim.refresh()
    assert torch.isfinite(sim.data.qpos).all()
    assert int(sim.data.ncheck_reset.sum()) == 0
    if case == "elliptic":
        assert sim.model.rows_per_con == 3 and int(sim.model.opt.cone) == 1


def test_check_supported_rejects_pyramidal_equality_on_cuda():
    """A joint equality under the pyramidal cone, which the card once
    refused, is now carried there too (csrc/newton_solve.cu takes equality
    rows): check_supported, which no longer depends on the device, accepts
    it, and so does a model without joint limits."""
    import torch_toy_models as toys

    eq = toys.convert("eq_toy")
    assert eq.neq_jnt == 1 and int(eq.opt.cone) == 0
    check_supported(eq)
    free = toys.convert("nolimit_toy")
    assert free.nlimit == 0
    check_supported(free)


def test_simulation_raises_on_batched_smooth_fields():
    """A per-env smooth field outside PER_ENV_SMOOTH_FIELDS is refused;
    body_mass per env is carried (tests/test_torch_dr_smooth.py)."""
    m = pm.put_model(toy_mj(), nconmax=TOY_NCONMAX, device="cpu")
    batched = dataclasses.replace(m, body_pos=m.body_pos.expand(4, -1, -1).clone())
    with pytest.raises(NotImplementedError, match="body_pos"):
        check_supported(batched)
    check_supported(dataclasses.replace(m, body_mass=m.body_mass.expand(4, -1).clone()))


def test_saved_g1_model_matches_fresh_conversion():
    """The G1 model file the chip run reads (no MuJoCo there) is the
    conversion of the scene compiled now, array for array, with the
    task's keyframe."""
    from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

    mj = g1_mj()
    m = pm.put_model(mj, dtype=torch.float64, nconmax=G1_NCONMAX, device="cpu")
    saved, key_qpos, key_ctrl = physics.load_saved_model(
        dtype=torch.float64, device="cpu"
    )
    for n in pm.tensor_fields():
        assert torch.equal(getattr(m, n), getattr(saved, n)), n
    for n in pm.static_fields():
        if n != "pairs":
            _assert_static_equal(getattr(m, n), getattr(saved, n), n)
    for f in dataclasses.fields(pm.PairTable):
        _assert_static_equal(
            getattr(m.pairs, f.name), getattr(saved.pairs, f.name), f.name
        )
    for n in pm.OPTION_TENSOR_FIELDS:
        assert torch.equal(getattr(m.opt, n), getattr(saved.opt, n)), n
    for n in pm.OPTION_STATIC_FIELDS:
        assert getattr(m.opt, n) == getattr(saved.opt, n), n
    np.testing.assert_array_equal(key_qpos, mj.key_qpos[0])
    np.testing.assert_array_equal(key_ctrl, mj.key_ctrl[0])


def _new_model_files():
    from mjlab_tpu_torch.tasks.velocity.config.g1 import physics as g1
    from mjlab_tpu_torch.tasks.velocity.config.go1 import physics as go1

    return {"g1_rough": ("Mjlab-Velocity-Rough-Unitree-G1", g1.ROUGH_MODEL),
            "go1_flat": ("Mjlab-Velocity-Flat-Unitree-Go1", go1.FLAT_MODEL),
            "go1_rough": ("Mjlab-Velocity-Rough-Unitree-Go1", go1.ROUGH_MODEL),
            "g1_tracking": ("Mjlab-Tracking-Flat-Unitree-G1", g1.SAVED_MODEL),
            "g1_jump": ("Mjlab-Jump-Flat-Unitree-G1", g1.SAVED_MODEL),
            "g1_jumping": ("Mjlab-Jumping-Flat-Unitree-G1", g1.SAVED_MODEL)}


@pytest.mark.parametrize("name", ["g1_rough", "go1_flat", "go1_rough", "g1_tracking", "g1_jump",
                                  "g1_jumping"])
def test_saved_velocity_model_files_match_fresh_conversions(name):
    """The rough G1 and the Go1 model files are the conversion of their
    task's scene compiled now (a rough scene with the smallest generated
    terrain, scene.model_file_scene_cfg), array for array, with the
    keyframe and the XML sensors. The G1 tracking task's scene (the G1 on a
    plane with the self-collision sensor alone, njmax 250) compiles to the
    flat velocity task's g1_velocity_flat.npz, which it loads; so do the
    jump tasks' scenes (the G1 on a plane with the feet's contact sensor),
    with the file's options as the Simulation applies the task's
    (MujocoCfg.apply_to: the jump task's dt 0.002). The jump task's crouch
    is the scene's keyframe, which the env does not read (the defaults come
    from the entity's init_state): the file keeps the knees-bent one."""
    from mjlab_tpu_torch.scene.scene import (
        Scene, model_file_scene_cfg, xml_sensors, xml_sensors_from_arrays,
    )
    from mjlab_tpu_torch.tasks import load_env_cfg

    task, path = _new_model_files()[name]
    cfg = load_env_cfg(task)
    assert cfg.scene.model_file == path
    mj = Scene(model_file_scene_cfg(cfg.scene)).compile()
    cfg.sim.mujoco.apply(mj)
    m = pm.put_model(mj, dtype=torch.float64, nconmax=cfg.sim.nconmax, device="cpu")
    saved, extra = pm.load_model(path, dtype=torch.float64, device="cpu")
    if name == "g1_jump":
        # the file keeps the velocity task's options; the Simulation applies
        # the jump task's (dt 0.002), as the fresh compile did
        assert float(saved.opt.timestep) == 0.005
        saved = cfg.sim.mujoco.apply_to(saved)
    for n in pm.tensor_fields():
        assert torch.equal(getattr(m, n), getattr(saved, n)), n
    for n in pm.static_fields():
        if n != "pairs":
            _assert_static_equal(getattr(m, n), getattr(saved, n), n)
    for f in dataclasses.fields(pm.PairTable):
        _assert_static_equal(getattr(m.pairs, f.name), getattr(saved.pairs, f.name), f.name)
    for n in pm.OPTION_TENSOR_FIELDS:
        assert torch.equal(getattr(m.opt, n), getattr(saved.opt, n)), n
    for n in pm.OPTION_STATIC_FIELDS:
        assert getattr(m.opt, n) == getattr(saved.opt, n), n
    if name == "g1_jump":
        robot = cfg.scene.entities["robot"].init_state
        assert mj.key_qpos[0][2] == robot.pos[2] != extra["key_qpos"][2]
    else:
        np.testing.assert_array_equal(extra["key_qpos"], mj.key_qpos[0])
        np.testing.assert_array_equal(extra["key_ctrl"], mj.key_ctrl[0])
    assert xml_sensors_from_arrays(extra) == xml_sensors(mj)
    assert saved.nhfield == ("rough" in name)
    assert (saved.nq, saved.nu) == ((36, 29) if name.startswith("g1") else (19, 12))


def test_simulation_from_saved_model_matches_mjmodel_route():
    """Simulation built from a converted Model applies the cfg's options
    as the MjModel route does, and refuses a different contact capacity."""
    from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

    saved, _, _ = physics.load_saved_model(device="cpu")
    a = Simulation(2, physics.sim_cfg(), saved, device="cpu")
    b = Simulation(2, physics.sim_cfg(), g1_velocity_flat_model(), device="cpu")
    for n in pm.OPTION_TENSOR_FIELDS:
        assert torch.equal(getattr(a.model.opt, n), getattr(b.model.opt, n)), n
    for n in pm.OPTION_STATIC_FIELDS:
        assert getattr(a.model.opt, n) == getattr(b.model.opt, n), n
    for n in pm.tensor_fields():
        assert torch.equal(getattr(a.model, n), getattr(b.model, n)), n
    with pytest.raises(ValueError, match="nconmax"):
        Simulation(2, SimulationCfg(nconmax=20), saved, device="cpu")


def test_save_load_model_roundtrip(tmp_path):
    m = pm.put_model(toy_mj(), dtype=torch.float64, nconmax=TOY_NCONMAX,
                     device="cpu")
    path = tmp_path / "toy.npz"
    pm.save_model(path, m, extra=np.arange(3.0))
    m2, extra = pm.load_model(path, dtype=torch.float64, device="cpu")
    np.testing.assert_array_equal(extra["extra"], np.arange(3.0))
    for n in pm.tensor_fields():
        assert torch.equal(getattr(m, n), getattr(m2, n)), n
    for n in pm.static_fields():
        if n != "pairs":
            _assert_static_equal(getattr(m, n), getattr(m2, n), n)


@pytest.mark.parametrize("against", ["port_spec", "jax_spec"])
def test_explicit_model_file_matches_fresh_conversions(against):
    """g1_velocity_flat_explicit.npz (tasks/velocity/config/g1/explicit.py:
    motors for the DC and PD groups, position actuators for the wrists) is
    the conversion of the explicit scene compiled now, array for array,
    with its keyframe and XML sensors: from the port's spec edits, and
    from the JAX package's (its twin's scene, torch_port_common
    .jax_explicit_env_cfg), whose MjModel converts to the same Model."""
    from mjlab_tpu_torch.scene.scene import (
        Scene, model_file_scene_cfg, xml_sensors, xml_sensors_from_arrays,
    )
    from mjlab_tpu_torch.tasks.velocity.config.g1 import explicit as X
    from torch_port_common import jax_explicit_env_cfg

    cfg = X.g1_explicit_env_cfg()
    if against == "port_spec":
        mj = Scene(model_file_scene_cfg(cfg.scene)).compile()
    else:
        from mjlab_tpu.scene import Scene as JaxScene

        mj = JaxScene(jax_explicit_env_cfg(1).scene).compile()
    cfg.sim.mujoco.apply(mj)
    m = pm.put_model(mj, dtype=torch.float64, nconmax=cfg.sim.nconmax, device="cpu")
    saved, extra = pm.load_model(X.EXPLICIT_MODEL, dtype=torch.float64, device="cpu")
    for n in pm.tensor_fields():
        assert torch.equal(getattr(m, n), getattr(saved, n)), n
    for n in pm.static_fields():
        if n != "pairs":
            _assert_static_equal(getattr(m, n), getattr(saved, n), n)
    for f in dataclasses.fields(pm.PairTable):
        _assert_static_equal(getattr(m.pairs, f.name), getattr(saved.pairs, f.name), f.name)
    np.testing.assert_array_equal(extra["key_qpos"], mj.key_qpos[0])
    np.testing.assert_array_equal(extra["key_ctrl"], mj.key_ctrl[0])
    assert xml_sensors_from_arrays(extra) == xml_sensors(mj)
    # motors (gain 1, no bias, ctrl and force limited) on every joint but
    # the four wrist pitch and yaw joints, which keep position actuators
    motor = (mj.actuator_biastype == 0) & (mj.actuator_ctrllimited == 1)
    assert int(motor.sum()) == 25 and int((~motor).sum()) == 4
