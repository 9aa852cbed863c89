"""The port's sensors (mjlab_tpu_torch/sensor) against the JAX package's on
the same Data, at float64, within 1e-9 relative (to max(1, |JAX|max)).

- builtin sensors: the four types the G1 XML declares (gyro, velocimeter,
  accelerometer on a site, subtreeangmom of a body), as the G1 velocity
  task's scene wraps them and on a toy with a rotated site, a ball and a
  hinge joint and a slide (the accelerometer's rne_postconstraint
  included);
- every builtin type but the tendon types on the JAX package's own
  sensor toy (tests/test_builtin_sensors.py: a free base on a plane,
  limited hinges with a spring and armature, sphere, capsule and box
  geoms, an obstacle, a magnetic field), its state settled by port steps
  and written whole by the port's forward(), some joints then past their
  range, and the same Data given to both packages: each case of the JAX
  test, force and torque on a site of a moving body, the joint-limit
  types on the joints past their range, upvector, reference frames, the
  cutoff, e_kinetic with dof_armature per env; the scene's wrap of every
  XML sensor of that model; the three tendon types raise
  NotImplementedError naming what they wait for;
- contact sensors: the G1 task's feet_ground_contact (subtree primary,
  terrain secondary, found and net force, air time) and self_collision
  (found, reduce none), the reductions on the REFRESH toy, and every
  reduction and field (maxforce, mindist with every field, none with a
  force and torque per slot, global_frame) on the sensor toy;
  pyramid_to_force; the JAX config's own ValueError for global_frame
  without normal and tangent;
- the air/contact-time state machine after a scripted found / not-found
  sequence, the masked reset included, equal to the JAX sensor's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.scene.scene import SimContext as JaxSimContext
from mjlab_tpu.sensor import builtin_sensor as jbs
from mjlab_tpu.sensor import contact_sensor as jcs
from mjlab_tpu_torch.scene.scene import SimContext
from mjlab_tpu_torch.sensor import builtin_sensor as pbs
from mjlab_tpu_torch.sensor import contact_sensor as pcs
from mjlab_tpu_torch.sim.sim import MujocoCfg, Simulation, SimulationCfg

from torch_port_common import (
    REFRESH_XML, TOY_NCONMAX, g1_scenes, jax_data_from_port, jax_put_model,
    rel_err, state_np, tnp,
)

E = 6
G1_BUILTIN = ("robot/imu_ang_vel", "robot/imu_lin_vel", "robot/imu_lin_acc",
              "robot/root_angmom")


@pytest.fixture(scope="module")
def g1():
    with jax.enable_x64(True):
        yield g1_scenes(E)


@pytest.mark.parametrize("name", G1_BUILTIN)
def test_g1_builtin_sensor_matches_jax(g1, name):
    jscene, ctx, _, scene = g1
    with jax.enable_x64(True):
        ref = np.asarray(jscene[name].data)
    got = tnp(scene[name].data)
    assert ref.shape == got.shape
    assert rel_err(ref, got) < 1e-9, f"{name}: {rel_err(ref, got):.2e}"
    assert np.abs(ref).max() > 1e-3  # a live signal, not zeros on both sides


def test_g1_scene_wraps_the_xml_sensors(g1):
    jscene, _, _, scene = g1
    for name in G1_BUILTIN:
        j, p = jscene[name].cfg, scene[name].cfg
        assert (p.sensor_type, p.obj.type, p.obj.name, p.cutoff) == (
            j.sensor_type, j.obj.type, j.obj.name, j.cutoff)


@pytest.mark.parametrize("field", ["found", "force", "current_air_time"])
def test_g1_feet_ground_contact_matches_jax(g1, field):
    jscene, _, _, scene = g1
    with jax.enable_x64(True):
        ref = np.asarray(getattr(jscene["feet_ground_contact"].data, field))
    got = tnp(getattr(scene["feet_ground_contact"].data, field))
    assert ref.shape == got.shape
    assert rel_err(ref, got) < 1e-9, f"{field}: {rel_err(ref, got):.2e}"
    if field != "current_air_time":
        assert np.abs(ref).max() > 0  # the feet touch the ground


def test_g1_contact_sensor_tables_match_jax(g1):
    jscene, _, _, scene = g1
    for name in ("feet_ground_contact", "self_collision"):
        j, p = jscene[name], scene[name]
        assert p.match_names == j.match_names, name
        np.testing.assert_array_equal(p.slot_table.numpy(), j.slot_table)
        np.testing.assert_array_equal(p.slot_mask.numpy(), j.slot_mask)
        np.testing.assert_array_equal(p.slot_sign.numpy(), j.slot_sign)


def test_g1_self_collision_matches_jax(g1):
    jscene, _, _, scene = g1
    with jax.enable_x64(True):
        ref = np.asarray(jscene["self_collision"].data.found)
    np.testing.assert_array_equal(ref, scene["self_collision"].data.found.numpy())


def test_g1_air_time_sequence_matches_jax(g1):
    """A scripted found / not-found sequence on both feet through the
    air-time state machine (update at the physics dt), then a masked
    reset: every state tensor equal to the JAX sensor's."""
    jscene, ctx, sim, scene = g1
    js, ps = jscene["feet_ground_contact"], scene["feet_ground_contact"]
    pt_table = ps.slot_table.numpy()
    found0 = sim.data.con_found.clone()
    rng = np.random.default_rng(3)
    dt = 0.005
    try:
        with jax.enable_x64(True):
            for _ in range(12):
                found = found0.numpy().copy()
                for e in range(E):
                    for mm in range(pt_table.shape[0]):
                        if rng.random() < 0.4:  # this foot leaves the ground
                            found[e, pt_table[mm]] = False
                sim.data = sim.data.replace(con_found=torch.as_tensor(found))
                ctx.data = ctx.data.replace(con_found=jnp.asarray(found))
                ps.update(scene.ctx, dt)
                js.update(ctx, dt)
            mask = np.array([True, False, True, False, False, True])
            ps.reset(scene.ctx, torch.as_tensor(mask))
            js.reset(ctx, jnp.asarray(mask))
            ref, got = js.data, ps.data
            for f in ("current_air_time", "current_contact_time", "last_air_time",
                      "last_contact_time"):
                r, g = np.asarray(getattr(ref, f)), tnp(getattr(got, f))
                assert rel_err(r, g) < 1e-12, f
                assert (r[mask] == 0).all()
            assert np.asarray(ref.last_air_time).max() > 0
            first = js.compute_first_contact(dt), js.compute_first_air(dt)
            np.testing.assert_array_equal(np.asarray(first[0]),
                                          ps.compute_first_contact(dt).numpy())
            np.testing.assert_array_equal(np.asarray(first[1]),
                                          ps.compute_first_air(dt).numpy())
    finally:
        sim.data = sim.data.replace(con_found=found0)


# ---------------------------------------------------------------------------
# the toy: a rotated site, ball, hinge and slide joints, a plane
# ---------------------------------------------------------------------------


TOY_SENSORS = {
    "gyro_imu": ("gyro", pbs.ObjRef("site", "imu")),
    "velo_imu": ("velocimeter", pbs.ObjRef("site", "imu")),
    "acc_imu": ("accelerometer", pbs.ObjRef("site", "imu")),
    "gyro_tip": ("gyro", pbs.ObjRef("site", "tip")),
    "velo_tip": ("velocimeter", pbs.ObjRef("site", "tip")),
    "acc_tip": ("accelerometer", pbs.ObjRef("site", "tip")),
    "angmom_base": ("subtreeangmom", pbs.ObjRef("body", "base")),
    "angmom_arm": ("subtreeangmom", pbs.ObjRef("body", "arm")),
}


@pytest.fixture(scope="module")
def toy():
    """(MjModel, JAX SimContext, port SimContext) on one float64 state after
    a few port steps (the base on the plane: contacts carry force)."""
    mj = mujoco.MjModel.from_xml_string(REFRESH_XML)
    sim = Simulation(E, SimulationCfg(nconmax=TOY_NCONMAX, mujoco=MujocoCfg(
        iterations=8, ls_iterations=12), dtype="float64"), mj, device="cpu")
    q, v, c = state_np(mj, E, seed=4, qpos_noise=0.2, qvel_noise=1.0)
    for j in range(mj.njnt):
        if mj.jnt_type[j] == mujoco.mjtJoint.mjJNT_BALL:
            a = mj.jnt_qposadr[j]
            q[:, a:a + 4] /= np.linalg.norm(q[:, a:a + 4], axis=1, keepdims=True)
    q[:, 2] = 0.09  # the base's sphere touches the plane
    rng = np.random.default_rng(5)
    xfrc = 0.3 * rng.standard_normal((E, mj.nbody, 6))
    sim.data = sim.data.replace(qpos=torch.as_tensor(q), qvel=torch.as_tensor(v),
                                xfrc_applied=torch.as_tensor(xfrc))
    for _ in range(3):
        sim.step()
    sim.refresh()
    with jax.enable_x64(True):
        jm = jax_put_model(mj, dtype=jnp.float64, nconmax=TOY_NCONMAX)
        jctx = JaxSimContext(jm, jax_data_from_port(sim.data))
    yield mj, jctx, SimContext(sim)


def _pair(cfg_j, cfg_p, mj, jctx, pctx, jcls, pcls):
    js = jcls(cfg_j, None)
    js.name = ps_name = getattr(cfg_p, "name", "") or "s"
    js.initialize(mj, E, jax.random.PRNGKey(0), jctx)
    ps = pcls(cfg_p, None)
    ps.name = ps_name
    ps.initialize(pctx)
    return js, ps


@pytest.mark.parametrize("name", list(TOY_SENSORS))
def test_toy_builtin_sensor_matches_jax(toy, name):
    mj, jctx, pctx = toy
    stype, obj = TOY_SENSORS[name]
    jcfg = jbs.BuiltinSensorCfg(sensor_type=stype, obj=jbs.ObjRef(obj.type, obj.name))
    pcfg = pbs.BuiltinSensorCfg(sensor_type=stype, obj=obj)
    with jax.enable_x64(True):
        js, ps = _pair(jcfg, pcfg, mj, jctx, pctx, jbs.BuiltinSensor, pbs.BuiltinSensor)
        ref = np.asarray(js.data)
    got = tnp(ps.data)
    assert rel_err(ref, got) < 1e-9, f"{name}: {rel_err(ref, got):.2e}"
    assert np.abs(ref).max() > 1e-3


def test_toy_cutoff_clips_like_jax(toy):
    mj, jctx, pctx = toy
    obj = pbs.ObjRef("site", "imu")
    jcfg = jbs.BuiltinSensorCfg(sensor_type="accelerometer",
                                obj=jbs.ObjRef("site", "imu"), cutoff=2.0)
    pcfg = pbs.BuiltinSensorCfg(sensor_type="accelerometer", obj=obj, cutoff=2.0)
    with jax.enable_x64(True):
        js, ps = _pair(jcfg, pcfg, mj, jctx, pctx, jbs.BuiltinSensor, pbs.BuiltinSensor)
        ref = np.asarray(js.data)
    assert np.abs(ref).max() == 2.0
    assert rel_err(ref, tnp(ps.data)) < 1e-9


@pytest.mark.parametrize("stype", ["tendonpos", "tendonvel", "tendonactuatorfrc"])
def test_unported_builtin_type_raises(toy, stype):
    """The tendon types wait for tendons (queue 1 item 4 of ROADMAP.md)."""
    _, _, pctx = toy
    s = pbs.BuiltinSensor(pbs.BuiltinSensorCfg(sensor_type=stype,
                                               obj=pbs.ObjRef("tendon", "t")), None)
    with pytest.raises(NotImplementedError, match=f"{stype}.*tendons.*queue 1 item 4"):
        s.initialize(pctx)


CONTACT_CASES = {
    "geom_netforce": dict(primary=("geom", ".*", None), fields=("found", "force", "torque", "dist"),
                          reduce="netforce", num_slots=1),
    "body_netforce_2slots": dict(primary=("body", "base", None), fields=("found", "force"),
                                 reduce="netforce", num_slots=2),
    "subtree_mindist": dict(primary=("subtree", "base", None), fields=("found", "dist"),
                            reduce="mindist", num_slots=2),
    "body_none_secondary_any": dict(primary=("body", "base|arm|wrist", ("world",)),
                                    fields=("found", "dist"), reduce="none", num_slots=1,
                                    secondary_policy="any"),
}


@pytest.mark.parametrize("case", list(CONTACT_CASES))
def test_toy_contact_sensor_matches_jax(toy, case):
    mj, jctx, pctx = toy
    kw = dict(CONTACT_CASES[case])
    mode, pattern, sec = kw.pop("primary")
    cfgs = []
    for mod in (jcs, pcs):
        secondary = None
        if sec is not None:
            secondary = mod.ContactMatch(mode="body", pattern=sec[0])
        cfgs.append(mod.ContactSensorCfg(
            name=case, primary=mod.ContactMatch(mode=mode, pattern=pattern),
            secondary=secondary, **kw))
    with jax.enable_x64(True):
        js, ps = _pair(cfgs[0], cfgs[1], mj, jctx, pctx, jcs.ContactSensor,
                       pcs.ContactSensor)
        ref = js.data
        for f in kw["fields"]:
            r, g = np.asarray(getattr(ref, f)), tnp(getattr(ps.data, f))
            assert r.shape == g.shape, f
            assert rel_err(r, g) < 1e-9, f"{f}: {rel_err(r, g):.2e}"
    assert np.asarray(ref.found).max() > 0


@pytest.mark.parametrize("kw", [
    dict(reduce="maxforce", fields=("found", "force"), global_frame=True),
    dict(reduce="mindist", fields=("torque", "normal"), global_frame=True),
])
def test_unported_contact_reduction_raises(kw):
    """global_frame with a force or torque per slot needs normal and
    tangent: the JAX config's ValueError, in both packages."""
    for mod in (jcs, pcs):
        with pytest.raises(ValueError, match="global_frame=True requires"):
            mod.ContactSensorCfg(name="x", primary=mod.ContactMatch(), **kw)


# ---------------------------------------------------------------------------
# the JAX package's sensor toy (tests/test_builtin_sensors.py): every type
# ---------------------------------------------------------------------------

SENSOR_TOY_E = 6
# the joints the forced state puts past their range, by env: the knee
# (range -2 .. 0.5) below in env 0 and above in env 2, the hip (-1 .. 1)
# above in env 4
PAST_RANGE = ((0, "knee", -2.2), (2, "knee", 0.7), (4, "hip", 1.15))


def _sensor_toy_cases():
    """(id, type, obj, ref) of every case of the JAX test (its CASES and
    jointlimitfrc), the types as (kind, name) pairs, and the cases this
    file adds: force and torque on a site of a moving body, the
    joint-limit types on the hip, upvector, a geom frame's quaternion."""
    from test_builtin_sensors import CASES

    def pair(o):
        return None if o is None else (o.type, o.name)

    cases = [(n, t, pair(o), pair(r)) for n, t, o, r in CASES]
    cases += [
        ("s_jlfrc", "jointlimitfrc", ("joint", "knee"), None),
        ("legtip_force", "force", ("site", "legtip"), None),
        ("legtip_torque", "torque", ("site", "legtip"), None),
        ("hip_jlpos", "jointlimitpos", ("joint", "hip"), None),
        ("hip_jlvel", "jointlimitvel", ("joint", "hip"), None),
        ("hip_jlfrc", "jointlimitfrc", ("joint", "hip"), None),
        ("knee_jafrc", "jointactuatorfrc", ("joint", "knee"), None),
        ("up_imu", "upvector", ("site", "imu"), None),
        ("fquat_geom", "framequat", ("geom", "footg"), ("body", "base")),
        ("flv_xbody_ref", "framelinvel", ("xbody", "foot"), ("geom", "legc")),
        ("stcom_base", "subtreecom", ("body", "base"), None),
        ("range_imu", "rangefinder", ("site", "imu"), None),
    ]
    return cases


SENSOR_TOY_CASES = _sensor_toy_cases()


@pytest.fixture(scope="module")
def sensor_toy():
    """(MjModel, JAX SimContext, port SimContext) on one float64 state of
    the sensor toy: 30 port steps from seeded velocities and controls,
    the joints of PAST_RANGE moved past their range, then the port's
    forward(), which writes the whole Data (actuator_length,
    qfrc_actuator and the limit rows included); the JAX context holds
    the same Data."""
    from test_builtin_sensors import XML

    mj = mujoco.MjModel.from_xml_string(XML)
    E = SENSOR_TOY_E
    sim = Simulation(E, SimulationCfg(nconmax=8, mujoco=MujocoCfg(
        iterations=30, ls_iterations=20), dtype="float64"), mj, device="cpu")
    rng = np.random.default_rng(3)
    q = np.tile(mj.qpos0, (E, 1))
    q[:, 0] += 0.05 * np.arange(E)
    sim.data = sim.data.replace(
        qpos=torch.as_tensor(q), qvel=torch.as_tensor(0.3 * rng.standard_normal((E, mj.nv))),
        ctrl=torch.as_tensor(0.3 * rng.standard_normal((E, mj.nu))))
    for _ in range(30):
        sim.step()
    q = sim.data.qpos.clone()
    for e, joint, value in PAST_RANGE:
        q[e, int(mj.jnt_qposadr[mj.joint(joint).id])] = value
    sim.data = sim.data.replace(qpos=q)
    sim.forward()
    with jax.enable_x64(True):
        jm = jax_put_model(mj, dtype=jnp.float64, nconmax=8)
        jctx = JaxSimContext(jm, jax_data_from_port(sim.data))
    yield mj, jctx, SimContext(sim)


def _builtin_pair(mj, jctx, pctx, stype, obj, ref=None, cutoff=0.0):
    """(JAX reading, port reading) of one sensor on the sensor toy."""
    def refs(mod, o):
        return None if o is None else mod.ObjRef(*o)

    with jax.enable_x64(True):
        js = jbs.BuiltinSensor(jbs.BuiltinSensorCfg(
            sensor_type=stype, obj=refs(jbs, obj), ref=refs(jbs, ref), cutoff=cutoff), None)
        js.initialize(mj, SENSOR_TOY_E, None, jctx)
        want = np.asarray(js.data)
    ps = pbs.BuiltinSensor(pbs.BuiltinSensorCfg(
        sensor_type=stype, obj=refs(pbs, obj), ref=refs(pbs, ref), cutoff=cutoff), None)
    ps.initialize(pctx)
    return want, tnp(ps.data)


@pytest.mark.parametrize("name, stype, obj, ref", SENSOR_TOY_CASES,
                         ids=[c[0] for c in SENSOR_TOY_CASES])
def test_sensor_toy_builtin_type_matches_jax(sensor_toy, name, stype, obj, ref):
    want, got = _builtin_pair(*sensor_toy, stype, obj, ref)
    assert want.shape == got.shape
    assert rel_err(want, got) < 1e-9, f"{name}: {rel_err(want, got):.2e}"
    if stype == "jointlimitfrc":
        assert np.abs(want).max() > 1e-3  # a live limit force
    if stype in ("jointlimitpos", "jointlimitvel", "jointlimitfrc"):
        # live on the envs whose joint the state put past its range
        past = sorted(e for e, j, _ in PAST_RANGE if j == obj[1])
        assert np.abs(want[past, 0]).min() > 0


def test_sensor_toy_covers_every_ported_type():
    assert {c[1] for c in SENSOR_TOY_CASES} == pbs.PORTED_TYPES


def test_sensor_toy_rangefinder_hits_and_misses(sensor_toy):
    """The "down" site's ray hits the floor in every env; the imu site's
    (its z axis tilted up and about) misses in some, reading -1 as in the
    JAX package."""
    down, _ = _builtin_pair(*sensor_toy, "rangefinder", ("site", "down"))
    assert (down > 0).all()
    up, got = _builtin_pair(*sensor_toy, "rangefinder", ("site", "imu"))
    np.testing.assert_array_equal(up == -1.0, got == -1.0)


def test_sensor_toy_cutoff_and_per_env_armature(sensor_toy):
    """framelinacc clipped at 3 by its cutoff in both packages; e_kinetic
    with dof_armature carried per env (each env its own scale)."""
    mj, jctx, pctx = sensor_toy
    want, got = _builtin_pair(mj, jctx, pctx, "framelinacc", ("site", "legtip"), cutoff=3.0)
    assert np.abs(want).max() == 3.0 and rel_err(want, got) < 1e-9
    sim = pctx.sim
    arm0 = sim.model.dof_armature
    scale = 1.0 + np.arange(SENSOR_TOY_E)[:, None]
    arm = np.asarray(arm0)[None] * scale + 0.01
    try:
        sim.model = dataclasses.replace(sim.model, dof_armature=torch.as_tensor(arm))
        with jax.enable_x64(True):
            jctx.model = jctx.model.replace(dof_armature=jnp.asarray(arm))
        want, got = _builtin_pair(mj, jctx, pctx, "e_kinetic", None)
        assert rel_err(want, got) < 1e-9
        assert np.unique(want).size == SENSOR_TOY_E
    finally:
        sim.model = dataclasses.replace(sim.model, dof_armature=arm0)
        with jax.enable_x64(True):
            jctx.model = jctx.model.replace(dof_armature=jnp.asarray(np.asarray(arm0)))


def test_sensor_toy_scene_wraps_every_xml_sensor(sensor_toy):
    """Every sensor row of the toy's XML wrapped by the port's scene
    (xml_sensors, from_xml_sensor) as the JAX scene wraps its spec's
    (from_spec_sensor): type, object, reference and cutoff, and the same
    reading."""
    from test_builtin_sensors import XML

    from mjlab_tpu_torch.scene.scene import xml_sensors

    mj, jctx, pctx = sensor_toy
    spec = mujoco.MjSpec.from_string(XML)
    rows = xml_sensors(mj)
    assert len(rows) == len(spec.sensors) == mj.nsensor
    for row, s in zip(rows, spec.sensors):
        assert row.name == s.name
        ps = pbs.BuiltinSensor.from_xml_sensor(None, row)
        ps.initialize(pctx)
        with jax.enable_x64(True):
            js = jbs.BuiltinSensor.from_spec_sensor(None, s)
            js.initialize(mj, SENSOR_TOY_E, None, jctx)
            want = np.asarray(js.data)
        jc, pc = js.cfg, ps.cfg
        assert pc.sensor_type == jc.sensor_type, row.name
        assert (pc.obj is None) == (jc.obj is None) and (pc.ref is None) == (jc.ref is None)
        if jc.obj is not None:
            assert (pc.obj.type, pc.obj.name) == (jc.obj.type, jc.obj.name), row.name
        if jc.ref is not None:
            assert (pc.ref.type, pc.ref.name) == (jc.ref.type, jc.ref.name), row.name
        assert pc.cutoff == jc.cutoff
        assert rel_err(want, tnp(ps.data)) < 1e-9, row.name


def test_sensor_toy_read_group_shares_rne_post(sensor_toy):
    """Inside a read group the acceleration and force sensors share one
    rne_postconstraint (the same tensors), and read what they read
    alone."""
    _, _, pctx = sensor_toy
    sensors = []
    for stype, obj in (("accelerometer", "imu"), ("force", "legtip"), ("torque", "legtip")):
        ps = pbs.BuiltinSensor(pbs.BuiltinSensorCfg(sensor_type=stype,
                                                    obj=pbs.ObjRef("site", obj)), None)
        ps.initialize(pctx)
        sensors.append(ps)
    alone = [tnp(s.data) for s in sensors]
    with pctx.read_group():
        first = pctx.rne_post()
        assert pctx.rne_post() is first
        grouped = [tnp(s.data) for s in sensors]
    assert pctx.rne_post() is not first
    for a, b in zip(alone, grouped):
        np.testing.assert_array_equal(a, b)


SENSOR_TOY_CONTACTS = {
    "maxforce_all_fields": dict(primary=("subtree", "base"), reduce="maxforce", num_slots=2,
                                fields=("found", "force", "torque", "dist", "pos", "normal",
                                        "tangent")),
    "mindist_all_fields": dict(primary=("geom", ".*"), reduce="mindist", num_slots=1,
                               fields=("found", "force", "torque", "dist", "pos", "normal",
                                       "tangent")),
    "none_force_torque": dict(primary=("body", "leg|foot|base"), reduce="none", num_slots=2,
                              fields=("found", "force", "torque")),
    "mindist_global_frame": dict(primary=("body", "base|foot"), reduce="mindist", num_slots=2,
                                 fields=("found", "force", "torque", "pos", "normal", "tangent"),
                                 global_frame=True),
    "maxforce_floor_secondary": dict(primary=("body", "foot|leg"), secondary="floor",
                                     reduce="maxforce", num_slots=1,
                                     fields=("found", "force", "normal", "tangent")),
    "netforce_floor": dict(primary=("subtree", "base"), secondary="floor", reduce="netforce",
                           num_slots=2, fields=("found", "force", "torque", "pos")),
}


@pytest.mark.parametrize("case", list(SENSOR_TOY_CONTACTS))
def test_sensor_toy_contact_sensor_matches_jax(sensor_toy, case):
    mj, jctx, pctx = sensor_toy
    kw = dict(SENSOR_TOY_CONTACTS[case])
    mode, pattern = kw.pop("primary")
    sec = kw.pop("secondary", None)
    cfgs = [mod.ContactSensorCfg(
        name=case, primary=mod.ContactMatch(mode=mode, pattern=pattern),
        secondary=None if sec is None else mod.ContactMatch(mode="geom", pattern=sec), **kw)
        for mod in (jcs, pcs)]
    with jax.enable_x64(True):
        js, ps = _pair(cfgs[0], cfgs[1], mj, jctx, pctx, jcs.ContactSensor, pcs.ContactSensor)
        ref = js.data
        for f in kw["fields"]:
            r, g = np.asarray(getattr(ref, f)), tnp(getattr(ps.data, f))
            assert r.shape == g.shape, f
            assert rel_err(r, g) < 1e-9, f"{f}: {rel_err(r, g):.2e}"
    assert np.asarray(ref.found).max() > 0
    if "force" in kw["fields"]:
        assert np.abs(np.asarray(ref.force)).max() > 1e-3  # the solver's forces


def test_pyramid_to_force_matches_jax():
    rs = np.random.default_rng(11)
    mu = rs.uniform(0.2, 1.0, (4, 5))
    for dim, nrows in ((1, 1), (3, 4), (4, 6), (6, 10)):
        rows = rs.uniform(0.0, 2.0, (4, nrows))
        with jax.enable_x64(True):
            want = np.asarray(jcs.pyramid_to_force(dim, jnp.asarray(mu), jnp.asarray(rows)))
        got = tnp(pcs.pyramid_to_force(dim, torch.as_tensor(mu), torch.as_tensor(rows)))
        assert want.shape == got.shape == (4, dim)
        assert rel_err(want, got) < 1e-12
