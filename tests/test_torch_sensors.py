"""The port's sensors (mjlab_tpu_torch/sensor) against the JAX package's on
the same Data, at float64.

- builtin sensors: the four types the G1 XML declares (gyro, velocimeter,
  accelerometer on a site, subtreeangmom of a body), as the G1 velocity
  task's scene wraps them and on a toy with a rotated site, a ball and a
  hinge joint and a slide, within 1e-9 relative (the accelerometer's
  rne_postconstraint included); a type not ported yet raises
  NotImplementedError naming it;
- contact sensors: the G1 task's feet_ground_contact (subtree primary,
  terrain secondary, found and net force, air time) and self_collision
  (found, reduce none), and the ported reductions on the toy, within 1e-9;
- the air/contact-time state machine after a scripted found / not-found
  sequence, the masked reset included, equal to the JAX sensor's.
"""

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


@pytest.mark.parametrize("stype, kind", [("framepos", "site"), ("jointpos", "joint"),
                                         ("force", "site")])
def test_unported_builtin_type_raises(toy, stype, kind):
    _, _, pctx = toy
    name = {"site": "imu", "joint": "flex"}[kind]
    s = pbs.BuiltinSensor(pbs.BuiltinSensorCfg(sensor_type=stype,
                                               obj=pbs.ObjRef(kind, name)), None)
    with pytest.raises(NotImplementedError, match=stype):
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


@pytest.mark.parametrize("kw", [dict(reduce="maxforce"), dict(fields=("found", "pos"),
                                                               reduce="mindist")])
def test_unported_contact_reduction_raises(kw):
    with pytest.raises(NotImplementedError):
        pcs.ContactSensorCfg(name="x", primary=pcs.ContactMatch(), **kw)
