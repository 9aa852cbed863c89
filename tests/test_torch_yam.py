"""The YAM lift-cube physics (Mjlab-Lift-Cube-Yam) in the PyTorch port
against the JAX package: the scene and model conversion, the model file
the card's machine reads, the mocap base in Data, kinematics with mocap
frames, the contact stack (the four box families, condim 6 fingertips,
the elliptic cone's slot tensors, the joint equality row) and the
kinematic refresh.

Tolerances: model arrays exactly equal; f64 parity 1e-9 relative to
max(1, |ref|max), the top-K contact selection exactly equal, ties
included (tests/test_torch_stages.py, tests/test_torch_contact.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.data import make_data as jax_make_data
from mjlab_tpu.phys.lm import stages as jst
from mjlab_tpu.phys.smooth_pallas import SYM6, HostParams
from mjlab_tpu_torch.phys import model as pm
from mjlab_tpu_torch.phys import smooth_kernels as sk
from mjlab_tpu_torch.phys.data import make_data
from mjlab_tpu_torch.phys.lm import stages
from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.phys.model import (
    GEOM_BOX, GEOM_CAPSULE, GEOM_PLANE, GEOM_SPHERE,
)
from mjlab_tpu_torch.scene.scene import yam_lift_cube_model
from mjlab_tpu_torch.sim.sim import Simulation, check_supported
from mjlab_tpu_torch.tasks.manipulation.config.yam import physics as yam

from test_torch_contact import _run_both, check_contact_stack
from test_torch_model import _assert_static_equal, assert_models_equal
from test_torch_step import _assert_refresh_equal, _vmapped_refresh
from torch_port_common import (
    YAM_NCONMAX, jax_put_model, model_pair, rel_err, tnp, yam_mj, yam_states,
)


def test_yam_scene_matches_jax_scene():
    """yam_lift_cube_model() compiles the MjModel the JAX Scene compiles
    for Mjlab-Lift-Cube-Yam (its contact sensor adds no MjModel array)."""
    import mjlab_tpu.tasks  # noqa: F401  (registers the tasks)
    from mjlab_tpu.scene.scene import Scene
    from mjlab_tpu.tasks.registry import load_env_cfg

    cfg = load_env_cfg("Mjlab-Lift-Cube-Yam")
    mj_ref = Scene(cfg.scene).compile()
    mj = yam_lift_cube_model()
    differ, n = [], 0
    for name in dir(mj_ref):
        a = getattr(mj_ref, name)
        if name.startswith("_") or not isinstance(a, np.ndarray):
            continue
        n += 1
        b = getattr(mj, name)
        if a.shape != b.shape or not np.array_equal(a, b):
            differ.append(name)
    assert n > 100
    assert not differ, f"arrays differ: {differ}"
    cfg.sim.mujoco.apply(mj_ref)
    mj_port = yam_mj()
    for f in ("timestep", "iterations", "ls_iterations", "integrator", "cone",
              "tolerance", "impratio"):
        assert getattr(mj_ref.opt, f) == getattr(mj_port.opt, f), f
    assert cfg.sim.nconmax == YAM_NCONMAX


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_yam_put_model_matches_jax(dtype):
    mj = yam_mj()
    tdt = torch.float64 if dtype == np.float64 else torch.float32
    with jax.enable_x64(dtype == np.float64):
        jm = jax_put_model(mj, dtype=jnp.dtype(dtype), nconmax=YAM_NCONMAX)
        m = pm.put_model(mj, dtype=tdt, nconmax=YAM_NCONMAX, device="cpu")
        assert_models_equal(jm, m)


def test_yam_model_sizes():
    """The model as the lift-cube task runs it."""
    m = pm.put_model(yam_mj(), nconmax=YAM_NCONMAX, device="cpu")
    assert (m.nq, m.nv, m.nu, m.nbody, m.ngeom) == (15, 14, 7, 17, 56)
    assert (m.nmocap, m.neq_jnt, m.nlimit) == (1, 1, 8)
    assert m.pairs.ncon == 313 and m.ncon_max == 55 and m.rows_per_con == 6
    assert m.nefc == 353 and int(m.opt.cone) == pm.CONE_ELLIPTIC
    assert float(m.opt.impratio) == 10.0
    assert (m.na, m.ntendon, m.nmesh) == (0, 0, 17)
    fams = {(int(a), int(b)) for a, b in zip(
        m.geom_type[m.pairs.geom1], m.geom_type[m.pairs.geom2])}
    assert {(GEOM_PLANE, GEOM_BOX), (GEOM_SPHERE, GEOM_BOX),
            (GEOM_CAPSULE, GEOM_BOX), (GEOM_BOX, GEOM_BOX)} <= fams
    check_supported(m)


def test_saved_yam_model_matches_fresh_conversion():
    """The model file the card's machine reads (it has no MuJoCo) is the
    conversion of the scene compiled now, with the task's initial state."""
    mj = yam_mj()
    m = pm.put_model(mj, dtype=torch.float64, nconmax=YAM_NCONMAX, device="cpu")
    saved, state = yam.load_saved_model(dtype=torch.float64, device="cpu")
    for n in pm.tensor_fields():
        assert torch.equal(getattr(m, n), getattr(saved, n)), n
    for n in pm.static_fields():
        if n != "pairs":
            _assert_static_equal(getattr(m, n), getattr(saved, n), n)
    for f in dataclasses.fields(pm.PairTable):
        _assert_static_equal(
            getattr(m.pairs, f.name), getattr(saved.pairs, f.name), f.name
        )
    for n in pm.OPTION_STATIC_FIELDS:
        assert getattr(m.opt, n) == getattr(saved.opt, n), n
    fresh = yam.initial_state(mj)
    assert sorted(state) == sorted(fresh)
    for k in fresh:
        np.testing.assert_array_equal(state[k], fresh[k], err_msg=k)
    # the robot at its home keyframe, the cube on the table
    np.testing.assert_array_equal(state["qpos"][8:11], yam.CUBE_POS)
    np.testing.assert_array_equal(state["mocap_pos"][0], (0.0, 0.0, 0.01))


def test_yam_action_scale_matches_jax():
    """The task's action scale, read from the model, is the JAX package's
    YAM_ACTION_SCALE, actuator by actuator."""
    import re

    from mjlab_tpu.asset_zoo.robots.i2rt_yam.yam_constants import YAM_ACTION_SCALE

    m, _ = yam.load_saved_model(dtype=torch.float64, device="cpu")
    scale = yam.action_scale(m).numpy()
    assert scale.shape == (m.nu,)
    for u in range(m.nu):
        joint = m.joint_names[m.actuator_trnid[u, 0]].split("/")[-1]
        want = [v for k, v in YAM_ACTION_SCALE.items() if re.fullmatch(k, joint)]
        assert len(want) == 1, joint
        np.testing.assert_allclose(scale[u], want[0], rtol=1e-12, err_msg=joint)


def test_yam_reset_states_are_the_tasks_reset():
    """reset_states: the robot at its home keyframe and at rest, the cube at
    rest at the lifting command's draw, inside its position range and
    turned by a yaw in its range (the JAX package's quat_from_euler_xyz)."""
    from mjlab_tpu.utils.math import quat_from_euler_xyz

    E = 64
    m, st = yam.load_saved_model(dtype=torch.float64, device="cpu")
    b = yam.reset_states(m, st, E, seed=5)
    adr = int(m.jnt_qposadr[list(m.joint_names).index("cube/cube_joint")])
    tile = lambda x: np.tile(x, (E,) + (1,) * np.ndim(x))  # noqa: E731
    np.testing.assert_array_equal(b["qpos"][:, :adr], tile(st["qpos"][:adr]))
    for k in ("ctrl", "mocap_pos", "mocap_quat"):
        np.testing.assert_array_equal(b[k], tile(st[k]), err_msg=k)
    assert b["qvel"].shape == (E, m.nv) and not b["qvel"].any()
    pos, quat = b["qpos"][:, adr:adr + 3], b["qpos"][:, adr + 3:adr + 7]
    lo, hi = np.array(yam.CUBE_RESET_POS).T
    assert ((pos >= lo) & (pos <= hi)).all()
    assert np.ptp(pos, axis=0).min() > 0.5 * (hi - lo).min()
    yaw = 2 * np.arctan2(quat[:, 3], quat[:, 0])
    assert (yaw >= yam.CUBE_RESET_YAW[0]).all() and (yaw <= yam.CUBE_RESET_YAW[1]).all()
    with jax.enable_x64(True):
        z = jnp.zeros(E, jnp.float64)
        ref = np.asarray(quat_from_euler_xyz(z, z, jnp.asarray(yaw)))
    np.testing.assert_allclose(quat, ref, atol=1e-15)
    again = yam.reset_states(m, st, E, seed=5)
    np.testing.assert_array_equal(again["qpos"], b["qpos"])
    assert not np.array_equal(yam.reset_states(m, st, E, seed=6)["qpos"], b["qpos"])


def test_yam_task_traffic_steps_on_cpu():
    """Two control steps of the task's traffic (reset, random actions 0.5
    N(0, 1) times the action scale around the home targets) through
    Simulation on the CPU: finite, no diverged-state resets, the cube
    falling onto the table."""
    E = 8
    m, st = yam.load_saved_model(device="cpu")
    sim = Simulation(E, yam.sim_cfg(), m, device="cpu")
    sim.reset()
    b = yam.reset_states(m, st, E, seed=2)
    sim.data = sim.data.replace(**{
        k: torch.as_tensor(v, dtype=torch.float32) for k, v in b.items()
    })
    adr = int(m.jnt_qposadr[list(m.joint_names).index("cube/cube_joint")])
    z0 = sim.data.qpos[:, adr + 2].clone()
    gen = torch.Generator().manual_seed(0)
    ctrl0, scale = sim.data.ctrl.clone(), yam.action_scale(m)
    for _ in range(2):
        ctrl = ctrl0 + 0.5 * scale * torch.randn(ctrl0.shape, generator=gen)
        sim.data = sim.data.replace(ctrl=ctrl)
        for _ in range(4):
            sim.step()
        sim.refresh()
    d = sim.data
    assert torch.isfinite(d.qpos).all() and int(d.ncheck_reset.sum()) == 0
    assert bool((d.qpos[:, adr + 2] <= z0 + 1e-6).all())


def test_yam_data_mocap_at_body_frames_and_reset():
    """Fresh Data (and a reset) put the mocap frames at their bodies'
    model frames, as mj_resetData; for the YAM that is the JAX package's
    make_data (the base body sits at the origin)."""
    mj = yam_mj()
    with jax.enable_x64(True):
        jm = jax_put_model(mj, dtype=jnp.float64, nconmax=YAM_NCONMAX)
        jd = jax_make_data(jm, dtype=jnp.float64)
    m = pm.put_model(mj, dtype=torch.float64, nconmax=YAM_NCONMAX, device="cpu")
    d = make_data(m, 3)
    b = int(np.flatnonzero(m.body_mocapid >= 0)[0])
    for e in range(3):
        np.testing.assert_array_equal(d.mocap_pos[e].numpy(), np.asarray(jd.mocap_pos))
        np.testing.assert_array_equal(d.mocap_quat[e].numpy(), np.asarray(jd.mocap_quat))
        np.testing.assert_array_equal(d.mocap_pos[e, 0].numpy(), mj.body_pos[b])
    sim = Simulation(4, yam.sim_cfg(), m, device="cpu")
    sim.data = sim.data.replace(
        mocap_pos=sim.data.mocap_pos + 0.1, mocap_quat=sim.data.mocap_quat * 0.5
    )
    sim.reset(np.array([True, False, True, False]))
    assert torch.equal(sim.data.mocap_pos[0], d.mocap_pos[0].float())
    assert torch.equal(sim.data.mocap_pos[1], d.mocap_pos[0].float() + 0.1)
    assert torch.equal(sim.data.mocap_quat[2], d.mocap_quat[0].float())


def _mocap_inputs(m, E, seed=3):
    """Seeded mocap frames: the home pose moved and turned."""
    rng = np.random.default_rng(seed)
    mp = np.array([0.0, 0.0, 0.01]) + 0.05 * rng.standard_normal((E, m.nmocap, 3))
    mq = np.array([1.0, 0.0, 0.0, 0.0]) + 0.2 * rng.standard_normal((E, m.nmocap, 4))
    return mp, mq / np.linalg.norm(mq, axis=-1, keepdims=True)


def test_yam_kinematics_with_mocap_matches_jax_f64():
    """stages.kinematics_lm (every body, geom and site) and the plain
    kin_com with the mocap frames against the JAX package's lm stages."""
    E = 8
    with jax.enable_x64(True):
        jm, m = model_pair(yam_mj(), YAM_NCONMAX, np.float64)
        q, _, _, _, _ = yam_states(m, E)
        mp, mq = _mocap_inputs(m, E)
        jp = lambda x: tuple(jnp.asarray(x[:, i]) for i in range(x.shape[1]))  # noqa: E731
        tp = lambda x: tuple(torch.as_tensor(x[:, i]) for i in range(x.shape[1]))  # noqa: E731
        kj = jst.kinematics_lm(
            jm, HostParams(jm, E), jp(q), [jp(mp[:, i]) for i in range(m.nmocap)],
            [jp(mq[:, i]) for i in range(m.nmocap)],
        )
        kp = stages.kinematics_lm(
            m, Params(m, E), tp(q), [tp(mp[:, i]) for i in range(m.nmocap)],
            [tp(mq[:, i]) for i in range(m.nmocap)],
        )
        for key in ("xpos", "xquat", "xmat", "xipos", "ximat", "xanchor",
                    "xaxis", "geom_xpos", "geom_xmat", "site_xpos", "site_xmat"):
            a = np.stack([np.stack([np.broadcast_to(np.asarray(c), (E,)) for c in x])
                          for x in kj[key]])
            b = np.stack([np.stack([np.broadcast_to(tnp(c), (E,)) for c in x])
                          for x in kp[key]])
            assert rel_err(a, b) < 1e-9, key
        # the base follows its mocap frame
        base = int(np.flatnonzero(m.body_mocapid >= 0)[0])
        np.testing.assert_allclose(np.stack([tnp(c) for c in kp["xpos"][base]], -1), mp[:, 0])

        kj = jst.com_pos_lm(jm, HostParams(jm, E), jst.kinematics_lm(
            jm, HostParams(jm, E), jp(q), [jp(mp[:, 0])], [jp(mq[:, 0])],
            geoms=sk.collision_geoms(m), sites=(),
        ))
        T = lambda x: torch.as_tensor(np.ascontiguousarray(x))  # noqa: E731
        outs = sk.kin_com(m, T(q.T), T(np.moveaxis(mp, 0, -1)), T(np.moveaxis(mq, 0, -1)))
        st = lambda planes: np.stack([np.broadcast_to(np.asarray(p), (E,)) for p in planes])  # noqa: E731
        ref = dict(
            gxpos=np.stack([st(kj["geom_xpos"][g]) for g in sk.collision_geoms(m)]),
            gxmat=np.stack([st(kj["geom_xmat"][g]) for g in sk.collision_geoms(m)]),
            subcom=np.stack([st(x) for x in kj["subtree_com"]]),
            cdof=np.stack([st(x) for x in kj["cdof"]]),
            cinA=np.stack([st([ci["A"][ij] for ij in SYM6]) for ci in kj["cinert"]]),
            cinc=np.stack([st(ci["c"]) for ci in kj["cinert"]]),
            xipos=np.stack([st(x) for x in kj["xipos"]]),
            xpos=np.stack([st(x) for x in kj["xpos"]]),
            xquat=np.stack([st(x) for x in kj["xquat"]]),
        )
        for (name, a), b in zip(ref.items(), outs):
            assert a.shape == tuple(b.shape), name
            assert rel_err(a, tnp(b)) < 1e-9, name
    with pytest.raises(ValueError, match="mocap"):
        sk.kin_com(m, T(q.T))


def test_yam_contact_stack_matches_jax_f64():
    """Every box family of the grasp and the elliptic/equality tensors
    (con_Dfri, con_mut, efc_Jeq), con_sel exactly equal."""
    m, kp, kj, sp, sj = _run_both("yam")
    check_contact_stack(m, kp, kj, sp, sj)
    found = kj["con_dist"] < sj[3]
    t1 = m.geom_type[m.pairs.con_geom1]
    t2 = m.geom_type[m.pairs.con_geom2]
    for fam in ((GEOM_PLANE, GEOM_BOX), (GEOM_SPHERE, GEOM_BOX),
                (GEOM_CAPSULE, GEOM_BOX), (GEOM_BOX, GEOM_BOX)):
        slots = (t1 == fam[0]) & (t2 == fam[1])
        assert found[slots].any(), f"no contact of family {fam}"
    assert (kp["con_dim_k"][kp["con_sel_active"]] == 6).any()


def test_yam_refresh_matches_vmapped_f64():
    """refresh() with the mocap base moved, against the vmapped
    kinematics + com_pos + com_vel refresh."""
    E = 6
    mj = yam_mj()
    sim = Simulation(E, dataclasses.replace(yam.sim_cfg(), dtype="float64"),
                     mj, device="cpu")
    q, v, c, _, _ = yam_states(sim.model, E)
    mp, mq = _mocap_inputs(sim.model, E)
    t = lambda x: torch.as_tensor(x, dtype=torch.float64)  # noqa: E731
    sim.data = sim.data.replace(qpos=t(q), qvel=t(v), ctrl=t(c),
                                mocap_pos=t(mp), mocap_quat=t(mq))
    sim.refresh()
    with jax.enable_x64(True):
        jm = jax_put_model(mj, dtype=jnp.float64, nconmax=YAM_NCONMAX)
        d0 = jax_make_data(jm, dtype=jnp.float64)
        dB = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), d0)
        dB = dB.replace(qpos=jnp.asarray(q), qvel=jnp.asarray(v), ctrl=jnp.asarray(c),
                        mocap_pos=jnp.asarray(mp), mocap_quat=jnp.asarray(mq))
        _assert_refresh_equal(_vmapped_refresh(jm, dB), sim.data)
