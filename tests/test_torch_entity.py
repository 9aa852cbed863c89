"""The port's runtime scene layer against the JAX package's.

- utils/string.py: the name resolution of mjlab_tpu/utils/string.py, case
  for case (tests/test_string_resolve.py), errors included;
- utils/math.py: quat_mul, quat_apply, quat_apply_inverse and mat_to_quat
  against the JAX helpers (tests/test_math.py) at float64, 1e-12;
- entity/entity.py and entity/data.py on the G1 velocity task's scene:
  the indexing, defaults and limits equal; every read of the EntityData
  view within 1e-9 relative at float64 on the same Data
  (tests/test_entity_data.py's root pose, velocity and projected gravity
  among them); the writes, clear_state and the actuators' ctrl
  (apply_actuator_controls) within 1e-12, the joint targets equal;
- scene/scene.py: the env origins of the plane terrain, and the G1's
  runtime path (model file, scene, control step) on a Python with MuJoCo
  blocked, as on the card's machine.
"""

import os
import subprocess
import sys
import textwrap
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.utils import math as jmath
from mjlab_tpu.utils import string as jstring
from mjlab_tpu_torch.utils import math as pmath
from mjlab_tpu_torch.utils import string as pstring

from torch_port_common import CHILD_THREADS, CHILD_TIMEOUT_S, g1_scenes, rel_err, tnp

E = 6
NAMES = ["hip_l", "hip_r", "knee_l", "knee_r", "ankle"]
STRING_CASES = {
    "order_follows_names": ("names", (["knee_.*", "hip_.*"], NAMES), {}),
    "preserve_order": ("names", (["knee_.*", "hip_.*"], NAMES), {"preserve_order": True}),
    "single_key": ("names", ("ankle", NAMES), {}),
    "unmatched_raises": ("names", (["elbow"], NAMES), {}),
    "values": ("values", ({"hip_.*": 1.0, "ankle": 2.0}, NAMES), {}),
    "values_conflict_raises": ("values", ({"hip_.*": 1.0, "hip_l": 2.0}, NAMES), {}),
    "values_unmatched_raises": ("values", ({"elbow": 1.0}, NAMES), {}),
}


@pytest.mark.parametrize("case", list(STRING_CASES))
def test_string_resolution_matches_jax(case):
    kind, args, kw = STRING_CASES[case]
    fn = "resolve_matching_names" if kind == "names" else "resolve_matching_names_values"

    def run(mod):
        try:
            return getattr(mod, fn)(*args, **kw)
        except ValueError as e:
            return ("ValueError", str(e))

    assert run(pstring) == run(jstring)


def _quats(n, seed):
    q = np.random.default_rng(seed).normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _mats(n, seed):
    from scipy.spatial.transform import Rotation

    return Rotation.from_quat(_quats(n, seed)).as_matrix()


MATH_CASES = {
    "quat_mul": lambda: (_quats(64, 1), _quats(64, 2)),
    "quat_apply": lambda: (_quats(64, 3), np.random.default_rng(4).normal(size=(64, 3))),
    "quat_apply_inverse": lambda: (_quats(64, 5), np.random.default_rng(6).normal(size=(64, 3))),
    "mat_to_quat": lambda: (_mats(64, 7),),
}


@pytest.mark.parametrize("fn", list(MATH_CASES))
def test_math_helper_matches_jax(fn):
    args = MATH_CASES[fn]()
    with jax.enable_x64(True):
        ref = np.asarray(getattr(jmath, fn)(*(jnp.asarray(a) for a in args)))
    got = tnp(getattr(pmath, fn)(*(torch.as_tensor(a) for a in args)))
    np.testing.assert_allclose(got, ref, rtol=0, atol=1e-12)


@pytest.fixture(scope="module")
def g1():
    with jax.enable_x64(True):
        yield g1_scenes(E, seed=2)


def test_entity_indexing_matches_jax(g1):
    jscene, _, _, scene = g1
    je, pe = jscene["robot"], scene["robot"]
    for n in ("body_names", "joint_names", "geom_names", "site_names",
              "actuator_joint_names"):
        assert getattr(pe, n) == getattr(je, n), n
    for f in ("body_ids", "geom_ids", "site_ids", "joint_ids", "ctrl_ids",
              "joint_q_adr", "joint_v_adr", "free_joint_q_adr", "free_joint_v_adr",
              "body_tree_ids"):
        np.testing.assert_array_equal(getattr(pe.indexing, f).numpy(),
                                      getattr(je.indexing, f), err_msg=f)
    for f in ("mocap_id", "root_body_id", "root_tree_id"):
        assert getattr(pe.indexing, f) == getattr(je.indexing, f), f
    assert pe.is_fixed_base == je.is_fixed_base and pe.num_joints == je.num_joints
    for f in ("default_joint_pos", "default_joint_vel", "default_root_state",
              "joint_pos_limits", "soft_joint_pos_limits"):
        np.testing.assert_array_equal(tnp(getattr(pe, f)), np.asarray(getattr(je, f)),
                                      err_msg=f)
    assert pe.find_joints(".*_knee_joint") == je.find_joints(".*_knee_joint")
    assert pe.find_geoms(["left_foot.*"]) == je.find_geoms(["left_foot.*"])


VIEW_PROPS = (
    "root_link_pos_w", "root_link_quat_w", "root_link_pose_w", "root_link_vel_w",
    "root_com_pos_w", "root_com_quat_w", "root_com_vel_w", "root_link_lin_vel_b",
    "root_link_ang_vel_b", "root_com_lin_vel_b", "root_com_ang_vel_b",
    "projected_gravity_b", "heading_w", "body_link_pos_w", "body_link_quat_w",
    "body_link_vel_w", "body_com_pos_w", "body_com_vel_w", "geom_pos_w",
    "site_pos_w", "site_quat_w", "site_vel_w", "geom_lin_vel_w", "joint_pos",
    "joint_pos_biased", "joint_vel", "joint_acc", "actuator_force",
)


@pytest.mark.parametrize("prop", VIEW_PROPS)
def test_entity_view_matches_jax(g1, prop):
    jscene, _, _, scene = g1
    with jax.enable_x64(True):
        ref = np.asarray(getattr(jscene["robot"].data, prop))
    got = tnp(getattr(scene["robot"].data, prop))
    assert ref.shape == got.shape, f"{prop}: {ref.shape} vs {got.shape}"
    assert rel_err(ref, got) < 1e-9, f"{prop}: {rel_err(ref, got):.2e}"


def _writes(e, data, lib, rng_seed):
    """The same sequence of writes through one package's EntityData."""
    rng = np.random.default_rng(rng_seed)
    J = 29
    arr = jnp.asarray if lib == "jax" else torch.as_tensor
    mask = np.array([True, False, True, True, False, False])
    idx = np.array([1, 4])
    root = rng.normal(size=(E, 13))
    root[:, 3:7] /= np.linalg.norm(root[:, 3:7], axis=1, keepdims=True)
    data.write_root_state(arr(root), env_ids=arr(mask))
    data.write_joint_position(arr(rng.normal(size=(E, 3))), joint_ids=np.array([0, 5, 9]),
                              env_ids=arr(idx))
    data.write_joint_velocity(arr(rng.normal(size=(E, J))))
    data.write_external_wrench(arr(rng.normal(size=(E, 2, 3))), arr(rng.normal(size=(E, 2, 3))),
                               body_ids=np.array([0, 7]), env_ids=arr(mask))
    data.set_joint_position_target(arr(rng.normal(size=(E, J)).astype(np.float32)))
    data.set_joint_velocity_target(arr(rng.normal(size=(E, 2)).astype(np.float32)),
                                   joint_ids=np.array([3, 4]), env_ids=arr(idx))
    data.clear_state(arr(np.array([False, True, False, False, False, True])))


def test_entity_writes_and_actuators_match_jax(g1):
    """Writes of the root and joint state, external wrenches, joint targets
    and clear_state, then apply_actuator_controls: Data and targets equal
    the JAX entity's."""
    jscene, ctx, sim, scene = g1
    d0, jd0 = sim.data, ctx.data
    st = scene["robot"].state
    saved = [t.clone() for t in scene["robot"].state_tensors()]
    try:
        with jax.enable_x64(True):
            _writes(E, jscene["robot"].data, "jax", 8)
            _writes(E, scene["robot"].data, "torch", 8)
            jscene.write_data_to_sim()
            scene.write_data_to_sim()
            jd = ctx.data
            jst = ctx.entity_states["robot"]
        for f in ("qpos", "qvel", "xfrc_applied", "ctrl"):
            # the root's angular velocity is rotated into the body frame in
            # another order of operations: a few ulps
            ref, got = np.asarray(getattr(jd, f)), tnp(getattr(sim.data, f))
            assert rel_err(ref, got) < 1e-12, f"{f}: {rel_err(ref, got):.2e}"
        for f in ("joint_pos_target", "joint_vel_target", "joint_effort_target"):
            np.testing.assert_array_equal(getattr(st, f).numpy(),
                                          np.asarray(getattr(jst, f)), err_msg=f)
        assert np.abs(np.asarray(jd.ctrl)).max() > 0
    finally:
        sim.data, ctx.data = d0, jd0
        for t, s in zip(scene["robot"].state_tensors(), saved):
            t.copy_(s)


def test_scene_env_origins_match_jax(g1):
    jscene, _, _, scene = g1
    np.testing.assert_allclose(tnp(scene.env_origins), np.asarray(jscene.env_origins),
                               rtol=0, atol=1e-6)


def test_scene_reset_matches_jax(g1):
    """Scene.reset of a mask: targets, wrenches and air times of the masked
    envs cleared, the others kept, as the JAX scene does."""
    jscene, ctx, sim, scene = g1
    d0, jd0 = sim.data, ctx.data
    saved = [t.clone() for t in scene.state_tensors()]
    try:
        with jax.enable_x64(True):
            for lib, sc in (("jax", jscene), ("torch", scene)):
                _writes(E, sc["robot"].data, lib, 9)
            mask = np.array([False, True, True, False, False, True])
            jscene.reset(ctx, jnp.asarray(mask), jax.random.PRNGKey(1))
            scene.reset(torch.as_tensor(mask))
            np.testing.assert_array_equal(tnp(sim.data.xfrc_applied),
                                          np.asarray(ctx.data.xfrc_applied))
            jst = ctx.entity_states["robot"]
            np.testing.assert_array_equal(scene["robot"].state.joint_pos_target.numpy(),
                                          np.asarray(jst.joint_pos_target))
    finally:
        sim.data, ctx.data = d0, jd0
        for t, s in zip(scene.state_tensors(), saved):
            t.copy_(s)


def test_g1_runtime_path_runs_without_mujoco():
    """The G1's model file, scene, entity, sensors and control step on a
    Python where importing mujoco fails, as on the card's machine."""
    root = Path(__file__).resolve().parents[1]
    code = textwrap.dedent("""
        import sys
        sys.modules["mujoco"] = None  # any import of mujoco raises
        import numpy as np, torch
        from mjlab_tpu_torch.sim.sim import Simulation
        from mjlab_tpu_torch.tasks.velocity.config.g1 import physics
        m, key_qpos, key_ctrl = physics.load_saved_model(device="cpu")
        sim = Simulation(2, physics.sim_cfg(), m, device="cpu")
        scene = physics.make_scene(sim)
        t = lambda x: torch.as_tensor(np.tile(x, (2, 1)), dtype=sim.dtype)
        sim.data = sim.data.replace(qpos=t(key_qpos), ctrl=t(key_ctrl))
        scene["robot"].data.set_joint_position_target(t(key_ctrl))
        physics.control_step(sim, scene).eager()
        out = [scene[n].data for n in scene.sensors]
        assert "mujoco" not in sys.modules or sys.modules["mujoco"] is None
        print("ok", sorted(scene.sensors), bool(torch.isfinite(sim.data.qpos).all()))
    """)
    r = subprocess.run([sys.executable, "-c", code], cwd=root, capture_output=True,
                       text=True, timeout=CHILD_TIMEOUT_S,
                       env={**os.environ, **CHILD_THREADS})
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("ok") and r.stdout.strip().endswith("True"), r.stdout
