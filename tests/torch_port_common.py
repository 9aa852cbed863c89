"""Shared inputs of the PyTorch-port parity tests (tests/test_torch_*.py).

The port (mjlab_tpu_torch) and the JAX package get the same inputs, made
from numpy seeds, and their outputs are compared as numpy arrays. The JAX
package's Model leaves become the port's Model through model_from_numpy.
"""

from __future__ import annotations

import dataclasses

import jax.numpy as jnp
import mujoco
import numpy as np
import torch

from mjlab_tpu.phys.model import put_model as jax_put_model
from mjlab_tpu_torch.phys import model as pm
from mjlab_tpu_torch.scene.scene import (
    g1_velocity_flat_model, yam_lift_cube_model,
)
from mjlab_tpu_torch.tasks.manipulation.config.yam import physics as yam
from mjlab_tpu_torch.tasks.velocity.config.g1.physics import sim_cfg

from test_hybrid_parity import TOY_XML

from test_pallas2_solver import ELL_XML

# The toy's foot is a box. The port's narrowphase carries the pair families
# of the G1 velocity task (plane/sphere/capsule); the box family waits for a
# later slice, so the contact, solver and step gates use the toy with a
# capsule foot.
TOY_CAPSULE_XML = TOY_XML.replace(
    '<geom type="box" size="0.05 0.03 0.02"/>',
    '<geom type="capsule" size="0.03" fromto="-0.05 0 0 0.05 0 0"/>',
)

# the elliptic toy (box foot, condim 3 and 6 contacts, a joint equality)
# under the pyramidal cone
EQ_XML = ELL_XML.replace('cone="elliptic" impratio="10" ', "")

# the G1 flat-velocity and YAM lift-cube tasks' contact capacities
# (velocity_env_cfg.py, lift_cube_env_cfg.py)
G1_NCONMAX = sim_cfg().nconmax
YAM_NCONMAX = yam.sim_cfg().nconmax
TOY_NCONMAX = 12


def rel_err(a, b) -> float:
    """max |a - b| / max(1, max |a|), a the reference."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    if a.size == 0:
        return 0.0
    scale = max(1.0, float(np.abs(a).max()))
    return float(np.abs(a - b).max()) / scale


def tnp(x) -> np.ndarray:
    """A torch tensor (or anything array-like) as a float64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def toy_mj(capsule: bool = True) -> mujoco.MjModel:
    return mujoco.MjModel.from_xml_string(TOY_CAPSULE_XML if capsule else TOY_XML)


def g1_mj() -> mujoco.MjModel:
    """The G1 flat-velocity model with the task's solver options applied."""
    mj = g1_velocity_flat_model()
    sim_cfg().mujoco.apply(mj)
    return mj


def ell_mj() -> mujoco.MjModel:
    """The elliptic toy: condim 3 and 6 contacts, impratio 10, a joint
    equality (tests/test_pallas2_solver.py ELL_XML)."""
    return mujoco.MjModel.from_xml_string(ELL_XML)


def eq_mj() -> mujoco.MjModel:
    """The elliptic toy under the pyramidal cone (impratio 1): a joint
    equality row in the pyramidal solves."""
    return mujoco.MjModel.from_xml_string(EQ_XML)


def yam_mj() -> mujoco.MjModel:
    """The YAM lift-cube model with the task's solver options applied."""
    mj = yam_lift_cube_model()
    yam.sim_cfg().mujoco.apply(mj)
    return mj


def yam_states(m, E: int, seed: int = 0, dtype=np.float64):
    """(qpos, qvel, ctrl, mocap_pos, mocap_quat) numpy arrays for E envs of
    the port's YAM Model m (yam.task_states: half at the reset state, half
    pinching the cube)."""
    _, st = yam.load_saved_model(dtype=torch.float64, device="cpu")
    b = yam.task_states(m, st, E, seed)
    return tuple(b[k].astype(dtype) for k in (
        "qpos", "qvel", "ctrl", "mocap_pos", "mocap_quat"))


def model_pair(mj, nconmax, dtype):
    """(JAX Model, port Model) of one MjModel; the port's is built from
    the JAX leaves with model_from_numpy. dtype is a numpy dtype."""
    jm = jax_put_model(mj, dtype=jnp.dtype(dtype), nconmax=nconmax)
    return jm, port_model_from_jax(jm, dtype)


def port_model_from_jax(jm, dtype) -> pm.Model:
    fields = {n: np.asarray(getattr(jm, n)) for n in pm.tensor_fields()}
    for n in pm.OPTION_TENSOR_FIELDS:
        fields[f"opt_{n}"] = np.asarray(getattr(jm.opt, n))
    static = {n: getattr(jm, n) for n in pm.static_fields()}
    static["pairs"] = {
        f.name: getattr(jm.pairs, f.name)
        for f in dataclasses.fields(pm.PairTable)
    }
    for n in pm.OPTION_STATIC_FIELDS:
        static[f"opt_{n}"] = getattr(jm.opt, n)
    tdtype = torch.float64 if np.dtype(dtype) == np.float64 else torch.float32
    return pm.model_from_numpy(fields, static, dtype=tdtype, device="cpu")


def state_np(mj, E: int, seed: int = 0, dtype=np.float64, keyframe=False,
             qpos_noise=0.03, qvel_noise=0.3, ctrl_noise=0.2):
    """(qpos, qvel, ctrl) numpy arrays (E, n): qpos0 (or keyframe 0) plus
    seeded noise, free-joint quaternions renormalised."""
    rng = np.random.default_rng(seed)
    base = mj.key_qpos[0] if keyframe else mj.qpos0
    qpos = np.tile(np.asarray(base, np.float64), (E, 1))
    qpos += qpos_noise * rng.standard_normal(qpos.shape)
    for j in range(mj.njnt):
        if mj.jnt_type[j] == 0:
            a = mj.jnt_qposadr[j] + 3
            qpos[:, a:a + 4] /= np.linalg.norm(qpos[:, a:a + 4], axis=1,
                                               keepdims=True)
    qvel = qvel_noise * rng.standard_normal((E, mj.nv))
    ctrl = ctrl_noise * rng.standard_normal((E, mj.nu))
    if keyframe:
        ctrl += mj.key_ctrl[0]
    return qpos.astype(dtype), qvel.astype(dtype), ctrl.astype(dtype)
