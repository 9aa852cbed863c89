"""The physics of Mjlab-Lift-Cube-Yam: its cube, its simulation options and
its compiled model, saved so that a machine without MuJoCo can run it.

PyTorch-package counterpart of the physics parts of
mjlab_tpu/tasks/manipulation/config/yam/env_cfgs.py (``get_cube_spec``,
the cube entity) and of mjlab_tpu/tasks/manipulation/lift_cube_env_cfg.py
(nconmax 55, dt 0.005, decimation 4, 10 Newton and 20 line-search
iterations, implicitfast, elliptic cone with impratio 10), and the task's
physics traffic: the reset state of its events and lifting command, and
its joint-position actions.

yam_lift_cube.npz beside this file holds the scene (scene/scene.py
yam_lift_cube_model) as the port's Model (float64 values) with the task's
initial state: the YAM at its home keyframe, its mocap base at the home
pose, the cube resting at (0.3, 0, 0.02). Regenerate it, on a machine
with MuJoCo, with

    python -m mjlab_tpu_torch.tasks.manipulation.config.yam.physics

tests/test_torch_yam.py checks that it equals a fresh conversion.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mjlab_tpu_torch.phys.model import Model, load_model, put_model, save_model
from mjlab_tpu_torch.sim.sim import MujocoCfg, SimulationCfg

SAVED_MODEL = Path(__file__).resolve().parent / "yam_lift_cube.npz"
CUBE_POS = (0.3, 0.0, 0.02)
# a pose whose grasp site sits 0.03 above the table, and the cube under it
GRASP_ARM = {"robot/joint2": 1.67, "robot/joint3": 0.8}
GRASP_CUBE_POS = (0.378, 0.0, 0.02)
# where the lifting command puts the cube at a reset (lift_cube_env_cfg.py,
# LiftingCommandCfg object_pose_range): position box and yaw range
CUBE_RESET_POS = ((0.2, 0.4), (-0.2, 0.2), (0.02, 0.05))
CUBE_RESET_YAW = (-3.14, 3.14)


def get_cube_spec(cube_size: float = 0.02, mass: float = 0.05) -> "mujoco.MjSpec":
    """A free box, condim 6, with the task's friction."""
    import mujoco

    spec = mujoco.MjSpec()
    body = spec.worldbody.add_body(name="cube")
    body.add_freejoint(name="cube_joint")
    body.add_geom(
        name="cube_geom",
        type=mujoco.mjtGeom.mjGEOM_BOX,
        size=(cube_size,) * 3,
        mass=mass,
        rgba=(0.8, 0.2, 0.2, 1.0),
        friction=(1.0, 5e-3, 5e-4),
        condim=6,
    )
    return spec


def cube_entity_cfg() -> "EntityCfg":
    """The cube entity: not articulated, no keyframe of its own."""
    from mjlab_tpu_torch.entity.entity import EntityCfg, InitialStateCfg

    return EntityCfg(
        spec_fn=get_cube_spec,
        init_state=InitialStateCfg(pos=CUBE_POS, joint_pos=None),
    )


def sim_cfg() -> SimulationCfg:
    """The lift-cube task's simulation options."""
    return SimulationCfg(
        nconmax=55,
        njmax=600,
        mujoco=MujocoCfg(
            timestep=0.005, iterations=10, ls_iterations=20, impratio=10,
            cone="elliptic",
        ),
    )


def initial_state(mj: "mujoco.MjModel") -> dict[str, np.ndarray]:
    """The task's reset state of one env: qpos (the robot's home keyframe,
    the cube at CUBE_POS), ctrl (the keyframe's position targets) and the
    mocap frame of the robot's base (the home pose)."""
    from mjlab_tpu_torch.asset_zoo.robots.i2rt_yam.yam_constants import (
        HOME_KEYFRAME,
    )

    qpos = np.array(mj.key_qpos[0])
    adr = mj.jnt_qposadr[mj.joint("cube/cube_joint").id]
    qpos[adr:adr + 7] = CUBE_POS + (1.0, 0.0, 0.0, 0.0)
    mid = mj.body_mocapid[mj.body("robot/mocap_base").id]
    mocap_pos = np.zeros((mj.nmocap, 3))
    mocap_quat = np.tile([1.0, 0.0, 0.0, 0.0], (mj.nmocap, 1))
    mocap_pos[mid] = HOME_KEYFRAME.pos
    mocap_quat[mid] = HOME_KEYFRAME.rot
    return dict(qpos=qpos, ctrl=np.array(mj.key_ctrl[0]),
                mocap_pos=mocap_pos, mocap_quat=mocap_quat)


def grasp_state(m: Model, state: dict[str, np.ndarray]) -> dict[str, np.ndarray]:
    """``state`` with the arm lowered (joint2 1.67, joint3 0.8, held there by
    its position targets) and the cube moved between the fingertips, which
    pinch it: the contact regime of a grasp, with plane-box, sphere-box,
    capsule-box and box-box contacts, condim 6 on the fingertips."""
    out = {k: np.array(v) for k, v in state.items()}
    names = list(m.joint_names)
    for name, value in GRASP_ARM.items():
        j = names.index(name)
        out["qpos"][m.jnt_qposadr[j]] = value
        out["ctrl"][np.flatnonzero(m.actuator_trnid[:, 0] == j)] = value
    adr = m.jnt_qposadr[names.index("cube/cube_joint")]
    out["qpos"][adr:adr + 3] = GRASP_CUBE_POS
    return out


def _batch(m: Model, state: dict[str, np.ndarray], num_envs: int) -> dict:
    """``state`` for num_envs envs, at rest."""
    tile = lambda x: np.tile(x, (num_envs,) + (1,) * x.ndim)  # noqa: E731
    out = {k: tile(np.asarray(v)) for k, v in state.items()}
    out["qvel"] = np.zeros((num_envs, m.nv))
    return out


def task_states(m: Model, state: dict[str, np.ndarray], num_envs: int,
                seed: int = 0) -> dict[str, np.ndarray]:
    """Per-env states (num_envs, ...) in which the kernels meet every
    contact regime: even envs at ``state`` (the cube on the table), odd
    envs pinching the cube (grasp_state), seeded noise on the arm's six
    joints (0.02 rad) and their velocities (0.1 rad/s), the mocap base at
    ``state``'s. A hand-made mix, not the task's traffic (reset_states)."""
    grasp = grasp_state(m, state)
    rng = np.random.default_rng(seed)
    out = _batch(m, state, num_envs)
    pick = (np.arange(num_envs) % 2)[:, None]
    out["qpos"] = np.where(pick, grasp["qpos"], out["qpos"])
    out["ctrl"] = np.where(pick, grasp["ctrl"], out["ctrl"])
    out["qpos"][:, :6] += 0.02 * rng.standard_normal((num_envs, 6))
    out["qvel"][:, :6] = 0.1 * rng.standard_normal((num_envs, 6))
    return out


def reset_states(m: Model, state: dict[str, np.ndarray], num_envs: int,
                 seed: int = 0) -> dict[str, np.ndarray]:
    """Per-env states (num_envs, ...) after the task's reset: the robot at
    ``state``'s home keyframe, at rest (the reset events offset nothing),
    the cube at rest at a pose the lifting command draws, uniform in
    CUBE_RESET_POS with a uniform yaw in CUBE_RESET_YAW
    (quat_from_euler_xyz(0, 0, yaw)), from a numpy generator seeded with
    ``seed``."""
    rng = np.random.default_rng(seed)
    out = _batch(m, state, num_envs)
    lo, hi = np.array(CUBE_RESET_POS).T
    yaw = rng.uniform(*CUBE_RESET_YAW, num_envs)
    adr = m.jnt_qposadr[list(m.joint_names).index("cube/cube_joint")]
    out["qpos"][:, adr:adr + 3] = lo + rng.random((num_envs, 3)) * (hi - lo)
    out["qpos"][:, adr + 3:adr + 7] = np.stack(
        [np.cos(0.5 * yaw), 0 * yaw, 0 * yaw, np.sin(0.5 * yaw)], axis=1
    )
    return out


def action_scale(m: Model) -> torch.Tensor:
    """The task's joint-position action scale per actuator (nu,): 0.25
    effort limit / stiffness (YAM_ACTION_SCALE), read from the model, where
    a position actuator's stiffness is its kp (gainprm[0]) and its effort
    limit the top of its force range. ctrl = the home targets + scale *
    action."""
    return 0.25 * m.actuator_forcerange[:, 1] / m.actuator_gainprm[:, 0]


def load_saved_model(
    dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"
) -> tuple[Model, dict[str, np.ndarray]]:
    """(Model, initial state) from yam_lift_cube.npz; the state holds
    qpos, ctrl, mocap_pos and mocap_quat of one env."""
    m, extra = load_model(SAVED_MODEL, dtype=dtype, device=device)
    return m, {k[len("init_"):]: v for k, v in extra.items()}


def save_model_file(path: Path = SAVED_MODEL) -> None:
    """Compile the scene with MuJoCo, convert it and write ``path``."""
    from mjlab_tpu_torch.scene.scene import yam_lift_cube_model

    mj = yam_lift_cube_model()
    cfg = sim_cfg()
    cfg.mujoco.apply(mj)
    m = put_model(mj, dtype=torch.float64, nconmax=cfg.nconmax, device="cpu")
    state = initial_state(mj)
    save_model(path, m, **{f"init_{k}": v for k, v in state.items()})


if __name__ == "__main__":
    save_model_file()
    print(f"wrote {SAVED_MODEL} ({SAVED_MODEL.stat().st_size} bytes)")
