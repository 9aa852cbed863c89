"""The physics of Mjlab-Velocity-Flat-Unitree-G1: its simulation options and
its compiled model, saved so that a machine without MuJoCo can run it.

PyTorch-package counterpart of the sim part of
mjlab_tpu/tasks/velocity/velocity_env_cfg.py (nconmax 35, dt 0.005, 10
Newton and 20 line-search iterations; implicitfast, pyramidal cone) for the
G1 flat-terrain scene (scene/scene.py g1_velocity_flat_model).

g1_velocity_flat.npz beside this file holds that model as the port's
Model (float64 values) with the knees-bent keyframe. Regenerate it, on a
machine with MuJoCo, with

    python -m mjlab_tpu_torch.tasks.velocity.config.g1.physics

tests/test_torch_model.py checks that it equals a fresh conversion.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mjlab_tpu_torch.phys.model import Model, load_model, put_model, save_model
from mjlab_tpu_torch.sim.sim import MujocoCfg, SimulationCfg

SAVED_MODEL = Path(__file__).resolve().parent / "g1_velocity_flat.npz"


def sim_cfg() -> SimulationCfg:
    """The velocity task's simulation options."""
    return SimulationCfg(
        nconmax=35,
        mujoco=MujocoCfg(timestep=0.005, iterations=10, ls_iterations=20),
    )


def load_saved_model(
    dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"
) -> tuple[Model, np.ndarray, np.ndarray]:
    """(Model, keyframe qpos, keyframe ctrl) from g1_velocity_flat.npz."""
    m, extra = load_model(SAVED_MODEL, dtype=dtype, device=device)
    return m, extra["key_qpos"], extra["key_ctrl"]


def save_model_file(path: Path = SAVED_MODEL) -> None:
    """Compile the scene with MuJoCo, convert it and write ``path``."""
    from mjlab_tpu_torch.scene.scene import g1_velocity_flat_model

    mj = g1_velocity_flat_model()
    cfg = sim_cfg()
    cfg.mujoco.apply(mj)
    m = put_model(mj, dtype=torch.float64, nconmax=cfg.nconmax, device="cpu")
    save_model(path, m, key_qpos=mj.key_qpos[0], key_ctrl=mj.key_ctrl[0])


if __name__ == "__main__":
    save_model_file()
    print(f"wrote {SAVED_MODEL} ({SAVED_MODEL.stat().st_size} bytes)")
