"""The physics of Mjlab-Velocity-Flat-Unitree-G1: its simulation options,
its scene's contact sensors, its control step as the env runs it, and its
compiled model, saved so that a machine without MuJoCo can run it.

PyTorch-package counterpart of the sim part of
mjlab_tpu/tasks/velocity/velocity_env_cfg.py (nconmax 35, njmax 300, dt
0.005, decimation 4, 10 Newton and 20 line-search iterations;
implicitfast, pyramidal cone) and of the contact sensors of
mjlab_tpu/tasks/velocity/config/g1/env_cfgs.py:28-49, for the G1
flat-terrain scene (scene/scene.py g1_velocity_flat_model).

g1_velocity_flat.npz beside this file holds that model as the port's
Model (float64 values) with the knees-bent keyframe and the sensors the G1
XML declares (scene.XmlSensor rows). Regenerate it, on a machine with
MuJoCo, with

    python -m mjlab_tpu_torch.tasks.velocity.config.g1.physics

tests/test_torch_model.py checks that it equals a fresh conversion.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from mjlab_tpu_torch.phys.model import Model, load_model, put_model, save_model
from mjlab_tpu_torch.sensor.contact_sensor import ContactMatch, ContactSensorCfg
from mjlab_tpu_torch.sim.sim import ControlStep, Simulation, SimulationCfg

SAVED_MODEL = Path(__file__).resolve().parent / "g1_velocity_flat.npz"
DECIMATION = 4  # physics substeps per control step


def sim_cfg() -> SimulationCfg:
    """The velocity task's simulation options (velocity_env_cfg.py)."""
    from mjlab_tpu_torch.tasks.velocity.velocity_env_cfg import make_velocity_env_cfg

    return make_velocity_env_cfg().sim


def contact_sensor_cfgs() -> tuple[ContactSensorCfg, ...]:
    """The G1 velocity task's contact sensors: each foot's ground contact
    (found, net force, air time) and self-collision (found)."""
    feet = ContactSensorCfg(
        name="feet_ground_contact",
        primary=ContactMatch(
            mode="subtree",
            pattern=r"^(left_ankle_roll_link|right_ankle_roll_link)$",
            entity="robot",
        ),
        secondary=ContactMatch(mode="body", pattern="terrain/terrain"),
        fields=("found", "force"),
        reduce="netforce",
        num_slots=1,
        track_air_time=True,
    )
    self_collision = ContactSensorCfg(
        name="self_collision",
        primary=ContactMatch(mode="subtree", pattern="pelvis", entity="robot"),
        secondary=ContactMatch(mode="subtree", pattern="pelvis", entity="robot"),
        fields=("found",),
        reduce="none",
        num_slots=1,
    )
    return feet, self_collision


def saved_xml_sensors() -> tuple:
    """The sensors the G1 XML declares, from g1_velocity_flat.npz."""
    from mjlab_tpu_torch.scene.scene import xml_sensors_from_arrays

    with np.load(SAVED_MODEL, allow_pickle=False) as z:
        extra = {k[3:]: z[k] for k in z.files if k.startswith("x__sensor_")}
    return xml_sensors_from_arrays(extra)


def make_scene(sim: Simulation, xml_sensors: tuple | None = None):
    """The task's scene, initialized on sim (entity "robot", the two
    contact sensors and the XML's four builtin sensors). xml_sensors
    defaults to the rows g1_velocity_flat.npz keeps."""
    from mjlab_tpu_torch.scene.scene import Scene, g1_velocity_flat_scene_cfg

    scene = Scene(g1_velocity_flat_scene_cfg())
    scene.initialize(sim, saved_xml_sensors() if xml_sensors is None else xml_sensors)
    return scene


def control_step(sim: Simulation, scene) -> ControlStep:
    """The env's physics control step (mjlab_tpu/envs/
    manager_based_rl_env.py:424-444, then the refresh): DECIMATION times
    the entities' actuator controls into ctrl, a physics step and the
    sensors' update, then the kinematic refresh. The joint position
    targets it reads are the robot's (scene["robot"].data
    .set_joint_position_target); the action manager sets them in the env."""
    dt = sim.cfg.mujoco.timestep
    return ControlStep(
        sim, DECIMATION, pre_substep=scene.write_data_to_sim,
        post_substep=lambda: scene.update(dt), state=scene.state_tensors,
    )


def load_saved_model(
    dtype: torch.dtype = torch.float32, device: str | torch.device = "cuda"
) -> tuple[Model, np.ndarray, np.ndarray]:
    """(Model, keyframe qpos, keyframe ctrl) from g1_velocity_flat.npz."""
    m, extra = load_model(SAVED_MODEL, dtype=dtype, device=device)
    return m, extra["key_qpos"], extra["key_ctrl"]


def save_model_file(path: Path = SAVED_MODEL) -> None:
    """Compile the scene with MuJoCo, convert it and write ``path``."""
    from mjlab_tpu_torch.scene.scene import (
        g1_velocity_flat_model, xml_sensor_arrays, xml_sensors,
    )

    mj = g1_velocity_flat_model()
    cfg = sim_cfg()
    cfg.mujoco.apply(mj)
    m = put_model(mj, dtype=torch.float64, nconmax=cfg.nconmax, device="cpu")
    save_model(path, m, key_qpos=mj.key_qpos[0], key_ctrl=mj.key_ctrl[0],
               **xml_sensor_arrays(xml_sensors(mj)))


if __name__ == "__main__":
    save_model_file()
    print(f"wrote {SAVED_MODEL} ({SAVED_MODEL.stat().st_size} bytes)")
