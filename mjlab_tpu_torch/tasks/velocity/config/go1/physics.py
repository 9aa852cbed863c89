"""The physics of the Go1 velocity tasks: their contact sensor and the
compiled models of the flat and rough scenes, saved so that a machine
without MuJoCo can run them.

PyTorch-package counterpart of the Go1 scene of
mjlab_tpu/tasks/velocity/config/go1/env_cfgs.py (the velocity task's
simulation options, tasks/velocity/velocity_env_cfg.py). The Go1 has 12
actuated joints (four legs of hip, thigh and calf), four foot spheres and
box, capsule and sphere collision geoms on its trunk and legs.

go1_velocity_flat.npz and go1_velocity_rough.npz beside this file hold the
flat and rough scenes as the port's Model (float64 values) with the
standing keyframe; the rough one's terrain is a height field that each
build fills with its own generated terrain (scene.model_file_scene_cfg,
terrains/importer.py fill_hfield). Regenerate both, on a machine with
MuJoCo, with

    python -m mjlab_tpu_torch.tasks.velocity.config.go1.physics

tests/test_torch_model.py checks that they equal fresh conversions.
"""

from __future__ import annotations

from pathlib import Path

from mjlab_tpu_torch.sensor.contact_sensor import ContactMatch, ContactSensorCfg

FLAT_MODEL = Path(__file__).resolve().parent / "go1_velocity_flat.npz"
ROUGH_MODEL = Path(__file__).resolve().parent / "go1_velocity_rough.npz"


def contact_sensor_cfgs() -> tuple[ContactSensorCfg, ...]:
    """The Go1 velocity task's contact sensor: each foot's ground contact
    (found, net force, air time)."""
    feet = ContactSensorCfg(
        name="feet_ground_contact",
        primary=ContactMatch(mode="geom", pattern="^[FR][LR]_foot_collision$",
                             entity="robot"),
        secondary=ContactMatch(mode="body", pattern="terrain/terrain"),
        fields=("found", "force"),
        reduce="netforce",
        num_slots=1,
        track_air_time=True,
    )
    return (feet,)


def save_model_files() -> None:
    """Compile the flat and rough scenes with MuJoCo, convert them and
    write FLAT_MODEL and ROUGH_MODEL."""
    from mjlab_tpu_torch.scene.scene import save_scene_model
    from mjlab_tpu_torch.tasks.velocity.config.go1.env_cfgs import (
        unitree_go1_flat_env_cfg, unitree_go1_rough_env_cfg,
    )

    for make, path in ((unitree_go1_flat_env_cfg, FLAT_MODEL),
                       (unitree_go1_rough_env_cfg, ROUGH_MODEL)):
        cfg = make()
        save_scene_model(path, cfg.scene, cfg.sim)


if __name__ == "__main__":
    save_model_files()
    for path in (FLAT_MODEL, ROUGH_MODEL):
        print(f"wrote {path} ({path.stat().st_size} bytes)")
