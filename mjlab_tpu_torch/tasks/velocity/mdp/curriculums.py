"""Velocity-task curricula as in-place updates on the device.

PyTorch counterpart of mjlab_tpu/tasks/velocity/mdp/curriculums.py: the
command ranges live in the command term's state, so a stage change
happens inside a captured env step.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

_DEFAULT = SceneEntityCfg("robot")


def commands_vel(env, env_mask, command_name: str, velocity_stages: list[dict]):
    """Staged widening of the command ranges by the global step count:
    velocity_stages is a list of {step, lin_vel_x, lin_vel_y, ang_vel_z}.
    Returns the current top forward speed (the curriculum's progress)."""
    ranges = env.command_manager.get_term(command_name).state["ranges"]
    step = env.common_step_counter
    for stage in velocity_stages:
        cond = step > stage["step"]
        for key in ("lin_vel_x", "lin_vel_y", "ang_vel_z"):
            if stage.get(key) is not None:
                r = ranges[key]
                r.copy_(torch.where(cond, env.const(stage[key]), r))
    return ranges["lin_vel_x"][1]


def terrain_levels_vel(env, env_mask, command_name: str,
                       asset_cfg: SceneEntityCfg = _DEFAULT):
    """Terrain-level promotion by the distance walked. On a plane it does
    nothing and returns 0; the terrain generator it steers is not ported,
    so a generator terrain raises."""
    terrain = env.scene.cfg.terrain
    if terrain is not None and terrain.terrain_type == "generator":
        raise NotImplementedError(
            "terrain_levels_vel on a generator terrain: terrains/* is not ported yet")
    return env.const(0.0)
