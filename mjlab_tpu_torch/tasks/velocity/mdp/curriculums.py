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
    """Terrain-level promotion by the distance walked
    (mjlab_tpu/tasks/velocity/mdp/curriculums.py:36-58): of the resetting
    envs, one that walked more than half a sub-terrain from its origin
    moves up a row, one that covered less than half its commanded distance
    over an episode moves down; the levels and origins change in place
    (terrains/importer.py update_env_origins). It runs in the masked reset
    before the reset events, so it reads the root position the episode
    ended at. Returns the mean level (a device scalar); 0 on a plane."""
    terrain = env.scene.terrain
    if terrain is None or terrain.generator is None:
        return env.const(0.0)
    asset = env.scene[asset_cfg.name]
    command = env.command_manager.get_command(command_name)
    dist = torch.linalg.vector_norm(
        asset.data.root_link_pos_w[:, :2] - env.scene.env_origins[:, :2], dim=1)
    size = terrain.cfg.terrain_generator.size[0]
    move_up = dist > size / 2
    move_down = (dist < torch.linalg.vector_norm(command[:, :2], dim=1)
                 * env.max_episode_length_s * 0.5) & ~move_up
    terrain.update_env_origins(env_mask, move_up, move_down, env.rng)
    return terrain.terrain_levels.to(torch.float32).mean()
