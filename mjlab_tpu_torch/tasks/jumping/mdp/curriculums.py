"""Jumping curricula as in-place updates on the device.

PyTorch counterpart of mjlab_tpu/tasks/jumping/mdp/curriculums.py: the
staged widening of the commanded target-height range, written into the
command's 2-element range tensor inside a captured env step.
"""

from __future__ import annotations

import torch


def jump_height_curriculum(env, env_mask, command_name: str,
                           height_stages: list[dict]) -> torch.Tensor:
    """The range of the last stage whose step the global step count has
    passed (strictly), written in place; returns its upper end (logged)."""
    th = env.command_manager.get_term(command_name).state["ranges"]["target_height"]
    step = env.common_step_counter
    new = th
    for stage in height_stages:
        new = torch.where(step > stage["step"], env.const(stage["target_height"]), new)
    th.copy_(new)
    return th[1]
