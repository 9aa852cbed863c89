"""Jump curricula as in-place updates on the device.

PyTorch counterpart of mjlab_tpu/tasks/jump/mdp/curriculums.py: the
target height and tolerance live in the jump command's state, the reward
weight in the reward manager, so a stage change happens inside a
captured env step. A stage applies once the global step count has passed
its step (strictly).
"""

from __future__ import annotations

import torch

# the weight of the last stage passed, through RewardManager.set_weight
from mjlab_tpu_torch.tasks.manipulation.mdp.curriculums import (
    reward_weight as progressive_stability_requirement,
)

__all__ = ["progressive_jump_height", "progressive_stability_requirement"]


def progressive_jump_height(env, env_mask, command_name: str,
                            height_stages: list[dict]) -> torch.Tensor:
    """The target height and tolerance of the last stage passed, written
    into the command's state; returns the target (logged)."""
    s = env.command_manager.get_term(command_name).state
    step = env.common_step_counter
    tgt, tol = s["target_height"], s["height_tolerance"]
    for stage in height_stages:
        passed = step > stage["step"]
        tgt = torch.where(passed, env.const(stage["target_height"]), tgt)
        tol = torch.where(passed, env.const(stage["tolerance"]), tol)
    s["target_height"].copy_(tgt)
    s["height_tolerance"].copy_(tol)
    return s["target_height"]
