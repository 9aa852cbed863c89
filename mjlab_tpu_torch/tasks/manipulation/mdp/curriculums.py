"""Manipulation curricula as in-place updates on the device.

PyTorch counterpart of mjlab_tpu/tasks/manipulation/mdp/curriculums.py:
the reward weight lives in the reward manager as a device tensor, so a
stage change happens inside a captured env step.
"""

from __future__ import annotations

import torch


def reward_weight(env, env_mask, reward_name: str, weight_stages: list[dict]) -> torch.Tensor:
    """The weight of the last stage whose step the global step count has
    passed (stages in ascending step order), written into the reward
    manager; returns it (logged)."""
    step = env.common_step_counter
    w = env.reward_manager.weights[reward_name]
    for stage in weight_stages:
        w = torch.where(step > stage["step"], env.const(stage["weight"]), w)
    env.reward_manager.set_weight(reward_name, w)
    return w
