"""Manipulation terminations.

PyTorch counterpart of mjlab_tpu/tasks/manipulation/mdp/terminations.py.
"""

from __future__ import annotations

import torch


def illegal_contact(env, sensor_name: str) -> torch.Tensor:
    """True where any slot of the contact sensor found a contact."""
    return torch.any(env.scene[sensor_name].data.found > 0, dim=1)
