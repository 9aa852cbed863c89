"""Jump terminations.

PyTorch counterpart of mjlab_tpu/tasks/jump/mdp/terminations.py.
"""

from __future__ import annotations

import torch


def excessive_landing_force(env, sensor_name: str, force_threshold: float = 2500.0):
    """A foot's net contact force beyond the hardware-safe threshold."""
    force = env.scene[sensor_name].data.force
    return torch.linalg.norm(force, dim=-1).amax(1) > force_threshold
