"""Actuator runtime interface.

PyTorch counterpart of the runtime side of mjlab_tpu/actuator/actuator.py:
an actuator group maps the entity's joint targets onto data.ctrl once per
physics substep (``compute``), batched over envs; its per-env state, where
it has one, is a tensor it owns and updates in place, so that the control
step can be captured as one CUDA graph.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import torch


@dataclass
class ActuatorCmd:
    """Batched actuator command, (num_envs, joints in the group) each."""

    position_target: torch.Tensor
    velocity_target: torch.Tensor
    effort_target: torch.Tensor
    joint_pos: torch.Tensor
    joint_vel: torch.Tensor


class Actuator:
    """An actuator group of one entity: local joint ids and names, and the
    global actuator ids (ctrl_ids) the entity resolves at initialize."""

    def __init__(self, cfg, joint_ids: list[int], joint_names: list[str]):
        self.cfg = cfg
        self.joint_ids = list(joint_ids)  # local (entity) joint indices
        self.joint_names = list(joint_names)
        self.ctrl_ids: torch.Tensor | None = None  # global actuator ids

    def initialize(self, num_envs: int, device) -> Any:
        """The group's per-env state (None: it has none)."""
        return None

    def compute(self, state: Any, cmd: ActuatorCmd) -> torch.Tensor:
        """The value written to data.ctrl for each of the group's
        actuators (num_envs, joints)."""
        return cmd.effort_target

    def reset(self, state: Any, mask: torch.Tensor) -> None:
        """Reset the masked envs' state in place."""
