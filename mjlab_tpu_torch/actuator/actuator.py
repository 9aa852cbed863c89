"""Actuator interface: the config every actuator group shares and the
runtime contract.

PyTorch counterpart of mjlab_tpu/actuator/actuator.py: an actuator group
maps the entity's joint targets onto data.ctrl once per physics substep
(``compute``), batched over envs; its per-env state, where it has one, is
made of tensors it owns and updates in place (``state_tensors`` lists
them), so that the control step can be captured as one CUDA graph. Every
random draw goes through the env's Rng (utils/random.py), in the JAX
package's order: at ``initialize``, in ``compute`` and in ``reset``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import TYPE_CHECKING, Any

import torch

if TYPE_CHECKING:
    import mujoco

    from mjlab_tpu_torch.utils.random import Rng


@dataclass
class ActuatorCmd:
    """Batched actuator command, (num_envs, joints in the group) each."""

    position_target: torch.Tensor
    velocity_target: torch.Tensor
    effort_target: torch.Tensor
    joint_pos: torch.Tensor
    joint_vel: torch.Tensor


@dataclass(kw_only=True)
class ActuatorCfg:
    """The joints of a group (names or regexes), and the reflected rotor
    inertia and dry friction each of them gets."""

    joint_names_expr: tuple[str, ...]
    armature: float = 0.0
    frictionloss: float = 0.0

    def build(self, joint_ids: list[int], joint_names: list[str]) -> "Actuator":
        raise NotImplementedError

    def edit_spec(self, spec: "mujoco.MjSpec", joint_names: list[str]) -> None:
        """Add the group's actuator elements and joint properties to the
        spec (host side, where MuJoCo is installed)."""


class Actuator:
    """An actuator group of one entity: local joint ids and names, and the
    global actuator ids (ctrl_ids) the entity resolves at initialize.
    ``is_passthrough``: ctrl is a joint target the physics turns into a
    force (MuJoCo's builtin actuators); otherwise ctrl is the torque the
    group computes."""

    is_passthrough: bool = False

    def __init__(self, cfg, joint_ids: list[int], joint_names: list[str]):
        self.cfg = cfg
        self.joint_ids = list(joint_ids)  # local (entity) joint indices
        self.joint_names = list(joint_names)
        self.ctrl_ids: torch.Tensor | None = None  # global actuator ids

    def initialize(self, num_envs: int, device, rng: "Rng") -> Any:
        """The group's per-env state (None: it has none)."""
        return None

    def compute(self, state: Any, cmd: ActuatorCmd, rng: "Rng") -> torch.Tensor:
        """The value written to data.ctrl for each of the group's
        actuators (num_envs, joints); state is updated in place."""
        return cmd.effort_target

    def reset(self, state: Any, mask: torch.Tensor, rng: "Rng") -> None:
        """Reset the masked envs' state in place."""

    def state_tensors(self, state: Any) -> list[torch.Tensor]:
        """Every tensor of the group's state (what a capture puts back)."""
        return []
