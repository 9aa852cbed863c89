"""DC motor actuator: the ideal PD torque clipped by a linear torque-speed
envelope.

PyTorch counterpart of mjlab_tpu/actuator/dc.py: the torque available
falls linearly from saturation_effort at rest to zero at velocity_limit,
asymmetrically for motoring and braking, each bound within the effort
limit.
"""

from __future__ import annotations

import warnings
from dataclasses import dataclass

import torch

from mjlab_tpu_torch.actuator.actuator import ActuatorCmd
from mjlab_tpu_torch.actuator.pd import IdealPdActuator, IdealPdActuatorCfg, PdState


@dataclass(kw_only=True)
class DcMotorActuatorCfg(IdealPdActuatorCfg):
    saturation_effort: float = 0.0
    velocity_limit: float = 0.0

    def __post_init__(self):
        if self.saturation_effort < self.effort_limit:
            warnings.warn(
                "saturation_effort < effort_limit: torque-speed curve will "
                "clip below the configured effort limit at all speeds"
            )

    def build(self, joint_ids, joint_names) -> "DcMotorActuator":
        return DcMotorActuator(self, joint_ids, joint_names)


def dc_clip(cfg, effort_limit: torch.Tensor, joint_vel: torch.Tensor,
            tau: torch.Tensor) -> torch.Tensor:
    """tau clipped by the torque-speed envelope of cfg (saturation_effort,
    velocity_limit), each bound within +-effort_limit."""
    sat = cfg.saturation_effort
    ratio = joint_vel / max(cfg.velocity_limit, 1e-9)
    tau_max = torch.clamp(sat * (1.0 - ratio), -effort_limit, effort_limit)
    tau_min = torch.clamp(sat * (-1.0 - ratio), -effort_limit, effort_limit)
    return torch.clamp(tau, tau_min, tau_max)


class DcMotorActuator(IdealPdActuator):
    """See the module docstring."""

    def compute(self, state: PdState, cmd: ActuatorCmd, rng=None) -> torch.Tensor:
        tau = super().compute(state, cmd)
        return dc_clip(self.cfg, state.effort_limit, cmd.joint_vel, tau)
