"""Electric-actuator physics helpers.

PyTorch-package counterpart of mjlab_tpu/utils/actuator.py (the parts the
robot constants use): motor data and the reflection of a rotary motor
through a linear transmission.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple


@dataclass(frozen=True)
class ElectricActuator:
    reflected_inertia: float
    velocity_limit: float
    effort_limit: float


class LinearJointProperties(NamedTuple):
    armature: float
    velocity_limit: float
    effort_limit: float


def reflect_rotary_to_linear(
    armature_rotary: float,
    velocity_limit_rotary: float,
    effort_limit_rotary: float,
    transmission_ratio: float,
) -> LinearJointProperties:
    """Reflect rotary motor specs through a linear transmission of ratio r
    (m = I / r^2, v = r w, F = tau / r)."""
    return LinearJointProperties(
        armature_rotary / transmission_ratio**2,
        velocity_limit_rotary * transmission_ratio,
        effort_limit_rotary / transmission_ratio,
    )


def reflected_inertia(rotor_inertia: float, gear_ratio: float) -> float:
    """Rotor inertia reflected through a single-stage gearbox: I * G^2."""
    return rotor_inertia * gear_ratio**2
