"""Sensor base interface (mjlab_tpu/sensor/sensor.py), at run time."""

from __future__ import annotations

from typing import TYPE_CHECKING

import torch

if TYPE_CHECKING:
    from mjlab_tpu_torch.scene.scene import Scene, SimContext


class SensorCfg:
    """A sensor's config; ``build`` makes the sensor of a scene."""

    name: str = ""

    def build(self, scene: "Scene") -> "Sensor":
        raise NotImplementedError


class Sensor:
    def __init__(self, scene: "Scene"):
        self.scene = scene
        self.name: str = ""
        self.ctx: SimContext | None = None

    def initialize(self, ctx: "SimContext") -> None:
        """Resolve indices against the Model and allocate per-env state in
        ctx.sensor_states."""
        self.ctx = ctx

    def update(self, ctx: "SimContext", dt: float) -> None:
        """Per-physics-substep state update, in place."""

    def reset(self, ctx: "SimContext", mask: torch.Tensor) -> None:
        """Reset the masked envs' state, in place."""

    def state_tensors(self, ctx: "SimContext") -> list[torch.Tensor]:
        """The per-env state tensors the sensor updates in place."""
        return []

    @property
    def data(self):
        raise NotImplementedError
