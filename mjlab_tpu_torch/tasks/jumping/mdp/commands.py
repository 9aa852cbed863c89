"""The jumping task's command: a jump trigger that decays after landing
and a target height above standing, per env.

PyTorch counterpart of mjlab_tpu/tasks/jumping/mdp/commands.py. The
command is (E, 2): [:, 0] the trigger, [:, 1] the target above standing
height. The flight and landing flags, the trigger's decay and the
target-height range (a 2-element tensor the curriculum widens in place)
are tensors updated in place inside a captured env step; a resample,
every 3-6 s and at a reset, draws one unit uniform per env through the
env's Rng.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from mjlab_tpu_torch.managers.command_manager import CommandTerm
from mjlab_tpu_torch.managers.manager_term_config import CommandTermCfg


class JumpCommand(CommandTerm):
    cfg: "JumpCommandCfg"

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        self.robot = env.scene[cfg.asset_name]

    def init_state(self, num_envs: int) -> dict:
        dev = self._env.device
        z = lambda *s: torch.zeros((num_envs,) + s, dtype=torch.float32, device=dev)  # noqa: E731
        b = lambda: torch.zeros((num_envs,), dtype=torch.bool, device=dev)  # noqa: E731
        return {
            "command": z(2),
            "ranges": {"target_height": torch.tensor(
                self.cfg.ranges.target_height, dtype=torch.float32, device=dev)},
            "jump_active": b(),
            "jump_completed": b(),
            "was_in_flight": b(),
            "time_left": z(),
            "metrics": {"target_height": z()},
        }

    def _get_command(self) -> torch.Tensor:
        return self.state["command"]

    def _resample(self, mask: torch.Tensor) -> None:
        """For the masked envs: a target uniform in the range, the trigger
        set, the flight and landing flags cleared."""
        s = self.state
        lohi = s["ranges"]["target_height"]
        h = lohi[0] + self._env.rng.uniform(mask.shape) * (lohi[1] - lohi[0])
        cmd = s["command"]
        cmd[:, 1] = torch.where(mask, h, cmd[:, 1])
        cmd[:, 0].masked_fill_(mask, 1.0)
        s["jump_active"].masked_fill_(mask, True)
        s["jump_completed"].masked_fill_(mask, False)
        s["was_in_flight"].masked_fill_(mask, False)

    def _update_command(self) -> None:
        """Latch a flight (not both feet down) and a landing after it; once
        landed, the trigger decays by trigger_decay_rate per step."""
        if self.cfg.contact_sensor_name is None:
            return
        s = self.state
        both = (self._env.scene[self.cfg.contact_sensor_name].data.found > 0).all(1)
        s["was_in_flight"].logical_or_(~both)
        s["jump_completed"].logical_or_(s["was_in_flight"] & both)
        cmd = s["command"]
        cmd[:, 0] = torch.where(s["jump_completed"], cmd[:, 0] * self.cfg.trigger_decay_rate,
                                cmd[:, 0])

    def _update_metrics(self) -> None:
        s = self.state
        s["metrics"]["target_height"].copy_(s["command"][:, 1])


@dataclass(kw_only=True)
class JumpCommandCfg(CommandTermCfg):
    class_type: type = JumpCommand
    asset_name: str = "robot"
    contact_sensor_name: str | None = None
    standing_height: float = 0.76
    trigger_decay_rate: float = 0.95

    @dataclass
    class Ranges:
        target_height: tuple[float, float] = (0.02, 0.05)

    ranges: Ranges = field(default_factory=Ranges)
