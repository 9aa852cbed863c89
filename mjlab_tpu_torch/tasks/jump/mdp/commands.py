"""The jump-height command: one target height per episode, constant
within it.

PyTorch counterpart of mjlab_tpu/tasks/jump/mdp/commands.py. The target
height and its tolerance are 0-d tensors in the term's state, which the
curriculum (curriculums.py progressive_jump_height) writes in place inside
a captured env step; a resample copies the current target into the
masked envs' command. The time left stays at 1e9: the command resamples
only at a reset.
"""

from __future__ import annotations

from dataclasses import dataclass

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
        full = lambda v, *s: torch.full(s, v, dtype=torch.float32, device=dev)  # noqa: E731
        return {
            "command": full(self.cfg.target_height, num_envs, 1),
            "target_height": full(self.cfg.target_height),
            "height_tolerance": full(self.cfg.height_tolerance),
            "time_left": full(1e9, num_envs),
            "metrics": {"target_height": full(0.0, num_envs)},
        }

    def _get_command(self) -> torch.Tensor:
        return self.state["command"]

    def _resample(self, mask: torch.Tensor) -> None:
        s = self.state
        s["command"].copy_(torch.where(mask[:, None], s["target_height"], s["command"]))

    def _update_metrics(self) -> None:
        s = self.state
        s["metrics"]["target_height"].copy_(s["target_height"].expand(s["time_left"].shape))


@dataclass(kw_only=True)
class JumpCommandCfg(CommandTermCfg):
    class_type: type = JumpCommand
    asset_name: str = "robot"
    resampling_time_range: tuple[float, float] = (1e9, 1e9)
    target_height: float = 0.25
    height_tolerance: float = 0.05
