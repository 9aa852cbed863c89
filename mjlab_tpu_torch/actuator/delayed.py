"""Delayed actuator: any base actuator whose chosen command targets pass
through per-env stochastic delay buffers, ticking at physics rate.

PyTorch counterpart of mjlab_tpu/actuator/delayed.py, on the port's
DelayBuffer (utils/buffers.py): delay_target picks which of position,
velocity and effort are delayed; lags in [min_lag, max_lag] physics steps
with the buffer's hold_prob, update_period and per_env_phase. The draws go
through the env's Rng in the JAX actuator's order: one phase draw per
target at initialize (per_env_phase with update_period > 1), two uniform
draws per target in each compute (the candidate lag, the hold), one per
target in each reset.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

from mjlab_tpu_torch.actuator.actuator import Actuator, ActuatorCfg, ActuatorCmd
from mjlab_tpu_torch.utils.buffers import DelayBuffer

DelayTarget = Literal["position", "velocity", "effort"]


@dataclass
class DelayedState:
    base: object  # the base actuator's state
    buffers: dict  # target -> DelayBuffer


@dataclass(kw_only=True)
class DelayedActuatorCfg(ActuatorCfg):
    base_cfg: ActuatorCfg = None
    delay_target: DelayTarget | tuple[DelayTarget, ...] = "position"
    min_lag: int = 0
    max_lag: int = 0
    hold_prob: float = 0.0
    update_period: int = 0
    per_env_phase: bool = False

    def __post_init__(self):
        if self.base_cfg is None:
            raise ValueError("DelayedActuatorCfg requires base_cfg")
        if not self.joint_names_expr:
            self.joint_names_expr = self.base_cfg.joint_names_expr

    def build(self, joint_ids, joint_names) -> "DelayedActuator":
        return DelayedActuator(self, self.base_cfg.build(joint_ids, joint_names),
                               joint_ids, joint_names)

    def edit_spec(self, spec, joint_names) -> None:
        self.base_cfg.edit_spec(spec, joint_names)


class DelayedActuator(Actuator):
    """See the module docstring."""

    def __init__(self, cfg, base: Actuator, joint_ids, joint_names):
        super().__init__(cfg, joint_ids, joint_names)
        self.base = base
        targets = cfg.delay_target
        self.targets = (targets,) if isinstance(targets, str) else tuple(targets)

    def initialize(self, num_envs: int, device, rng) -> DelayedState:
        c, J = self.cfg, len(self.joint_names)
        buffers = {
            t: DelayBuffer(c.max_lag, num_envs, (J,), min_lag=c.min_lag,
                           update_period=c.update_period, hold_prob=c.hold_prob,
                           per_env_phase=c.per_env_phase, rng=rng, device=device)
            for t in self.targets
        }
        return DelayedState(base=self.base.initialize(num_envs, device, rng), buffers=buffers)

    def compute(self, state: DelayedState, cmd: ActuatorCmd, rng) -> torch.Tensor:
        values = {"position": cmd.position_target, "velocity": cmd.velocity_target,
                  "effort": cmd.effort_target}
        for t in self.targets:
            values[t] = state.buffers[t].push(values[t], rng)
        cmd = ActuatorCmd(position_target=values["position"],
                          velocity_target=values["velocity"],
                          effort_target=values["effort"],
                          joint_pos=cmd.joint_pos, joint_vel=cmd.joint_vel)
        return self.base.compute(state.base, cmd, rng)

    def reset(self, state: DelayedState, mask: torch.Tensor, rng) -> None:
        for t in self.targets:
            state.buffers[t].reset(mask, rng)
        self.base.reset(state.base, mask, rng)

    def state_tensors(self, state: DelayedState) -> list[torch.Tensor]:
        out = self.base.state_tensors(state.base)
        for b in state.buffers.values():
            out += b.tensors()
        return out

    @staticmethod
    def set_lags(state: DelayedState, min_lag, max_lag) -> None:
        """Every buffer's lag range (mjlab_tpu/utils/buffers.py:130-137:
        not clipped to the buffer's capacity)."""
        for b in state.buffers.values():
            b.set_lags(min_lag, max_lag)
