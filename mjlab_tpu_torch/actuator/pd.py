"""Ideal PD actuator: the explicit torque kp (q* - q) + kd (qd* - qd) +
tau_ff, clipped to the effort limit.

PyTorch counterpart of mjlab_tpu/actuator/pd.py: one <motor> per joint
(ctrl is the torque); the gains and the effort limit live per env in the
group's state (``PdState``), tensors that the DR events write in place
(``set_gains``, ``set_effort_limit``).
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mjlab_tpu_torch.actuator.actuator import Actuator, ActuatorCfg, ActuatorCmd
from mjlab_tpu_torch.actuator.builtin import create_motor_actuator


@dataclass
class PdState:
    """Per-env gains and effort limit (num_envs, joints), float32, and
    their defaults (joints,)."""

    stiffness: torch.Tensor
    damping: torch.Tensor
    effort_limit: torch.Tensor
    default_stiffness: torch.Tensor
    default_damping: torch.Tensor
    default_effort_limit: torch.Tensor

    def tensors(self) -> list[torch.Tensor]:
        return [self.stiffness, self.damping, self.effort_limit]


@dataclass(kw_only=True)
class IdealPdActuatorCfg(ActuatorCfg):
    stiffness: float
    damping: float
    effort_limit: float

    def build(self, joint_ids, joint_names) -> "IdealPdActuator":
        return IdealPdActuator(self, joint_ids, joint_names)

    def edit_spec(self, spec, joint_names) -> None:
        """One motor per joint, in the given order."""
        for name in joint_names:
            create_motor_actuator(spec, name, effort_limit=self.effort_limit,
                                  armature=self.armature, frictionloss=self.frictionloss)


class IdealPdActuator(Actuator):
    """See the module docstring."""

    def initialize(self, num_envs: int, device, rng=None) -> PdState:
        J = len(self.joint_names)

        def full(v):
            return torch.full((J,), v, dtype=torch.float32, device=device)

        kp, kd, fl = full(self.cfg.stiffness), full(self.cfg.damping), full(self.cfg.effort_limit)
        return PdState(
            stiffness=kp.expand(num_envs, J).clone(), damping=kd.expand(num_envs, J).clone(),
            effort_limit=fl.expand(num_envs, J).clone(), default_stiffness=kp,
            default_damping=kd, default_effort_limit=fl,
        )

    def compute(self, state: PdState, cmd: ActuatorCmd, rng=None) -> torch.Tensor:
        tau = (state.stiffness * (cmd.position_target - cmd.joint_pos)
               + state.damping * (cmd.velocity_target - cmd.joint_vel)
               + cmd.effort_target)
        return torch.clamp(tau, -state.effort_limit, state.effort_limit)

    def state_tensors(self, state: PdState) -> list[torch.Tensor]:
        return state.tensors()

    @staticmethod
    def set_gains(state: PdState, mask: torch.Tensor, stiffness=None, damping=None) -> None:
        """The masked envs' gains, (num_envs, joints) each, in place."""
        m = mask[:, None]
        if stiffness is not None:
            state.stiffness.copy_(torch.where(m, stiffness, state.stiffness))
        if damping is not None:
            state.damping.copy_(torch.where(m, damping, state.damping))

    @staticmethod
    def set_effort_limit(state: PdState, mask: torch.Tensor, effort_limit) -> None:
        """The masked envs' effort limits, in place."""
        state.effort_limit.copy_(torch.where(mask[:, None], effort_limit, state.effort_limit))
