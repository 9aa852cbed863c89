"""Joint action terms: scale and offset, the default-position offset and
encoder-bias compensation of position actions.

PyTorch counterpart of mjlab_tpu/envs/mdp/actions.py. The processed
actions live in a buffer of the term's own, written once per control
step; the joint ids are a tensor on the device, so that the per-substep
target write needs no host copy. As in the JAX package the ids index the
entity's actuator-joint list (Entity.find_actuators).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from mjlab_tpu_torch.managers.action_manager import ActionTerm
from mjlab_tpu_torch.managers.manager_term_config import ActionTermCfg
from mjlab_tpu_torch.utils.string import resolve_matching_names_values


class JointAction(ActionTerm):
    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        ids, names = self._asset.find_actuators(list(cfg.actuator_names))
        dev = env.device
        self._joint_ids = torch.as_tensor(ids, dtype=torch.long, device=dev)
        self._joint_names = names
        J = len(names)

        def expand(value, default):
            out = np.full(J, default, np.float32)
            if isinstance(value, dict):
                idxs, _, vals = resolve_matching_names_values(value, names)
                out[idxs] = vals
            elif value is not None:
                out[:] = float(value)
            return torch.as_tensor(out, device=dev)

        self._scale = expand(cfg.scale, 1.0)
        self._offset = expand(cfg.offset, 0.0)
        E = env.num_envs
        self._raw = torch.zeros((E, J), dtype=torch.float32, device=dev)
        self._processed = torch.zeros((E, J), dtype=torch.float32, device=dev)

    @property
    def scale(self) -> torch.Tensor:
        """Per-joint action scale (deployment metadata)."""
        return self._scale

    @property
    def offset(self) -> torch.Tensor:
        return self._offset

    @property
    def action_dim(self) -> int:
        return len(self._joint_names)

    @property
    def raw_actions(self) -> torch.Tensor:
        return self._raw

    @property
    def processed_actions(self) -> torch.Tensor:
        return self._processed

    def state_tensors(self) -> list[torch.Tensor]:
        return [self._raw, self._processed]

    def process_actions(self, actions):
        self._raw.copy_(actions)
        self._processed.copy_(actions * self._scale + self._offset)


@dataclass
class JointPositionActionCfg(ActionTermCfg):
    actuator_names: tuple[str, ...] = (".*",)
    scale: object = 1.0
    offset: object = None
    use_default_offset: bool = True

    def __post_init__(self):
        self.class_type = JointPositionAction


class JointPositionAction(JointAction):
    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        if cfg.use_default_offset and cfg.offset is None:
            self._offset = self._asset.data.default_joint_pos[0, self._joint_ids].to(
                torch.float32)

    def apply_actions(self):
        # encoder-bias compensation: the policy commands positions in the
        # biased (encoder) frame; the physical target subtracts the bias
        bias = self._asset.data.encoder_bias[:, self._joint_ids]
        self._asset.data.set_joint_position_target(self._processed - bias,
                                                   joint_ids=self._joint_ids)


@dataclass
class JointVelocityActionCfg(ActionTermCfg):
    actuator_names: tuple[str, ...] = (".*",)
    scale: object = 1.0
    offset: object = None
    use_default_offset: bool = True

    def __post_init__(self):
        self.class_type = JointVelocityAction


class JointVelocityAction(JointAction):
    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        if cfg.use_default_offset and cfg.offset is None:
            self._offset = self._asset.data.default_joint_vel[0, self._joint_ids].to(
                torch.float32)

    def apply_actions(self):
        self._asset.data.set_joint_velocity_target(self._processed,
                                                   joint_ids=self._joint_ids)


@dataclass
class JointEffortActionCfg(ActionTermCfg):
    actuator_names: tuple[str, ...] = (".*",)
    scale: object = 1.0
    offset: object = 0.0

    def __post_init__(self):
        self.class_type = JointEffortAction


class JointEffortAction(JointAction):
    def apply_actions(self):
        self._asset.data.set_joint_effort_target(self._processed,
                                                 joint_ids=self._joint_ids)
