"""Action manager.

PyTorch counterpart of mjlab_tpu/managers/action_manager.py: the action,
the previous and the one before it are (num_envs, A) float32 tensors
updated in place; each action term processes its slice once per control
step and writes its targets once per physics substep.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, _cfg_items


class ActionTerm:
    """Base action term: processes its slice of the action vector."""

    def __init__(self, cfg, env):
        self.cfg = cfg
        self._env = env
        self._asset = env.scene[cfg.asset_name]

    @property
    def action_dim(self) -> int:
        raise NotImplementedError

    def process_actions(self, actions: torch.Tensor) -> None:
        """Keep the processed actions (in buffers of the term's own)."""
        raise NotImplementedError

    def apply_actions(self) -> None:
        """Write targets into the entity (once per physics substep)."""
        raise NotImplementedError

    def state_tensors(self) -> list[torch.Tensor]:
        return []

    def reset(self, env_mask) -> None:
        pass


class ActionManager(ManagerBase):
    def _prepare_terms(self) -> None:
        self._terms: dict[str, ActionTerm] = {}
        for name, term_cfg in _cfg_items(self.cfg):
            if term_cfg is None or not hasattr(term_cfg, "class_type"):
                continue
            self._terms[name] = term_cfg.class_type(term_cfg, self._env)

    @property
    def total_action_dim(self) -> int:
        return sum(t.action_dim for t in self._terms.values())

    @property
    def active_terms(self) -> list[str]:
        return list(self._terms)

    def get_term(self, name: str) -> ActionTerm:
        return self._terms[name]

    def init_state(self, num_envs: int) -> None:
        z = lambda: torch.zeros((num_envs, self.total_action_dim),  # noqa: E731
                                dtype=torch.float32, device=self.device)
        self.action, self.prev_action, self.prev_prev_action = z(), z(), z()

    def state_tensors(self) -> list[torch.Tensor]:
        out = [self.action, self.prev_action, self.prev_prev_action]
        for t in self._terms.values():
            out += t.state_tensors()
        return out

    def process_action(self, action: torch.Tensor) -> None:
        self.prev_prev_action.copy_(self.prev_action)
        self.prev_action.copy_(self.action)
        self.action.copy_(action)
        idx = 0
        for term in self._terms.values():
            term.process_actions(self.action[:, idx:idx + term.action_dim])
            idx += term.action_dim

    def apply_action(self) -> None:
        for term in self._terms.values():
            term.apply_actions()

    def reset(self, env_mask) -> dict:
        m = env_mask[:, None]
        for t in (self.action, self.prev_action, self.prev_prev_action):
            t.masked_fill_(m, 0.0)
        for term in self._terms.values():
            term.reset(env_mask)
        return {}
