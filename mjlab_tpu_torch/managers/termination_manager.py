"""Termination manager: terminated and truncated (the time_out terms),
and per-term episode counts.

PyTorch counterpart of mjlab_tpu/managers/termination_manager.py; the
flags, the terms' values of the last step and the counts are tensors
updated in place.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, _cfg_items
from mjlab_tpu_torch.managers.manager_term_config import TerminationTermCfg


class TerminationManager(ManagerBase):
    def _prepare_terms(self) -> None:
        self._term_names: list[str] = []
        self._term_cfgs: list[TerminationTermCfg] = []
        for name, term_cfg in _cfg_items(self.cfg):
            if not isinstance(term_cfg, TerminationTermCfg):
                continue
            self._resolve_common_term_cfg(name, term_cfg)
            self._term_names.append(name)
            self._term_cfgs.append(term_cfg)

    @property
    def active_terms(self) -> list[str]:
        return list(self._term_names)

    def init_state(self, num_envs: int) -> None:
        dev = self.device
        b = lambda: torch.zeros((num_envs,), dtype=torch.bool, device=dev)  # noqa: E731
        # all false before the first step: a reset at construction reads
        # them
        self.terminated, self.truncated = b(), b()
        self._term_values = {n: b() for n in self._term_names}
        self.episode_counts = {
            n: torch.zeros((num_envs,), dtype=torch.float32, device=dev)
            for n in self._term_names
        }

    def state_tensors(self) -> list[torch.Tensor]:
        return ([self.terminated, self.truncated] + list(self._term_values.values())
                + list(self.episode_counts.values()))

    def compute(self) -> tuple[torch.Tensor, torch.Tensor]:
        terminated = torch.zeros_like(self.terminated)
        truncated = torch.zeros_like(self.truncated)
        for name, cfg in zip(self._term_names, self._term_cfgs):
            value = cfg.func(self._env, **cfg.params).to(torch.bool)
            self._term_values[name].copy_(value)
            if cfg.time_out:
                truncated = truncated | value
            else:
                terminated = terminated | value
            self.episode_counts[name].add_(value.to(torch.float32))
        self.terminated.copy_(terminated)
        self.truncated.copy_(truncated)
        return self.terminated, self.truncated

    @property
    def dones(self) -> torch.Tensor:
        return self.terminated | self.truncated

    def get_term(self, name: str) -> torch.Tensor:
        return self._term_values[name]

    def reset(self, env_mask) -> dict:
        logs = {}
        n_reset = torch.clamp(env_mask.sum(), min=1)
        for name in self._term_names:
            c = self.episode_counts[name]
            logs[f"Episode_Termination/{name}"] = torch.where(env_mask, c, 0.0).sum() / n_reset
            c.masked_fill_(env_mask, 0.0)
        return logs
