"""Reward manager: the weighted sum of the terms' values times dt, with
non-finite values scrubbed, and time-normalised episode sums.

PyTorch counterpart of mjlab_tpu/managers/reward_manager.py. The episode
sums, the weights (a curriculum may change them at run time, on the
device) and each term's value of the last step are tensors updated in
place.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import (
    ManagerBase,
    ManagerTermBase,
    _cfg_items,
)
from mjlab_tpu_torch.managers.manager_term_config import RewardTermCfg


class RewardManager(ManagerBase):
    def _prepare_terms(self) -> None:
        self._term_names: list[str] = []
        self._term_cfgs: list[RewardTermCfg] = []
        for name, term_cfg in _cfg_items(self.cfg):
            if not isinstance(term_cfg, RewardTermCfg):
                continue
            self._resolve_common_term_cfg(name, term_cfg)
            self._term_names.append(name)
            self._term_cfgs.append(term_cfg)

    @property
    def active_terms(self) -> list[str]:
        return list(self._term_names)

    def get_term_cfg(self, name: str) -> RewardTermCfg:
        return self._term_cfgs[self._term_names.index(name)]

    def init_state(self, num_envs: int) -> None:
        dev = self.device
        z = lambda: torch.zeros((num_envs,), dtype=torch.float32, device=dev)  # noqa: E731
        self.episode_sums = {n: z() for n in self._term_names}
        # terms with a static weight of 0 are skipped and cannot be
        # re-weighted at run time
        self.weights = {n: torch.tensor(c.weight, dtype=torch.float32, device=dev)
                        for n, c in zip(self._term_names, self._term_cfgs)}
        self.step_values = {n: z() for n in self._term_names}
        self.reward = z()

    def state_tensors(self) -> list[torch.Tensor]:
        out = (list(self.episode_sums.values()) + list(self.weights.values())
               + list(self.step_values.values()) + [self.reward])
        for cfg in self._term_cfgs:
            if isinstance(cfg.func, ManagerTermBase):
                out += cfg.func.state_tensors()
        return out

    def compute(self, dt: float) -> torch.Tensor:
        """The step's reward (the fixed buffer ``reward``)."""
        total = torch.zeros_like(self.reward)
        for name, cfg in zip(self._term_names, self._term_cfgs):
            if cfg.weight == 0.0:
                self.step_values[name].zero_()
                continue
            value = cfg.func(self._env, **cfg.params) * (self.weights[name] * dt)
            # scrub nan/inf and clamp finite runaway values, so that one
            # exploding env cannot poison the return statistics
            value = torch.clamp(torch.nan_to_num(value, nan=0.0, posinf=0.0, neginf=0.0),
                                -1e6, 1e6)
            total = total + value
            self.episode_sums[name].add_(value)
            self.step_values[name].copy_(value)
        self.reward.copy_(total)
        return self.reward

    def set_weight(self, name: str, value) -> None:
        """Curriculum hook: the term's weight, on the device."""
        w = self.weights[name]
        if isinstance(value, torch.Tensor):
            w.copy_(value)
        else:
            w.fill_(float(value))

    def reset(self, env_mask) -> dict:
        """Episode_Reward/<term>: the mean over the reset envs of the
        time-normalised episode sum."""
        logs = {}
        for cfg in self._term_cfgs:
            if isinstance(cfg.func, ManagerTermBase):
                logs.update(cfg.func.reset(env_mask) or {})
        n_reset = torch.clamp(env_mask.sum(), min=1)
        max_len_s = self._env.max_episode_length_s
        for name in self._term_names:
            s = self.episode_sums[name]
            logs[f"Episode_Reward/{name}"] = (
                torch.where(env_mask, s, 0.0).sum() / n_reset / max_len_s)
            s.masked_fill_(env_mask, 0.0)
        return logs
