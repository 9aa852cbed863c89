"""Event manager: startup, reset and interval events, with per-env
interval timers, the min-step gate of reset events and the collection of
the domain-randomisation fields.

PyTorch counterpart of mjlab_tpu/managers/event_manager.py:18-111. Term
functions take (env, env_mask, **params) and act only where env_mask is
true; the timers and the last-reset steps are tensors updated in place, so
that a captured env step fires its events with no host read.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, _cfg_items
from mjlab_tpu_torch.managers.manager_term_config import EventTermCfg


class EventManager(ManagerBase):
    def _prepare_terms(self) -> None:
        self._modes: dict[str, list[tuple[str, EventTermCfg]]] = {
            "startup": [], "reset": [], "interval": [],
        }
        for name, term_cfg in _cfg_items(self.cfg):
            if not isinstance(term_cfg, EventTermCfg):
                continue
            self._resolve_common_term_cfg(name, term_cfg)
            if term_cfg.mode not in self._modes:
                raise ValueError(f"unknown event mode {term_cfg.mode}")
            self._modes[term_cfg.mode].append((name, term_cfg))

    @property
    def active_terms(self) -> dict[str, list[str]]:
        return {m: [n for n, _ in ts] for m, ts in self._modes.items()}

    @property
    def domain_randomization_fields(self) -> list[str]:
        """The Model fields DR terms name: the env gives them a leading env
        axis before the first step."""
        fields = []
        for terms in self._modes.values():
            for _, cfg in terms:
                if cfg.domain_randomization and "field" in cfg.params:
                    fields.append(cfg.params["field"])
        return fields

    def init_state(self, num_envs: int) -> None:
        rng, dev = self._env.rng, self.device
        self.interval_left: dict[str, torch.Tensor] = {}
        self.last_reset_step: dict[str, torch.Tensor] = {}
        for name, cfg in self._modes["interval"]:
            lo, hi = cfg.interval_range_s
            shape = () if cfg.is_global_time else (num_envs,)
            self.interval_left[name] = rng.uniform(shape, lo, hi)
        for name, cfg in self._modes["reset"]:
            if cfg.min_step_count_between_reset > 0:
                self.last_reset_step[name] = torch.full(
                    (num_envs,), -(10**9), dtype=torch.int32, device=dev)

    def state_tensors(self) -> list[torch.Tensor]:
        return list(self.interval_left.values()) + list(self.last_reset_step.values())

    def apply_startup(self) -> None:
        """The startup events over every env (before the first step)."""
        all_mask = torch.ones((self.num_envs,), dtype=torch.bool, device=self.device)
        for _, cfg in self._modes["startup"]:
            cfg.func(self._env, all_mask, **cfg.params)

    def apply_interval(self, dt: float) -> None:
        rng = self._env.rng
        for name, cfg in self._modes["interval"]:
            lo, hi = cfg.interval_range_s
            left = self.interval_left[name]
            t = left - dt
            due = t <= 0.0
            resample = rng.uniform(t.shape, lo, hi)
            left.copy_(torch.where(due, resample, t))
            mask = due.expand(self.num_envs) if cfg.is_global_time else due
            cfg.func(self._env, mask, **cfg.params)

    def apply_reset(self, env_mask) -> None:
        step = self._env.common_step_counter
        for name, cfg in self._modes["reset"]:
            mask = env_mask
            if cfg.min_step_count_between_reset > 0:
                last = self.last_reset_step[name]
                mask = env_mask & ((step - last) >= cfg.min_step_count_between_reset)
                last.copy_(torch.where(mask, step, last))
            cfg.func(self._env, mask, **cfg.params)

    def reset(self, env_mask) -> dict:
        return {}
