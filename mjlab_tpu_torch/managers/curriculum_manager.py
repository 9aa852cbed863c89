"""Curriculum manager.

PyTorch counterpart of mjlab_tpu/managers/curriculum_manager.py: the
terms run at reset time on the masked envs and return a value logged
under Curriculum/<term> (a device scalar); a term changes the state it
steers (command ranges, reward weights) in place on the device.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, _cfg_items
from mjlab_tpu_torch.managers.manager_term_config import CurriculumTermCfg


class CurriculumManager(ManagerBase):
    def _prepare_terms(self) -> None:
        self._term_names: list[str] = []
        self._term_cfgs: list[CurriculumTermCfg] = []
        for name, term_cfg in _cfg_items(self.cfg):
            if not isinstance(term_cfg, CurriculumTermCfg):
                continue
            self._resolve_common_term_cfg(name, term_cfg)
            self._term_names.append(name)
            self._term_cfgs.append(term_cfg)

    @property
    def active_terms(self) -> list[str]:
        return list(self._term_names)

    def init_state(self, num_envs: int) -> None:
        pass

    def compute(self, env_mask) -> dict:
        """Run the terms for the resetting envs; the Curriculum/ logs."""
        logs = {}
        for name, cfg in zip(self._term_names, self._term_cfgs):
            value = cfg.func(self._env, env_mask, **cfg.params)
            if value is not None:
                logs[f"Curriculum/{name}"] = value.to(torch.float32)
        return logs


class NullCurriculumManager:
    active_terms: list = []

    def __init__(self, env):
        self._env = env

    def init_state(self, num_envs):
        pass

    def state_tensors(self):
        return []

    def compute(self, env_mask):
        return {}

    def reset(self, env_mask):
        return {}
