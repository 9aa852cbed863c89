"""Command manager: command terms with time-based resampling and metrics.

PyTorch counterpart of mjlab_tpu/managers/command_manager.py. A command
term's state (the command, the time left, its metrics and whatever the
term keeps) is a dict of tensors updated in place; subclasses implement
masked update rules on it.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import (
    ManagerBase, ManagerTermBase, _cfg_items, tensors_of,
)


class CommandTerm(ManagerTermBase):
    """Base command term. Subclasses implement
    - init_state(num_envs) -> dict of tensors, with "time_left";
    - _resample(mask): draw new commands for the masked envs, in place;
    - _update_command(): post-process the command, in place;
    - _update_metrics(): accumulate state["metrics"][...], in place;
    - _get_command() -> the (num_envs, ...) command."""

    name: str = ""
    state: dict

    @property
    def command(self) -> torch.Tensor:
        return self._get_command()

    def _get_command(self) -> torch.Tensor:
        raise NotImplementedError

    def init_state(self, num_envs: int) -> dict:
        raise NotImplementedError

    def _resample(self, mask: torch.Tensor) -> None:
        raise NotImplementedError

    def _update_command(self) -> None:
        pass

    def _update_metrics(self) -> None:
        pass

    def state_tensors(self) -> list[torch.Tensor]:
        return tensors_of(self.state)

    def _resample_time(self, mask: torch.Tensor, time_left: torch.Tensor) -> None:
        lo, hi = self.cfg.resampling_time_range
        new_t = self._env.rng.uniform(time_left.shape, lo, hi)
        self.state["time_left"].copy_(torch.where(mask, new_t, time_left))

    def compute(self, dt: float) -> None:
        """Per-control-step update: metrics, the time-based resample, the
        command's post-processing."""
        self._update_metrics()
        time_left = self.state["time_left"] - dt
        due = time_left <= 0.0
        self._resample_time(due, time_left)
        self._resample(due)
        self._update_command()

    def reset(self, env_mask) -> dict:
        self._resample_time(env_mask, self.state["time_left"])
        self._resample(env_mask)
        self._update_command()
        logs = {}
        n = torch.clamp(env_mask.sum(), min=1)
        for mname, mval in self.state.get("metrics", {}).items():
            logs[f"Metrics/{self.name}/{mname}"] = torch.where(env_mask, mval, 0.0).sum() / n
            mval.masked_fill_(env_mask, 0.0)
        return logs


class CommandManager(ManagerBase):
    def _prepare_terms(self) -> None:
        self._terms: dict[str, CommandTerm] = {}
        for name, term_cfg in _cfg_items(self.cfg):
            if term_cfg is None or not hasattr(term_cfg, "class_type"):
                continue
            term = term_cfg.class_type(term_cfg, self._env)
            term.name = name
            self._terms[name] = term

    @property
    def active_terms(self) -> list[str]:
        return list(self._terms)

    def get_command(self, name: str) -> torch.Tensor:
        return self._terms[name].command

    def get_term(self, name: str) -> CommandTerm:
        return self._terms[name]

    def init_state(self, num_envs: int) -> None:
        for term in self._terms.values():
            term.state = term.init_state(num_envs)

    def state_tensors(self) -> list[torch.Tensor]:
        return [t for term in self._terms.values() for t in term.state_tensors()]

    def compute(self, dt: float) -> None:
        for term in self._terms.values():
            term.compute(dt)

    def reset(self, env_mask) -> dict:
        logs = {}
        for term in self._terms.values():
            logs.update(term.reset(env_mask))
        return logs


class NullCommandManager:
    """Stands in when cfg.commands is None."""

    active_terms: list = []

    def __init__(self, env):
        self._env = env

    def init_state(self, num_envs):
        pass

    def state_tensors(self):
        return []

    def get_command(self, name):
        return None

    def get_term(self, name):
        return None

    def compute(self, dt):
        pass

    def reset(self, env_mask):
        return {}
