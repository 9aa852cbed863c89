"""Task registry.

PyTorch counterpart of mjlab_tpu/tasks/registry.py. A task registers its
env configs and, where it has one, its PPO config and runner class;
load_rl_cfg raises for a task registered without a PPO config.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass
from typing import Any

_REGISTRY: dict[str, "TaskEntry"] = {}


@dataclass
class TaskEntry:
    env_cfg: Any
    play_env_cfg: Any
    rl_cfg: Any = None
    runner_cls: type | None = None


def register_mjlab_task(name: str, env_cfg, rl_cfg=None, play_env_cfg=None,
                        runner_cls: type | None = None) -> None:
    if name in _REGISTRY:
        raise ValueError(f"task '{name}' already registered")
    _REGISTRY[name] = TaskEntry(
        env_cfg=env_cfg,
        play_env_cfg=play_env_cfg if play_env_cfg is not None else env_cfg,
        rl_cfg=rl_cfg,
        runner_cls=runner_cls,
    )


def list_tasks() -> list[str]:
    return sorted(_REGISTRY)


def _get(name: str) -> TaskEntry:
    if name not in _REGISTRY:
        raise KeyError(f"unknown task '{name}'; available: {list_tasks()}")
    return _REGISTRY[name]


def _fresh(cfg):
    if callable(cfg) and not hasattr(cfg, "__dataclass_fields__"):
        return cfg()
    return copy.deepcopy(cfg)


def load_env_cfg(name: str, play: bool = False):
    entry = _get(name)
    return _fresh(entry.play_env_cfg if play else entry.env_cfg)


def load_rl_cfg(name: str):
    cfg = _get(name).rl_cfg
    if cfg is None:
        raise NotImplementedError(f"task '{name}' has no PPO config")
    return _fresh(cfg)


def load_runner_cls(name: str):
    return _get(name).runner_cls
