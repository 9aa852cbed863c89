"""Manager base classes.

PyTorch counterpart of mjlab_tpu/managers/manager_base.py. The JAX package
threads term state through a functional context; here a manager and a
class term own their per-env state as tensors updated in place, and list
them in ``state_tensors()`` (the buffers a captured env step reads and
writes, which sim.ControlStep puts back after its warm-up steps).
"""

from __future__ import annotations

import inspect
from typing import TYPE_CHECKING

import torch

from mjlab_tpu_torch.managers.scene_entity_config import SceneEntityCfg

if TYPE_CHECKING:
    from mjlab_tpu_torch.envs.manager_based_rl_env import ManagerBasedRlEnv


def _cfg_items(cfg):
    """(name, value) of a dict-style or dataclass-attribute config."""
    if cfg is None:
        return []
    if isinstance(cfg, dict):
        return list(cfg.items())
    return list(vars(cfg).items())


def tensors_of(obj) -> list[torch.Tensor]:
    """Every tensor in a (nested) dict, list, tuple or object with a
    ``tensors()`` method, in a fixed order."""
    if isinstance(obj, torch.Tensor):
        return [obj]
    if isinstance(obj, dict):
        return [t for v in obj.values() for t in tensors_of(v)]
    if isinstance(obj, (list, tuple)):
        return [t for v in obj for t in tensors_of(v)]
    if hasattr(obj, "tensors"):
        return list(obj.tensors())
    return []


class ManagerTermBase:
    """A class term: configured once, then called like a term function.
    A stateful term keeps its per-env state as tensors of its own, resets
    the masked envs' part in ``reset`` and lists them in
    ``state_tensors``."""

    def __init__(self, cfg, env: "ManagerBasedRlEnv"):
        self.cfg = cfg
        self._env = env

    def state_tensors(self) -> list[torch.Tensor]:
        return []

    def reset(self, env_mask) -> dict:
        """Masked per-env reset of the term's state; an optional log
        dict."""
        return {}

    def __call__(self, env, **kwargs):
        raise NotImplementedError


class ManagerBase:
    def __init__(self, cfg, env: "ManagerBasedRlEnv"):
        self.cfg = cfg
        self._env = env
        self._prepare_terms()

    @property
    def num_envs(self) -> int:
        return self._env.num_envs

    @property
    def device(self) -> torch.device:
        return self._env.device

    def _prepare_terms(self) -> None:
        raise NotImplementedError

    def _resolve_common_term_cfg(self, name: str, term_cfg) -> None:
        """Resolve the SceneEntityCfg params and instantiate class terms."""
        for value in term_cfg.params.values():
            if isinstance(value, SceneEntityCfg):
                value.resolve(self._env.scene)
        if inspect.isclass(term_cfg.func):
            term_cfg.func = term_cfg.func(cfg=term_cfg, env=self._env)

    def state_tensors(self) -> list[torch.Tensor]:
        return []

    def reset(self, env_mask) -> dict:
        return {}
