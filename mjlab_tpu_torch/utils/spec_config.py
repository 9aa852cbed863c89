"""Declarative MjSpec editors (host-side): collision properties by regex.

PyTorch-package counterpart of mjlab_tpu/utils/spec_config.py
(``CollisionCfg`` only: the lights, cameras, textures and materials editors
have no effect on the physics model and are not carried).
"""

from __future__ import annotations

import re
from dataclasses import dataclass
from typing import TYPE_CHECKING, Sequence

import numpy as np

if TYPE_CHECKING:
    import mujoco


def _match(expr_tuple: Sequence[str], name: str) -> bool:
    return any(re.fullmatch(e, name) for e in expr_tuple)


def _resolve_value(value, name: str, default=None):
    """value may be a scalar or a dict of regex->scalar (first match wins)."""
    if isinstance(value, dict):
        for k, v in value.items():
            if re.fullmatch(k, name):
                return v
        return default
    return value


@dataclass
class CollisionCfg:
    """Enable/configure collision on geoms selected by regex. Geoms NOT
    matching geom_names_expr get their collisions disabled
    (contype=conaffinity=0)."""

    geom_names_expr: tuple[str, ...] = (".*",)
    contype: int | dict[str, int] = 1
    conaffinity: int | dict[str, int] = 1
    condim: int | dict[str, int] | None = None
    priority: int | dict[str, int] | None = None
    friction: tuple | dict[str, tuple] | None = None
    solref: tuple | dict[str, tuple] | None = None
    solimp: tuple | dict[str, tuple] | None = None
    disable_other_geoms: bool = True

    def edit_spec(self, spec: "mujoco.MjSpec") -> None:
        for g in spec.geoms:
            name = g.name or ""
            if not _match(self.geom_names_expr, name):
                if self.disable_other_geoms:
                    g.contype = 0
                    g.conaffinity = 0
                continue
            g.contype = int(_resolve_value(self.contype, name, 1))
            g.conaffinity = int(_resolve_value(self.conaffinity, name, 1))
            condim = _resolve_value(self.condim, name)
            if condim is not None:
                g.condim = int(condim)
            priority = _resolve_value(self.priority, name)
            if priority is not None:
                g.priority = int(priority)
            for attr in ("friction", "solref", "solimp"):
                val = _resolve_value(getattr(self, attr), name)
                if val is not None:
                    arr = np.array(getattr(g, attr))
                    arr[: len(val)] = val
                    setattr(g, attr, arr)
