"""Minimal gym-free spaces.

PyTorch-package copy of mjlab_tpu/utils/spaces.py (no JAX in it, but the
port imports nothing of the JAX package).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np


@dataclass
class Box:
    low: float
    high: float
    shape: tuple
    dtype: type = np.float32


@dataclass
class DictSpace:
    spaces: dict = field(default_factory=dict)

    def __getitem__(self, k):
        return self.spaces[k]

    def items(self):
        return self.spaces.items()


def batch_space(space, n: int):
    if isinstance(space, Box):
        return Box(space.low, space.high, (n,) + tuple(space.shape), space.dtype)
    if isinstance(space, DictSpace):
        return DictSpace({k: batch_space(v, n) for k, v in space.items()})
    raise TypeError(space)
