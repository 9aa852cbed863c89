"""Noise configs and the noise models of the observation pipeline.

PyTorch counterpart of mjlab_tpu/utils/noise.py: NoiseCfg with add / scale
/ abs operations (Constant, Uniform, Gaussian), the noise models, and the
per-episode additive bias of NoiseModelWithAdditiveBiasCfg. The draws come
from the env's Rng (utils/random.py): ``apply(rng, x)`` in place of the
JAX package's ``apply(key, x)``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch

from mjlab_tpu_torch.utils.random import Rng


@dataclass
class NoiseCfg:
    operation: Literal["add", "scale", "abs"] = "add"

    def sample(self, rng: Rng, shape, dtype) -> torch.Tensor:
        raise NotImplementedError

    def apply(self, rng: Rng, x: torch.Tensor) -> torch.Tensor:
        n = self.sample(rng, x.shape, x.dtype)
        if self.operation == "add":
            return x + n
        if self.operation == "scale":
            return x * n
        return n  # abs: replace


@dataclass
class ConstantNoiseCfg(NoiseCfg):
    bias: float = 0.0

    def sample(self, rng, shape, dtype):
        return torch.full(tuple(shape), self.bias, dtype=dtype, device=rng.device)


@dataclass
class UniformNoiseCfg(NoiseCfg):
    n_min: float = -1.0
    n_max: float = 1.0

    def sample(self, rng, shape, dtype):
        return rng.uniform(shape, self.n_min, self.n_max, dtype)


@dataclass
class GaussianNoiseCfg(NoiseCfg):
    mean: float = 0.0
    std: float = 1.0

    def sample(self, rng, shape, dtype):
        return self.mean + self.std * rng.normal(shape, dtype)


@dataclass
class NoiseModelCfg:
    noise_cfg: NoiseCfg | None = None


@dataclass
class NoiseModelWithAdditiveBiasCfg(NoiseModelCfg):
    bias_noise_cfg: NoiseCfg | None = None


def sample_bias(cfg: NoiseModelWithAdditiveBiasCfg, rng: Rng, shape, dtype):
    """Per-episode additive bias, resampled on reset (zeros without a bias
    noise config)."""
    if cfg.bias_noise_cfg is None:
        return torch.zeros(tuple(shape), dtype=dtype, device=rng.device)
    return cfg.bias_noise_cfg.sample(rng, shape, dtype)


def apply_noise(cfg: NoiseCfg | None, rng: Rng, x: torch.Tensor) -> torch.Tensor:
    if cfg is None:
        return x
    return cfg.apply(rng, x)
