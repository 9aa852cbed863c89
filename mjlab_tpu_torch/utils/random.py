"""The env's random source: every random draw of the port goes through
``Rng.draw``.

The JAX package splits a threefry key per draw (``ctx.next_key()``); the
port draws from one explicit torch.Generator on the env's device (Philox on
the card). A captured env step registers that generator with its CUDA
graph (sim.ControlStep), so that each replay draws fresh numbers. Because
every draw passes through ``draw``, a test can substitute the JAX
package's draws for the port's by overriding that one method.

The kinds are those the JAX package draws: "uniform", "normal",
"integers" and "categorical" (jax.random.uniform, normal, randint,
categorical) for the env, "normal" and "permutation"
(jax.random.permutation of range(n), one per learning epoch) for the
learner, which has a Rng of its own. A categorical draw inverts the CDF of
its probabilities at one uniform draw per sample (JAX takes the arg max of
Gumbel noise: the same distribution, other numbers).

The samplers keep the JAX package's formulas: ``uniform(shape, lo, hi)``
is jax.random.uniform with minval/maxval (lo + u (hi - lo), at least lo);
where the JAX code draws a unit uniform and scales it itself, the port
does the same with ``uniform(shape)``.
"""

from __future__ import annotations

import numpy as np
import torch

_NP = {torch.float32: np.float32, torch.float64: np.float64}


class Rng:
    """Random draws on one device from one torch.Generator."""

    def __init__(self, seed: int, device: str | torch.device):
        self.device = torch.device(device)
        self.generator = torch.Generator(device=self.device)
        self.generator.manual_seed(int(seed))

    def draw(self, kind: str, shape: tuple, dtype: torch.dtype,
             low: int = 0, high: int = 1, probs: torch.Tensor | None = None) -> torch.Tensor:
        """The one source of randomness: ``kind`` "uniform" ([0, 1)),
        "normal" (N(0, 1)), "integers" ([low, high), int32), "categorical"
        (indices into ``probs`` (n,), non-negative and not all zero, with
        those relative weights; int64) or "permutation" (a permutation of
        range(shape[0]), int64)."""
        g, dev = self.generator, self.device
        if kind == "categorical":
            cdf = torch.cumsum(probs, 0)
            u = torch.rand(shape, generator=g, device=dev, dtype=cdf.dtype)
            idx = torch.searchsorted(cdf, (u * cdf[-1]).contiguous(), right=True)
            return idx.clamp_max(cdf.shape[0] - 1)
        if kind == "uniform":
            return torch.rand(shape, generator=g, device=dev, dtype=dtype)
        if kind == "normal":
            return torch.randn(shape, generator=g, device=dev, dtype=dtype)
        if kind == "integers":
            return torch.randint(low, high, shape, generator=g, device=dev,
                                 dtype=torch.int32)
        if kind == "permutation":
            return torch.randperm(shape[0], generator=g, device=dev, dtype=torch.int64)
        raise ValueError(f"unknown draw kind {kind!r}")

    def uniform(self, shape, lo=0.0, hi=1.0, dtype=torch.float32) -> torch.Tensor:
        """U[lo, hi) of ``shape``; lo and hi are numbers or tensors that
        broadcast against it."""
        u = self.draw("uniform", tuple(shape), dtype)
        if isinstance(lo, torch.Tensor):
            return torch.maximum(u * (hi - lo) + lo, lo.to(dtype))
        if lo == 0.0 and hi == 1.0:
            return u
        # the bounds rounded to dtype before their difference, as JAX does
        lo_d, hi_d = (np.asarray(x, dtype=_NP[dtype]) for x in (lo, hi))
        return (u * float(hi_d - lo_d) + float(lo_d)).clamp_min(float(lo_d))

    def normal(self, shape, dtype=torch.float32) -> torch.Tensor:
        return self.draw("normal", tuple(shape), dtype)

    def integers(self, shape, low: int, high: int) -> torch.Tensor:
        return self.draw("integers", tuple(shape), torch.int32, low, high)

    def categorical(self, shape, probs: torch.Tensor) -> torch.Tensor:
        """Indices into probs (n,) drawn with its relative weights."""
        return self.draw("categorical", tuple(shape), torch.int64, probs=probs)

