"""Batched ring buffers: observation history and stochastic delay.

PyTorch counterpart of mjlab_tpu/utils/buffers.py (circular_buffer_* and
delay_buffer_*, buffers.py:28-183), with the same semantics: fixed-shape
time-major storage, a masked per-env reset with first-append backfill,
LIFO lag indexing, per-env stochastic lags with a hold probability,
multi-rate update periods and per-env phase staggering. The JAX package
returns new states; here each buffer is an object whose tensors are
updated in place (no host read of a device value), so that a captured env
step carries them.
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.utils.random import Rng


class CircularBuffer:
    """``buf`` (T, B, ...) ring storage, ``ptr`` () int32 the next write
    slot (monotonic, taken mod T), ``num_pushes`` (B,) int32 pushes since
    each env's last reset."""

    def __init__(self, max_len: int, batch: int, shape: tuple,
                 dtype=torch.float32, device="cpu"):
        self.buf = torch.zeros((max_len, batch) + tuple(shape), dtype=dtype, device=device)
        self.ptr = torch.zeros((), dtype=torch.int32, device=device)
        self.num_pushes = torch.zeros((batch,), dtype=torch.int32, device=device)

    @property
    def max_len(self) -> int:
        return self.buf.shape[0]

    def tensors(self) -> list[torch.Tensor]:
        return [self.buf, self.ptr, self.num_pushes]

    def reset(self, mask: torch.Tensor) -> None:
        """Invalidate the masked envs' history."""
        self.num_pushes.masked_fill_(mask, 0)

    def append(self, value: torch.Tensor) -> None:
        """Append a batch frame; envs with no push since their reset get the
        value in every slot, so reads before the window fills return the
        oldest real frame."""
        T = self.max_len
        slot = torch.remainder(self.ptr, T).reshape(1).long()
        value = value.to(self.buf.dtype)
        self.buf.index_copy_(0, slot, value[None])
        first = (self.num_pushes == 0).reshape((1, -1) + (1,) * (value.ndim - 1))
        self.buf.copy_(torch.where(first, value[None], self.buf))
        self.ptr.add_(1)
        self.num_pushes.add_(1)

    def get(self, lag) -> torch.Tensor:
        """LIFO read: lag 0 the newest frame, lag k k pushes ago; lag () or
        (B,), clamped to each env's valid history."""
        T, B = self.buf.shape[:2]
        dev = self.buf.device
        if isinstance(lag, torch.Tensor):
            lag = lag.to(torch.int32).expand(B)
        else:
            lag = torch.full((B,), int(lag), dtype=torch.int32, device=dev)
        valid = torch.clamp(self.num_pushes - 1, min=0)
        lag = torch.clamp(torch.minimum(lag, valid), max=T - 1)
        newest = torch.remainder(self.ptr - 1, T)
        idx = torch.remainder(newest - lag, T).long()
        return self.buf[idx, torch.arange(B, device=dev)]

    def window(self) -> torch.Tensor:
        """The whole history, batch-first and oldest first: (B, T, ...)."""
        T = self.max_len
        newest = torch.remainder(self.ptr - 1, T)
        lags = torch.arange(T - 1, -1, -1, dtype=torch.int32, device=self.buf.device)
        idx = torch.remainder(newest - lags, T).long()
        return self.buf[idx].transpose(0, 1)


class DelayBuffer:
    """A history of max_lag + 1 frames read at a per-env lag, resampled in
    [min_lag, max_lag] every update_period pushes (each env at its own
    phase), keeping the previous lag with probability hold_prob."""

    def __init__(self, max_lag: int, batch: int, shape: tuple, dtype=torch.float32,
                 min_lag: int = 0, update_period: int = 0, hold_prob: float = 0.0,
                 per_env_phase: bool = False, rng: Rng | None = None, device="cpu"):
        self.hist = CircularBuffer(max_lag + 1, batch, shape, dtype, device)
        if per_env_phase and update_period > 1:
            assert rng is not None
            self.phase = rng.integers((batch,), 0, update_period)
        else:
            self.phase = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.lag = torch.full((batch,), min_lag, dtype=torch.int32, device=device)
        self.min_lag = torch.full((batch,), min_lag, dtype=torch.int32, device=device)
        self.max_lag = torch.full((batch,), max_lag, dtype=torch.int32, device=device)
        self.step = torch.zeros((batch,), dtype=torch.int32, device=device)
        self.update_period = int(update_period)
        self.hold_prob = float(hold_prob)

    def tensors(self) -> list[torch.Tensor]:
        return self.hist.tensors() + [self.phase, self.lag, self.min_lag,
                                      self.max_lag, self.step]

    def set_lags(self, min_lag, max_lag) -> None:
        """New lag ranges (per env or shared), for DR events."""
        for t, v in ((self.min_lag, min_lag), (self.max_lag, max_lag)):
            t.copy_(torch.as_tensor(v, dtype=torch.int32, device=t.device).expand_as(t))

    def _sample_lag(self, rng: Rng) -> torch.Tensor:
        lo, hi = self.min_lag, self.max_lag
        u = rng.uniform(lo.shape)
        cand = (lo + (u * (hi - lo + 1).to(u.dtype)).to(torch.int32)).to(torch.int32)
        return torch.clamp(cand, lo, hi)

    def reset(self, mask: torch.Tensor, rng: Rng) -> None:
        """Clear the masked envs' history and resample their lag."""
        self.hist.reset(mask)
        new_lag = self._sample_lag(rng)
        self.lag.copy_(torch.where(mask, new_lag, self.lag))
        self.step.masked_fill_(mask, 0)

    def push(self, value: torch.Tensor, rng: Rng) -> torch.Tensor:
        """Push a frame and return the delayed one."""
        self.hist.append(value)
        B = self.lag.shape[0]
        if self.update_period > 1:
            due = torch.remainder(self.step + self.phase, self.update_period) == 0
        else:
            due = torch.ones((B,), dtype=torch.bool, device=self.lag.device)
        cand = self._sample_lag(rng)
        hold = rng.uniform((B,)) < self.hold_prob
        self.lag.copy_(torch.where(due & ~hold, cand, self.lag))
        self.step.add_(1)
        return self.hist.get(self.lag)
