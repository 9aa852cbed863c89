"""Observation manager: the per-group term pipeline
func -> noise -> clip -> scale -> delay -> history -> concatenation.

PyTorch counterpart of mjlab_tpu/managers/observation_manager.py:71-207.
The delay and history buffers (utils/buffers.py) and the additive noise
biases are per-term state updated in place; the terms' shapes come from
one dry run at construction, as in the JAX package. Each group's output is
a fixed buffer, written in place by every ``compute`` (a captured env step
returns the same tensors each replay).
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.managers.manager_base import ManagerBase, _cfg_items, tensors_of
from mjlab_tpu_torch.managers.manager_term_config import (
    ObservationGroupCfg,
    ObservationTermCfg,
)
from mjlab_tpu_torch.utils.buffers import CircularBuffer, DelayBuffer
from mjlab_tpu_torch.utils.noise import (
    NoiseCfg,
    NoiseModelCfg,
    NoiseModelWithAdditiveBiasCfg,
    sample_bias,
)


class ObservationManager(ManagerBase):
    def _prepare_terms(self) -> None:
        self._groups: dict[str, ObservationGroupCfg] = {}
        self._group_terms: dict[str, dict[str, ObservationTermCfg]] = {}
        for gname, gcfg in _cfg_items(self.cfg):
            if not isinstance(gcfg, ObservationGroupCfg):
                continue
            self._groups[gname] = gcfg
            terms = {}
            for tname, tcfg in gcfg.term_items():
                self._resolve_common_term_cfg(f"{gname}/{tname}", tcfg)
                terms[tname] = tcfg
            self._group_terms[gname] = terms
        self._out: dict[str, object] = {}

    @property
    def active_terms(self) -> dict[str, list[str]]:
        return {g: list(ts) for g, ts in self._group_terms.items()}

    def group_obs_dim(self, group: str) -> int:
        return self._dims[group]

    def _history_len(self, gcfg, tcfg) -> int:
        if gcfg.history_length is not None:
            return gcfg.history_length
        return tcfg.history_length

    def _flatten_history(self, gcfg, tcfg) -> bool:
        """A group's history_length, when set, replaces the term's history
        settings, flatten_history_dim included."""
        if gcfg.history_length is not None:
            return gcfg.flatten_history_dim
        return tcfg.flatten_history_dim

    def init_state(self, num_envs: int) -> None:
        """Dry-run every term to size the delay and history buffers and
        the noise biases."""
        rng = self._env.rng
        self._state: dict[str, dict[str, dict]] = {}
        self._dims: dict[str, int] = {}
        for gname, gcfg in self._groups.items():
            gstate, dim = {}, 0
            for tname, tcfg in self._group_terms[gname].items():
                val = tcfg.func(self._env, **tcfg.params)
                shape = tuple(val.shape[1:])
                tstate: dict = {}
                if tcfg.delay_max_lag > 0:
                    tstate["delay"] = DelayBuffer(
                        max_lag=tcfg.delay_max_lag, batch=num_envs, shape=shape,
                        min_lag=tcfg.delay_min_lag,
                        update_period=tcfg.delay_update_period,
                        hold_prob=tcfg.delay_hold_prob,
                        per_env_phase=tcfg.delay_per_env_phase, rng=rng,
                        device=self.device,
                    )
                hist = self._history_len(gcfg, tcfg)
                if hist > 0:
                    tstate["hist"] = CircularBuffer(hist, num_envs, shape, device=self.device)
                if isinstance(tcfg.noise, NoiseModelWithAdditiveBiasCfg):
                    tstate["bias"] = sample_bias(tcfg.noise, rng, (num_envs,) + shape,
                                                 val.dtype)
                gstate[tname] = tstate
                tdim = int(val.reshape(val.shape[0], -1).shape[-1])
                if hist > 0 and self._flatten_history(gcfg, tcfg):
                    tdim *= hist
                dim += tdim
            self._state[gname] = gstate
            self._dims[gname] = dim

    def state_tensors(self) -> list[torch.Tensor]:
        return tensors_of(self._state) + tensors_of(self._out)

    def compute(self, update_history: bool = True) -> dict:
        """Every group's observation, written into its fixed buffer; returns
        {group: buffer} ({group: {term: buffer}} for a group that does not
        concatenate)."""
        env = self._env
        for gname, gcfg in self._groups.items():
            outs = {}
            for tname, tcfg in self._group_terms[gname].items():
                tstate = self._state[gname][tname]
                val = tcfg.func(env, **tcfg.params)
                # noise
                if gcfg.enable_corruption and tcfg.noise is not None:
                    noise = tcfg.noise
                    if isinstance(noise, NoiseModelCfg):
                        if noise.noise_cfg is not None:
                            val = noise.noise_cfg.apply(env.rng, val)
                        if isinstance(noise, NoiseModelWithAdditiveBiasCfg):
                            val = val + tstate["bias"]
                    elif isinstance(noise, NoiseCfg):
                        val = noise.apply(env.rng, val)
                if tcfg.clip is not None:
                    val = torch.clamp(val, tcfg.clip[0], tcfg.clip[1])
                if tcfg.scale is not None:
                    val = val * env.const(tcfg.scale, val.dtype)
                if "delay" in tstate:
                    if update_history:
                        val = tstate["delay"].push(val, env.rng)
                    else:
                        d = tstate["delay"]
                        val = d.hist.get(d.lag)
                if "hist" in tstate:
                    if update_history:
                        tstate["hist"].append(val)
                    win = tstate["hist"].window()  # (E, T, ...)
                    val = win.reshape(win.shape[0], -1) if self._flatten_history(
                        gcfg, tcfg) else win
                outs[tname] = val
            if gcfg.concatenate_terms:
                self._store(gname, None, torch.cat(list(outs.values()),
                                                   dim=gcfg.concatenate_dim))
            else:
                for tname, val in outs.items():
                    self._store(gname, tname, val)
        return dict(self._out)

    def _store(self, group: str, term: str | None, val: torch.Tensor) -> None:
        """Copy into the group's (or group term's) fixed buffer, made on
        first use."""
        if term is None:
            if group not in self._out:
                self._out[group] = torch.empty_like(val)
            self._out[group].copy_(val)
            return
        bufs = self._out.setdefault(group, {})
        if term not in bufs:
            bufs[term] = torch.empty_like(val)
        bufs[term].copy_(val)

    def reset(self, env_mask) -> dict:
        rng = self._env.rng
        for gname in self._groups:
            for tname, tcfg in self._group_terms[gname].items():
                tstate = self._state[gname][tname]
                if "delay" in tstate:
                    tstate["delay"].reset(env_mask, rng)
                if "hist" in tstate:
                    tstate["hist"].reset(env_mask)
                if "bias" in tstate:
                    bias = tstate["bias"]
                    new = sample_bias(tcfg.noise, rng, bias.shape, bias.dtype)
                    m = env_mask.reshape((-1,) + (1,) * (bias.ndim - 1))
                    bias.copy_(torch.where(m, new, bias))
        return {}
