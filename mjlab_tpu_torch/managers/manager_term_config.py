"""Manager term configuration dataclasses.

PyTorch counterpart of mjlab_tpu/managers/manager_term_config.py, with the
same config surface, so that task definitions read the same. Term
functions take (env, **params) and return batched tensors on the env's
device; class terms subclass ManagerTermBase.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Literal

from mjlab_tpu_torch.utils.noise import NoiseCfg, NoiseModelCfg


@dataclass
class ManagerTermBaseCfg:
    func: Callable = None
    params: dict[str, Any] = field(default_factory=dict)


@dataclass
class ActionTermCfg:
    class_type: type = None
    asset_name: str = "robot"
    clip: dict[str, tuple] | None = None
    debug_vis: bool = False


@dataclass
class CommandTermCfg:
    class_type: type = None
    resampling_time_range: tuple[float, float] = (10.0, 10.0)
    debug_vis: bool = False


@dataclass
class CurriculumTermCfg(ManagerTermBaseCfg):
    pass


@dataclass
class EventTermCfg(ManagerTermBaseCfg):
    mode: Literal["startup", "reset", "interval"] = "reset"
    interval_range_s: tuple[float, float] | None = None
    is_global_time: bool = False
    min_step_count_between_reset: int = 0
    domain_randomization: bool = False
    """Marks terms whose params['field'] names a Model field that must get a
    leading env axis (Simulation.expand_model_fields)."""


@dataclass
class ObservationTermCfg(ManagerTermBaseCfg):
    """Pipeline per step: func -> noise -> clip -> scale -> delay ->
    history."""

    noise: NoiseCfg | NoiseModelCfg | None = None
    clip: tuple[float, float] | None = None
    scale: float | tuple | None = None
    # delay
    delay_min_lag: int = 0
    delay_max_lag: int = 0
    delay_update_period: int = 0
    delay_hold_prob: float = 0.0
    delay_per_env_phase: bool = True
    # history
    history_length: int = 0
    flatten_history_dim: bool = True


@dataclass
class ObservationGroupCfg:
    concatenate_terms: bool = True
    concatenate_dim: int = -1
    enable_corruption: bool = False
    history_length: int | None = None
    flatten_history_dim: bool = True
    # term cfgs in the dict, or as extra attributes of the dataclass
    terms: dict[str, ObservationTermCfg] = field(default_factory=dict)

    def term_items(self):
        """(name, ObservationTermCfg) from the dict and from any extra
        dataclass attributes."""
        out = list(self.terms.items())
        for k, v in vars(self).items():
            if isinstance(v, ObservationTermCfg):
                out.append((k, v))
        return out


@dataclass
class RewardTermCfg(ManagerTermBaseCfg):
    weight: float = 0.0


@dataclass
class TerminationTermCfg(ManagerTermBaseCfg):
    time_out: bool = False
