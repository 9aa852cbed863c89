"""ManagerBasedRlEnv: the manager-based RL environment.

PyTorch counterpart of mjlab_tpu/envs/manager_based_rl_env.py, with its
config surface, manager load order (222-276) and step and reset
semantics. The JAX package runs the whole control step as one jitted
function over an EnvState pytree; here it is one sim.ControlStep over
state kept as device tensors updated in place, captured on the card as one
CUDA graph. A step is, in the JAX env's order (_traced_step, 419-469):

1. the action into the action manager;
2. decimation x (the action terms' targets, the actuators' ctrl, the
   physics step, the sensors' update), with no refresh: the last substep
   writes the frames of the state it started from, as mj_step leaves them
   (and the JAX package's batched step on the CPU), so that the
   terminations and rewards read frames one substep behind qpos;
3. the episode counters;
4. the NaN guard's record and check, where it is enabled; terminations,
   then rewards;
5. the masked reset of the envs that are done, then the kinematic
   refresh of every env;
6. the command, the interval events, the observations.

Resets are masks on the device (no host read of which envs reset), and
every random draw comes from the env's Rng (utils/random.py), one
torch.Generator that a capture registers with its graph.

The inputs and results of ``step`` are fixed buffers: the action is
copied into one before the step, and the observations (each group), the
reward, terminated, truncated and the logs (``extras["log"]``, device
scalars) are the same tensors after every step, overwritten by the next:
a caller who keeps them across steps must clone them. On the card the
first ``step`` captures the graph (two eager warm-up steps on a side
stream, whose effects are put back) and every step is one replay; pass
``capture=False`` to run every step op by op. On the CPU steps run op by
op (the plain PyTorch versions of the kernels).
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any

import numpy as np
import torch

from mjlab_tpu_torch.managers.action_manager import ActionManager
from mjlab_tpu_torch.managers.command_manager import CommandManager, NullCommandManager
from mjlab_tpu_torch.managers.curriculum_manager import (
    CurriculumManager,
    NullCurriculumManager,
)
from mjlab_tpu_torch.managers.event_manager import EventManager
from mjlab_tpu_torch.managers.manager_term_config import EventTermCfg
from mjlab_tpu_torch.managers.observation_manager import ObservationManager
from mjlab_tpu_torch.managers.reward_manager import RewardManager
from mjlab_tpu_torch.managers.termination_manager import TerminationManager
from mjlab_tpu_torch.phys.model import load_model, resolve_device
from mjlab_tpu_torch.scene.scene import Scene, SceneCfg
from mjlab_tpu_torch.sim.sim import ControlStep, Simulation, SimulationCfg
from mjlab_tpu_torch.utils.random import Rng
from mjlab_tpu_torch.utils.spaces import Box, DictSpace


@dataclass
class DefaultEventsCfg:
    """The default event set: every entity back to its default state on
    reset."""

    reset_scene_to_default: EventTermCfg = field(
        default_factory=lambda: EventTermCfg(func=None, mode="reset"))

    def __post_init__(self):
        if self.reset_scene_to_default.func is None:
            from mjlab_tpu_torch.envs.mdp.events import reset_scene_to_default

            self.reset_scene_to_default.func = reset_scene_to_default


@dataclass
class ViewerConfig:
    origin_type: str = "world"
    asset_name: str | None = None
    distance: float = 5.0
    azimuth: float = 90.0
    elevation: float = -30.0
    width: int = 1280
    height: int = 720


@dataclass(kw_only=True)
class ManagerBasedRlEnvCfg:
    decimation: int = 1
    scene: SceneCfg = field(default_factory=SceneCfg)
    observations: Any = None
    actions: Any = None
    events: Any = field(default_factory=DefaultEventsCfg)
    seed: int | None = None
    sim: SimulationCfg = field(default_factory=SimulationCfg)
    viewer: ViewerConfig = field(default_factory=ViewerConfig)
    episode_length_s: float = 0.0
    rewards: Any = None
    terminations: Any = None
    commands: Any = None
    curriculum: Any = None
    is_finite_horizon: bool = False


class ManagerBasedRlEnv:
    """See the module docstring."""

    is_vector_env = True
    metadata = {"render_modes": [None]}

    def __init__(self, cfg: ManagerBasedRlEnvCfg, device: str | torch.device = "cuda",
                 render_mode=None, capture: bool = True):
        if render_mode is not None:
            raise NotImplementedError("rendering is not ported yet")
        self.cfg = cfg
        self.device = resolve_device(device)
        self.render_mode = render_mode
        self.rng = Rng(cfg.seed if cfg.seed is not None else 0, self.device)
        self._consts: dict = {}

        # 1. the scene and its Model: from the scene's model file (no
        # MuJoCo), else compiled from the spec
        self.scene = Scene(cfg.scene)
        model, xml_sensors = self._scene_model()
        self.sim = Simulation(self.num_envs, cfg.sim, model, self.device)

        # 2. the scene's runtime on the Simulation, and the refresh that the
        # managers' dry runs read
        self.scene.initialize(self.sim, xml_sensors, rng=self.rng)

        # the NaN guard (mjlab_tpu/envs/manager_based_rl_env.py:190-199): a
        # rolling history of the physics state, recorded inside the step
        self.nan_guard = None
        guard_cfg = cfg.sim.nan_guard
        if guard_cfg is not None and guard_cfg.enabled:
            from mjlab_tpu_torch.utils.nan_guard import NanGuard

            m = self.sim.model
            self.nan_guard = NanGuard(guard_cfg, self.num_envs, m.nq, m.nv, m.nu,
                                      self.device, model=self._shared_model)
        self.sim.refresh()

        # 3. the terrain's per-env state, then the managers, in the JAX
        # env's load order
        E = self.num_envs
        self.episode_length_buf = torch.zeros((E,), dtype=torch.int32, device=self.device)
        self.common_step_counter = torch.zeros((), dtype=torch.int32, device=self.device)
        if self.scene.terrain is not None:
            self.scene.terrain.init_state(self.rng)

        self.event_manager = EventManager(cfg.events, self)
        dr_fields = self.event_manager.domain_randomization_fields
        if dr_fields:
            self.sim.expand_model_fields(dr_fields)
        self.event_manager.init_state(E)

        self.command_manager = (CommandManager(cfg.commands, self) if cfg.commands is not None
                                else NullCommandManager(self))
        self.command_manager.init_state(E)
        self.action_manager = ActionManager(cfg.actions, self)
        self.action_manager.init_state(E)
        self.observation_manager = ObservationManager(cfg.observations, self)
        self.observation_manager.init_state(E)
        self.termination_manager = TerminationManager(cfg.terminations, self)
        self.termination_manager.init_state(E)
        self.reward_manager = RewardManager(cfg.rewards, self)
        self.reward_manager.init_state(E)
        self.curriculum_manager = (CurriculumManager(cfg.curriculum, self)
                                   if cfg.curriculum is not None
                                   else NullCurriculumManager(self))
        self.curriculum_manager.init_state(E)

        # 4. startup events (domain randomisation of the expanded fields),
        # before any capture: the graph holds the Model it saw
        self.event_manager.apply_startup()

        if not os.environ.get("MJLAB_QUIET"):
            self._print_manager_tables()
        self._build_spaces()

        # 5. the fixed input buffer, the logs, and the control step
        self._action_in = torch.zeros((E, self.action_manager.total_action_dim),
                                      dtype=torch.float32, device=self.device)
        self._term_log: dict[str, torch.Tensor] = {}
        self._log_out: dict[str, torch.Tensor] = {}
        self._obs: dict = {}
        self._capture = capture and self.device.type == "cuda"
        dt = self.physics_dt
        self._step = ControlStep(
            self.sim, cfg.decimation,
            pre_substep=self._pre_substep,
            post_substep=lambda: self.scene.update(dt),
            state=self._state_tensors,
            before=lambda: self.action_manager.process_action(self._action_in),
            after=self._after_physics,
            generators=(self.rng.generator,) if self.device.type == "cuda" else (),
            frames_last=True,
        )

    # -- helpers --

    @property
    def rng(self) -> Rng:
        """The env's random source; setting it also points the scene's
        actuator groups at the new one."""
        return self._rng

    @rng.setter
    def rng(self, rng) -> None:
        self._rng = rng
        ctx = getattr(getattr(self, "scene", None), "ctx", None)
        if ctx is not None:
            ctx.rng = rng

    def _scene_model(self):
        """(Model or MjModel, the XML sensor rows) of the scene; a Model
        from the scene's model file gets the scene's generated terrain."""
        from mjlab_tpu_torch.scene.scene import xml_sensors, xml_sensors_from_arrays

        path = self.cfg.scene.model_file
        if path is not None:
            model, extra = load_model(Path(path), dtype=torch.float64, device="cpu")
            terrain = self.scene.terrain
            generated = terrain is not None and terrain.generator is not None
            if generated != bool(model.nhfield):
                raise ValueError(
                    f"the model file {path} holds {model.nhfield} height fields; the "
                    f"scene's terrain is {'generated' if generated else 'not generated'}")
            if generated:
                model = terrain.fill_hfield(model)
            return model, xml_sensors_from_arrays(extra)
        mj = self.scene.compile()
        return mj, xml_sensors(mj)

    def _shared_model(self):
        """The Simulation's Model with every per-env field at its shared
        value (what the NaN guard writes beside its dump)."""
        import dataclasses

        return dataclasses.replace(self.sim.model, **self.sim._default_fields)

    def const(self, value, dtype: torch.dtype = torch.float32) -> torch.Tensor:
        """A constant tensor on the env's device, made once per value (a
        term reads it inside a captured step without a host copy)."""
        arr = np.asarray(value)
        key = (arr.dtype.str, arr.shape, arr.tobytes(), dtype)
        t = self._consts.get(key)
        if t is None:
            t = self._consts[key] = torch.as_tensor(arr, device=self.device).to(dtype)
        return t

    @property
    def num_envs(self) -> int:
        return self.cfg.scene.num_envs

    @property
    def physics_dt(self) -> float:
        return self.cfg.sim.mujoco.timestep

    @property
    def step_dt(self) -> float:
        return self.cfg.sim.mujoco.timestep * self.cfg.decimation

    @property
    def max_episode_length_s(self) -> float:
        return self.cfg.episode_length_s

    @property
    def max_episode_length(self) -> int:
        # play variants turn the time-out off with episode_length_s=1e9;
        # clamped to int32, the episode counters' type
        n = int(np.ceil(self.cfg.episode_length_s / self.step_dt))
        return min(n, np.iinfo(np.int32).max)

    @property
    def extras(self) -> dict:
        """{"log": ...} that terms write their Metrics/ logs into during a
        step."""
        return {"log": self._term_log}

    @property
    def captured(self) -> bool:
        return self._step.graph is not None

    def _print_manager_tables(self) -> None:
        for name, mgr in (
            ("Observations", self.observation_manager),
            ("Actions", self.action_manager),
            ("Rewards", self.reward_manager),
            ("Terminations", self.termination_manager),
            ("Events", self.event_manager),
            ("Commands", self.command_manager),
            ("Curriculum", self.curriculum_manager),
        ):
            terms = mgr.active_terms
            if not terms:
                continue
            if isinstance(terms, dict):
                rows = [f"  {g}: {', '.join(ts)}" for g, ts in terms.items()]
                if name == "Observations":
                    rows = [f"  {g} (dim {self.observation_manager.group_obs_dim(g)}): "
                            f"{', '.join(ts)}" for g, ts in terms.items()]
            elif name == "Rewards":
                rows = [f"  {t}: {self.reward_manager.get_term_cfg(t).weight:+.3g}"
                        for t in terms]
            else:
                rows = [f"  {t}" for t in terms]
            print(f"[{name}]\n" + "\n".join(rows))

    def _build_spaces(self) -> None:
        self.single_action_space = Box(-np.inf, np.inf,
                                       (self.action_manager.total_action_dim,))
        self.single_observation_space = DictSpace({
            g: Box(-np.inf, np.inf, (self.observation_manager.group_obs_dim(g),))
            for g in self.observation_manager.active_terms
        })

    def _state_tensors(self) -> list[torch.Tensor]:
        """Every tensor a step reads and writes besides the Data: the
        counters, the scene's and the managers' state, the per-env Model
        fields, the outputs."""
        out = [self.episode_length_buf, self.common_step_counter]
        out += self.scene.state_tensors()
        for mgr in (self.event_manager, self.command_manager, self.action_manager,
                    self.observation_manager, self.termination_manager,
                    self.reward_manager, self.curriculum_manager):
            out += mgr.state_tensors()
        out += [getattr(self.sim.model, n) for n in self.sim._default_fields]
        if self.nan_guard is not None:
            out += self.nan_guard.state_tensors()
        # last: the first step adds its logs' buffers
        out += list(self._log_out.values())
        return out

    # -- the step's parts --

    def _pre_substep(self) -> None:
        self.action_manager.apply_action()
        self.scene.write_data_to_sim()

    def _refresh_kinematics(self) -> None:
        """The kinematic refresh of every env (frames, com, velocities)."""
        self.sim.refresh()

    def _reset_masked(self, mask: torch.Tensor) -> dict:
        """Masked reset of all composed state, in the JAX env's order."""
        logs = {}
        logs.update(self.curriculum_manager.compute(mask))
        self.scene.reset(mask)
        self.event_manager.apply_reset(mask)
        logs.update(self.observation_manager.reset(mask))
        logs.update(self.action_manager.reset(mask))
        logs.update(self.reward_manager.reset(mask))
        logs.update(self.command_manager.reset(mask))
        logs.update(self.termination_manager.reset(mask))
        n = torch.clamp(mask.sum(), min=1)
        logs["Episode/length"] = torch.where(mask, self.episode_length_buf, 0).sum() / n
        self.episode_length_buf.masked_fill_(mask, 0)
        return logs

    def _after_physics(self) -> None:
        """Everything of a step after the decimation loop."""
        if self.nan_guard is not None:
            self.nan_guard.record(self.sim.data)
        self._term_log.clear()
        self.episode_length_buf.add_(1)
        self.common_step_counter.add_(1)
        terminated, truncated = self.termination_manager.compute()
        self.reward_manager.compute(self.step_dt)
        logs = self._reset_masked(terminated | truncated)
        self._refresh_kinematics()
        self.command_manager.compute(self.step_dt)
        self.event_manager.apply_interval(self.step_dt)
        with self.scene.ctx.read_group():
            self._obs = self.observation_manager.compute(update_history=True)
        logs.update(self._term_log)
        for k, v in logs.items():
            if k not in self._log_out:
                self._log_out[k] = torch.zeros((), dtype=torch.float32, device=self.device)
            self._log_out[k].copy_(v)

    # -- public API --

    def step(self, action: torch.Tensor):
        """One control step: (obs, reward, terminated, truncated, extras),
        each a fixed buffer (see the module docstring)."""
        self._action_in.copy_(action)
        if self._capture:
            if self._step.graph is None:
                self._step.capture()
            self._step.replay()
        else:
            self._step.eager()
        tm = self.termination_manager
        extras = {"log": self._log_out, "time_outs": tm.truncated}
        return self._obs, self.reward_manager.reward, tm.terminated, tm.truncated, extras

    def reset(self, seed: int | None = None, options=None):
        """Reset every env (op by op, outside any graph): (obs, {"log":
        ...})."""
        if seed is not None:
            self.seed(seed)
        mask = torch.ones((self.num_envs,), dtype=torch.bool, device=self.device)
        self._term_log.clear()
        logs = self._reset_masked(mask)
        self._refresh_kinematics()
        self.command_manager.compute(self.step_dt)
        with self.scene.ctx.read_group():
            self._obs = self.observation_manager.compute(update_history=True)
        return self._obs, {"log": logs}

    def seed(self, seed: int) -> int:
        self.rng.generator.manual_seed(int(seed))
        return seed

    def render(self):
        return None

    def close(self) -> None:
        """Write the NaN guard's dump if an env went bad (a host read)."""
        if self.nan_guard is not None:
            self.nan_guard.dump_if_detected()
