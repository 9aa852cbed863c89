"""The lifting command: a target position per episode, with dynamic
difficulty, and the object's pose drawn at every resample.

PyTorch counterpart of mjlab_tpu/tasks/manipulation/mdp/commands.py, as a
masked in-place command term: the target, the success flag, the time left
and the metrics are tensors updated in place, and a resample writes the
object's free joint (pose and zero velocity) for the masked envs inside
a captured env step.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Literal

import numpy as np
import torch

from mjlab_tpu_torch.managers.command_manager import CommandTerm
from mjlab_tpu_torch.managers.manager_term_config import CommandTermCfg
from mjlab_tpu_torch.utils.math import quat_from_euler_xyz

# the target of difficulty "fixed", relative to the env origin
_FIXED_TARGET = (0.4, 0.0, 0.3)


class LiftingCommand(CommandTerm):
    cfg: "LiftingCommandCfg"

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        self.object = env.scene[cfg.asset_name]

    def init_state(self, num_envs: int) -> dict:
        dev = self._env.device
        z = lambda *s: torch.zeros((num_envs,) + s, dtype=torch.float32, device=dev)  # noqa: E731
        return {
            "target_pos": z(3),
            "episode_success": z(),
            "time_left": z(),
            "metrics": {"object_height": z(), "position_error": z(), "at_goal": z(),
                        "episode_success": z()},
        }

    def _get_command(self) -> torch.Tensor:
        return self.state["target_pos"]

    @property
    def target_pos(self) -> torch.Tensor:
        return self.state["target_pos"]

    def compute_success(self) -> torch.Tensor:
        return self.state["metrics"]["position_error"] < self.cfg.success_threshold

    def _update_metrics(self) -> None:
        s = self.state
        obj_pos = self.object.data.root_link_pos_w
        err = torch.linalg.vector_norm(s["target_pos"] - obj_pos, dim=-1)
        at_goal = (err < self.cfg.success_threshold).to(torch.float32)
        s["episode_success"].copy_(torch.maximum(s["episode_success"], at_goal))
        m = s["metrics"]
        m["object_height"].copy_(obj_pos[:, 2])
        m["position_error"].copy_(err)
        m["at_goal"].copy_(at_goal)
        m["episode_success"].copy_(s["episode_success"])

    def _box(self, r) -> tuple[torch.Tensor, torch.Tensor]:
        """A range config's (x, y, z) bounds as float32 constants."""
        lo, hi = (np.asarray([r.x[i], r.y[i], r.z[i]], np.float32) for i in (0, 1))
        return self._env.const(lo), self._env.const(hi)

    def _resample(self, mask: torch.Tensor) -> None:
        """For the masked envs: the success flag cleared, a new target
        (dynamic: uniform in target_position_range about the env origin)
        and, with object_pose_range, the object at a uniform position and
        yaw, at rest. Draws in the JAX term's order: the target, the
        object's position, its yaw."""
        s = self.state
        E = mask.shape[0]
        env = self._env
        origins = env.scene.env_origins
        s["episode_success"].masked_fill_(mask, 0.0)

        if self.cfg.difficulty == "fixed":
            tgt = env.const(np.asarray(_FIXED_TARGET, np.float32)) + origins
        else:
            lo, hi = self._box(self.cfg.target_position_range)
            tgt = lo + env.rng.uniform((E, 3)) * (hi - lo) + origins
        s["target_pos"].copy_(torch.where(mask[:, None], tgt, s["target_pos"]))

        r = self.cfg.object_pose_range
        if r is not None:
            lo, hi = self._box(r)
            pos = lo + env.rng.uniform((E, 3)) * (hi - lo) + origins
            yaw = env.rng.uniform((E,), r.yaw[0], r.yaw[1])
            zero = torch.zeros_like(yaw)
            pose = torch.cat([pos, quat_from_euler_xyz(zero, zero, yaw).to(pos.dtype)], -1)
            data = self.object.data
            data.write_root_pose(pose, mask)
            data.write_root_velocity(torch.zeros((E, 6), dtype=pos.dtype, device=pos.device),
                                     mask)


@dataclass(kw_only=True)
class LiftingCommandCfg(CommandTermCfg):
    asset_name: str
    class_type: type = LiftingCommand
    success_threshold: float = 0.05
    difficulty: Literal["fixed", "dynamic"] = "fixed"

    @dataclass
    class TargetPositionRangeCfg:
        x: tuple[float, float] = (0.3, 0.5)
        y: tuple[float, float] = (-0.2, 0.2)
        z: tuple[float, float] = (0.2, 0.4)

    target_position_range: TargetPositionRangeCfg = field(
        default_factory=TargetPositionRangeCfg)

    @dataclass
    class ObjectPoseRangeCfg:
        x: tuple[float, float] = (0.3, 0.35)
        y: tuple[float, float] = (-0.1, 0.1)
        z: tuple[float, float] = (0.02, 0.05)
        yaw: tuple[float, float] = (-math.pi, math.pi)

    object_pose_range: ObjectPoseRangeCfg | None = field(default_factory=ObjectPoseRangeCfg)
