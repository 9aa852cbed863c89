"""Uniform velocity command with heading control, standing envs and
initial-velocity sampling, as a masked in-place command term.

PyTorch counterpart of mjlab_tpu/tasks/velocity/mdp/velocity_command.py.
The command ranges live in the term's state as (2,) device tensors, so a
curriculum widens them inside a captured env step.
"""

from __future__ import annotations

from dataclasses import dataclass, field as dfield

import torch

from mjlab_tpu_torch.managers.command_manager import CommandTerm
from mjlab_tpu_torch.managers.manager_term_config import CommandTermCfg
from mjlab_tpu_torch.utils import math


class UniformVelocityCommand(CommandTerm):
    cfg: "UniformVelocityCommandCfg"

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        if cfg.heading_command and cfg.ranges.heading is None:
            raise ValueError("heading_command=True requires ranges.heading")
        if cfg.ranges.heading and not cfg.heading_command:
            raise ValueError("ranges.heading set but heading_command=False")
        self.robot = env.scene[cfg.asset_name]

    def init_state(self, num_envs: int) -> dict:
        r = self.cfg.ranges
        dev = self._env.device
        f = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        b = lambda: torch.zeros((num_envs,), dtype=torch.bool, device=dev)  # noqa: E731
        rng = lambda v: torch.tensor(v, dtype=torch.float32, device=dev)  # noqa: E731
        return {
            "command": f(num_envs, 3),
            "heading_target": f(num_envs),
            "is_heading_env": b(),
            "is_standing_env": b(),
            "time_left": f(num_envs),
            "ranges": {
                "lin_vel_x": rng(r.lin_vel_x),
                "lin_vel_y": rng(r.lin_vel_y),
                "ang_vel_z": rng(r.ang_vel_z),
                "heading": rng(r.heading if r.heading is not None else (0.0, 0.0)),
            },
            "metrics": {"error_vel_xy": f(num_envs), "error_vel_yaw": f(num_envs)},
        }

    def _get_command(self):
        return self.state["command"]

    def _update_metrics(self):
        max_command_step = self.cfg.resampling_time_range[1] / self._env.step_dt
        s = self.state
        cmd = s["command"]
        lin = self.robot.data.root_link_lin_vel_b
        ang = self.robot.data.root_link_ang_vel_b
        m = s["metrics"]
        m["error_vel_xy"].add_(
            torch.linalg.norm(cmd[:, :2] - lin[:, :2], dim=-1) / max_command_step)
        m["error_vel_yaw"].add_(torch.abs(cmd[:, 2] - ang[:, 2]) / max_command_step)

    def _resample(self, mask):
        s = self.state
        E = mask.shape[0]
        rng, rg = self._env.rng, s["ranges"]

        def u(lohi):
            return lohi[0] + rng.uniform((E,)) * (lohi[1] - lohi[0])

        cmd = torch.stack([u(rg["lin_vel_x"]), u(rg["lin_vel_y"]), u(rg["ang_vel_z"])], -1)
        s["command"].copy_(torch.where(mask[:, None], cmd, s["command"]))
        s["heading_target"].copy_(torch.where(mask, u(rg["heading"]), s["heading_target"]))
        is_heading = rng.uniform((E,)) <= self.cfg.rel_heading_envs
        s["is_heading_env"].copy_(torch.where(mask, is_heading, s["is_heading_env"]))
        is_standing = rng.uniform((E,)) <= self.cfg.rel_standing_envs
        s["is_standing_env"].copy_(torch.where(mask, is_standing, s["is_standing_env"]))

        # initial-velocity sampling: with probability p the root velocity
        # becomes the new command
        if self.cfg.init_velocity_prob > 0.0:
            init_mask = mask & (rng.uniform((E,)) < self.cfg.init_velocity_prob)
            data = self.robot.data
            command = s["command"]
            lin_b = data.root_link_lin_vel_b.clone()
            lin_b[:, :2] = command[:, :2]
            lin_w = math.quat_apply(data.root_link_quat_w, lin_b)
            ang_b = data.root_link_ang_vel_b.clone()
            ang_b[:, 2] = command[:, 2]
            ang_w = math.quat_apply(data.root_link_quat_w, ang_b)
            data.write_root_velocity(torch.cat([lin_w, ang_w], -1), init_mask)

    def _update_command(self):
        s = self.state
        cmd = s["command"]
        if self.cfg.heading_command:
            err = math.wrap_to_pi(s["heading_target"] - self.robot.data.heading_w)
            rg = s["ranges"]["ang_vel_z"]
            wz = torch.minimum(torch.maximum(
                self.cfg.heading_control_stiffness * err, rg[0]), rg[1])
            cmd[:, 2] = torch.where(s["is_heading_env"], wz.to(cmd.dtype), cmd[:, 2])
        cmd.copy_(torch.where(s["is_standing_env"][:, None], 0.0, cmd))


@dataclass(kw_only=True)
class UniformVelocityCommandCfg(CommandTermCfg):
    asset_name: str = "robot"
    heading_command: bool = False
    heading_control_stiffness: float = 1.0
    rel_standing_envs: float = 0.0
    rel_heading_envs: float = 1.0
    init_velocity_prob: float = 0.0

    @dataclass
    class Ranges:
        lin_vel_x: tuple = (0.0, 0.0)
        lin_vel_y: tuple = (0.0, 0.0)
        ang_vel_z: tuple = (0.0, 0.0)
        heading: tuple | None = None

    ranges: Ranges = dfield(default_factory=Ranges)

    def __post_init__(self):
        self.class_type = UniformVelocityCommand
