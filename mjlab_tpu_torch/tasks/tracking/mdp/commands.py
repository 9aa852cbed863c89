"""The motion command (BeyondMimic-style motion imitation): a reference
motion's frame per env, reference-state initialisation on a resample, and
adaptive sampling of the start frames.

PyTorch counterpart of mjlab_tpu/tasks/tracking/mdp/commands.py, as a
masked in-place command term: the time steps, the anchor-relative
reference body poses, the failure counts per bin and the metrics are
tensors updated in place, so the term runs inside a captured env step.

- MotionLoader: the motion's arrays (joint positions and velocities, the
  tracked bodies' poses and velocities) as float32 tensors on the env's
  device, made once;
- a resample draws start frames ("adaptive" by default, "uniform" or
  "start") and writes the robot's state at that frame (root pose and
  velocity, joint positions and velocities) with pose, velocity and
  joint noise, for the masked envs;
- adaptive sampling: the failed envs' bins are counted with a scatter-add
  (kept only when an env failed, chosen on the device, not by a host
  read), the counts' moving average plus a uniform share is smoothed by
  an exponential kernel over a replicate-padded window, and each env
  draws a bin (Rng.categorical: the inverse CDF at one uniform draw) and
  a uniform offset inside it;
- the reference bodies are re-expressed around the robot's anchor
  (yaw-aligned, xy-translated) after every update, at the frames the
  envs held when the update (a step's compute, or a reset) began: the
  JAX term reads its properties from the state it was called with, not
  from the one it is building (ROADMAP.md queue 3 item 8).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Literal

import numpy as np
import torch

from mjlab_tpu_torch.managers.command_manager import CommandTerm
from mjlab_tpu_torch.managers.manager_term_config import CommandTermCfg
from mjlab_tpu_torch.utils import math as m3

_METRICS = (
    "error_anchor_pos", "error_anchor_rot", "error_anchor_lin_vel",
    "error_anchor_ang_vel", "error_body_pos", "error_body_rot",
    "error_body_lin_vel", "error_body_ang_vel", "error_joint_pos",
    "error_joint_vel", "sampling_entropy", "sampling_top1_prob",
    "sampling_top1_bin",
)
_AXES = ("x", "y", "z", "roll", "pitch", "yaw")


class MotionLoader:
    """A motion file's arrays (npz: joint_pos, joint_vel (T, J) and
    body_pos_w, body_quat_w, body_lin_vel_w, body_ang_vel_w (T, nbody, .)
    of every robot body in entity order), the bodies body_indexes selects,
    as float32 tensors on ``device``."""

    def __init__(self, motion_file: str, body_indexes, device):
        with np.load(motion_file) as data:
            t = lambda x: torch.as_tensor(np.asarray(x, np.float32), device=device)  # noqa: E731
            ids = np.asarray(body_indexes)
            self.joint_pos = t(data["joint_pos"])
            self.joint_vel = t(data["joint_vel"])
            self.body_pos_w = t(data["body_pos_w"][:, ids])
            self.body_quat_w = t(data["body_quat_w"][:, ids])
            self.body_lin_vel_w = t(data["body_lin_vel_w"][:, ids])
            self.body_ang_vel_w = t(data["body_ang_vel_w"][:, ids])
        self.time_step_total = int(self.joint_pos.shape[0])


class MotionCommand(CommandTerm):
    cfg: "MotionCommandCfg"

    def __init__(self, cfg, env):
        super().__init__(cfg, env)
        if not cfg.motion_file:
            raise ValueError(
                "the motion command needs a motion file (--motion-file, or the "
                "MJLAB_TPU_MOTION_FILE environment variable)")
        self.robot = env.scene[cfg.asset_name]
        self.robot_anchor_body_index = self.robot.body_names.index(cfg.anchor_body_name)
        self.motion_anchor_body_index = list(cfg.body_names).index(cfg.anchor_body_name)
        ids, _ = self.robot.find_bodies(list(cfg.body_names), preserve_order=True)
        self.body_indexes = torch.as_tensor(ids, dtype=torch.long, device=env.device)
        self.motion = MotionLoader(cfg.motion_file, ids, env.device)
        self.bin_count = int(self.motion.time_step_total // (1 / env.step_dt)) + 1
        k = np.array([cfg.adaptive_lambda ** i for i in range(cfg.adaptive_kernel_size)],
                     np.float32)
        self.kernel = env.const(k / k.sum())

    def init_state(self, num_envs: int) -> dict:
        dev = self._env.device
        z = lambda *s: torch.zeros(s, dtype=torch.float32, device=dev)  # noqa: E731
        B = len(self.cfg.body_names)
        quat = z(num_envs, B, 4)
        quat[..., 0] = 1.0
        return {
            "time_steps": torch.zeros(num_envs, dtype=torch.int32, device=dev),
            "time_left": torch.full((num_envs,), 1e9, dtype=torch.float32, device=dev),
            "body_pos_relative_w": z(num_envs, B, 3),
            "body_quat_relative_w": quat,
            "bin_failed_count": z(self.bin_count),
            "current_bin_failed": z(self.bin_count),
            "metrics": {n: z(num_envs) for n in _METRICS},
        }

    def compute(self, dt: float) -> None:
        self._retarget_ts = self.state["time_steps"].clone()
        super().compute(dt)

    def reset(self, env_mask) -> dict:
        self._retarget_ts = self.state["time_steps"].clone()
        return super().reset(env_mask)

    # -- the reference at each env's current frame --

    @property
    def _ts(self) -> torch.Tensor:
        return self.state["time_steps"].long()

    @property
    def joint_pos(self):
        return self.motion.joint_pos[self._ts]

    @property
    def joint_vel(self):
        return self.motion.joint_vel[self._ts]

    @property
    def _origins(self) -> torch.Tensor:
        """The env origins in float32: the reference frames are float32,
        as the JAX term's (its origins are float32 at any precision)."""
        return self._env.scene.env_origins.to(torch.float32)

    @property
    def body_pos_w(self):
        return self.motion.body_pos_w[self._ts] + self._origins[:, None, :]

    @property
    def body_quat_w(self):
        return self.motion.body_quat_w[self._ts]

    @property
    def body_lin_vel_w(self):
        return self.motion.body_lin_vel_w[self._ts]

    @property
    def body_ang_vel_w(self):
        return self.motion.body_ang_vel_w[self._ts]

    @property
    def anchor_pos_w(self):
        return self.body_pos_w[:, self.motion_anchor_body_index]

    @property
    def anchor_quat_w(self):
        return self.body_quat_w[:, self.motion_anchor_body_index]

    @property
    def anchor_lin_vel_w(self):
        return self.body_lin_vel_w[:, self.motion_anchor_body_index]

    @property
    def anchor_ang_vel_w(self):
        return self.body_ang_vel_w[:, self.motion_anchor_body_index]

    @property
    def body_pos_relative_w(self):
        return self.state["body_pos_relative_w"]

    @property
    def body_quat_relative_w(self):
        return self.state["body_quat_relative_w"]

    # -- the robot --

    @property
    def robot_joint_pos(self):
        return self.robot.data.joint_pos

    @property
    def robot_joint_vel(self):
        return self.robot.data.joint_vel

    @property
    def robot_body_pos_w(self):
        return self.robot.data.body_link_pos_w[:, self.body_indexes]

    @property
    def robot_body_quat_w(self):
        return self.robot.data.body_link_quat_w[:, self.body_indexes]

    @property
    def robot_body_lin_vel_w(self):
        return self.robot.data.body_link_lin_vel_w[:, self.body_indexes]

    @property
    def robot_body_ang_vel_w(self):
        return self.robot.data.body_link_ang_vel_w[:, self.body_indexes]

    @property
    def robot_anchor_pos_w(self):
        return self.robot.data.body_link_pos_w[:, self.robot_anchor_body_index]

    @property
    def robot_anchor_quat_w(self):
        return self.robot.data.body_link_quat_w[:, self.robot_anchor_body_index]

    @property
    def robot_anchor_lin_vel_w(self):
        return self.robot.data.body_link_lin_vel_w[:, self.robot_anchor_body_index]

    @property
    def robot_anchor_ang_vel_w(self):
        return self.robot.data.body_link_ang_vel_w[:, self.robot_anchor_body_index]

    def _get_command(self) -> torch.Tensor:
        return torch.cat([self.joint_pos, self.joint_vel], dim=1)

    # -- metrics --

    def _update_metrics(self) -> None:
        m = self.state["metrics"]
        norm = lambda x: torch.linalg.vector_norm(x, dim=-1)  # noqa: E731
        m["error_anchor_pos"].copy_(norm(self.anchor_pos_w - self.robot_anchor_pos_w))
        m["error_anchor_rot"].copy_(
            m3.quat_error_magnitude(self.anchor_quat_w, self.robot_anchor_quat_w))
        m["error_anchor_lin_vel"].copy_(
            norm(self.anchor_lin_vel_w - self.robot_anchor_lin_vel_w))
        m["error_anchor_ang_vel"].copy_(
            norm(self.anchor_ang_vel_w - self.robot_anchor_ang_vel_w))
        m["error_body_pos"].copy_(
            norm(self.body_pos_relative_w - self.robot_body_pos_w).mean(-1))
        m["error_body_rot"].copy_(m3.quat_error_magnitude(
            self.body_quat_relative_w, self.robot_body_quat_w).mean(-1))
        m["error_body_lin_vel"].copy_(
            norm(self.body_lin_vel_w - self.robot_body_lin_vel_w).mean(-1))
        m["error_body_ang_vel"].copy_(
            norm(self.body_ang_vel_w - self.robot_body_ang_vel_w).mean(-1))
        m["error_joint_pos"].copy_(norm(self.joint_pos - self.robot_joint_pos))
        m["error_joint_vel"].copy_(norm(self.joint_vel - self.robot_joint_vel))

    # -- sampling --

    def _sample_time_steps(self, mask: torch.Tensor) -> None:
        """New start frames for the masked envs (mjlab_tpu commands.py
        _sample_time_steps); the sampling metrics of every env."""
        s = self.state
        E = mask.shape[0]
        T = self.motion.time_step_total
        nb = self.bin_count
        env = self._env
        m = s["metrics"]
        ts = s["time_steps"]
        if self.cfg.sampling_mode == "start":
            new_ts = torch.zeros_like(ts)
        elif self.cfg.sampling_mode == "uniform":
            new_ts = env.rng.integers((E,), 0, T)
            m["sampling_entropy"].fill_(1.0)
            m["sampling_top1_prob"].fill_(1.0 / nb)
            m["sampling_top1_bin"].fill_(0.5)
        else:  # adaptive
            failed = env.termination_manager.terminated & mask
            cur_bin = torch.clamp((ts * nb) // max(T, 1), 0, nb - 1)
            counts = torch.zeros_like(s["current_bin_failed"]).index_add_(
                0, cur_bin.long(), failed.to(torch.float32))
            s["current_bin_failed"].copy_(
                torch.where(failed.any(), counts, s["current_bin_failed"]))
            # the smoothed sampling probabilities: replicate-pad, then the
            # kernel over each window (np.convolve with the kernel reversed)
            p = s["bin_failed_count"] + self.cfg.adaptive_uniform_ratio / nb
            ksz = self.cfg.adaptive_kernel_size
            p_pad = torch.cat([p, p[-1:].expand(ksz - 1)])
            p_smooth = (p_pad.unfold(0, ksz, 1) * self.kernel).sum(-1)
            p_smooth = p_smooth / p_smooth.sum()
            bins = env.rng.categorical((E,), p_smooth)
            u = env.rng.uniform((E,))
            new_ts = ((bins.to(torch.float32) + u) / nb * (T - 1)).to(torch.int32)
            H = -(p_smooth * torch.log(p_smooth + 1e-12)).sum()
            m["sampling_entropy"].copy_((H / math.log(nb)).expand(E))
            m["sampling_top1_prob"].copy_(p_smooth.max().expand(E))
            m["sampling_top1_bin"].copy_((torch.argmax(p_smooth).to(torch.float32) / nb).expand(E))
        ts.copy_(torch.where(mask, new_ts, ts))

    def _ranges6(self, table: dict) -> tuple[torch.Tensor, torch.Tensor]:
        r = np.asarray([table.get(k, (0.0, 0.0)) for k in _AXES], np.float32)
        return self._env.const(r[:, 0]), self._env.const(r[:, 1])

    def _resample(self, mask: torch.Tensor) -> None:
        """Start frames for the masked envs, and the robot at that frame of
        the motion with pose, velocity and joint noise (reference-state
        initialisation; mjlab_tpu commands.py _resample). Draws in the JAX
        term's order: the frames, the pose, the velocity, the joints."""
        self._sample_time_steps(mask)
        env = self._env
        E = mask.shape[0]
        ts = self._ts
        mo = self.motion
        root_pos = mo.body_pos_w[ts, 0] + self._origins
        root_quat = mo.body_quat_w[ts, 0]
        root_lin = mo.body_lin_vel_w[ts, 0]
        root_ang = mo.body_ang_vel_w[ts, 0]

        u = env.rng.uniform((E, 6), *self._ranges6(self.cfg.pose_range))
        root_pos = root_pos + u[:, 0:3]
        root_quat = m3.quat_mul(m3.quat_from_euler_xyz(u[:, 3], u[:, 4], u[:, 5]), root_quat)
        uv = env.rng.uniform((E, 6), *self._ranges6(self.cfg.velocity_range))
        root_lin = root_lin + uv[:, 0:3]
        root_ang = root_ang + uv[:, 3:6]

        jp = mo.joint_pos[ts]
        jp = jp + env.rng.uniform(tuple(jp.shape), *self.cfg.joint_position_range)
        lims = self.robot.data.soft_joint_pos_limits.to(jp.dtype)
        jp = torch.minimum(torch.maximum(jp, lims[..., 0]), lims[..., 1])
        jv = mo.joint_vel[ts]

        data = self.robot.data
        data.write_joint_state(jp, jv, env_ids=mask)
        data.write_root_pose(torch.cat([root_pos, root_quat.to(root_pos.dtype)], -1), mask)
        data.write_root_velocity(torch.cat([root_lin, root_ang], -1), mask)
        data.clear_state(mask)

    def _update_command(self) -> None:
        """Advance the frames; the envs past the motion's end resample
        (every env draws, the mask picks); the reference re-expressed
        around the robot's anchor; the failure counts' moving average
        (mjlab_tpu commands.py _update_command). Called by compute and
        reset, which set _retarget_ts first."""
        s = self.state
        T = self.motion.time_step_total
        ts = s["time_steps"] + 1
        overflow = ts >= T
        s["time_steps"].copy_(torch.where(overflow, T - 1, ts))
        self._resample(overflow)

        # the reference at the frames the update began with (the JAX term's)
        f = self._retarget_ts.long()
        body_pos_w = self.motion.body_pos_w[f] + self._origins[:, None, :]
        body_quat_w = self.motion.body_quat_w[f]
        a = self.motion_anchor_body_index
        anchor_pos = body_pos_w[:, a, None, :]
        anchor_quat = body_quat_w[:, a, None, :]
        r_anchor_pos = self.robot_anchor_pos_w[:, None, :]
        r_anchor_quat = self.robot_anchor_quat_w[:, None, :]
        delta_pos = torch.cat([r_anchor_pos[..., :2], anchor_pos[..., 2:3]], dim=-1)
        delta_ori = m3.yaw_quat(m3.quat_mul(r_anchor_quat, m3.quat_inv(anchor_quat)))
        ori = delta_ori.expand(body_quat_w.shape[:-1] + (4,))
        s["body_quat_relative_w"].copy_(m3.quat_mul(ori, body_quat_w))
        s["body_pos_relative_w"].copy_(
            delta_pos + m3.quat_apply(ori, body_pos_w - anchor_pos))

        if self.cfg.sampling_mode == "adaptive":
            a = self.cfg.adaptive_alpha
            s["bin_failed_count"].copy_(
                a * s["current_bin_failed"] + (1 - a) * s["bin_failed_count"])
            s["current_bin_failed"].zero_()


@dataclass(kw_only=True)
class MotionCommandCfg(CommandTermCfg):
    class_type: type = MotionCommand
    motion_file: str = ""
    anchor_body_name: str = ""
    body_names: tuple[str, ...] = ()
    asset_name: str = "robot"
    pose_range: dict = field(default_factory=dict)
    velocity_range: dict = field(default_factory=dict)
    joint_position_range: tuple = (-0.52, 0.52)
    adaptive_kernel_size: int = 1
    adaptive_lambda: float = 0.8
    adaptive_uniform_ratio: float = 0.1
    adaptive_alpha: float = 0.001
    sampling_mode: Literal["adaptive", "uniform", "start"] = "adaptive"
