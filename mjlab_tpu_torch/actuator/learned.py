"""Learned MLP actuator: a trained per-joint network over the history of
position errors and velocities, its torque clipped by the DC motor
envelope.

PyTorch counterpart of mjlab_tpu/actuator/learned.py. The network file
(TorchScript) is loaded once at build; its linear layers' weights are
taken out and run as plain tensor products on the env's device (the
TorchScript module itself is not run). The histories (num_envs, H, joints)
are most-recent-first and advance at physics rate; the output is scaled
and clipped by the parent DC motor's torque-speed envelope.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal

import torch
import torch.nn.functional as F

from mjlab_tpu_torch.actuator.actuator import ActuatorCmd
from mjlab_tpu_torch.actuator.dc import DcMotorActuator, DcMotorActuatorCfg, dc_clip
from mjlab_tpu_torch.actuator.pd import PdState

_ACT = {
    "elu": F.elu,
    "relu": F.relu,
    "tanh": torch.tanh,
    "softsign": F.softsign,
    "sigmoid": torch.sigmoid,
}


def load_torchscript_mlp(path: str) -> tuple[list[tuple[torch.Tensor, torch.Tensor]], str]:
    """(weight, bias) pairs in order of appearance and the activation's
    name (the first of _ACT's names the graph mentions; elu when none)."""
    net = torch.jit.load(path, map_location="cpu")
    net.eval()
    params = dict(net.named_parameters())
    layers = []
    for wk in [k for k in params if k.endswith("weight")]:
        w = params[wk].detach().float()
        bk = wk[: -len("weight")] + "bias"
        b = params[bk].detach().float() if bk in params else torch.zeros(w.shape[0])
        layers.append((w, b))
    act = "elu"
    try:
        g = str(net.inlined_graph)
        for name in _ACT:
            if name in g:
                act = name
                break
    except Exception:
        pass
    return layers, act


@dataclass
class LearnedMlpState:
    pd: PdState  # the DC parent's state (its effort limit clips)
    pos_err_hist: torch.Tensor  # (E, H, J), most recent first
    vel_hist: torch.Tensor  # (E, H, J)


@dataclass(kw_only=True)
class LearnedMlpActuatorCfg(DcMotorActuatorCfg):
    network_file: str = ""
    pos_scale: float = 1.0
    vel_scale: float = 1.0
    torque_scale: float = 1.0
    input_order: Literal["pos_vel", "vel_pos"] = "pos_vel"
    history_length: int = 3
    activation: str | None = None  # None: from the TorchScript graph
    stiffness: float = 0.0
    damping: float = 0.0

    def build(self, joint_ids, joint_names) -> "LearnedMlpActuator":
        return LearnedMlpActuator(self, joint_ids, joint_names)


class LearnedMlpActuator(DcMotorActuator):
    """See the module docstring."""

    def __init__(self, cfg, joint_ids, joint_names):
        super().__init__(cfg, joint_ids, joint_names)
        layers, act = load_torchscript_mlp(cfg.network_file)
        self._host_layers = layers
        self._layers: list[tuple[torch.Tensor, torch.Tensor]] = layers
        self._act = _ACT[cfg.activation or act]
        exp_in = 2 * cfg.history_length
        if layers[0][0].shape[1] != exp_in:
            raise ValueError(
                f"network expects input dim {layers[0][0].shape[1]}, actuator "
                f"provides {exp_in} (2 x history_length)")

    def initialize(self, num_envs: int, device, rng=None) -> LearnedMlpState:
        pd = super().initialize(num_envs, device, rng)
        self._layers = [(w.to(device), b.to(device)) for w, b in self._host_layers]
        shape = (num_envs, self.cfg.history_length, len(self.joint_names))
        return LearnedMlpState(
            pd=pd, pos_err_hist=torch.zeros(shape, dtype=torch.float32, device=device),
            vel_hist=torch.zeros(shape, dtype=torch.float32, device=device))

    def reset(self, state: LearnedMlpState, mask: torch.Tensor, rng=None) -> None:
        m = mask[:, None, None]
        state.pos_err_hist.masked_fill_(m, 0.0)
        state.vel_hist.masked_fill_(m, 0.0)

    def state_tensors(self, state: LearnedMlpState) -> list[torch.Tensor]:
        return state.pd.tensors() + [state.pos_err_hist, state.vel_hist]

    def compute(self, state: LearnedMlpState, cmd: ActuatorCmd, rng=None) -> torch.Tensor:
        c = self.cfg
        pos_err = cmd.position_target - cmd.joint_pos  # (E, J)
        hist = state.pos_err_hist
        peh = torch.cat([pos_err[:, None].to(hist.dtype), hist[:, :-1]], 1)
        vh = torch.cat([cmd.joint_vel[:, None].to(hist.dtype), state.vel_hist[:, :-1]], 1)
        E, H, J = peh.shape
        pos_flat = peh.transpose(1, 2).reshape(E * J, H)
        vel_flat = vh.transpose(1, 2).reshape(E * J, H)
        parts = [pos_flat * c.pos_scale, vel_flat * c.vel_scale]
        x = torch.cat(parts if c.input_order == "pos_vel" else parts[::-1], 1)
        for i, (w, b) in enumerate(self._layers):
            x = torch.matmul(x, w.T) + b
            if i < len(self._layers) - 1:
                x = self._act(x)
        tau = x.reshape(E, J) * c.torque_scale
        state.pos_err_hist.copy_(peh)
        state.vel_hist.copy_(vh)
        return dc_clip(c, state.pd.effort_limit, cmd.joint_vel, tau)
