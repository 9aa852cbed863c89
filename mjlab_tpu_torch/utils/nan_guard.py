"""NaN guard: a rolling history of the physics state, written to disk
once some env goes non-finite.

PyTorch counterpart of mjlab_tpu/utils/nan_guard.py. The guard keeps the
last buffer_size control steps of qpos, qvel and ctrl (CircularBuffers,
utils/buffers.py) and checks qpos, qvel, qacc and qacc_warmstart after the
decimation loop, inside the captured step (``record``). The JAX package
writes the dump from a host callback at the step of the first detection;
a CUDA graph cannot call the host, so here the first detection stops the
recording (the window then ends at the detection step, as the JAX dump's
does) and sets a device flag, and the host writes the dump where it
already synchronises (``dump_if_detected``: the runner's iteration end,
and env.close()). The dump is one npz (bad_envs, and the qpos, qvel and
ctrl windows, batch-first and oldest first) with a latest.npz link, and
the scene's Model beside it (phys/model.py save_model, in place of the
JAX package's .mjb: the card has no MuJoCo); it is written once.

Per-env quarantine for training is separate: the nan_detection
termination (envs/mdp/terminations.py) resets the envs that went bad.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch

from mjlab_tpu_torch.utils.buffers import CircularBuffer


@dataclass
class NanGuardCfg:
    enabled: bool = False
    buffer_size: int = 100
    output_dir: str = "nan_dumps"


def detect_nans(data) -> torch.Tensor:
    """(E,) bool: a non-finite qpos, qvel, qacc or qacc_warmstart."""
    bad = ~torch.isfinite(data.qpos).all(-1)
    bad |= ~torch.isfinite(data.qvel).all(-1)
    bad |= ~torch.isfinite(data.qacc).all(-1)
    bad |= ~torch.isfinite(data.qacc_warmstart).all(-1)
    return bad


class NanGuard:
    """See the module docstring. ``model`` gives the Model written beside
    the dump."""

    def __init__(self, cfg: NanGuardCfg, num_envs: int, nq: int, nv: int, nu: int,
                 device, model: Callable[[], object] | None = None):
        self.cfg = cfg
        self.model = model
        T = cfg.buffer_size
        self.buffers = {k: CircularBuffer(T, num_envs, (n,), device=device)
                        for k, n in (("qpos", nq), ("qvel", nv), ("ctrl", nu))}
        self.stopped = torch.zeros((), dtype=torch.bool, device=device)
        self.bad_envs = torch.zeros((num_envs,), dtype=torch.bool, device=device)
        self.dumped: str | None = None

    def state_tensors(self) -> list[torch.Tensor]:
        out = [self.stopped, self.bad_envs]
        for b in self.buffers.values():
            out += b.tensors()
        return out

    def record(self, data) -> None:
        """Append this step's qpos, qvel and ctrl unless a detection came
        before, then check: the first detection keeps its bad envs and
        stops the recording. No host read."""
        live = ~self.stopped
        for k, b in self.buffers.items():
            b.append(getattr(data, k), when=live)
        bad = detect_nans(data)
        found = bad.any()
        self.bad_envs.copy_(torch.where(live & found, bad, self.bad_envs))
        self.stopped.logical_or_(found)

    def windows(self) -> dict[str, np.ndarray]:
        """The recorded windows (E, buffer_size, n), oldest first."""
        return {k: b.window().cpu().numpy() for k, b in self.buffers.items()}

    def dump_if_detected(self) -> str | None:
        """Write the dump if an env went bad and none was written yet; the
        npz's path, or None (one host read)."""
        if self.dumped is not None or not bool(self.stopped):
            return None
        from mjlab_tpu_torch.phys.model import save_model

        os.makedirs(self.cfg.output_dir, exist_ok=True)
        stamp = time.strftime("%Y%m%d_%H%M%S")
        path = os.path.join(self.cfg.output_dir, f"nan_dump_{stamp}")
        np.savez(path + ".npz", bad_envs=np.nonzero(self.bad_envs.cpu().numpy())[0],
                 **self.windows())
        if self.model is not None:
            save_model(path + "_model.npz", self.model())
        latest = os.path.join(self.cfg.output_dir, "latest.npz")
        try:
            if os.path.islink(latest):
                os.unlink(latest)
            os.symlink(os.path.basename(path) + ".npz", latest)
        except OSError:
            pass
        print(f"[nan_guard] dumped NaN state history to {path}.npz")
        self.dumped = path + ".npz"
        return self.dumped
