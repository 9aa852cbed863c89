"""Tracking-task runner: every checkpoint also exports the
motion-embedded deployment ONNX policy, ``<run>.onnx`` beside it.

PyTorch counterpart of mjlab_tpu/tasks/tracking/rl/runner.py, without its
W&B registry link (it needs the network and the wandb package; the port
has no wandb logger, rl/runner.py).
"""

from __future__ import annotations

import os

from mjlab_tpu_torch.rl.exporter import get_base_metadata
from mjlab_tpu_torch.rl.runner import OnPolicyRunner
from mjlab_tpu_torch.tasks.tracking.rl.exporter import export_motion_policy_as_onnx


class MotionTrackingOnPolicyRunner(OnPolicyRunner):
    def save(self, path: str) -> None:
        super().save(path)
        policy_dir = os.path.dirname(path)
        filename = os.path.basename(os.path.abspath(policy_dir)) + ".onnx"
        metadata = get_base_metadata(self.env, run_path=self.cfg.run_name)
        export_motion_policy_as_onnx(self.env, self.ppo, os.path.join(policy_dir, filename),
                                     metadata=metadata)
