"""Velocity-task runner: every checkpoint also exports the deployment ONNX
policy with its metadata, ``<run>.onnx`` beside it (reference
src/mjlab/tasks/velocity/rl/runner.py:13-38; PyTorch counterpart of
mjlab_tpu/tasks/velocity/rl/runner.py)."""

from __future__ import annotations

import os

from mjlab_tpu_torch.rl.exporter import export_policy_as_onnx, get_base_metadata
from mjlab_tpu_torch.rl.runner import OnPolicyRunner


class VelocityOnPolicyRunner(OnPolicyRunner):
    def save(self, path: str) -> None:
        super().save(path)
        policy_dir = os.path.dirname(path)
        filename = os.path.basename(os.path.abspath(policy_dir)) + ".onnx"
        metadata = get_base_metadata(self.env, run_path=self.cfg.run_name)
        export_policy_as_onnx(self.ppo, os.path.join(policy_dir, filename), metadata=metadata)
