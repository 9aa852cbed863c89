"""The PPO learner, its runner, checkpoints and ONNX export (PyTorch
counterpart of mjlab_tpu/rl)."""

from mjlab_tpu_torch.rl.config import (  # noqa: F401
    RslRlBaseRunnerCfg,
    RslRlOnPolicyRunnerCfg,
    RslRlPpoActorCriticCfg,
    RslRlPpoAlgorithmCfg,
)
from mjlab_tpu_torch.rl.runner import OnPolicyRunner  # noqa: F401
from mjlab_tpu_torch.rl.vecenv_wrapper import RslRlVecEnvWrapper  # noqa: F401
