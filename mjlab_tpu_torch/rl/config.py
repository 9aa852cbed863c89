"""PPO runner and algorithm configs.

PyTorch counterpart of mjlab_tpu/rl/config.py, field for field, so that
the task configs port unchanged. The class_name fields are kept for config
compatibility; the learner ignores them. One difference: load_checkpoint
matches ``model_<it>.pt``, the rsl-rl checkpoint file the port's runner
writes. learner_sharding is kept for the same compatibility; data-parallel
training is not ported (the train CLI's --distributed raises).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal, Tuple


@dataclass
class RslRlPpoActorCriticCfg:
    init_noise_std: float = 1.0
    noise_std_type: Literal["scalar", "log"] = "scalar"
    actor_obs_normalization: bool = False
    critic_obs_normalization: bool = False
    actor_hidden_dims: Tuple[int, ...] = (128, 128, 128)
    critic_hidden_dims: Tuple[int, ...] = (128, 128, 128)
    activation: str = "elu"
    class_name: str = "ActorCritic"


@dataclass
class RslRlPpoAlgorithmCfg:
    num_learning_epochs: int = 5
    num_mini_batches: int = 4
    learning_rate: float = 1e-3
    schedule: Literal["adaptive", "fixed"] = "adaptive"
    gamma: float = 0.99
    lam: float = 0.95
    entropy_coef: float = 0.005
    desired_kl: float = 0.01
    max_grad_norm: float = 1.0
    value_loss_coef: float = 1.0
    use_clipped_value_loss: bool = True
    clip_param: float = 0.2
    normalize_advantage_per_mini_batch: bool = False
    class_name: str = "PPO"


@dataclass
class RslRlBaseRunnerCfg:
    seed: int = 42
    num_steps_per_env: int = 24
    max_iterations: int = 300
    obs_groups: dict = field(
        default_factory=lambda: {"policy": ("policy",), "critic": ("critic",)}
    )
    save_interval: int = 50
    experiment_name: str = "exp1"
    run_name: str = ""
    logger: Literal["wandb", "tensorboard", "stdout"] = "stdout"
    wandb_project: str = "mjlab_tpu"
    wandb_tags: Tuple[str, ...] = ()
    resume: bool = False
    load_run: str = ".*"
    load_checkpoint: str = "model_.*.pt"
    clip_actions: float | None = None
    # multi-chip learner placement of the JAX package ("replicated": the
    # DDP layout; "sharded": optimizer and params sharded over the data
    # axis); kept for config compatibility
    learner_sharding: Literal["replicated", "sharded"] = "replicated"


@dataclass
class RslRlOnPolicyRunnerCfg(RslRlBaseRunnerCfg):
    class_name: str = "OnPolicyRunner"
    policy: RslRlPpoActorCriticCfg = field(default_factory=RslRlPpoActorCriticCfg)
    algorithm: RslRlPpoAlgorithmCfg = field(default_factory=RslRlPpoAlgorithmCfg)
