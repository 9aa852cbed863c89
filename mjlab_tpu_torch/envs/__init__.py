from mjlab_tpu_torch.envs.manager_based_rl_env import (  # noqa: F401
    ManagerBasedRlEnv,
    ManagerBasedRlEnvCfg,
)
