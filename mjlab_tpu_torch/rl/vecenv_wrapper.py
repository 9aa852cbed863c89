"""VecEnv wrapper (reference src/mjlab/rl/vecenv_wrapper.py:11-111).

PyTorch counterpart of mjlab_tpu/rl/vecenv_wrapper.py: the rsl-rl VecEnv
surface over ManagerBasedRlEnv. The runner steps the unwrapped env itself
(the learner clips actions only where clip_actions is set in its config).
"""

from __future__ import annotations

import torch


class RslRlVecEnvWrapper:
    def __init__(self, env, clip_actions: float | None = None):
        self.env = env
        self.clip_actions = clip_actions
        self.num_envs = env.num_envs
        self.num_actions = env.action_manager.total_action_dim
        self.max_episode_length = env.max_episode_length
        # auto-reset on construct (reference vecenv_wrapper.py:27)
        self._obs, _ = env.reset()

    @property
    def unwrapped(self):
        return self.env

    @property
    def episode_length_buf(self):
        return self.env.episode_length_buf

    def get_observations(self):
        return self._obs

    def step(self, action):
        if self.clip_actions is not None:
            action = torch.clamp(action, -self.clip_actions, self.clip_actions)
        obs, reward, terminated, truncated, extras = self.env.step(action)
        self._obs = obs
        dones = terminated | truncated
        extras["time_outs"] = truncated
        return obs, reward, dones, extras

    def reset(self):
        self._obs, extras = self.env.reset()
        return self._obs, extras

    def close(self):
        self.env.close()
