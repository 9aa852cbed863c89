"""On-policy runner: the training loop around the PPO iteration.

PyTorch counterpart of mjlab_tpu/rl/runner.py (rsl-rl's OnPolicyRunner as
the reference drives it, reference scripts/train.py:148-169). Each
iteration runs PPO.learn_iteration on the env's device (on the card the env
step is one CUDA graph replay) with no host read inside it; the metrics
come to the host once per iteration, then the runner logs and checkpoints.

Checkpoints are rsl-rl ``model_<it>.pt`` files (torch.save): a
``model_state_dict`` with ``actor.{0,2,4,6}.*``, ``critic.{0,2,4,6}.*``,
``std`` (or ``log_std``) and ``{actor,critic}_obs_normalizer.{mean,var,
count}``, which mjlab_tpu/rl/interop.py load_rslrl_checkpoint reads; an
``optimizer_state_dict`` (Adam's moments and step count, the learning
rate), the learner's generator state and ``iter``. ``load`` with
load_optimizer restores all of it, so a resumed run continues the same
training dynamics.
"""

from __future__ import annotations

import os
import time
from typing import Callable

import torch

from mjlab_tpu_torch.phys.model import resolve_device
from mjlab_tpu_torch.rl.config import RslRlOnPolicyRunnerCfg
from mjlab_tpu_torch.rl.interop import load_model_state
from mjlab_tpu_torch.rl.ppo import PPO


class OnPolicyRunner:
    def __init__(self, env, cfg: RslRlOnPolicyRunnerCfg, log_dir: str | None = None,
                 device: str | torch.device | None = None):
        self.env = env.unwrapped if hasattr(env, "unwrapped") else env
        self.cfg = cfg
        self.log_dir = log_dir
        self.device = self.env.device if device is None else resolve_device(device)
        if self.device != self.env.device:
            raise ValueError(f"the runner's device {self.device} is not the env's "
                             f"{self.env.device}")
        if cfg.logger == "wandb":
            raise NotImplementedError("the wandb logger is not ported; use 'stdout' or "
                                      "'tensorboard'")
        om = self.env.observation_manager
        obs_dims = {g: om.group_obs_dim(g) for g in om.active_terms}
        self.ppo = PPO(
            cfg,
            env_step=self._env_step,
            num_envs=self.env.num_envs,
            num_actions=self.env.action_manager.total_action_dim,
            actor_obs_dim=obs_dims["policy"],
            critic_obs_dim=obs_dims.get("critic", obs_dims["policy"]),
            device=self.device,
        )
        self.iteration = 0
        self.timings: list[dict] = []
        self.obs: dict = {}
        self._tb = None

    def _env_step(self, action):
        obs, reward, terminated, truncated, extras = self.env.step(action)
        return obs, reward, terminated, truncated, extras["log"]

    # -- logging --

    def _log(self, metrics: dict, steps_per_sec: float) -> None:
        it = self.iteration
        if self.cfg.logger == "tensorboard":
            # reference rl/config.py:85-90: rsl-rl's tensorboard backend;
            # torch's SummaryWriter needs the tensorboard package, else the
            # in-repo event writer
            if self._tb is None:
                tb_dir = self.log_dir or "logs/tb"
                try:
                    from torch.utils.tensorboard import SummaryWriter
                except ImportError:
                    from mjlab_tpu_torch.rl.tb_writer import SummaryWriter
                self._tb = SummaryWriter(log_dir=tb_dir)
            for k, v in metrics.items():
                self._tb.add_scalar(k, float(v), it)
            self._tb.add_scalar("perf/steps_per_sec", steps_per_sec, it)
            self._tb.flush()
            return
        keys = ["train/mean_reward", "loss/surrogate", "loss/value", "train/kl", "train/lr",
                "Episode/length"]
        parts = [f"it={it}"]
        for k in keys:
            if k in metrics:
                parts.append(f"{k.split('/')[-1]}={float(metrics[k]):.4f}")
        parts.append(f"sps={steps_per_sec:,.0f}")
        print("  ".join(parts), flush=True)

    # -- training --

    def learn(self, num_learning_iterations: int | None = None,
              on_iteration: Callable[[dict], None] | None = None) -> dict:
        """Train from env.reset() for the given number of iterations (the
        config's max_iterations by default); returns the last iteration's
        metrics as floats. ``timings`` holds each iteration's seconds and,
        on the card, its rollout and update ms (CUDA events), ``obs`` the
        env's last obs; ``on_iteration(metrics)`` runs after each
        iteration's host read."""
        n_iter = num_learning_iterations or self.cfg.max_iterations
        obs, _ = self.env.reset()
        steps_per_iter = self.cfg.num_steps_per_env * self.env.num_envs
        cuda = self.device.type == "cuda"
        self.timings = []
        host = {}
        for _ in range(n_iter):
            marks = [torch.cuda.Event(enable_timing=True) for _ in range(3)] if cuda else None
            t0 = time.perf_counter()
            obs, metrics = self.ppo.learn_iteration(obs, marks)
            self.obs = obs
            # the one host read of the iteration
            names = list(metrics)
            values = torch.stack([metrics[k].float() for k in names]).cpu().tolist()
            dt = time.perf_counter() - t0
            host = dict(zip(names, values))
            self.iteration += 1
            timing = {"seconds": dt}
            if cuda:
                timing.update(rollout_ms=marks[0].elapsed_time(marks[1]),
                              update_ms=marks[1].elapsed_time(marks[2]))
            self.timings.append(timing)
            self._log(host, steps_per_iter / dt)
            guard = getattr(self.env, "nan_guard", None)
            if guard is not None:
                guard.dump_if_detected()
            if on_iteration is not None:
                on_iteration(host)
            if self.log_dir and self.iteration % self.cfg.save_interval == 0:
                self.save(os.path.join(self.log_dir, f"model_{self.iteration}.pt"))
        if self.log_dir:
            self.save(os.path.join(self.log_dir, f"model_{self.iteration}.pt"))
        return host

    # -- inference and checkpoints --

    def get_inference_policy(self):
        """obs dict -> the actor's mean action (the normaliser applied)."""
        return self.ppo.act_inference

    def save(self, path: str) -> None:
        ppo = self.ppo
        sd = {k: v.detach().cpu().clone() for k, v in ppo.ac.state_dict().items()}
        for prefix, s in (("actor_obs_normalizer", ppo.actor_norm),
                          ("critic_obs_normalizer", ppo.critic_norm)):
            for k, v in zip(("mean", "var", "count"), s.tensors()):
                sd[f"{prefix}.{k}"] = v.detach().cpu().clone()
        names = [k for k, _ in ppo.ac.named_parameters()]
        payload = {
            "model_state_dict": sd,
            "optimizer_state_dict": {
                "mu": {k: t.cpu().clone() for k, t in zip(names, ppo.opt.mu)},
                "nu": {k: t.cpu().clone() for k, t in zip(names, ppo.opt.nu)},
                "count": ppo.opt.count.cpu().clone(),
                "lr": ppo.lr.cpu().clone(),
            },
            "generator_state": ppo.rng.generator.get_state(),
            "iter": self.iteration,
            "infos": None,
        }
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        torch.save(payload, path)

    @torch.no_grad()
    def load(self, path: str, load_optimizer: bool = True) -> dict:
        """Restore the params and normalisers; with load_optimizer also
        Adam's moments and step count, the learning rate and the learner's
        generator, so that a resumed run continues the same dynamics."""
        payload = torch.load(path, map_location="cpu", weights_only=False)
        ppo = self.ppo
        load_model_state(ppo, payload)
        opt = payload.get("optimizer_state_dict")
        if load_optimizer and opt is not None:
            names = [k for k, _ in ppo.ac.named_parameters()]
            for k, mu, nu in zip(names, ppo.opt.mu, ppo.opt.nu):
                mu.copy_(opt["mu"][k])
                nu.copy_(opt["nu"][k])
            ppo.opt.count.copy_(opt["count"])
            ppo.lr.copy_(opt["lr"])
            if "generator_state" in payload:
                ppo.rng.generator.set_state(payload["generator_state"])
        self.iteration = int(payload.get("iter", 0))
        return payload
