"""The PPO learner.

PyTorch counterpart of mjlab_tpu/rl/ppo.py (rsl-rl 3.1.0 semantics as the
reference configures them), part for part:

  - a Gaussian MLP actor-critic with a scalar or log noise-std head;
  - empirical observation normalisation (running mean and population
    variance, float32 count), updated with each rollout step's obs before
    they are normalised, the batch clipped to +-20 sigma after the first,
    the normalised obs clipped to +-10;
  - GAE(gamma, lam) with the time-out bootstrap reward + gamma V truncated;
  - the clipped surrogate, the clipped value loss, the entropy bonus;
  - the adaptive-KL learning rate (x1.5 / 1.5 around desired_kl), applied
    per minibatch on the KL of the params before its step;
  - optax's clip_by_global_norm then Adam, written out on tensors.

The JAX package compiles one iteration (rollout scan, GAE, epochs of
minibatch updates) to one XLA program. Here an iteration is a Python loop
over device tensors that never reads a device value on the host: the
rollout calls the env step (one CUDA graph replay on the card), copies the
env's fixed output buffers into the rollout storage and sums the env's
logs on the device; the learning rate is a 0-d device tensor; the metrics
are device tensors the caller brings to the host once.

Every random draw (the init, the action noise, each epoch's permutation)
goes through the learner's own Rng (utils/random.py), apart from the
env's.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
from torch import nn

from mjlab_tpu_torch.phys.model import resolve_device
from mjlab_tpu_torch.rl.config import RslRlOnPolicyRunnerCfg
from mjlab_tpu_torch.utils.random import Rng

# the JAX package's activations (flax's gelu is the tanh approximation)
_ACT = {
    "elu": nn.ELU,
    "relu": nn.ReLU,
    "tanh": nn.Tanh,
    "gelu": lambda: nn.GELU(approximate="tanh"),
    "silu": nn.SiLU,
}

# float32 constants as the JAX package computes them
_HALF_LOG_2PI = float(np.float32(0.5) * np.log(np.float32(2 * np.pi)))
_HALF_LOG_2PIE = float(np.float32(0.5) * np.log(np.float32(2 * np.pi * np.e)))
# flax's lecun_normal: a normal truncated to +-2, scaled to unit variance
_TRUNC_STD = 0.87962566103423978


def mlp(in_dim: int, hidden: tuple, out: int, activation: str = "elu") -> nn.Sequential:
    """Linear, act, ..., Linear: the rsl-rl layout (Linear i at index 2 i)."""
    layers, d = [], in_dim
    for h in hidden:
        layers += [nn.Linear(d, h), _ACT[activation]()]
        d = h
    layers.append(nn.Linear(d, out))
    return nn.Sequential(*layers)


@torch.no_grad()
def lecun_normal_(seq: nn.Sequential, rng: Rng) -> None:
    """flax Dense's init: kernels lecun_normal (a normal truncated to +-2
    std, std 1/sqrt(fan_in)/0.8796, drawn as jax.random.truncated_normal
    draws it), biases 0. The kernel is drawn as flax's (in, out)."""
    lo, hi = math.erf(-2.0 / math.sqrt(2.0)), math.erf(2.0 / math.sqrt(2.0))
    for lin in seq:
        if not isinstance(lin, nn.Linear):
            continue
        out_f, in_f = lin.weight.shape
        u = rng.uniform((in_f, out_f), lo, hi, dtype=torch.float32)
        z = (math.sqrt(2.0) * torch.erfinv(u)).clamp(
            float(np.nextafter(np.float32(-2), np.float32(0))),
            float(np.nextafter(np.float32(2), np.float32(0))))
        lin.weight.copy_((z * (math.sqrt(1.0 / in_f) / _TRUNC_STD)).T)
        lin.bias.zero_()


@dataclass
class NormState:
    """Running observation statistics; count is float32, as in JAX."""

    mean: torch.Tensor
    var: torch.Tensor
    count: torch.Tensor

    @classmethod
    def zeros(cls, dim: int, device) -> "NormState":
        return cls(torch.zeros((dim,), device=device), torch.ones((dim,), device=device),
                   torch.zeros((), device=device))

    def tensors(self) -> tuple:
        return self.mean, self.var, self.count


def norm_update(s: NormState, batch: torch.Tensor) -> NormState:
    """Batched update of the running mean and variance. After the first
    batch the batch is clipped to mean +- 20 sigma, so that one diverged
    env cannot poison the statistics."""
    sigma = torch.sqrt(s.var + 1e-8)
    b = batch.reshape(-1, batch.shape[-1])
    b = torch.where(s.count > 0, torch.clamp(b, s.mean - 20.0 * sigma, s.mean + 20.0 * sigma), b)
    n_b = b.shape[0]
    mean_b = b.mean(0)
    var_b = b.var(0, correction=0)
    n = s.count
    tot = n + n_b
    delta = mean_b - s.mean
    # a true division, as JAX's (torch's number / tensor multiplies by the
    # reciprocal)
    mean = s.mean + delta * (torch.full_like(tot, n_b) / tot)
    m_a = s.var * n
    m_b = var_b * n_b
    var = (m_a + m_b + delta.square() * n * n_b / tot) / tot
    return NormState(mean=mean, var=var, count=tot)


def norm_apply(s: NormState, x: torch.Tensor) -> torch.Tensor:
    """Normalised obs clipped to +-10 (rsl-rl's normaliser has no clip)."""
    return torch.clamp((x - s.mean) / torch.sqrt(s.var + 1e-8), -10.0, 10.0)


class ActorCritic(nn.Module):
    """The actor and critic MLPs and the noise head (``std``, or
    ``log_std`` for noise_std_type "log"): the rsl-rl module layout, so
    that its state_dict is an rsl-rl model_state_dict."""

    def __init__(self, cfg: RslRlOnPolicyRunnerCfg, num_actions: int, actor_obs_dim: int,
                 critic_obs_dim: int):
        super().__init__()
        p = cfg.policy
        self.noise_std_type = p.noise_std_type
        self.num_actions = num_actions
        self.actor_obs_dim = actor_obs_dim
        self.critic_obs_dim = critic_obs_dim
        self.actor = mlp(actor_obs_dim, tuple(p.actor_hidden_dims), num_actions, p.activation)
        self.critic = mlp(critic_obs_dim, tuple(p.critic_hidden_dims), 1, p.activation)
        if p.noise_std_type == "scalar":
            self.std = nn.Parameter(torch.full((num_actions,), float(p.init_noise_std)))
        else:
            init = float(np.log(np.float32(p.init_noise_std)))
            self.log_std = nn.Parameter(torch.full((num_actions,), init))

    def init_weights(self, rng: Rng) -> None:
        lecun_normal_(self.actor, rng)
        lecun_normal_(self.critic, rng)

    def noise_std(self) -> torch.Tensor:
        if self.noise_std_type == "scalar":
            return torch.clamp_min(self.std, 1e-6)
        return torch.exp(self.log_std)

    def act_mean(self, obs: torch.Tensor) -> torch.Tensor:
        return self.actor(obs)

    def value(self, obs: torch.Tensor) -> torch.Tensor:
        return self.critic(obs)[..., 0]

    def logprob(self, obs: torch.Tensor, action: torch.Tensor):
        """(log-likelihood of action, the actor's mean)."""
        mean = self.act_mean(obs)
        return gaussian_logprob(action, mean, self.noise_std()), mean

    def entropy(self) -> torch.Tensor:
        return torch.sum(_HALF_LOG_2PIE + torch.log(self.noise_std()))


def gaussian_logprob(action, mean, std) -> torch.Tensor:
    return torch.sum(-0.5 * torch.square((action - mean) / std) - torch.log(std) - _HALF_LOG_2PI,
                     -1)


class Adam:
    """optax.chain(clip_by_global_norm(max_norm), adam(lr)) on tensors, with
    the learning rate a 0-d device tensor: mu = (1 - b1) g + b1 mu, nu =
    (1 - b2) g^2 + b2 nu, the update mu_hat / (sqrt(nu_hat) + eps), the
    global norm clipped as where(norm < max, g, g / norm * max)."""

    def __init__(self, params: list[torch.Tensor], max_grad_norm: float,
                 b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8):
        self.params = params
        self.max_grad_norm = max_grad_norm
        dev = params[0].device
        # optax's injected hyperparameters are float32 arrays
        self.b1, self.b2, self.eps = (torch.tensor(x, dtype=torch.float32, device=dev)
                                      for x in (b1, b2, eps))
        self.mu = [torch.zeros_like(p) for p in params]
        self.nu = [torch.zeros_like(p) for p in params]
        self.count = torch.zeros((), dtype=torch.int32, device=dev)

    @torch.no_grad()
    def step(self, grads: list[torch.Tensor], lr: torch.Tensor) -> None:
        norm = torch.sqrt(sum(torch.sum(torch.square(g)) for g in grads))
        keep = norm < self.max_grad_norm
        self.count.add_(1)
        c1 = 1 - self.b1 ** self.count
        c2 = 1 - self.b2 ** self.count
        for p, g, mu, nu in zip(self.params, grads, self.mu, self.nu):
            g = torch.where(keep, g, (g / norm) * self.max_grad_norm)
            mu.copy_((1 - self.b1) * g + self.b1 * mu)
            nu.copy_((1 - self.b2) * torch.square(g) + self.b2 * nu)
            update = (mu / c1) / (torch.sqrt(nu / c2) + self.eps)
            p.copy_(p + (-lr) * update)


def critic_obs(obs: dict) -> torch.Tensor:
    """The privileged critic group when there is one, else the policy's
    (rsl-rl's obs_groups fallback)."""
    return obs["critic"] if "critic" in obs else obs["policy"]


# the per-minibatch numbers update() keeps, one row per minibatch
MINIBATCH_STATS = ("surrogate", "value_loss", "entropy", "kl", "lr")


class PPO:
    """PPO over an env step function.

    env_step: action -> (obs dict, reward, terminated, truncated, logs),
    where the tensors may be buffers the next call overwrites (the port
    env's): the rollout copies them. ``rng`` is the learner's own random
    source (default: Rng(cfg.seed) on ``device``).
    """

    def __init__(self, cfg: RslRlOnPolicyRunnerCfg, env_step: Callable | None, num_envs: int,
                 num_actions: int, actor_obs_dim: int, critic_obs_dim: int,
                 device: str | torch.device = "cuda", rng: Rng | None = None):
        self.cfg = cfg
        self.env_step = env_step
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.rng = rng if rng is not None else Rng(cfg.seed, self.device)
        self.ac = ActorCritic(cfg, num_actions, actor_obs_dim, critic_obs_dim).to(self.device)
        self.ac.init_weights(self.rng)
        self.params = list(self.ac.parameters())
        self.opt = Adam(self.params, cfg.algorithm.max_grad_norm)
        self.actor_norm = NormState.zeros(actor_obs_dim, self.device)
        self.critic_norm = NormState.zeros(critic_obs_dim, self.device)
        self.lr = torch.tensor(cfg.algorithm.learning_rate, dtype=torch.float32,
                               device=self.device)
        self.storage: dict[str, torch.Tensor] = {}
        self.log_sums: dict[str, torch.Tensor] = {}
        alg = cfg.algorithm
        self.minibatch_stats = torch.zeros(
            (alg.num_learning_epochs * alg.num_mini_batches, len(MINIBATCH_STATS)),
            device=self.device)

    # -- policy API --

    @torch.no_grad()
    def act_inference(self, obs: dict) -> torch.Tensor:
        return self.ac.act_mean(norm_apply(self.actor_norm, obs["policy"]))

    # -- one PPO iteration --

    def learn_iteration(self, obs: dict, marks: list | None = None):
        """Rollout, GAE and update: (the final obs, metrics as device
        tensors). ``marks``, three CUDA events, are recorded before the
        rollout, after it and after the update."""
        if marks is not None:
            marks[0].record()
        obs = self.rollout(obs)
        if marks is not None:
            marks[1].record()
        self.compute_returns(obs)
        metrics = self.update()
        if marks is not None:
            marks[2].record()
        return obs, metrics

    def _storage(self, obs: dict) -> dict:
        if not self.storage:
            T, N = self.cfg.num_steps_per_env, self.num_envs
            A, dev = self.ac.num_actions, self.device
            f = dict(aobs=(T, N, obs["policy"].shape[-1]), cobs=(T, N, critic_obs(obs).shape[-1]),
                     action=(T, N, A), logprob=(T, N), value=(T, N), reward=(T, N),
                     raw_reward=(T, N), old_mean=(T, N, A), old_std=(T, N, A),
                     advantage=(T, N), returns=(T, N))
            self.storage = {k: torch.zeros(s, device=dev) for k, s in f.items()}
            self.storage["done"] = torch.zeros((T, N), dtype=torch.bool, device=dev)
        return self.storage

    @torch.no_grad()
    def rollout(self, obs: dict) -> dict:
        """num_steps_per_env steps of rollout_step from obs; the env's logs
        summed per key. Returns the last obs."""
        self._storage(obs)
        for s in self.log_sums.values():
            s.zero_()
        for t in range(self.cfg.num_steps_per_env):
            obs = self.rollout_step(t, obs)
        return obs

    @torch.no_grad()
    def rollout_step(self, t: int, obs: dict) -> dict:
        """One env step under the current policy: both normalisers updated
        with obs, then the normalised obs, the action, its logprob, the
        value, the bootstrapped and raw reward, done and the policy's mean
        and std into row t of the storage, the env's logs added to their
        sums. Returns the next obs."""
        st, cfg, gamma = self._storage(obs), self.cfg, self.cfg.algorithm.gamma
        self.actor_norm = norm_update(self.actor_norm, obs["policy"])
        self.critic_norm = norm_update(self.critic_norm, critic_obs(obs))
        aobs = norm_apply(self.actor_norm, obs["policy"])
        cobs = norm_apply(self.critic_norm, critic_obs(obs))
        mean = self.ac.act_mean(aobs)
        std = self.ac.noise_std()
        action = mean + std * self.rng.draw("normal", tuple(mean.shape), torch.float32)
        if cfg.clip_actions is not None:
            action = torch.clamp(action, -cfg.clip_actions, cfg.clip_actions)
        value = self.ac.value(cobs)
        for k, v in (("aobs", aobs), ("cobs", cobs), ("action", action),
                     ("logprob", gaussian_logprob(action, mean, std)), ("value", value),
                     ("old_mean", mean), ("old_std", std.expand_as(mean))):
            st[k][t].copy_(v)
        obs, reward, terminated, truncated, logs = self.env_step(action)
        # time-out bootstrap (reference rl/vecenv_wrapper.py:86-87)
        st["reward"][t].copy_(reward + gamma * value * truncated.to(reward.dtype))
        st["raw_reward"][t].copy_(reward)
        torch.logical_or(terminated, truncated, out=st["done"][t])
        for k, v in logs.items():
            if k not in self.log_sums:
                self.log_sums[k] = torch.zeros((), device=self.device)
            self.log_sums[k].add_(v)
        return obs

    @torch.no_grad()
    def compute_returns(self, last_obs: dict) -> None:
        """GAE into storage["advantage"] and ["returns"]; the advantages
        normalised over the whole batch unless per minibatch. The last
        value reads the final obs under the normaliser as it stands."""
        st, alg = self.storage, self.cfg.algorithm
        last_value = self.ac.value(norm_apply(self.critic_norm, critic_obs(last_obs)))
        adv_next, v_next = torch.zeros_like(last_value), last_value
        for t in reversed(range(self.cfg.num_steps_per_env)):
            not_done = 1.0 - st["done"][t].to(torch.float32)
            delta = st["reward"][t] + alg.gamma * v_next * not_done - st["value"][t]
            adv_next = delta + alg.gamma * alg.lam * not_done * adv_next
            st["advantage"][t].copy_(adv_next)
            v_next = st["value"][t]
        torch.add(st["advantage"], st["value"], out=st["returns"])
        if not alg.normalize_advantage_per_mini_batch:
            a = st["advantage"]
            a.copy_((a - a.mean()) / (a.std(correction=0) + 1e-8))

    def loss(self, mb: dict):
        """(total loss, {surrogate, value_loss, entropy, kl}) of a minibatch."""
        alg = self.cfg.algorithm
        lp, mean = self.ac.logprob(mb["aobs"], mb["action"])
        std = self.ac.noise_std()
        ratio = torch.exp(lp - mb["logprob"])
        adv = mb["advantage"]
        if alg.normalize_advantage_per_mini_batch:
            adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        surr1 = ratio * adv
        surr2 = torch.clamp(ratio, 1 - alg.clip_param, 1 + alg.clip_param) * adv
        # rsl-rl formulates the surrogate as a loss over -advantages
        surrogate = -torch.mean(torch.minimum(surr1, surr2))
        value = self.ac.value(mb["cobs"])
        if alg.use_clipped_value_loss:
            v_clipped = mb["value"] + torch.clamp(value - mb["value"], -alg.clip_param,
                                                  alg.clip_param)
            v_loss = torch.maximum(torch.square(value - mb["returns"]),
                                   torch.square(v_clipped - mb["returns"])).mean()
        else:
            v_loss = torch.mean(torch.square(value - mb["returns"]))
        entropy = self.ac.entropy()
        total = surrogate + alg.value_loss_coef * v_loss - alg.entropy_coef * entropy
        # analytic Gaussian KL(old || new) for the adaptive learning rate
        old_mean, old_std = mb["old_mean"], mb["old_std"]
        new_std = std.expand_as(mean)
        kl = torch.mean(torch.sum(
            torch.log(new_std / old_std)
            + (torch.square(old_std) + torch.square(old_mean - mean)) / (2.0 * torch.square(new_std))
            - 0.5, -1))
        return total, {"surrogate": surrogate, "value_loss": v_loss, "entropy": entropy, "kl": kl}

    def update(self) -> dict:
        """num_learning_epochs epochs, each over one permutation of the
        T x N samples in num_mini_batches minibatches; before each
        minibatch's step the adaptive rule sets the learning rate from its
        KL. Returns the metrics (device tensors)."""
        alg, st = self.cfg.algorithm, self.storage
        T, N = self.cfg.num_steps_per_env, self.num_envs
        B = T * N
        mb_size = B // alg.num_mini_batches
        batch = {k: st[k].reshape((B,) + st[k].shape[2:]) for k in (
            "aobs", "cobs", "action", "logprob", "value", "advantage", "returns", "old_mean",
            "old_std")}
        row = 0
        for _ in range(alg.num_learning_epochs):
            perm = self.rng.draw("permutation", (B,), torch.int64)
            for i in range(alg.num_mini_batches):
                idx = perm[i * mb_size:(i + 1) * mb_size]
                mb = {k: v[idx] for k, v in batch.items()}
                total, aux = self.loss(mb)
                grads = torch.autograd.grad(total, self.params)
                kl, lr = aux["kl"].detach(), self.lr
                if alg.schedule == "adaptive":
                    lr = torch.where(kl > alg.desired_kl * 2.0, torch.clamp_min(lr / 1.5, 1e-5), lr)
                    lr = torch.where((kl < alg.desired_kl / 2.0) & (kl > 0.0),
                                     torch.clamp_max(lr * 1.5, 1e-2), lr)
                self.lr.copy_(lr)
                self.opt.step(list(grads), self.lr)
                self.minibatch_stats[row] = torch.stack(
                    [aux["surrogate"].detach(), aux["value_loss"].detach(),
                     aux["entropy"].detach(), kl, self.lr])
                row += 1
        means = self.minibatch_stats.mean(0)
        metrics = {
            "loss/surrogate": means[0],
            "loss/value": means[1],
            "loss/entropy": means[2],
            "train/kl": means[3],
            "train/lr": self.lr,
            "train/mean_reward": st["raw_reward"].mean(),
            "train/mean_std": self.ac.noise_std().detach().mean(),
        }
        # episode logs: the mean over the rollout's steps
        for k, v in self.log_sums.items():
            metrics[k] = v / T
        return metrics

    # -- learner state --

    def learner_tensors(self) -> dict[str, torch.Tensor]:
        """Every tensor of the learner's state, by name."""
        out = {f"param/{k}": v for k, v in self.ac.state_dict().items()}
        for name, s in (("actor_norm", self.actor_norm), ("critic_norm", self.critic_norm)):
            for k, v in zip(("mean", "var", "count"), s.tensors()):
                out[f"{name}/{k}"] = v
        names = [k for k, _ in self.ac.named_parameters()]
        for k, mu, nu in zip(names, self.opt.mu, self.opt.nu):
            out[f"adam_mu/{k}"], out[f"adam_nu/{k}"] = mu, nu
        out["adam/count"], out["lr"] = self.opt.count, self.lr
        return out
