"""rsl-rl checkpoints and the JAX package's weights into the port's learner.

PyTorch counterpart of mjlab_tpu/rl/interop.py. An rsl-rl ``model_<it>.pt``
holds the actor and critic MLPs (torch Sequentials with interleaved
activations), the noise head (``std`` or ``log_std``) and the empirical
observation normalisers, under every key variant the JAX loader accepts
(interop.py:51-136). The port's runner writes the same layout, so its
checkpoints load here and into the JAX package.

``params_from_numpy`` carries the JAX package's PPO params (flax trees as
numpy arrays: ``Dense_i.kernel`` is (in, out), a torch Linear's weight is
(out, in)) and normalisers into the same layout.
"""

from __future__ import annotations

import numpy as np
import torch

# the normaliser key prefixes of rsl-rl's model_state_dict, by group
ACTOR_NORM_PREFIXES = ("obs_normalizer", "actor_obs_normalizer", "empirical_normalization")
CRITIC_NORM_PREFIXES = ("critic_obs_normalizer", "privileged_obs_normalizer")
# rsl-rl with empirical_normalization=True: top-level normaliser state dicts
ACTOR_NORM_PAYLOAD, CRITIC_NORM_PAYLOAD = "obs_norm_state_dict", "critic_obs_norm_state_dict"
# the count of a normaliser saved without one
DEFAULT_COUNT = 1e6


def _mlp_layers(sd: dict, prefix: str) -> list:
    """(weight, bias) of an rsl-rl MLP's Linear layers, in index order."""
    layers: dict = {}
    for key, tensor in sd.items():
        if not key.startswith(prefix):
            continue
        parts = key[len(prefix):].lstrip(".").split(".")
        if len(parts) != 2 or parts[1] not in ("weight", "bias") or not parts[0].isdigit():
            continue
        layers.setdefault(int(parts[0]), {})[parts[1]] = torch.as_tensor(tensor)
    return [(lw["weight"], lw.get("bias")) for _, lw in sorted(layers.items()) if "weight" in lw]


def _norm_from(mean, var, count) -> tuple:
    count = (DEFAULT_COUNT if count is None
             else float(np.asarray(torch.as_tensor(count).cpu()).reshape(-1)[0]))
    return (torch.as_tensor(mean).reshape(-1), torch.as_tensor(var).reshape(-1),
            torch.tensor(count, dtype=torch.float32))


def _find_norm(sd: dict, payload: dict, prefixes, payload_key):
    found = None
    for p in prefixes:
        if f"{p}.mean" in sd:
            found = _norm_from(sd[f"{p}.mean"], sd[f"{p}.var"], sd.get(f"{p}.count"))
            break
    nd = payload.get(payload_key)
    if nd and nd.get("mean") is not None and nd.get("var") is not None:
        found = _norm_from(nd["mean"], nd["var"], nd.get("count"))
    return found


@torch.no_grad()
def load_model_state(ppo, payload: dict) -> None:
    """The actor, critic, noise head and normalisers of an rsl-rl payload
    into ``ppo`` (mjlab_tpu_torch.rl.ppo.PPO), on its device."""
    sd = payload["model_state_dict"]
    ac = ppo.ac
    for name, seq in (("actor", ac.actor), ("critic", ac.critic)):
        dst = [m for m in seq if isinstance(m, torch.nn.Linear)]
        src = _mlp_layers(sd, name)
        if len(src) != len(dst):
            raise ValueError(f"checkpoint {name}: {len(src)} layers, the policy has {len(dst)}")
        for lin, (w, b) in zip(dst, src):
            if tuple(w.shape) != tuple(lin.weight.shape):
                raise ValueError(f"checkpoint {name}: weight {tuple(w.shape)}, the policy's "
                                 f"{tuple(lin.weight.shape)}")
            lin.weight.copy_(w)
            lin.bias.copy_(b if b is not None else torch.zeros_like(lin.bias))
    scalar = ac.noise_std_type == "scalar"
    head = ac.std if scalar else ac.log_std
    if "std" in sd:
        std = torch.as_tensor(sd["std"]).reshape(-1)
        head.copy_(std if scalar else torch.log(torch.clamp_min(std, 1e-8)))
    elif "log_std" in sd:
        log_std = torch.as_tensor(sd["log_std"]).reshape(-1)
        head.copy_(torch.exp(log_std) if scalar else log_std)
    for attr, prefixes, key in (("actor_norm", ACTOR_NORM_PREFIXES, ACTOR_NORM_PAYLOAD),
                                ("critic_norm", CRITIC_NORM_PREFIXES, CRITIC_NORM_PAYLOAD)):
        found = _find_norm(sd, payload, prefixes, key)
        if found is not None:
            for dst, src in zip(getattr(ppo, attr).tensors(), found):
                dst.copy_(src)


def load_rslrl_checkpoint(path: str, runner) -> None:
    """Load an rsl-rl ``model_*.pt`` into runner.ppo (inference: actor,
    critic, noise head, obs normalisers) and set runner.iteration."""
    payload = torch.load(path, map_location="cpu", weights_only=False)
    load_model_state(runner.ppo, payload)
    runner.iteration = int(payload.get("iter", 0))


def params_from_numpy(jax_params: dict, actor_norm=None, critic_norm=None,
                      noise_std_type: str = "scalar") -> dict:
    """An rsl-rl payload ({"model_state_dict": ...}, for load_model_state)
    from the JAX package's PPO params as numpy arrays ({"actor": flax tree,
    "critic": flax tree, "std": the noise param}) and normalisers (objects
    with mean, var and count, e.g. the JAX NormState)."""
    sd = {}
    for name in ("actor", "critic"):
        layers = jax_params[name]["params"]
        for i in range(len(layers)):
            d = layers[f"Dense_{i}"]
            sd[f"{name}.{2 * i}.weight"] = torch.tensor(np.asarray(d["kernel"]).T)
            sd[f"{name}.{2 * i}.bias"] = torch.tensor(np.asarray(d["bias"]))
    sd["std" if noise_std_type == "scalar" else "log_std"] = torch.tensor(
        np.asarray(jax_params["std"]))
    for prefix, norm in (("actor_obs_normalizer", actor_norm),
                         ("critic_obs_normalizer", critic_norm)):
        if norm is not None:
            for k in ("mean", "var", "count"):
                sd[f"{prefix}.{k}"] = torch.tensor(np.asarray(getattr(norm, k)))
    return {"model_state_dict": sd}
