"""The port's PPO learner (mjlab_tpu_torch/rl/ppo.py) against the JAX
package's (mjlab_tpu/rl/ppo.py) on the CPU, float32 both.

- The normaliser: norm_update and norm_apply over three batches, the first
  with outliers (unclipped: the first-batch rule), the later ones with an
  entry far beyond 20 sigma (clipped before the update) and obs past the
  +-10 clip of norm_apply. Mean, var, count and the normalised obs to
  1e-6 relative to max(1, |JAX|).
- ActorCritic at the G1 task's widths (policy obs 99 -> 29 actions, critic
  obs 111 -> 1, hidden (512, 256, 128) ELU), both noise_std_type values,
  the JAX params carried into the port by interop.params_from_numpy:
  act_mean, value, logprob and entropy to 1e-5 relative to max(1, |JAX|).
- One whole learn_iteration: both learners start from the same params,
  run on the same recorded traffic (a replay env step: seeded obs with
  outliers, rewards, terminations and time-outs, logs; the port's replay
  hands back fixed buffers, overwritten every step, as the port's env
  does) and the same draws (JAX's, recorded under jax.disable_jit() and
  played back to the port through Rng.draw). Compared: each step's action,
  logprob, value, bootstrapped reward and stored obs (TOL_ROLLOUT); the
  advantages and returns (TOL_GAE); each minibatch's KL (TOL_KL: it reads
  the params after the minibatch steps before it, so it carries their
  Adam outliers) and learning rate (equal branch for branch; the margin of
  each KL to the adaptive rule's thresholds is reported); the final params (TOL_PARAMS, with
  the Adam outliers below),
  Adam's moments (TOL_MOMENTS, relative to the tensor's largest entry) and
  step count, the normalisers and the metrics (TOL_METRICS). Cases: the
  task's config (adaptive schedule, clipped value loss, advantages
  normalised over the batch), the fixed schedule, advantages normalised
  per minibatch, the unclipped value loss, clipped actions, and a learning
  rate small enough that the adaptive rule raises it. The
  iteration is cut to T = 4 steps of 8 envs, 2 epochs of 2 minibatches
  (JAX runs it op by op).
"""

import copy

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.rl import ppo as jppo_mod
from mjlab_tpu.tasks.velocity.config.g1.rl_cfg import unitree_g1_ppo_runner_cfg as jax_cfg_fn
from mjlab_tpu_torch.rl import ppo as pppo_mod
from mjlab_tpu_torch.rl.interop import load_model_state, params_from_numpy
from mjlab_tpu_torch.tasks.velocity.config.g1.rl_cfg import (
    unitree_g1_ppo_runner_cfg as port_cfg_fn,
)
from torch_port_common import (
    JaxDraws, ReplayRng, jax_learn_iteration, jax_learner_payload, rel_err, tnp,
)

ACT, POL, CRI = 29, 99, 111
T, N, EPOCHS, MINIBATCHES = 4, 8, 2, 2
TOL_NORM = 1e-6
TOL_AC = 1e-5
TOL_ROLLOUT = 1e-5
TOL_GAE = 1e-5
TOL_KL = 1e-4
# Adam divides each element's step by the root mean square of its own
# gradients, so an element whose gradient is of the order of the sums'
# float32 rounding moves by up to lr per step whichever side computes it:
# all but PARAM_OUTLIER_SHARE of the learner's param entries are held to
# TOL_PARAMS, every one to PARAM_OUTLIER_STEP of the summed step sizes
TOL_PARAMS = 1e-5
PARAM_OUTLIER_SHARE = 1e-3
PARAM_OUTLIER_STEP = 0.1
TOL_MOMENTS = 1e-3
TOL_METRICS = 1e-4


def _cfgs(edit=None):
    cfgs = [jax_cfg_fn(), port_cfg_fn()]
    for c in cfgs:
        c.num_steps_per_env = T
        c.algorithm.num_learning_epochs = EPOCHS
        c.algorithm.num_mini_batches = MINIBATCHES
        if edit is not None:
            edit(c)
    return cfgs


def _jax_state(jcfg, seed=0):
    jppo = jppo_mod.PPO(jcfg, env_step=None, num_envs=N, num_actions=ACT, actor_obs_dim=POL,
                        critic_obs_dim=CRI)
    return jppo, jppo.init_state(jax.random.PRNGKey(seed))


def _port_from_jax(pcfg, state, env_step=None):
    p = pppo_mod.PPO(pcfg, env_step, N, ACT, POL, CRI, device="cpu")
    load_model_state(p, params_from_numpy(jax.device_get(state.params),
                                          jax.device_get(state.actor_norm),
                                          jax.device_get(state.critic_norm),
                                          pcfg.policy.noise_std_type))
    return p


# ---------------------------------------------------------------------------
# the normaliser
# ---------------------------------------------------------------------------


def _norm_batches():
    rs = np.random.default_rng(0)
    scale = rs.uniform(0.1, 5.0, 7).astype(np.float32)
    out = []
    for i in range(3):
        b = (rs.standard_normal((64, 7)) * scale + 2.0).astype(np.float32)
        if i == 0:
            b[3, 1] = 500.0  # first batch: no clip
        else:
            b[5, 2] = 1e4 * scale[2]  # far past 20 sigma: clipped first
            b[7, 4] = -30.0 * scale[4]  # past the +-10 clip of norm_apply
        out.append(b)
    return out


def test_norm_update_and_apply_match_jax():
    js = jppo_mod.norm_init(7)
    ps = pppo_mod.NormState.zeros(7, "cpu")
    for i, b in enumerate(_norm_batches()):
        js = jppo_mod.norm_update(js, jnp.asarray(b))
        ps = pppo_mod.norm_update(ps, torch.as_tensor(b))
        for k in ("mean", "var", "count"):
            assert rel_err(np.asarray(getattr(js, k)), tnp(getattr(ps, k))) < TOL_NORM, (i, k)
        ja = np.asarray(jppo_mod.norm_apply(js, jnp.asarray(b)))
        pa = tnp(pppo_mod.norm_apply(ps, torch.as_tensor(b)))
        assert rel_err(ja, pa) < TOL_NORM, i
    assert ps.count.dtype == torch.float32 and float(ps.count) == 192.0
    # the +-10 clip bit: one entry of the last batch normalises past -10
    assert pa.min() == -10.0


def test_norm_first_batch_is_not_clipped():
    """The first batch's outlier moves the mean (no clip at count 0); the
    same outlier in a later batch is clipped to mean + 20 sigma."""
    b = np.zeros((4, 1), np.float32)
    b[0, 0] = 1000.0
    s = pppo_mod.norm_update(pppo_mod.NormState.zeros(1, "cpu"), torch.as_tensor(b))
    assert float(s.mean) == 250.0
    js = jppo_mod.norm_update(jppo_mod.norm_init(1), jnp.asarray(b))
    assert float(js.mean[0]) == 250.0
    small = np.full((4, 1), 1.0, np.float32)
    small[0, 0] = 1e9
    s2 = pppo_mod.norm_update(s, torch.as_tensor(small))
    js2 = jppo_mod.norm_update(js, jnp.asarray(small))
    assert rel_err(np.asarray(js2.mean), tnp(s2.mean)) < TOL_NORM
    assert float(s2.mean) < 1e4  # clipped, not 1e9 / 8


# ---------------------------------------------------------------------------
# the actor-critic at the G1 widths
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("noise", ["scalar", "log"])
def test_actor_critic_matches_jax(noise):
    def edit(c):
        c.policy.noise_std_type = noise
        c.policy.init_noise_std = 0.7

    jcfg, pcfg = _cfgs(edit)
    jppo, state = _jax_state(jcfg, seed=3)
    p = _port_from_jax(pcfg, state)
    rs = np.random.default_rng(1)
    aobs = rs.standard_normal((16, POL)).astype(np.float32)
    cobs = rs.standard_normal((16, CRI)).astype(np.float32)
    act = rs.standard_normal((16, ACT)).astype(np.float32)
    ac, params = jppo.ac, state.params
    jlp, jmean = ac.logprob(params, jnp.asarray(aobs), jnp.asarray(act))
    want = {"act_mean": np.asarray(ac.act_mean(params, jnp.asarray(aobs))),
            "value": np.asarray(ac.value(params, jnp.asarray(cobs))),
            "logprob": np.asarray(jlp), "logprob_mean": np.asarray(jmean),
            "entropy": np.asarray(ac.entropy(params)), "std": np.asarray(ac.std(params))}
    with torch.no_grad():
        plp, pmean = p.ac.logprob(torch.as_tensor(aobs), torch.as_tensor(act))
        got = {"act_mean": tnp(p.ac.act_mean(torch.as_tensor(aobs))),
               "value": tnp(p.ac.value(torch.as_tensor(cobs))),
               "logprob": tnp(plp), "logprob_mean": tnp(pmean),
               "entropy": tnp(p.ac.entropy()), "std": tnp(p.ac.noise_std())}
    for k in want:
        assert want[k].shape == got[k].shape, k
        assert rel_err(want[k], got[k]) < TOL_AC, (k, rel_err(want[k], got[k]))
    names = [k for k, _ in p.ac.named_parameters()]
    assert ("std" if noise == "scalar" else "log_std") in names
    assert [k for k in p.ac.state_dict() if k.startswith("actor.")] == [
        f"actor.{i}.{w}" for i in (0, 2, 4, 6) for w in ("weight", "bias")]


def test_port_init_is_flax_lecun_normal():
    """The port's own init: biases 0, each kernel's std 1/sqrt(fan_in)
    within sampling error, truncated at 2 std (flax Dense's lecun_normal),
    drawn from the learner's Rng (the same seed, the same weights)."""
    _, pcfg = _cfgs()
    a = pppo_mod.PPO(pcfg, None, N, ACT, POL, CRI, device="cpu")
    b = pppo_mod.PPO(pcfg, None, N, ACT, POL, CRI, device="cpu")
    for (name, x), y in zip(a.ac.state_dict().items(), b.ac.state_dict().values()):
        assert torch.equal(x, y), name
        if name.endswith("bias"):
            assert not x.any(), name
        elif x.dim() == 2:
            std = 1.0 / np.sqrt(x.shape[1])
            assert abs(float(x.std()) / std - 1.0) < 0.1, name
            assert float(x.abs().max()) <= 2.0 * std / 0.8796 + 1e-6, name
    assert float(a.lr) == np.float32(pcfg.algorithm.learning_rate)


# ---------------------------------------------------------------------------
# one learn_iteration
# ---------------------------------------------------------------------------


def _traffic(seed=0):
    """T steps of env outputs (obs for T + 1 states): the policy and critic
    obs with per-column scales and an outlier env, rewards, terminations
    and time-outs (both in some steps), two logs."""
    rs = np.random.default_rng(seed)
    sp = rs.uniform(0.2, 3.0, POL).astype(np.float32)
    sc = rs.uniform(0.2, 3.0, CRI).astype(np.float32)
    pol = (rs.standard_normal((T + 1, N, POL)) * sp + 0.5).astype(np.float32)
    cri = (rs.standard_normal((T + 1, N, CRI)) * sc - 0.3).astype(np.float32)
    pol[2, 5, 7] = 1e4  # beyond 20 sigma in a later batch: clipped
    cri[3, 1, 4] = -1e4
    rew = rs.standard_normal((T, N)).astype(np.float32)
    term = np.zeros((T, N), bool)
    trunc = np.zeros((T, N), bool)
    term[1, 2] = term[3, 6] = True
    trunc[0, 4] = trunc[2, 0] = trunc[2, 2] = True
    logs = {"Episode/length": rs.uniform(1, 50, T).astype(np.float32),
            "Metrics/twist/error_vel_xy": rs.uniform(0, 1, T).astype(np.float32)}
    return dict(policy=pol, critic=cri, reward=rew, terminated=term, truncated=trunc,
                logs=logs)


def _jax_replay(tr, actions):
    def env_step(env_state, action):
        t = int(env_state)
        actions.append(np.asarray(action))
        obs = {"policy": jnp.asarray(tr["policy"][t + 1]),
               "critic": jnp.asarray(tr["critic"][t + 1])}
        logs = {k: jnp.asarray(v[t]) for k, v in tr["logs"].items()}
        return (env_state + 1, obs, jnp.asarray(tr["reward"][t]), jnp.asarray(tr["terminated"][t]),
                jnp.asarray(tr["truncated"][t]), logs)
    return env_step


class _PortReplay:
    """The port's env step on recorded traffic, returning fixed buffers
    that the next step overwrites (as the port env's step does)."""

    def __init__(self, tr):
        self.tr, self.t = tr, 0
        self.obs = {"policy": torch.as_tensor(tr["policy"][0]).clone(),
                    "critic": torch.as_tensor(tr["critic"][0]).clone()}
        self.reward = torch.zeros(N)
        self.terminated = torch.zeros(N, dtype=torch.bool)
        self.truncated = torch.zeros(N, dtype=torch.bool)
        self.logs = {k: torch.zeros(()) for k in tr["logs"]}
        self.actions = []

    def __call__(self, action):
        t, tr = self.t, self.tr
        self.actions.append(action.clone())
        for k in ("policy", "critic"):
            self.obs[k].copy_(torch.as_tensor(tr[k][t + 1]))
        for k in ("reward", "terminated", "truncated"):
            getattr(self, k).copy_(torch.as_tensor(tr[k][t]))
        for k, v in tr["logs"].items():
            self.logs[k].copy_(torch.as_tensor(v[t]))
        self.t += 1
        return self.obs, self.reward, self.terminated, self.truncated, self.logs


CASES = {
    "task": None,
    "fixed_schedule": lambda c: setattr(c.algorithm, "schedule", "fixed"),
    "advantage_per_minibatch": lambda c: setattr(
        c.algorithm, "normalize_advantage_per_mini_batch", True),
    "unclipped_value_loss": lambda c: setattr(c.algorithm, "use_clipped_value_loss", False),
    "clip_actions": lambda c: setattr(c, "clip_actions", 1.0),
    # a step so small that the KL falls below desired_kl / 2: the rule's
    # other branch raises the learning rate
    "adaptive_raises_lr": lambda c: setattr(c.algorithm, "learning_rate", 2e-5),
}


@pytest.fixture(scope="module", params=list(CASES))
def iteration(request):
    jcfg, pcfg = _cfgs(CASES[request.param])
    tr = _traffic()
    jactions = []
    jppo = jppo_mod.PPO(jcfg, env_step=_jax_replay(tr, jactions), num_envs=N, num_actions=ACT,
                        actor_obs_dim=POL, critic_obs_dim=CRI)
    state = jppo.init_state(jax.random.PRNGKey(7))
    start = copy.deepcopy(jax.device_get(state))
    obs0 = {"policy": jnp.asarray(tr["policy"][0]), "critic": jnp.asarray(tr["critic"][0])}
    with JaxDraws() as draws:
        (jstate, _, _), jmetrics, rec = jax_learn_iteration(jppo, state, obs0, jnp.int32(0))
    replay = _PortReplay(tr)
    p = _port_from_jax(pcfg, start, replay)
    p.rng = ReplayRng(draws)
    _, pmetrics = p.learn_iteration(dict(replay.obs))
    assert p.rng.done(), "the port drew fewer numbers than JAX"
    return dict(case=request.param, jcfg=jcfg, tr=tr, jstate=jstate, jmetrics=jmetrics, rec=rec,
                jactions=jactions, port=p, replay=replay,
                pmetrics={k: tnp(v) for k, v in pmetrics.items()})


def test_rollout_matches_jax(iteration):
    it = iteration
    traj = it["rec"]["scan"]["rollout_step"][0][0]
    st = it["port"].storage
    for k in ("action", "logprob", "value", "reward", "raw_reward", "aobs", "cobs", "old_mean",
              "old_std"):
        assert traj[k].shape == tuple(st[k].shape), k
        for t in range(T):
            assert rel_err(traj[k][t], tnp(st[k][t])) < TOL_ROLLOUT, (k, t)
    np.testing.assert_array_equal(traj["done"], st["done"].numpy())
    # the env got the same actions, and the time-outs were bootstrapped
    for t in range(T):
        assert rel_err(it["jactions"][t], tnp(it["replay"].actions[t])) < TOL_ROLLOUT
    tr, gamma = it["tr"], it["jcfg"].algorithm.gamma
    boot = tr["reward"] + gamma * traj["value"] * tr["truncated"]
    assert rel_err(boot, tnp(st["reward"])) < TOL_ROLLOUT
    assert (tnp(st["reward"]) != tr["reward"]).sum() == tr["truncated"].sum()
    if it["case"] == "clip_actions":
        assert float(st["action"].abs().max()) == 1.0


def test_advantages_and_returns_match_jax(iteration):
    it = iteration
    traj = it["rec"]["scan"]["rollout_step"][0][0]
    adv = it["rec"]["scan"]["gae_step"][0][::-1]
    st = it["port"].storage
    assert rel_err(adv + traj["value"], tnp(st["returns"])) < TOL_GAE
    if not it["jcfg"].algorithm.normalize_advantage_per_mini_batch:
        a = adv.astype(np.float64)
        adv = (a - a.mean()) / (a.std() + 1e-8)
    assert rel_err(adv, tnp(st["advantage"])) < TOL_GAE


def test_minibatch_kl_and_lr_match_jax(iteration):
    it = iteration
    aux = it["rec"]["scan"]["epoch"][0]
    stats = tnp(it["port"].minibatch_stats)
    names = pppo_mod.MINIBATCH_STATS
    alg = it["jcfg"].algorithm
    kl = aux["kl"].reshape(-1)
    # how close each KL came to the adaptive rule's thresholds
    margin = np.min(np.abs(kl[:, None] - np.array([alg.desired_kl * 2, alg.desired_kl / 2])), 1)
    print(f"[{it['case']}] KL per minibatch {kl.tolist()}, margin to the thresholds "
          f"{margin.tolist()}")
    assert rel_err(kl, stats[:, names.index("kl")]) < TOL_KL
    np.testing.assert_allclose(stats[:, names.index("lr")], it["rec"]["lr"], rtol=1e-6)
    for k in ("surrogate", "value_loss", "entropy"):
        assert rel_err(aux[k].reshape(-1), stats[:, names.index(k)]) < TOL_METRICS, k
    if alg.schedule == "fixed":
        assert set(it["rec"]["lr"]) == {float(np.float32(alg.learning_rate))}
    if it["case"] == "adaptive_raises_lr":
        assert it["rec"]["lr"][-1] > 1.4 * alg.learning_rate


def test_final_learner_state_matches_jax(iteration):
    it = iteration
    p = it["port"]
    want = jax_learner_payload(it["jstate"], p.ac.noise_std_type)
    got = p.ac.state_dict()
    steps = float(np.sum(it["rec"]["lr"], dtype=np.float64))
    off, total = 0, 0
    for k, v in got.items():
        w = want["model"][k].numpy().astype(np.float64)
        err = np.abs(w - tnp(v)) / np.maximum(1.0, np.abs(w).max())
        off += int((err >= TOL_PARAMS).sum())
        total += err.size
        if (err >= TOL_PARAMS).any():
            print(f"[{it['case']}] {k}: {int((err >= TOL_PARAMS).sum())} of {err.size} entries "
                  f"off by >= {TOL_PARAMS:.0e}, at most {err.max():.3e} "
                  f"({err.max() / steps:.3f} of the summed steps)")
        assert err.max() < PARAM_OUTLIER_STEP * steps, (k, err.max(), steps)
    assert off <= PARAM_OUTLIER_SHARE * total, (off, total)
    names = [k for k, _ in p.ac.named_parameters()]
    for key, moments in (("mu", p.opt.mu), ("nu", p.opt.nu)):
        for k, m in zip(names, moments):
            w = want[key][k].numpy().astype(np.float64)
            err = np.abs(w - tnp(m)).max() / max(np.abs(w).max(), 1e-30)
            assert err < TOL_MOMENTS, (key, k, err)
    assert int(p.opt.count) == want["count"] == EPOCHS * MINIBATCHES
    assert float(p.lr) == np.float32(want["lr"])
    for name, s in (("actor_obs_normalizer", p.actor_norm),
                    ("critic_obs_normalizer", p.critic_norm)):
        for k, v in zip(("mean", "var", "count"), s.tensors()):
            assert rel_err(want["model"][f"{name}.{k}"].numpy(), tnp(v)) < TOL_NORM, (name, k)


def test_metrics_match_jax(iteration):
    want, got = iteration["jmetrics"], iteration["pmetrics"]
    assert set(want) == set(got)
    for k in want:
        assert rel_err(want[k], got[k]) < TOL_METRICS, (k, want[k], got[k])
