"""The port's training slice on the CPU against the JAX package: the
runner (mjlab_tpu_torch/rl/runner.py) on the port's G1 flat-velocity env,
checkpoints, ONNX export, the train CLI and its writers.

- The slice: OnPolicyRunner.learn(1) on the port's env of 4 envs with the
  task's PPO config except T = 3 steps and 2 epochs of 2 minibatches.
  After the reset env 0 is tipped 80 degrees (past fell_over's 70) and
  env 1 set one step before its time-out, as tests/test_torch_env.py does,
  so the first step terminates one and times out the other (its reward
  bootstrapped). The env outputs the port's rollout saw and the learner's
  draws are recorded and replayed through the JAX package's
  learn_iteration (jax.disable_jit(); no JAX env is built), which starts
  from the same params. Held as tests/test_torch_ppo.py holds one
  iteration, with its tolerances: each step's action, logprob, value,
  bootstrapped reward; the advantages and returns; each minibatch's KL and
  learning rate; the final params, Adam's moments, the normalisers and
  the metrics, the env's logs among them.
- Checkpoints: the runner's model_<it>.pt loads into the JAX package
  through mjlab_tpu.rl.interop.load_rslrl_checkpoint (a stand-in runner
  holding a JAX PPO state), whose act_inference then equals the port's to
  1e-6 relative; saved and loaded with load_optimizer, every learner
  tensor and the generator state come back bit for bit;
  get_checkpoint_path resolves the newest run and checkpoint; rsl-rl
  checkpoints under every key variant the JAX loader accepts load as they
  do in the JAX package.
- ONNX: the port's export is byte-equal to the JAX package's for carried
  params and the same metadata.
- The train CLI: the override cases of tests/test_train_cli.py against the
  port's CLI; one run of ``python -m mjlab_tpu_torch.scripts.train`` on the
  CPU (4 envs, 1 iteration, 2 steps) with MuJoCo blocked and no JAX
  imported, whose model_1.pt, <run>.onnx and params/{env,agent}.yaml are
  read back (yaml.safe_load gives the configs' fields; the checkpoint
  loads into JAX as above); the flags of what is not ported raise.
- The tensorboard writer: crc32c vectors and the record framing of the JAX
  package's writer.
"""

import dataclasses
import enum
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

from mjlab_tpu.rl import ppo as jppo_mod
from mjlab_tpu.tasks.velocity.config.g1.rl_cfg import unitree_g1_ppo_runner_cfg as jax_cfg_fn
from mjlab_tpu_torch.rl import ppo as pppo_mod
from mjlab_tpu_torch.rl.interop import load_model_state, params_from_numpy
from torch_port_common import (
    CHILD_THREADS, CHILD_TIMEOUT_S, G1_TASK, DrawsIntoJax, RecordingRng, jax_learn_iteration,
    jax_learner_payload, rel_err, tnp,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
E, T = 4, 3
# the tolerances of tests/test_torch_ppo.py
TOL_ROLLOUT = 1e-5
TOL_GAE = 1e-5
TOL_KL = 1e-4
TOL_PARAMS = 1e-5
PARAM_OUTLIER_SHARE = 1e-3
PARAM_OUTLIER_STEP = 0.1
TOL_MOMENTS = 1e-3
TOL_METRICS = 1e-4
TOL_NORM = 1e-6
TOL_INFERENCE = 1e-6


def _edit(c):
    c.num_steps_per_env = T
    c.algorithm.num_learning_epochs = 2
    c.algorithm.num_mini_batches = 2


def _jax_ppo(jcfg, env_step, n, dims):
    return jppo_mod.PPO(jcfg, env_step=env_step, num_envs=n, num_actions=dims[0],
                        actor_obs_dim=dims[1], critic_obs_dim=dims[2])


# ---------------------------------------------------------------------------
# the slice: the runner on the port's env, replayed through JAX
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def slice_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MJLAB_QUIET", "1")
        from mjlab_tpu_torch.envs import ManagerBasedRlEnv
        from mjlab_tpu_torch.rl import OnPolicyRunner, RslRlVecEnvWrapper
        from mjlab_tpu_torch.tasks import load_env_cfg, load_rl_cfg

        cfg = load_env_cfg(G1_TASK)
        cfg.scene.num_envs = E
        env = ManagerBasedRlEnv(cfg, device="cpu")
        pcfg = load_rl_cfg(G1_TASK)
        _edit(pcfg)
        runner = OnPolicyRunner(RslRlVecEnvWrapper(env), pcfg, device="cpu")
        dims = (29, 99, env.observation_manager.group_obs_dim("critic"))
        # JAX's init params into the port's learner
        jcfg = jax_cfg_fn()
        _edit(jcfg)
        start = jax.device_get(_jax_ppo(jcfg, None, E, dims).init_state(jax.random.PRNGKey(5)))
        p = runner.ppo
        load_model_state(p, params_from_numpy(start.params, start.actor_norm,
                                              start.critic_norm))
        rec_rng = RecordingRng(p.rng)
        p.rng = rec_rng

        seen = {"obs": [], "step": []}

        def clone_obs(o):
            return {k: v.clone() for k, v in o.items()}

        reset = env.reset

        def tipped_reset(*a, **kw):
            obs, extras = reset(*a, **kw)
            angle = math.radians(80.0) / 2
            qpos = env.sim.data.qpos.clone()
            qpos[0, 3:7] = torch.tensor([math.cos(angle), math.sin(angle), 0.0, 0.0])
            env.sim.data = env.sim.data.replace(qpos=qpos)
            env.episode_length_buf[1] = env.max_episode_length - 1
            seen["obs"].append(clone_obs(obs))
            return obs, extras

        env.reset = tipped_reset
        env_step = p.env_step

        def recording_step(action):
            obs, rew, term, trunc, logs = env_step(action)
            seen["step"].append(dict(obs=clone_obs(obs), reward=rew.clone(),
                                     terminated=term.clone(), truncated=trunc.clone(),
                                     logs={k: float(v) for k, v in logs.items()}))
            return obs, rew, term, trunc, logs

        p.env_step = recording_step
        metrics = runner.learn(1)
        env.reset = reset

        def jax_step(env_state, action):
            s = seen["step"][int(env_state)]
            obs = {k: jnp.asarray(v.numpy()) for k, v in s["obs"].items()}
            return (env_state + 1, obs, jnp.asarray(s["reward"].numpy()),
                    jnp.asarray(s["terminated"].numpy()), jnp.asarray(s["truncated"].numpy()),
                    {k: jnp.asarray(np.float32(v)) for k, v in s["logs"].items()})

        jppo = _jax_ppo(jcfg, jax_step, E, dims)
        state = jppo.init_state(jax.random.PRNGKey(5))
        obs0 = {k: jnp.asarray(v.numpy()) for k, v in seen["obs"][0].items()}
        with DrawsIntoJax(rec_rng.log) as d:
            (jstate, _, _), jmetrics, rec = jax_learn_iteration(jppo, state, obs0, jnp.int32(0))
        assert not d.queue, "JAX drew fewer numbers than the port"
        yield dict(env=env, runner=runner, pcfg=pcfg, jcfg=jcfg, seen=seen, metrics=metrics,
                   jstate=jstate, jmetrics=jmetrics, rec=rec, dims=dims)


def test_slice_first_step_terminates_and_times_out(slice_run):
    s0 = slice_run["seen"]["step"][0]
    assert s0["terminated"].tolist() == [True, False, False, False]
    assert s0["truncated"].tolist() == [False, True, False, False]
    assert s0["logs"]["Episode_Termination/fell_over"] == 0.5
    st = slice_run["runner"].ppo.storage
    gamma = slice_run["pcfg"].algorithm.gamma
    boot = s0["reward"] + gamma * st["value"][0] * s0["truncated"]
    assert torch.equal(st["reward"][0], boot)
    assert st["reward"][0][1] != s0["reward"][1] and st["done"][0].tolist()[:2] == [True, True]


def test_slice_rollout_matches_jax(slice_run):
    traj = slice_run["rec"]["scan"]["rollout_step"][0][0]
    st = slice_run["runner"].ppo.storage
    for k in ("action", "logprob", "value", "reward", "raw_reward", "aobs", "cobs"):
        for t in range(T):
            assert rel_err(traj[k][t], tnp(st[k][t])) < TOL_ROLLOUT, (k, t)
    np.testing.assert_array_equal(traj["done"], st["done"].numpy())


def test_slice_advantages_and_minibatches_match_jax(slice_run):
    rec, st = slice_run["rec"], slice_run["runner"].ppo.storage
    traj = rec["scan"]["rollout_step"][0][0]
    adv = rec["scan"]["gae_step"][0][::-1].astype(np.float64)
    assert rel_err(adv + traj["value"], tnp(st["returns"])) < TOL_GAE
    assert rel_err((adv - adv.mean()) / (adv.std() + 1e-8), tnp(st["advantage"])) < TOL_GAE
    stats = tnp(slice_run["runner"].ppo.minibatch_stats)
    names = pppo_mod.MINIBATCH_STATS
    kl = rec["scan"]["epoch"][0]["kl"].reshape(-1)
    print(f"KL per minibatch {kl.tolist()}, learning rates {rec['lr']}")
    assert rel_err(kl, stats[:, names.index("kl")]) < TOL_KL
    np.testing.assert_allclose(stats[:, names.index("lr")], rec["lr"], rtol=1e-6)


def test_slice_final_state_and_metrics_match_jax(slice_run):
    p = slice_run["runner"].ppo
    want = jax_learner_payload(slice_run["jstate"])
    steps = float(np.sum(slice_run["rec"]["lr"], dtype=np.float64))
    off, total = 0, 0
    for k, v in p.ac.state_dict().items():
        w = want["model"][k].numpy().astype(np.float64)
        err = np.abs(w - tnp(v)) / np.maximum(1.0, np.abs(w).max())
        off += int((err >= TOL_PARAMS).sum())
        total += err.size
        assert err.max() < PARAM_OUTLIER_STEP * steps, k
    assert off <= PARAM_OUTLIER_SHARE * total, (off, total)
    names = [k for k, _ in p.ac.named_parameters()]
    for key, moments in (("mu", p.opt.mu), ("nu", p.opt.nu)):
        for k, m in zip(names, moments):
            w = want[key][k].numpy().astype(np.float64)
            assert np.abs(w - tnp(m)).max() / max(np.abs(w).max(), 1e-30) < TOL_MOMENTS, (key, k)
    for name, s in (("actor_obs_normalizer", p.actor_norm),
                    ("critic_obs_normalizer", p.critic_norm)):
        for k, v in zip(("mean", "var", "count"), s.tensors()):
            assert rel_err(want["model"][f"{name}.{k}"].numpy(), tnp(v)) < TOL_NORM, (name, k)
    jm, pm = slice_run["jmetrics"], slice_run["metrics"]
    assert set(jm) == set(pm) and "Episode_Termination/fell_over" in pm
    for k in jm:
        assert rel_err(jm[k], pm[k]) < TOL_METRICS, (k, jm[k], pm[k])
    assert slice_run["runner"].iteration == 1


# ---------------------------------------------------------------------------
# checkpoints
# ---------------------------------------------------------------------------


class _JaxStandIn:
    """What mjlab_tpu.rl.interop.load_rslrl_checkpoint needs of a runner."""

    def __init__(self, jcfg, dims):
        self.ppo = _jax_ppo(jcfg, None, E, dims)
        self.ppo_state = self.ppo.init_state(jax.random.PRNGKey(11))
        self.cfg = jcfg
        self.iteration = 0


def _inference_matches_jax(path, port_ppo, jcfg, dims, seed=0):
    from mjlab_tpu.rl.interop import load_rslrl_checkpoint as jax_load

    r = _JaxStandIn(jcfg, dims)
    jax_load(path, r)
    obs = np.random.default_rng(seed).standard_normal((16, dims[1])).astype(np.float32) * 3
    want = np.asarray(r.ppo.act_inference(r.ppo_state, {"policy": jnp.asarray(obs)}))
    got = tnp(port_ppo.act_inference({"policy": torch.as_tensor(obs)}))
    return rel_err(want, got), r


def test_checkpoint_loads_into_jax(slice_run, tmp_path):
    path = str(tmp_path / "model_1.pt")
    slice_run["runner"].save(path)
    err, r = _inference_matches_jax(path, slice_run["runner"].ppo, slice_run["jcfg"],
                                    slice_run["dims"])
    assert err < TOL_INFERENCE, err
    assert r.iteration == 1
    sd = torch.load(path, weights_only=True)["model_state_dict"]
    assert {"actor.6.weight", "critic.6.bias", "std", "actor_obs_normalizer.count",
            "critic_obs_normalizer.var"} <= set(sd)


def test_checkpoint_round_trip_is_bitwise(slice_run, tmp_path):
    from mjlab_tpu_torch.rl import OnPolicyRunner

    runner = slice_run["runner"]
    path = str(tmp_path / "model_1.pt")
    runner.save(path)
    fresh = OnPolicyRunner(slice_run["env"], slice_run["pcfg"], device="cpu")
    fresh.ppo.rng.generator.manual_seed(123)
    before = fresh.ppo.learner_tensors()
    assert not all(torch.equal(v, runner.ppo.learner_tensors()[k]) for k, v in before.items())
    fresh.load(path, load_optimizer=True)
    want, got = runner.ppo.learner_tensors(), fresh.ppo.learner_tensors()
    assert set(want) == set(got)
    for k in want:
        assert want[k].dtype == got[k].dtype and torch.equal(want[k], got[k]), k
    assert torch.equal(fresh.ppo.rng.generator.get_state(), runner.ppo.rng.generator.get_state())
    assert fresh.iteration == runner.iteration == 1
    # without the optimiser: params and normalisers only
    other = OnPolicyRunner(slice_run["env"], slice_run["pcfg"], device="cpu")
    other.load(path, load_optimizer=False)
    assert int(other.ppo.opt.count) == 0
    assert torch.equal(other.ppo.ac.actor[0].weight, runner.ppo.ac.actor[0].weight)


def test_get_checkpoint_path_resolves_newest(tmp_path):
    from mjlab_tpu_torch.utils.os import get_checkpoint_path

    for run, its in (("2024-01-01_00-00-00", (1, 50)), ("2024-03-01_00-00-00", (2, 10, 9)),
                     ("other", (99,))):
        os.makedirs(tmp_path / run)
        for i in its:
            (tmp_path / run / f"model_{i}.pt").write_bytes(b"")
    (tmp_path / "2024-03-01_00-00-00" / "model_10.onnx").write_bytes(b"")
    got = get_checkpoint_path(str(tmp_path), r"2024-.*", "model_.*.pt")
    assert got == str(tmp_path / "2024-03-01_00-00-00" / "model_10.pt")
    assert get_checkpoint_path(str(tmp_path), "other", "model_.*.pt").endswith("model_99.pt")
    with pytest.raises(FileNotFoundError):
        get_checkpoint_path(str(tmp_path), "nope.*", "model_.*.pt")


def _rslrl_payload(variant: str, dims, seed: int = 0) -> dict:
    """An rsl-rl checkpoint payload at the G1 widths under one of the key
    variants mjlab_tpu/rl/interop.py accepts."""
    rs = np.random.default_rng(seed)
    sd = {}
    for name, din, dout in (("actor", dims[1], dims[0]), ("critic", dims[2], 1)):
        widths = (din, 512, 256, 128, dout)
        for i in range(4):
            w = rs.standard_normal((widths[i + 1], widths[i])) / np.sqrt(widths[i])
            sd[f"{name}.{2 * i}.weight"] = torch.tensor(w, dtype=torch.float32)
            sd[f"{name}.{2 * i}.bias"] = torch.tensor(
                0.1 * rs.standard_normal(widths[i + 1]), dtype=torch.float32)
    std = torch.tensor(rs.uniform(0.3, 1.2, dims[0]), dtype=torch.float32)
    if variant == "log_std":
        sd["log_std"] = torch.log(std)
    else:
        sd["std"] = std
    norms = {g: {"mean": torch.tensor(rs.standard_normal(d), dtype=torch.float32),
                 "var": torch.tensor(rs.uniform(0.2, 3.0, d), dtype=torch.float32),
                 "count": torch.tensor([1234.0])}
             for g, d in (("actor", dims[1]), ("critic", dims[2]))}
    if variant == "no_count":
        for n in norms.values():
            del n["count"]
    payload = {"model_state_dict": sd, "iter": 77}
    prefixes = {"log_std": ("obs_normalizer", "critic_obs_normalizer"),
                "empirical_normalization": ("empirical_normalization",
                                            "privileged_obs_normalizer")}.get(
        variant, ("actor_obs_normalizer", "critic_obs_normalizer"))
    if variant == "payload_norm_dicts":
        payload["obs_norm_state_dict"] = norms["actor"]
        payload["critic_obs_norm_state_dict"] = norms["critic"]
    else:
        for prefix, g in zip(prefixes, ("actor", "critic")):
            for k, v in norms[g].items():
                sd[f"{prefix}.{k}"] = v
    return payload


@pytest.mark.parametrize("noise", ["scalar", "log"])
@pytest.mark.parametrize("variant", ["actor_obs_normalizer", "log_std",
                                     "empirical_normalization", "payload_norm_dicts",
                                     "no_count"])
def test_rslrl_checkpoint_variants_load_as_in_jax(tmp_path, variant, noise):
    """rl/interop.py load_rslrl_checkpoint against the JAX package's on each
    key variant: the same policy mean, value, noise and normalisers."""
    from mjlab_tpu_torch.rl.interop import load_rslrl_checkpoint
    from mjlab_tpu_torch.tasks.velocity.config.g1.rl_cfg import unitree_g1_ppo_runner_cfg

    dims = (29, 99, 111)
    path = str(tmp_path / "model_77.pt")
    torch.save(_rslrl_payload(variant, dims), path)
    jcfg, pcfg = jax_cfg_fn(), unitree_g1_ppo_runner_cfg()
    for c in (jcfg, pcfg):
        c.policy.noise_std_type = noise

    class PortStandIn:
        ppo = pppo_mod.PPO(pcfg, None, E, *dims, device="cpu")
        iteration = 0

    runner = PortStandIn()
    load_rslrl_checkpoint(path, runner)
    err, jr = _inference_matches_jax(path, runner.ppo, jcfg, dims, seed=3)
    assert err < TOL_INFERENCE, err
    assert runner.iteration == jr.iteration == 77
    st = jr.ppo_state
    obs = np.random.default_rng(4).standard_normal((8, dims[2])).astype(np.float32)
    want = np.asarray(jr.ppo.ac.value(st.params, jnp.asarray(obs)))
    got = tnp(runner.ppo.ac.value(torch.as_tensor(obs)))
    assert rel_err(want, got) < TOL_INFERENCE
    assert rel_err(np.asarray(jr.ppo.ac.std(st.params)), tnp(runner.ppo.ac.noise_std())) < 1e-6
    for name in ("actor_norm", "critic_norm"):
        for k in ("mean", "var", "count"):
            assert rel_err(np.asarray(getattr(getattr(st, name), k)),
                           tnp(getattr(getattr(runner.ppo, name), k))) < 1e-7, (name, k)
    if variant == "no_count":
        assert float(runner.ppo.actor_norm.count) == 1e6


def test_inference_policy_is_the_normalised_actor_mean(slice_run):
    runner = slice_run["runner"]
    policy = runner.get_inference_policy()
    obs = {"policy": torch.randn(6, 99, generator=torch.Generator().manual_seed(0))}
    p = runner.ppo
    want = p.ac.actor(torch.clamp((obs["policy"] - p.actor_norm.mean)
                                  / torch.sqrt(p.actor_norm.var + 1e-8), -10, 10))
    assert torch.equal(policy(obs), want.detach())


# ---------------------------------------------------------------------------
# ONNX
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("normalize", [True, False])
def test_onnx_export_is_byte_equal_to_jax(tmp_path, normalize):
    from mjlab_tpu.rl.exporter import export_policy_as_onnx as jax_export
    from mjlab_tpu_torch.rl.exporter import export_policy_as_onnx
    from mjlab_tpu_torch.tasks.velocity.config.g1.rl_cfg import unitree_g1_ppo_runner_cfg

    jcfg, pcfg = jax_cfg_fn(), unitree_g1_ppo_runner_cfg()
    for c in (jcfg, pcfg):
        c.policy.actor_obs_normalization = normalize
    dims = (29, 99, 111)
    jppo = _jax_ppo(jcfg, None, E, dims)
    state = jppo.init_state(jax.random.PRNGKey(2))
    rs = np.random.default_rng(2)
    norm = jppo_mod.NormState(mean=jnp.asarray(rs.standard_normal(99).astype(np.float32)),
                              var=jnp.asarray(rs.uniform(0.1, 4, 99).astype(np.float32)),
                              count=jnp.asarray(np.float32(96.0)))
    state = state.replace(actor_norm=norm)
    p = pppo_mod.PPO(pcfg, None, E, *dims, device="cpu")
    host = jax.device_get(state)
    load_model_state(p, params_from_numpy(host.params, host.actor_norm, host.critic_norm))
    meta = {"run_path": "r", "joint_names": ["a", "b"], "joint_stiffness": [1.5, 40.17929840087891],
            "action_scale": 0.25}
    jax_export(jppo.ac, state, str(tmp_path / "jax.onnx"), metadata=meta)
    export_policy_as_onnx(p, str(tmp_path / "port.onnx"), metadata=meta)
    a, b = (tmp_path / "jax.onnx").read_bytes(), (tmp_path / "port.onnx").read_bytes()
    assert len(a) > 100_000 and a == b


# ---------------------------------------------------------------------------
# the train CLI
# ---------------------------------------------------------------------------


def _override_cases():
    import mjlab_tpu_torch.scripts.train as T
    import mjlab_tpu_torch.tasks as tasks

    def nested():
        cfg = tasks.load_env_cfg(G1_TASK)
        T._apply_overrides(cfg, ["scene.num-envs=512", "decimation=2"])
        assert (cfg.scene.num_envs, cfg.decimation) == (512, 2)
        rl = tasks.load_rl_cfg(G1_TASK)
        T._apply_overrides(rl, ["algorithm.gamma=0.97", "policy.init-noise-std=0.5"])
        assert abs(rl.algorithm.gamma - 0.97) < 1e-9 and abs(rl.policy.init_noise_std - 0.5) < 1e-9

    def bool_and_dict():
        cfg = tasks.load_env_cfg(G1_TASK)
        T._apply_overrides(cfg, ["observations.policy.enable-corruption=false"])
        assert cfg.observations["policy"].enable_corruption is False

    def tuple_list_enum_union():
        rl = tasks.load_rl_cfg(G1_TASK)
        T._apply_overrides(rl, ["policy.actor-hidden-dims=(64, 32)"])
        assert rl.policy.actor_hidden_dims == (64, 32)
        T._apply_overrides(rl, ["policy.critic-hidden-dims=128,64,32"])
        assert rl.policy.critic_hidden_dims == (128, 64, 32)
        T._apply_overrides(rl, ["load-run=2024-01-01_00-00-00"])
        assert rl.load_run == "2024-01-01_00-00-00"
        T._apply_overrides(rl, ["load-run=none"])
        assert rl.load_run is None

        class Mode(enum.Enum):
            FAST = "fast"
            SLOW = "slow"

        @dataclasses.dataclass
        class Inner:
            mode: Mode = Mode.FAST
            gains: list = dataclasses.field(default_factory=lambda: [1.0, 2.0])

        @dataclasses.dataclass
        class Outer:
            inner: Inner = dataclasses.field(default_factory=Inner)

        cfg = Outer()
        T._apply_overrides(cfg, ["inner.mode=SLOW"])
        assert cfg.inner.mode is Mode.SLOW
        T._apply_overrides(cfg, ["inner.mode=fast"])
        assert cfg.inner.mode is Mode.FAST
        T._apply_overrides(cfg, ["inner.gains=[0.5, -1.5, 3]"])
        assert cfg.inner.gains == [0.5, -1.5, 3] and isinstance(cfg.inner.gains, list)

    def bad_path():
        cfg = tasks.load_env_cfg(G1_TASK)
        with pytest.raises(AttributeError):
            T._apply_overrides(cfg, ["scene.does-not-exist=1"])
        with pytest.raises((AttributeError, KeyError)):
            T._apply_overrides(cfg, ["observations.nope.enable-corruption=false"])

    def variant_dataclass():
        from mjlab_tpu_torch.utils.noise import GaussianNoiseCfg, UniformNoiseCfg

        cfg = tasks.load_env_cfg(G1_TASK)
        assert isinstance(cfg.observations["policy"].terms["base_ang_vel"].noise, UniformNoiseCfg)
        T._apply_overrides(cfg, ["observations.policy.terms.base_ang_vel.noise="
                                 "GaussianNoiseCfg(mean=0.0, std=0.3)"])
        noise = cfg.observations["policy"].terms["base_ang_vel"].noise
        assert isinstance(noise, GaussianNoiseCfg) and noise.std == 0.3
        with pytest.raises(ValueError, match="unknown cfg variant"):
            T._apply_overrides(
                cfg, ["observations.policy.terms.base_ang_vel.noise=NopeCfg(std=1.0)"])

    def terrain_generator():
        """--env.scene.terrain.terrain-generator.* reach the rough task's
        generator config as they reach the JAX CLI's."""
        import mjlab_tpu.scripts.train as JT
        import mjlab_tpu.tasks as jtasks

        ovs = ["scene.terrain.terrain-generator.num-rows=4",
               "scene.terrain.terrain-generator.curriculum=false",
               "scene.terrain.terrain-generator.border-width=5.5",
               "scene.terrain.terrain-generator.seed=3",
               "scene.terrain.terrain-generator.sub-terrains.flat.proportion=0.1",
               "scene.terrain.max-init-terrain-level=2"]
        task = "Mjlab-Velocity-Rough-Unitree-G1"
        cfg, jcfg = tasks.load_env_cfg(task), jtasks.load_env_cfg(task)
        T._apply_overrides(cfg, ovs)
        JT._apply_overrides(jcfg, ovs)
        gen, jgen = cfg.scene.terrain.terrain_generator, jcfg.scene.terrain.terrain_generator
        for f in ("num_rows", "num_cols", "curriculum", "border_width", "seed", "size"):
            assert getattr(gen, f) == getattr(jgen, f), f
        assert (gen.num_rows, gen.curriculum, gen.border_width, gen.seed) == (4, False, 5.5, 3)
        assert gen.sub_terrains["flat"].proportion == jgen.sub_terrains["flat"].proportion == 0.1
        assert cfg.scene.terrain.max_init_terrain_level == 2

    return {f.__name__: f for f in (nested, bool_and_dict, tuple_list_enum_union, bad_path,
                                    variant_dataclass, terrain_generator)}


@pytest.mark.parametrize("case", ["nested", "bool_and_dict", "tuple_list_enum_union",
                                  "bad_path", "variant_dataclass", "terrain_generator"])
def test_cli_overrides(case):
    _override_cases()[case]()


def test_cli_dotted_flags_route_to_overrides(monkeypatch):
    import mjlab_tpu_torch.scripts.train as T

    captured = {}
    monkeypatch.setattr(T, "run_train", lambda task, **kw: captured.update(kw, task=task))
    monkeypatch.setattr(sys, "argv", ["train", G1_TASK, "--env.scene.num-envs", "4096",
                                      "--agent.algorithm.gamma=0.97", "--max-iterations", "3",
                                      "--device", "cpu"])
    T.main()
    assert captured["env_overrides"] == ["scene.num-envs=4096"]
    assert captured["agent_overrides"] == ["algorithm.gamma=0.97"]
    assert captured["max_iterations"] == 3 and captured["device"] == "cpu"


def test_cli_help_enumerates_nested_fields(capsys, monkeypatch):
    import mjlab_tpu_torch.scripts.train as T

    monkeypatch.setattr(sys, "argv", ["train", G1_TASK, "--help"])
    with pytest.raises(SystemExit) as e:
        T.main()
    assert e.value.code == 0
    out = capsys.readouterr().out
    assert "--env.scene.num-envs" in out and "--agent.algorithm.gamma" in out
    assert "--device" in out and out.count("--env.") > 100


@pytest.mark.parametrize("flag", ["distributed", "registry_name"])
def test_cli_unported_flags_raise(flag):
    import mjlab_tpu_torch.scripts.train as T

    value = True if flag == "distributed" else "x"
    with pytest.raises(NotImplementedError, match="not ported"):
        T.run_train(G1_TASK, device="cpu", **{flag: value})


def test_cli_runs_with_the_nan_guard(tmp_path, monkeypatch):
    """--enable-nan-guard (mjlab_tpu/scripts/train.py:205-208) turns the
    env's NaN guard on and trains: the env records its window in every
    step, and with no NaN nothing is written."""
    import mjlab_tpu_torch.scripts.train as T
    from mjlab_tpu_torch.rl.runner import OnPolicyRunner

    seen = {}
    learn = OnPolicyRunner.learn

    def spy(self, *a, **kw):
        out = learn(self, *a, **kw)
        seen["guard"] = self.env.nan_guard
        return out

    monkeypatch.setattr(OnPolicyRunner, "learn", spy)
    monkeypatch.chdir(tmp_path)
    T.run_train(G1_TASK, num_envs=2, max_iterations=1, device="cpu", enable_nan_guard=True,
                log_dir=str(tmp_path / "run"), agent_overrides=["num_steps_per_env=2"])
    guard = seen["guard"]
    assert guard is not None and guard.cfg.enabled
    assert int(guard.buffers["qpos"].ptr) == 2 and not bool(guard.stopped)
    assert not (tmp_path / "nan_dumps").exists()


CLI_ARGS = [G1_TASK, "--device", "cpu", "--num-envs", "4", "--max-iterations", "1",
            "--agent.num-steps-per-env", "2", "--log-dir", "run_cli"]


def _run_cli(cwd, args):
    """One run of the port's train CLI with ``args`` in a Python where
    importing mujoco fails; it reports whether jax was imported."""
    code = (
        "import runpy, sys\n"
        "sys.modules['mujoco'] = None\n"
        f"sys.argv = ['train'] + {args!r}\n"
        "runpy.run_module('mjlab_tpu_torch.scripts.train', run_name='__main__')\n"
        "print('jax imported:', 'jax' in sys.modules)\n"
    )
    env = {**os.environ, "MJLAB_QUIET": "1", "PYTHONPATH": ROOT, **CHILD_THREADS}
    r = subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True,
                       timeout=CHILD_TIMEOUT_S, env=env)
    assert r.returncode == 0, r.stderr[-3000:]
    return cwd / args[args.index("--log-dir") + 1], r.stdout


@pytest.fixture(scope="module")
def cli_run(tmp_path_factory):
    return _run_cli(tmp_path_factory.mktemp("cli"), CLI_ARGS)


def test_cli_run_writes_checkpoint_onnx_and_configs(cli_run):
    run, out = cli_run
    assert "jax imported: False" in out and "it=1" in out
    assert sorted(os.listdir(run)) == ["model_1.pt", "params", "run_cli.onnx"]
    assert sorted(os.listdir(run / "params")) == ["agent.yaml", "env.yaml"]
    payload = torch.load(run / "model_1.pt", weights_only=True)
    assert payload["iter"] == 1 and int(payload["optimizer_state_dict"]["count"]) == 20


def test_cli_yaml_reads_back(cli_run):
    from mjlab_tpu_torch.tasks import load_env_cfg, load_rl_cfg
    from mjlab_tpu_torch.utils.os import to_plain

    env_cfg, agent_cfg = load_env_cfg(G1_TASK), load_rl_cfg(G1_TASK)
    env_cfg.scene.num_envs = 4
    agent_cfg.max_iterations = 1
    agent_cfg.num_steps_per_env = 2
    run = cli_run[0]
    for name, cfg in (("env", env_cfg), ("agent", agent_cfg)):
        back = yaml.safe_load((run / "params" / f"{name}.yaml").read_text())
        assert back == to_plain(cfg), name
    assert back["algorithm"]["learning_rate"] == 1e-3 and back["policy"]["actor_hidden_dims"] == [
        512, 256, 128]


def test_cli_checkpoint_loads_into_jax(cli_run):
    from mjlab_tpu_torch.tasks import load_rl_cfg

    pcfg = load_rl_cfg(G1_TASK)
    dims = (29, 99, 111)
    p = pppo_mod.PPO(pcfg, None, E, *dims, device="cpu")
    load_model_state(p, torch.load(cli_run[0] / "model_1.pt", weights_only=True))
    err, _ = _inference_matches_jax(str(cli_run[0] / "model_1.pt"), p, jax_cfg_fn(), dims)
    assert err < TOL_INFERENCE, err


YAM_TASK = "Mjlab-Lift-Cube-Yam"
YAM_CLI_ARGS = [YAM_TASK, "--device", "cpu", "--num-envs", "4", "--max-iterations", "1",
                "--agent.num-steps-per-env", "2", "--log-dir", "run_yam"]
YAM_DIMS = (7, 29, 29)


@pytest.fixture(scope="module")
def yam_cli_run(tmp_path_factory):
    return _run_cli(tmp_path_factory.mktemp("cli_yam"), YAM_CLI_ARGS)


def test_yam_cli_run_writes_checkpoint_and_configs(yam_cli_run):
    """The train CLI on the lift-cube task: its env from the model file,
    the task's PPO config, one iteration through OnPolicyRunner (the task
    registers no runner class, as in the JAX package, whose generic runner
    writes no ONNX beside the checkpoint)."""
    from mjlab_tpu_torch.tasks import load_rl_cfg
    from mjlab_tpu_torch.utils.os import to_plain

    run, out = yam_cli_run
    assert "jax imported: False" in out and "it=1" in out
    assert sorted(os.listdir(run)) == ["model_1.pt", "params"]
    payload = torch.load(run / "model_1.pt", weights_only=True)
    # 5 epochs x 4 minibatches
    assert payload["iter"] == 1 and int(payload["optimizer_state_dict"]["count"]) == 20
    agent = load_rl_cfg(YAM_TASK)
    agent.max_iterations, agent.num_steps_per_env = 1, 2
    assert yaml.safe_load((run / "params" / "agent.yaml").read_text()) == to_plain(agent)
    assert agent.algorithm.entropy_coef == 0.005 and agent.experiment_name == "yam_lift_cube"


def _yam_jax_stand_in(path):
    from mjlab_tpu.rl.interop import load_rslrl_checkpoint as jax_load
    from mjlab_tpu.tasks.manipulation.config.yam.rl_cfg import yam_lift_cube_ppo_runner_cfg

    r = _JaxStandIn(yam_lift_cube_ppo_runner_cfg(), YAM_DIMS)
    jax_load(str(path), r)
    return r


def test_train_defaults_to_cuda(tmp_path):
    """Without a device the trainer runs on the card; with none it refuses
    rather than moving to the CPU."""
    from mjlab_tpu_torch.scripts.train import run_train

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    with pytest.raises(RuntimeError, match="cuda"):
        run_train(YAM_TASK, num_envs=2, max_iterations=1, log_dir=str(tmp_path / "run"))


def test_yam_cli_checkpoint_loads_into_jax(yam_cli_run):
    from mjlab_tpu.tasks.manipulation.config.yam.rl_cfg import yam_lift_cube_ppo_runner_cfg
    from mjlab_tpu_torch.tasks import load_rl_cfg

    p = pppo_mod.PPO(load_rl_cfg(YAM_TASK), None, E, *YAM_DIMS, device="cpu")
    load_model_state(p, torch.load(yam_cli_run[0] / "model_1.pt", weights_only=True))
    err, r = _inference_matches_jax(str(yam_cli_run[0] / "model_1.pt"), p,
                                    yam_lift_cube_ppo_runner_cfg(), YAM_DIMS)
    assert err < TOL_INFERENCE, err
    assert r.iteration == 1


def test_yam_onnx_export_is_byte_equal_to_jax(yam_cli_run, tmp_path):
    """The deployment ONNX of the CLI's YAM checkpoint (the learned
    normaliser fused), from the port's exporter and from the JAX package's
    on the same params and metadata."""
    from mjlab_tpu.rl.exporter import export_policy_as_onnx as jax_export
    from mjlab_tpu_torch.rl.exporter import export_policy_as_onnx
    from mjlab_tpu_torch.tasks import load_rl_cfg

    path = yam_cli_run[0] / "model_1.pt"
    p = pppo_mod.PPO(load_rl_cfg(YAM_TASK), None, E, *YAM_DIMS, device="cpu")
    load_model_state(p, torch.load(path, weights_only=True))
    r = _yam_jax_stand_in(path)
    meta = {"run_path": "r", "joint_names": [f"joint{i}" for i in range(1, 7)]
            + ["left_finger", "right_finger"], "command_names": ["lift_height"]}
    jax_export(r.ppo.ac, r.ppo_state, str(tmp_path / "jax.onnx"), metadata=meta)
    export_policy_as_onnx(p, str(tmp_path / "port.onnx"), metadata=meta)
    a, b = (tmp_path / "jax.onnx").read_bytes(), (tmp_path / "port.onnx").read_bytes()
    assert len(a) > 100_000 and a == b


# the jump tasks: (actions, policy obs, critic obs), epochs x minibatches,
# the JAX package's PPO config
JUMP_TASKS = {
    "Mjlab-Jump-Flat-Unitree-G1": ((29, 103, 111), 6 * 4,
                                   "mjlab_tpu.tasks.jump.config.g1.rl_cfg"),
    "Mjlab-Jumping-Flat-Unitree-G1": ((29, 100, 110), 5 * 4,
                                      "mjlab_tpu.tasks.jumping.config.g1.rl_cfg"),
}


def _jump_jax_cfg(task):
    import importlib

    mod = importlib.import_module(JUMP_TASKS[task][2])
    return next(getattr(mod, n) for n in dir(mod) if n.endswith("_ppo_runner_cfg"))()


@pytest.fixture(scope="module", params=list(JUMP_TASKS))
def jump_cli_run(request, tmp_path_factory):
    task = request.param
    run_dir = "run_" + task.split("-")[1].lower()
    args = [task, "--device", "cpu", "--num-envs", "4", "--max-iterations", "1",
            "--agent.num-steps-per-env", "2", "--log-dir", run_dir]
    return (task, *_run_cli(tmp_path_factory.mktemp("cli_" + run_dir), args))


def test_jump_cli_run_writes_checkpoint_and_configs(jump_cli_run):
    """The train CLI on each jump task: its env from the flat G1 model file
    (the jump task at dt 0.002, decimation 2), the task's PPO config, one
    iteration through OnPolicyRunner (the tasks register no runner class:
    no ONNX beside the checkpoint, as in the JAX package)."""
    from mjlab_tpu_torch.tasks import load_env_cfg, load_rl_cfg
    from mjlab_tpu_torch.utils.os import to_plain

    task, run, out = jump_cli_run
    assert "jax imported: False" in out and "it=1" in out
    assert sorted(os.listdir(run)) == ["model_1.pt", "params"]
    payload = torch.load(run / "model_1.pt", weights_only=True)
    assert payload["iter"] == 1
    assert int(payload["optimizer_state_dict"]["count"]) == JUMP_TASKS[task][1]
    agent = load_rl_cfg(task)
    agent.max_iterations, agent.num_steps_per_env = 1, 2
    assert yaml.safe_load((run / "params" / "agent.yaml").read_text()) == to_plain(agent)
    env = yaml.safe_load((run / "params" / "env.yaml").read_text())
    want = load_env_cfg(task)
    assert (env["decimation"], env["sim"]["mujoco"]["timestep"], env["scene"]["num_envs"]) == \
        (want.decimation, want.sim.mujoco.timestep, 4)


def test_jump_cli_checkpoint_loads_into_jax(jump_cli_run):
    """The CLI's checkpoint in the JAX package's loader: the same actor
    (the jump task's 256-128-64 beside a 512-256-128 critic)."""
    from mjlab_tpu_torch.tasks import load_rl_cfg

    task, run, _ = jump_cli_run
    dims = JUMP_TASKS[task][0]
    p = pppo_mod.PPO(load_rl_cfg(task), None, E, *dims, device="cpu")
    sd = torch.load(run / "model_1.pt", weights_only=True)
    load_model_state(p, sd)
    err, r = _inference_matches_jax(str(run / "model_1.pt"), p, _jump_jax_cfg(task), dims)
    assert err < TOL_INFERENCE, err
    assert r.iteration == 1
    actor = [tuple(sd["model_state_dict"][f"actor.{i}.weight"].shape) for i in (0, 2, 4, 6)]
    critic = [tuple(sd["model_state_dict"][f"critic.{i}.weight"].shape) for i in (0, 2, 4, 6)]
    widths = (256, 128, 64) if "Jump-" in task else (512, 256, 128)
    assert actor == [(widths[0], dims[1]), (widths[1], widths[0]), (widths[2], widths[1]),
                     (dims[0], widths[2])]
    assert critic == [(512, dims[2]), (256, 512), (128, 256), (1, 128)]


def test_jump_onnx_export_is_byte_equal_to_jax(jump_cli_run, tmp_path):
    """The deployment ONNX of the CLI's checkpoint, from the port's exporter
    and from the JAX package's on the same params and metadata."""
    from mjlab_tpu.rl.exporter import export_policy_as_onnx as jax_export
    from mjlab_tpu.rl.interop import load_rslrl_checkpoint as jax_load
    from mjlab_tpu_torch.rl.exporter import export_policy_as_onnx
    from mjlab_tpu_torch.tasks import load_rl_cfg

    task, run, _ = jump_cli_run
    dims = JUMP_TASKS[task][0]
    path = run / "model_1.pt"
    p = pppo_mod.PPO(load_rl_cfg(task), None, E, *dims, device="cpu")
    load_model_state(p, torch.load(path, weights_only=True))
    r = _JaxStandIn(_jump_jax_cfg(task), dims)
    jax_load(str(path), r)
    meta = {"run_path": "r", "command_names": ["jump"]}
    jax_export(r.ppo.ac, r.ppo_state, str(tmp_path / "jax.onnx"), metadata=meta)
    export_policy_as_onnx(p, str(tmp_path / "port.onnx"), metadata=meta)
    a, b = (tmp_path / "jax.onnx").read_bytes(), (tmp_path / "port.onnx").read_bytes()
    assert len(a) > 50_000 and a == b


TRACK_TASK = "Mjlab-Tracking-Flat-Unitree-G1"
MOTION = os.path.join(ROOT, "evidence", "tracking_r4", "motion.npz")
TRACK_CLI_ARGS = [TRACK_TASK, "--device", "cpu", "--num-envs", "4", "--max-iterations", "1",
                  "--agent.num-steps-per-env", "2", "--log-dir", "run_track",
                  "--motion-file", MOTION]
# actions, policy obs (command 58, anchor 3 + 6, imu 6, joints 58, actions
# 29), critic obs (+ 14 bodies' positions 42 and orientations 84)
TRACK_DIMS = (29, 160, 286)


@pytest.fixture(scope="module")
def track_cli_run(tmp_path_factory):
    return _run_cli(tmp_path_factory.mktemp("cli_track"), TRACK_CLI_ARGS)


def test_tracking_cli_run_writes_checkpoint_onnx_and_configs(track_cli_run):
    """The train CLI on the G1 tracking task with --motion-file: the env
    from the model file and the motion npz, the task's PPO config, one
    iteration through MotionTrackingOnPolicyRunner, whose checkpoint
    writes the motion-embedded ONNX beside it; the motion file reaches the
    dumped env config."""
    from mjlab_tpu_torch.tasks import load_rl_cfg
    from mjlab_tpu_torch.utils.os import to_plain

    run, out = track_cli_run
    assert "jax imported: False" in out and "it=1" in out
    assert sorted(os.listdir(run)) == ["model_1.pt", "params", "run_track.onnx"]
    payload = torch.load(run / "model_1.pt", weights_only=True)
    assert payload["iter"] == 1 and int(payload["optimizer_state_dict"]["count"]) == 20
    agent = load_rl_cfg(TRACK_TASK)
    agent.max_iterations, agent.num_steps_per_env = 1, 2
    assert yaml.safe_load((run / "params" / "agent.yaml").read_text()) == to_plain(agent)
    assert agent.experiment_name == "g1_tracking"
    env = yaml.safe_load((run / "params" / "env.yaml").read_text())
    assert env["commands"]["motion"]["motion_file"] == MOTION
    assert (run / "run_track.onnx").stat().st_size > 1_000_000  # the motion inside


def test_tracking_cli_checkpoint_loads_into_jax(track_cli_run):
    from mjlab_tpu.tasks.tracking.config.g1.rl_cfg import unitree_g1_tracking_ppo_runner_cfg
    from mjlab_tpu_torch.tasks import load_rl_cfg

    p = pppo_mod.PPO(load_rl_cfg(TRACK_TASK), None, E, *TRACK_DIMS, device="cpu")
    load_model_state(p, torch.load(track_cli_run[0] / "model_1.pt", weights_only=True))
    err, r = _inference_matches_jax(str(track_cli_run[0] / "model_1.pt"), p,
                                    unitree_g1_tracking_ppo_runner_cfg(), TRACK_DIMS)
    assert err < TOL_INFERENCE, err
    assert r.iteration == 1


class _MotionEnv:
    """What the motion exporters read of an env: the "motion" command
    term's motion."""

    def __init__(self, motion):
        term = type("Term", (), {"motion": motion})()
        self.command_manager = type("Commands", (), {"get_term": lambda _, name: term})()


def test_tracking_onnx_export_is_byte_equal_to_jax(track_cli_run, tmp_path):
    """The motion-embedded ONNX of the CLI's tracking checkpoint, from the
    port's exporter and from the JAX package's, on the same params, the
    same motion (the task's 14 bodies of evidence/tracking_r4/motion.npz)
    and the same metadata."""
    from mjlab_tpu.tasks.tracking.config.g1.rl_cfg import unitree_g1_tracking_ppo_runner_cfg
    from mjlab_tpu.tasks.tracking.mdp.commands import MotionLoader as JaxMotion
    from mjlab_tpu.tasks.tracking.rl.exporter import export_motion_policy_as_onnx as jax_export
    from mjlab_tpu_torch.tasks import load_rl_cfg
    from mjlab_tpu_torch.tasks.tracking.config.g1.env_cfgs import G1_TRACKING_BODY_NAMES
    from mjlab_tpu_torch.tasks.tracking.mdp.commands import MotionLoader
    from mjlab_tpu_torch.tasks.tracking.rl.exporter import export_motion_policy_as_onnx
    from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

    path = track_cli_run[0] / "model_1.pt"
    p = pppo_mod.PPO(load_rl_cfg(TRACK_TASK), None, E, *TRACK_DIMS, device="cpu")
    load_model_state(p, torch.load(path, weights_only=True))
    from mjlab_tpu.rl.interop import load_rslrl_checkpoint as jax_load

    r = _JaxStandIn(unitree_g1_tracking_ppo_runner_cfg(), TRACK_DIMS)
    jax_load(str(path), r)
    m, _, _ = physics.load_saved_model(device="cpu")
    robot = [n.split("/", 1)[1] for n in m.body_names if n.startswith("robot/")]
    ids = np.asarray([robot.index(n) for n in G1_TRACKING_BODY_NAMES], np.int32)
    meta = {"run_path": "r", "joint_names": ["a", "b"], "command_names": ["motion"],
            "action_scale": 0.25}
    jax_export(_MotionEnv(JaxMotion(MOTION, ids)), r.ppo.ac, r.ppo_state,
               str(tmp_path / "jax.onnx"), metadata=meta)
    export_motion_policy_as_onnx(_MotionEnv(MotionLoader(MOTION, ids, "cpu")), p,
                                 str(tmp_path / "port.onnx"), metadata=meta)
    a, b = (tmp_path / "jax.onnx").read_bytes(), (tmp_path / "port.onnx").read_bytes()
    assert len(a) > 1_000_000 and a == b


def test_yaml_emitter_round_trips_edge_values(tmp_path):
    from mjlab_tpu_torch.utils.os import dump_yaml

    data = {"f": [1e-05, 1e16, float("inf"), -0.0, 2.5], "s": "a: b\n'\"é", "e": [],
            "d": {}, "n": [[1, 2], [{"q": None}]], "t": (True, False)}
    dump_yaml(str(tmp_path / "x.yaml"), data)
    back = yaml.safe_load((tmp_path / "x.yaml").read_text())
    assert back == {**data, "t": [True, False]}


# ---------------------------------------------------------------------------
# the tensorboard writer
# ---------------------------------------------------------------------------


def test_tb_writer_crc32c_and_framing():
    from mjlab_tpu.rl import tb_writer as jtb
    from mjlab_tpu_torch.rl import tb_writer as ptb

    assert ptb.crc32c(b"") == 0x00000000
    assert ptb.crc32c(b"123456789") == 0xE3069283
    assert ptb.crc32c(b"\x00" * 32) == 0x8A9136AA
    ev = ptb._event(7, {"train/mean_reward": 1.25, "loss/value": -0.5}, 1234.5)
    assert ev == jtb._event(7, {"train/mean_reward": 1.25, "loss/value": -0.5}, 1234.5)
    assert ptb._record(ev) == jtb._record(ev)
