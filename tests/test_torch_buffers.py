"""The port's ring buffers and noise configs (mjlab_tpu_torch/utils/
buffers.py, utils/noise.py) against the JAX package's (mjlab_tpu/utils/
buffers.py, utils/noise.py), in the form of tests/test_buffers.py and
tests/test_noise.py: each scenario runs in both packages on the same
inputs, the port drawing the JAX package's random numbers played back
(torch_port_common.ReplayRng), and every output and lag must be equal
(the buffers only copy and index; the noise adds, scales or replaces in
float32: equal to 1e-6 relative)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.utils import buffers as jb
from mjlab_tpu.utils import noise as jn
from mjlab_tpu_torch.utils import buffers as pb
from mjlab_tpu_torch.utils import noise as pn

from torch_port_common import JaxDraws, ReplayRng, rel_err, tnp


def _frame(B, shape, t):
    return np.full((B,) + shape, float(t), np.float32) + np.arange(B, dtype=np.float32).reshape(
        (B,) + (1,) * len(shape))


# circular buffer: (max_len, batch, pushes, reset mask after push i or None)
CIRCULAR = {
    "backfill_first_append": (4, 2, 1, None),
    "lifo_past_capacity": (3, 1, 5, None),
    "per_env_reset_backfills_next": (3, 2, 4, (2, [True, False])),
}


@pytest.mark.parametrize("case", list(CIRCULAR))
def test_circular_buffer_matches_jax(case):
    T, B, pushes, reset = CIRCULAR[case]
    js = jb.circular_buffer_init(T, B, (3,))
    ps = pb.CircularBuffer(T, B, (3,))
    for t in range(pushes):
        v = _frame(B, (3,), t)
        js = jb.circular_buffer_append(js, jnp.asarray(v))
        ps.append(torch.as_tensor(v))
        if reset is not None and t == reset[0]:
            js = jb.circular_buffer_reset(js, jnp.asarray(reset[1]))
            ps.reset(torch.as_tensor(reset[1]))
        np.testing.assert_array_equal(np.asarray(jb.circular_buffer_window(js)),
                                      ps.window().numpy())
        for lag in (0, 1, 2, 10):
            np.testing.assert_array_equal(np.asarray(jb.circular_buffer_get(js, lag)),
                                          ps.get(lag).numpy())


# delay buffer: (init kwargs, batch, pushes, set_lags before a full reset)
DELAY = {
    "zero_lag_passthrough": (dict(max_lag=0), 2, 3, None),
    "fixed_lag": (dict(max_lag=2, min_lag=2), 1, 5, None),
    "stochastic": (dict(max_lag=3, min_lag=1), 64, 10, None),
    "set_lags": (dict(max_lag=5), 2, 3, (2, 4)),
    "update_period": (dict(max_lag=4, update_period=3, per_env_phase=False), 32, 12, None),
    "per_env_phase": (dict(max_lag=6, update_period=4, per_env_phase=True), 64, 8, None),
    "hold_prob_one": (dict(max_lag=5, hold_prob=1.0), 32, 10, None),
    "clamp_to_backfill": (dict(max_lag=4, min_lag=4), 8, 1, None),
}


@pytest.mark.parametrize("case", list(DELAY))
def test_delay_buffer_matches_jax(case):
    kw, B, pushes, lags = DELAY[case]
    rng = jax.random.PRNGKey(7)
    with JaxDraws() as draws:
        rng, k = jax.random.split(rng)
        js = jb.delay_buffer_init(batch=B, shape=(1,), rng=k, **kw)
        if lags is not None:
            js = jb.delay_buffer_set_lags(js, *lags)
            rng, k = jax.random.split(rng)
            js = jb.delay_buffer_reset(js, jnp.ones((B,), bool), k)
        jouts = []
        for t in range(pushes):
            rng, k = jax.random.split(rng)
            js, out = jb.delay_buffer_push(js, jnp.asarray(_frame(B, (1,), t)), k)
            jouts.append((np.asarray(out), np.asarray(js.lag)))
    r = ReplayRng(draws)
    ps = pb.DelayBuffer(batch=B, shape=(1,), rng=r, **kw)
    np.testing.assert_array_equal(ps.phase.numpy(), np.asarray(js.phase))
    if lags is not None:
        ps.set_lags(*lags)
        ps.reset(torch.ones(B, dtype=torch.bool), r)
    for t in range(pushes):
        out = ps.push(torch.as_tensor(_frame(B, (1,), t)), r)
        np.testing.assert_array_equal(out.numpy(), jouts[t][0])
        np.testing.assert_array_equal(ps.lag.numpy(), jouts[t][1])
    assert r.done()


NOISE = {
    "constant_add": jn.ConstantNoiseCfg(bias=0.5),
    "constant_scale": jn.ConstantNoiseCfg(bias=3.0, operation="scale"),
    "constant_abs": jn.ConstantNoiseCfg(bias=7.0, operation="abs"),
    "uniform_add": jn.UniformNoiseCfg(n_min=-0.25, n_max=0.75),
    "uniform_scale": jn.UniformNoiseCfg(n_min=0.9, n_max=1.1, operation="scale"),
    "gaussian_add": jn.GaussianNoiseCfg(mean=1.0, std=0.5),
    "gaussian_abs": jn.GaussianNoiseCfg(mean=-1.0, std=2.0, operation="abs"),
    "none": None,
}


def _port_noise(cfg):
    """The port's config of the same class and fields."""
    if cfg is None:
        return None
    return getattr(pn, type(cfg).__name__)(**vars(cfg))


@pytest.mark.parametrize("case", list(NOISE))
def test_noise_matches_jax(case):
    cfg = NOISE[case]
    x = np.random.default_rng(0).standard_normal((64, 3)).astype(np.float32)
    with JaxDraws() as draws:
        want = np.asarray(jn.apply_noise(cfg, jax.random.PRNGKey(1), jnp.asarray(x)))
    r = ReplayRng(draws)
    got = pn.apply_noise(_port_noise(cfg), r, torch.as_tensor(x))
    assert rel_err(want, tnp(got)) < 1e-6
    assert r.done()


@pytest.mark.parametrize("bias", [None, jn.UniformNoiseCfg(n_min=-1.0, n_max=1.0),
                                  jn.GaussianNoiseCfg(std=0.1)], ids=["none", "uniform",
                                                                      "gaussian"])
def test_additive_bias_matches_jax(bias):
    jcfg = jn.NoiseModelWithAdditiveBiasCfg(bias_noise_cfg=bias)
    pcfg = pn.NoiseModelWithAdditiveBiasCfg(bias_noise_cfg=_port_noise(bias))
    with JaxDraws() as draws:
        want = np.asarray(jn.sample_bias(jcfg, jax.random.PRNGKey(3), (8, 2), jnp.float32))
    r = ReplayRng(draws)
    got = pn.sample_bias(pcfg, r, (8, 2), torch.float32)
    assert rel_err(want, tnp(got)) < 1e-6
    assert r.done()
