"""The port's NaN guard (mjlab_tpu_torch/utils/nan_guard.py and the env's
hook) against the JAX package's (mjlab_tpu/utils/nan_guard.py), on the CPU.

detect_nans on each field; the rolling window (qpos, qvel, ctrl) against
the JAX guard's over a short G1 trajectory (the port's flat-velocity env,
3 envs, buffer_size 4, so the ring wraps); a NaN written into one env at
control step NAN_STEP: the port's npz holds the JAX dump's arrays
(bad_envs exactly, the windows exactly: the same float32 data in both) and
is written once, though the NaN stays; and the env's in-step recording
(the form a CUDA graph captures) against the guard's record called step by
step outside. The windows are held exactly: both packages copy the same
float32 values into ring buffers.
"""

import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from torch_port_common import G1_TASK

E, BUFFER, STEPS, NAN_STEP, NAN_ENV = 3, 4, 7, 4, 1
FIELDS = ("qpos", "qvel", "qacc", "qacc_warmstart")


def _data(rs, nq=5, nv=4, nu=2):
    return types.SimpleNamespace(
        qpos=rs.standard_normal((E, nq)).astype(np.float32),
        qvel=rs.standard_normal((E, nv)).astype(np.float32),
        qacc=rs.standard_normal((E, nv)).astype(np.float32),
        qacc_warmstart=rs.standard_normal((E, nv)).astype(np.float32),
        ctrl=rs.standard_normal((E, nu)).astype(np.float32))


def _as(d, f):
    return types.SimpleNamespace(**{k: f(v) for k, v in vars(d).items()})


@pytest.mark.parametrize("field", FIELDS + ("none",))
def test_detect_nans_per_field(field):
    """A NaN (or an inf) in one env's field flags that env alone, as the
    JAX function does."""
    from mjlab_tpu.utils.nan_guard import detect_nans as jd
    from mjlab_tpu_torch.utils.nan_guard import detect_nans as pd

    d = _data(np.random.default_rng(0))
    if field != "none":
        getattr(d, field)[NAN_ENV, 1] = np.nan
        getattr(d, field)[0, 0] = np.inf
    want = np.asarray(jd(_as(d, jnp.asarray)))
    got = pd(_as(d, torch.as_tensor)).numpy()
    np.testing.assert_array_equal(want, got)
    assert got.tolist() == ([False] * E if field == "none" else [True, True, False])


@pytest.fixture(scope="module")
def trajectory():
    """STEPS control steps of the port's G1 flat env (3 envs, seeded
    actions), the Data fields the guard reads after each; NaN in env
    NAN_ENV's qvel from step NAN_STEP on (in every later step too: the
    guard must write once)."""
    os.environ.setdefault("MJLAB_QUIET", "1")
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg
    from mjlab_tpu_torch.utils.nan_guard import NanGuardCfg

    cfg = load_env_cfg(G1_TASK)
    cfg.scene.num_envs = E
    cfg.sim.nan_guard = NanGuardCfg(enabled=True, buffer_size=BUFFER)
    env = ManagerBasedRlEnv(cfg, device="cpu", capture=False)
    env.reset()
    rs = np.random.default_rng(1)
    frames, env_windows = [], []
    for t in range(STEPS):
        env.step(torch.as_tensor(0.3 * rs.standard_normal((E, 29)), dtype=torch.float32))
        d = env.sim.data
        frame = {k: getattr(d, k).numpy().astype(np.float32).copy()
                 for k in FIELDS + ("ctrl",)}
        if t >= NAN_STEP:
            frame["qvel"][NAN_ENV] = np.nan
        frames.append(frame)
        env_windows.append(env.nan_guard.windows())
    return env, frames, env_windows


def _run_guards(frames, jdir, pdir, mj_model):
    """Both guards over frames: (JAX windows per step, port windows per
    step)."""
    from mjlab_tpu.utils.buffers import circular_buffer_window
    from mjlab_tpu.utils.nan_guard import NanGuard as JGuard, NanGuardCfg as JCfg
    from mjlab_tpu_torch.utils.nan_guard import NanGuard as PGuard, NanGuardCfg as PCfg

    f0 = frames[0]
    nq, nv, nu = f0["qpos"].shape[1], f0["qvel"].shape[1], f0["ctrl"].shape[1]
    jg = JGuard(JCfg(enabled=True, buffer_size=BUFFER, output_dir=jdir), mj_model)
    js = jg.make_state(E, nq, nv, nu)
    pg = PGuard(PCfg(enabled=True, buffer_size=BUFFER, output_dir=pdir), E, nq, nv, nu, "cpu")
    jw, pw = [], []
    for f in frames:
        jdata = types.SimpleNamespace(**{k: jnp.asarray(v) for k, v in f.items()})
        js = jg.record(js, jdata)
        jg.check_and_dump(js, jdata)
        jw.append({k: np.asarray(circular_buffer_window(js[k])) for k in ("qpos", "qvel", "ctrl")})
        pg.record(types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in f.items()}))
        pw.append(pg.windows())
    jax.effects_barrier()
    return jg, jw, pg, pw


def test_window_matches_jax_over_a_g1_trajectory(trajectory, tmp_path):
    """Before any NaN the port's window is the JAX guard's, step by step
    (the ring wrapped: STEPS > buffer_size)."""
    from torch_port_common import g1_mj

    _, frames, _ = trajectory
    _, jw, _, pw = _run_guards(frames[:NAN_STEP], str(tmp_path / "j"), str(tmp_path / "p"),
                               g1_mj())
    for a, b in zip(jw, pw):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def test_nan_dump_matches_jax(trajectory, tmp_path):
    """A NaN in env NAN_ENV at step NAN_STEP: the JAX guard dumps at once
    (host callback), the port when asked; the npz arrays equal (bad_envs
    [NAN_ENV]; the windows of the detection step, though the port is asked
    only after STEPS steps: its recording stopped there); one dump each
    though the NaN stays; latest.npz names it; the port's Model file
    beside it."""
    from torch_port_common import g1_mj

    _, frames, _ = trajectory
    jdir, pdir = str(tmp_path / "j"), str(tmp_path / "p")
    _, jw, pg, pw = _run_guards(frames, jdir, pdir, g1_mj())
    pg.model = None
    assert pg.dump_if_detected() is not None
    assert pg.dump_if_detected() is None
    jn = [f for f in os.listdir(jdir) if f.startswith("nan_dump") and f.endswith(".npz")]
    pn = [f for f in os.listdir(pdir) if f.startswith("nan_dump") and f.endswith(".npz")]
    assert len(jn) == 1 and len(pn) == 1
    with np.load(os.path.join(jdir, jn[0])) as a, np.load(os.path.join(pdir, pn[0])) as b:
        assert set(a.files) == set(b.files) == {"bad_envs", "qpos", "qvel", "ctrl"}
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert b["bad_envs"].tolist() == [NAN_ENV]
        for k in ("qpos", "qvel", "ctrl"):
            np.testing.assert_array_equal(b[k], jw[NAN_STEP][k])  # the detection step's
            np.testing.assert_array_equal(pw[-1][k], jw[NAN_STEP][k])
    assert os.readlink(os.path.join(pdir, "latest.npz")) == pn[0]


def test_env_step_records_what_record_does(trajectory):
    """The env's in-step recording (inside the step a CUDA graph captures)
    equals the guard's record called after each step on the same Data,
    window for window; the env's own data stayed finite, so its guard has
    no detection and writes nothing."""
    from mjlab_tpu_torch.utils.nan_guard import NanGuard, NanGuardCfg

    env, frames, env_windows = trajectory
    d0 = frames[0]
    g = NanGuard(NanGuardCfg(enabled=True, buffer_size=BUFFER), E, d0["qpos"].shape[1],
                 d0["qvel"].shape[1], d0["ctrl"].shape[1], "cpu")
    for t, f in enumerate(frames[:NAN_STEP]):
        g.record(types.SimpleNamespace(**{k: torch.as_tensor(v) for k, v in f.items()}))
        w = g.windows()
        for k in w:
            np.testing.assert_array_equal(w[k], env_windows[t][k], err_msg=f"{k} step {t}")
    # the env's own data never went bad (the NaN was written into the
    # frames only): its guard keeps recording and has no detection
    assert not bool(env.nan_guard.stopped) and not env.nan_guard.bad_envs.any()
    assert env.nan_guard.dump_if_detected() is None
