"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests need an NVIDIA card and nvcc, skip where
torch.cuda.is_available() is false, and run on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances (float32, TF32 matmuls off) are those of the CPU parity tests:
2e-6 on kin_com's frames, 5e-6 on crb_packed and vel_smooth, 2e-3 on the
solve's accelerations and 6e-3 on its per-row forces, relative to
max(1, |plain|max). chip_smoke.py runs the same comparisons at 4096 envs.

The model is the G1 flat-velocity model the repo keeps as a file, so these
tests need neither MuJoCo nor the JAX package.
"""

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.phys import smooth_kernels as sk
from mjlab_tpu_torch.phys import solver_kernels as sv
from mjlab_tpu_torch.phys.hybrid import contact_stack, has_implicit, solve_args
from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.sim.sim import Simulation
from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

pytestmark = pytest.mark.cuda


def rel_err(ref, got) -> float:
    ref, got = ref.double().cpu(), got.double().cpu()
    return float((ref - got).abs().max()) / max(1.0, float(ref.abs().max()))


def _state(key_qpos, key_ctrl, E, seed=0):
    rng = np.random.default_rng(seed)
    q = np.tile(key_qpos, (E, 1))
    q[:, 7:] += 0.05 * rng.standard_normal((E, q.shape[1] - 7))
    q[:, 2] -= 0.05
    v = 0.3 * rng.standard_normal((E, 35))
    c = np.tile(key_ctrl, (E, 1)) + 0.2 * rng.standard_normal((E, key_ctrl.size))
    f32 = lambda x: x.astype(np.float32)  # noqa: E731
    return f32(q), f32(v), f32(c)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (torch.cuda.is_available() is false)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


@pytest.mark.parametrize("E", [256, 300])
def test_kernels_match_plain_versions(E, cuda):
    """On a state settled for 10 steps (a random state interpenetrates hard
    and its f32 solve is far more ill-conditioned than the task's)."""
    m, key_qpos, key_ctrl = physics.load_saved_model(device=cuda)
    sim = Simulation(E, physics.sim_cfg(), m, device=cuda)
    q, v, c = _state(key_qpos, key_ctrl, E)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=cuda)  # noqa: E731
    sim.data = sim.data.replace(qpos=t(q), qvel=t(v), ctrl=t(c))
    for _ in range(10):
        sim.step()
    d = sim.data
    qT, vT, ctrlT = (x.T.contiguous() for x in (d.qpos, d.qvel, d.ctrl))
    rng = np.random.default_rng(1)
    xfrcT = t((0.1 * rng.standard_normal((m.nbody, 6, E))).astype(np.float32))
    qfaT = t((0.1 * rng.standard_normal((m.nv, E))).astype(np.float32))

    launches = sk.kin_com.launches
    kin_k = sk.kin_com(m, qT)
    assert sk.kin_com.launches == launches + 1
    kin_p = sk.kin_com_plain(m, qT)
    for p, k in zip(kin_p, kin_k):
        assert rel_err(p, k) < 2e-6
    _, _, subcom, cdof, cinA, cinc, xipos, _, _ = kin_p

    qm_k = sk.crb_packed(m, cdof, cinA, cinc)
    qm_p = sk.crb_packed_plain(m, cdof, cinA, cinc)
    assert rel_err(qm_p, qm_k) < 5e-6

    xq = (subcom, xipos, xfrcT, qfaT)
    vs_k = sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    vs_p = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    for p, k in zip(vs_p, vs_k):
        assert rel_err(p, k) < 5e-6

    nv = m.nv
    k = contact_stack(m, Params(m, E), qT, vT, kin_p[0], kin_p[1], subcom)
    assert bool(k["con_sel_active"].any())
    qM_cm = sk.qm_dense_cm(m, qm_p)
    Mh_cm = qM_cm.clone()
    assert has_implicit(m)
    Mh_cm[torch.arange(nv, device=cuda) * (nv + 1)] += vs_p[3]
    args, kw = solve_args(m, k, qM_cm, vs_p[0], d.qacc_warmstart.T, vT,
                          cdof.reshape(nv * 6, E), Mh_cm)
    it_k = torch.zeros(E, dtype=torch.int32, device=cuda)
    it_p = torch.zeros(E, dtype=torch.int32, device=cuda)
    so_k = sv.newton_assemble_solve(*args, **kw, iters=it_k)
    so_p = sv.newton_assemble_solve_plain(*args, **kw, iters=it_p)
    for i, (p, kk) in enumerate(zip(so_p, so_k)):
        if i != 3:
            tol = 6e-3 if i in (1, 2) else 2e-3
            assert rel_err(p, kk) < tol, i
    # qfrc_constraint: the solve tolerance where both took the same number
    # of Newton iterations; where the f32 acceptance test stopped them one
    # step apart, the per-row force tolerance (qfrc = J^T f)
    same = (it_k == it_p).cpu()
    ref, got = so_p[3].double().cpu(), so_k[3].double().cpu()
    scale = max(1.0, float(ref.abs().max()))
    assert float((ref - got)[:, same].abs().max()) / scale < 2e-3
    assert float((ref - got).abs().max()) / scale < 6e-3


def test_simulation_on_card_matches_cpu(cuda):
    """A few G1 steps through the kernels against the plain versions."""
    m, key_qpos, key_ctrl = physics.load_saved_model(device="cpu")
    sims = [Simulation(64, physics.sim_cfg(), m, device=dev)
            for dev in (cuda, "cpu")]
    q, v, c = _state(key_qpos, key_ctrl, 64)
    q[:, 2] += 0.05
    for s in sims:
        s.data = s.data.replace(
            qpos=torch.as_tensor(q, device=s.device),
            qvel=torch.as_tensor(v, device=s.device),
            ctrl=torch.as_tensor(c, device=s.device),
        )
    for _ in range(3):
        for s in sims:
            s.step()
        sims[0].refresh()
    dc, dp = sims[0].data, sims[1].data
    for f, tol in (("qpos", 1e-4), ("qvel", 1e-3), ("qacc", 5e-3)):
        assert rel_err(getattr(dp, f), getattr(dc, f)) < tol, f
    assert int(dc.ncheck_reset.sum()) == 0


def test_wrappers_reject_bad_inputs(cuda):
    m, _, _ = physics.load_saved_model(device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sk.kin_com(m, torch.zeros(m.nq, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        sk.kin_com(m, torch.zeros(m.nq + 1, 8, device=cuda))
