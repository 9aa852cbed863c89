"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests need an NVIDIA card and nvcc, skip where
torch.cuda.is_available() is false, and run on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances (float32, TF32 matmuls off) are those of the CPU parity tests:
2e-6 on kin_com's frames, 5e-6 on crb_packed and vel_smooth, 2e-3 on the
solve's accelerations and 6e-3 on its per-row forces, relative to
max(1, |plain|max). chip_smoke.py runs the same comparisons at 4096 envs.

The models are the G1 flat-velocity model (pyramidal cone: kernel 4, and
kernel 6 under Simulation.forward()) and the YAM lift-cube model (elliptic
cone, a joint equality and a mocap base: kernel 5 and kin_com's mocap
inputs) the repo keeps as files, so these tests need neither MuJoCo nor
the JAX package.
"""

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.phys import smooth_kernels as sk
from mjlab_tpu_torch.phys.data import data_from_numpy, tensor_fields
from mjlab_tpu_torch.phys import solver_dense_kernels as sd
from mjlab_tpu_torch.phys import solver_kernels as sv
from mjlab_tpu_torch.phys.hybrid import (
    contact_stack, forward_stages, has_implicit, mocap_planes, solve_args,
    solve_dense_inputs,
)
from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.sim.sim import Simulation
from mjlab_tpu_torch.tasks.manipulation.config.yam import physics as yam
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


def _check_kernels(m, d, cuda, seed=1):
    """Each kernel against its plain version on the state d."""
    E = d.qpos.shape[0]
    qT, vT, ctrlT = (x.T.contiguous() for x in (d.qpos, d.qvel, d.ctrl))
    mcT, mcqT = mocap_planes(m, d)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=cuda)  # noqa: E731
    rng = np.random.default_rng(seed)
    xfrcT = t((0.1 * rng.standard_normal((m.nbody, 6, E))).astype(np.float32))
    qfaT = t((0.1 * rng.standard_normal((m.nv, E))).astype(np.float32))

    launches = sk.kin_com.launches
    kin_k = sk.kin_com(m, qT, mcT, mcqT)
    assert sk.kin_com.launches == launches + 1
    kin_p = sk.kin_com_plain(m, qT, mcT, mcqT)
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
    by_cone = list(sv.newton_assemble_solve.launches_by_cone)
    so_k = sv.newton_assemble_solve(*args, **kw, iters=it_k)
    by_cone[kw["cone"]] += 1
    assert sv.newton_assemble_solve.launches_by_cone == by_cone
    so_p = sv.newton_assemble_solve_plain(*args, **kw, iters=it_p)
    for i, (p, kk) in enumerate(zip(so_p, so_k)):
        if i != 3:
            tol = sv.FORCE_TOL if i in (1, 2) else sv.SOLVE_TOL
            assert rel_err(p, kk) < tol, i
    # qfrc_constraint under the iteration-count rule (the f32 acceptance
    # test can stop the two one Newton step apart)
    row_scale = sv.row_force_scale(so_p) if kw["cone"] else 0.0
    for label, (err, tol) in sv.qfrc_errors(so_p[3], so_k[3], it_p, it_k,
                                            row_scale).items():
        assert err < tol, label


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
    _check_kernels(m, sim.data, cuda)


def _yam_state(sim, seed=0):
    """Half the envs at the task's reset state, half pinching the cube
    (yam.task_states)."""
    _, st = yam.load_saved_model(device="cpu")
    b = yam.task_states(sim.model, st, sim.num_envs, seed)
    sim.reset()
    sim.data = sim.data.replace(**{
        k: torch.as_tensor(v, dtype=torch.float32, device=sim.device)
        for k, v in b.items()
    })


def test_yam_kernels_match_plain_versions(cuda):
    """Kernel 5 (the elliptic cone with a joint equality) and kin_com with
    the mocap base, on a YAM state settled for 10 steps."""
    m, _ = yam.load_saved_model(device=cuda)
    sim = Simulation(256, yam.sim_cfg(), m, device=cuda)
    _yam_state(sim)
    for _ in range(10):
        sim.step()
    assert int(m.opt.cone) == 1 and m.neq_jnt == 1 and m.nmocap == 1
    _check_kernels(m, sim.data, cuda)


def test_yam_simulation_on_card_matches_cpu(cuda):
    """A few YAM steps through the kernels against the plain versions."""
    m, _ = yam.load_saved_model(device="cpu")
    sims = [Simulation(64, yam.sim_cfg(), m, device=dev) for dev in (cuda, "cpu")]
    for s in sims:
        _yam_state(s, seed=1)
    for _ in range(3):
        for s in sims:
            s.step()
        sims[0].refresh()
    dc, dp = sims[0].data, sims[1].data
    # the elliptic multistep tolerances (tests/test_pallas2_solver.py):
    # the cone's contact dynamics amplify an f32 difference ~3x per step
    for f, tol in (("qpos", 2e-4), ("qvel", 2e-2), ("qacc", 5e-3)):
        assert rel_err(getattr(dp, f), getattr(dc, f)) < tol, f
    assert int(dc.ncheck_reset.sum()) == 0
    # the same active contact slots in every env (their order may differ
    # where mirrored fingertip slots tie to a few f32 ulps)
    for e in range(64):
        card = dc.con_sel[e][dc.con_sel_active[e]].sort().values.cpu()
        cpu = dp.con_sel[e][dp.con_sel_active[e]].sort().values
        assert torch.equal(card, cpu), e


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


def _settled_g1(E, device, seed=0):
    """A G1 Simulation of E envs on ``device`` at a seeded state, settled
    for 10 steps."""
    m, key_qpos, key_ctrl = physics.load_saved_model(device="cpu")
    sim = Simulation(E, physics.sim_cfg(), m, device=device)
    q, v, c = _state(key_qpos, key_ctrl, E, seed)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=sim.device)  # noqa: E731
    sim.data = sim.data.replace(qpos=t(q), qvel=t(v), ctrl=t(c))
    for _ in range(10):
        sim.step()
    return sim


@pytest.mark.parametrize("E", [256, 300])
def test_dense_kernel_matches_plain_version(E, cuda):
    """Kernel 6 (the dense-Jacobian solve of forward()) against its plain
    version on the dense inputs of a settled G1 state's forward pass."""
    sim = _settled_g1(E, cuda)
    d, k, _ = forward_stages(sim.model, sim.data)
    args, kw = solve_dense_inputs(sim.model, k, d)
    it_k = torch.zeros(E, dtype=torch.int32, device=cuda)
    it_p = torch.zeros(E, dtype=torch.int32, device=cuda)
    launches = sd.newton_solve_dense.launches
    x_k, f_k = sd.newton_solve_dense(*args, **kw, iters=it_k)
    assert sd.newton_solve_dense.launches == launches + 1
    x_p, f_p = sd.newton_solve_dense_plain(*args, **kw, iters=it_p)
    torch.cuda.synchronize()
    assert rel_err(x_p, x_k) < sv.SOLVE_TOL
    assert rel_err(f_p, f_k) < sv.FORCE_TOL
    Jt = args[0]
    q_k = torch.einsum("vre,re->ve", Jt, f_k)
    q_p = torch.einsum("vre,re->ve", Jt, f_p)
    for label, (err, tol) in sv.qfrc_errors(q_p, q_k, it_p, it_k).items():
        assert err < tol, label
    first_contact_row = sim.model.nv + sim.model.nlimit
    assert int(it_p.max()) > 1 and bool((f_p[first_contact_row:] != 0).any())


def test_forward_on_card_matches_cpu(cuda):
    """forward() through kernel 6 on the card against forward() on the CPU
    (the plain versions) from the same 64 settled G1 envs."""
    card = _settled_g1(64, cuda, seed=2)
    cpu = Simulation(64, physics.sim_cfg(), physics.load_saved_model(device="cpu")[0],
                     device="cpu")
    cpu.data = data_from_numpy({
        n: (card.data.contact.packed if n == "contact" else getattr(card.data, n))
        .cpu().numpy() for n in tensor_fields()
    }, device="cpu")
    n6, n4 = sd.newton_solve_dense.launches, sv.newton_assemble_solve.launches
    card.forward()
    cpu.forward()
    assert sd.newton_solve_dense.launches == n6 + 1
    assert sv.newton_assemble_solve.launches == n4
    dc, dp = card.data, cpu.data
    for f, tol in (("qacc", sv.SOLVE_TOL), ("qacc_smooth", 1e-4),
                   ("qfrc_constraint", sv.FORCE_TOL), ("efc_force", sv.FORCE_TOL),
                   ("qM", 1e-5), ("qLD", 1e-5), ("efc_D", 1e-4), ("efc_aref", 1e-4),
                   ("efc_Jc", 1e-4), ("geom_xpos", 1e-5), ("site_xpos", 1e-5),
                   ("xanchor", 1e-5)):
        assert rel_err(getattr(dp, f), getattr(dc, f)) < tol, f
    assert rel_err(dp.contact.packed, dc.contact.packed) < 1e-4
    assert torch.equal(dp.efc_active, dc.efc_active.cpu())
    for e in range(64):
        on_card = dc.con_sel[e][dc.con_sel_active[e]].sort().values.cpu()
        on_cpu = dp.con_sel[e][dp.con_sel_active[e]].sort().values
        assert torch.equal(on_card, on_cpu), e


def test_wrappers_reject_bad_inputs(cuda):
    m, _, _ = physics.load_saved_model(device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sk.kin_com(m, torch.zeros(m.nq, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        sk.kin_com(m, torch.zeros(m.nq + 1, 8, device=cuda))
    # equality rows under the pyramidal cone run in the plain version only
    z = torch.zeros(1, 8, device=cuda)
    kw = dict(nv=1, K=1, R=4, ndirs=2, neq=1, nlim=1, lim_dofs=(0,),
              iterations=1, ls_iterations=8, tolerance=1e-8, do_int=False)
    with pytest.raises(NotImplementedError, match="equality"):
        sv.newton_assemble_solve(*(z,) * 23, **kw)
