"""The port's CUDA kernels against their plain PyTorch versions, on the card.

Marked ``cuda``: these tests need an NVIDIA card and nvcc, skip where
torch.cuda.is_available() is false, and run on the card with

    python -m pytest tests/test_torch_cuda.py -q -m cuda

Tolerances (float32, TF32 matmuls off) are those of the CPU parity tests:
2e-6 on kin_com's frames, 5e-6 on the crb kernel's qM and Mh and on
vel_smooth, 2e-3 on the solve's accelerations and 6e-3 on its per-row
forces, relative to max(1, |plain|max). chip_smoke.py runs the same
comparisons at 4096 envs.

The models are the G1 flat-velocity model (pyramidal cone: kernel 4, and
kernel 6 under Simulation.forward(); and its env-side control step,
captured as one CUDA graph), the YAM lift-cube model (elliptic
cone, a joint equality and a mocap base: kernel 5 and kin_com's mocap
inputs) and four toys (tests/torch_toy_models.py: a joint equality under
the pyramidal cone, each cone without joint limits, and joint_toy, with
every joint type, springs and a multi-geom body, for the smooth kernels)
the repo keeps as files, so these tests need neither MuJoCo nor the JAX
package. E = 300 is not a multiple of the smooth kernels' 16 envs per block
(csrc/smooth_tree.cuh), so their ragged edge runs too.
"""

import ctypes
import dataclasses
from pathlib import Path

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
from mjlab_tpu_torch.phys import model as pm
from mjlab_tpu_torch.phys.lm import stages
from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.sim.sim import ControlStep, MujocoCfg, Simulation, SimulationCfg
from mjlab_tpu_torch.tasks.manipulation.config.yam import physics as yam
from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

pytestmark = pytest.mark.cuda


def rel_err(ref, got, length=1.0) -> float:
    """max |ref - got| over max(1, |ref|max, length); ``length`` is a
    state's coordinate scale (chip_smoke.coordinate_scale: float32 keeps
    about 6e-8 of a coordinate, and differences of coordinates keep that
    absolute error)."""
    ref, got = ref.double().cpu(), got.double().cpu()
    return float((ref - got).abs().max()) / max(1.0, length, float(ref.abs().max()))


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


def _check_kernels(m, d, cuda, seed=1, dead_envs=(), stable_only=False, length=1.0):
    """Each kernel against its plain version on the state d; the solve
    also with every contact row of ``dead_envs`` off (no live row). With
    ``stable_only`` the solve is held only in the envs whose plain solve
    (qacc, and the row forces at FORCE_TOL) moves less than a third of its
    tolerance when qvel, qfrc_smooth or the warmstart changes by a few
    ulps (2e-7 and 1e-6 relative, both signs; where it moves more, the f32
    line search has not converged and its result turns on rounding, and
    the kernel's sums round differently from any one nudge), at most 5 %
    of the envs, and qacc and qacc_int take the iteration-count rule of
    qfrc_constraint."""
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
        assert rel_err(p, k, length) < 2e-6
    _, _, subcom, cdof, cinA, cinc, xipos, _, _ = kin_p

    xq = (subcom, xipos, xfrcT, qfaT)
    vs_k = sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    vs_p = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    for p, k in zip(vs_p, vs_k):
        assert rel_err(p, k, length) < 5e-6

    assert has_implicit(m)
    crb_k = sk.crb_dense(m, cdof, cinA, cinc, vs_p[3])
    qM_cm, Mh_cm = sk.crb_dense_plain(m, cdof, cinA, cinc, vs_p[3])
    assert rel_err(qM_cm, crb_k[0], length) < 5e-6 and rel_err(Mh_cm, crb_k[1], length) < 5e-6

    nv = m.nv
    k = contact_stack(m, Params(m, E), qT, vT, kin_p[0], kin_p[1], subcom)
    assert bool(k["con_sel_active"].any())
    args, kw = solve_args(m, k, qM_cm, vs_p[0], d.qacc_warmstart.T, vT,
                          cdof.reshape(nv * 6, E), Mh_cm)
    on = args[20].clone()
    on[:, list(dead_envs)] = 0.0
    args = args[:20] + (on,) + args[21:]
    it_k = torch.zeros(E, dtype=torch.int32, device=cuda)
    it_p = torch.zeros(E, dtype=torch.int32, device=cuda)
    by_cone = list(sv.newton_assemble_solve.launches_by_cone)
    so_k = sv.newton_assemble_solve(*args, **kw, iters=it_k)
    by_cone[kw["cone"]] += 1
    assert sv.newton_assemble_solve.launches_by_cone == by_cone
    so_p = sv.newton_assemble_solve_plain(*args, **kw, iters=it_p)
    if stable_only:
        keep = torch.ones(E, dtype=torch.bool, device=cuda)
        for index in (1, 2, 3):  # qfrc_smooth, the warmstart, qvel
            for nudge in (1 + 2e-7, 1 - 2e-7, 1 + 1e-6, 1 - 1e-6):
                nudged = args[:index] + (args[index] * nudge,) + args[index + 1:]
                so_n = sv.newton_assemble_solve_plain(*nudged, **kw)
                for i, tol in ((0, sv.SOLVE_TOL), (1, sv.FORCE_TOL), (2, sv.FORCE_TOL)):
                    scale = max(1.0, float(so_p[i].abs().max()))
                    keep &= (so_p[i] - so_n[i]).abs().amax(0) / scale < tol / 3
        assert float(keep.double().mean()) >= 0.95
        so_p, so_k = ([o[:, keep] for o in outs] for outs in (so_p, so_k))
        it_p, it_k = it_p[keep], it_k[keep]
    for i, (p, kk) in enumerate(zip(so_p, so_k)):
        if stable_only and i in (0, 5):
            # qacc and qacc_int under the iteration-count rule too: the
            # elliptic toy's last Newton steps are large, so two solves that
            # stop one step apart differ in qacc by that step
            for label, (err, tol) in sv.qfrc_errors(p, kk, it_p, it_k).items():
                assert err < tol, (i, label)
        elif i != 3:
            tol = sv.FORCE_TOL if i in (1, 2) else sv.SOLVE_TOL
            assert rel_err(p, kk, length) < tol, i
    # qfrc_constraint under the iteration-count rule (the f32 acceptance
    # test can stop the two one Newton step apart)
    row_scale = sv.row_force_scale(so_p) if kw["cone"] else 0.0
    for label, (err, tol) in sv.qfrc_errors(so_p[3], so_k[3], it_p, it_k,
                                            row_scale).items():
        assert err < tol, label
    for e in dead_envs:
        assert not bool(so_k[2][:, e].any())
    return it_k, kw


@pytest.mark.parametrize("E", [256, 300])
def test_kernels_match_plain_versions(E, cuda):
    """On a state settled for 10 steps (a random state interpenetrates hard
    and its f32 solve is far more ill-conditioned than the task's); env 5
    with no live contact row, and envs that run to the 10-iteration cap."""
    m, key_qpos, key_ctrl = physics.load_saved_model(device=cuda)
    sim = Simulation(E, physics.sim_cfg(), m, device=cuda)
    q, v, c = _state(key_qpos, key_ctrl, E)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=cuda)  # noqa: E731
    sim.data = sim.data.replace(qpos=t(q), qvel=t(v), ctrl=t(c))
    for _ in range(10):
        sim.step()
    it_k, kw = _check_kernels(m, sim.data, cuda, dead_envs=(5,))
    assert int(it_k.max()) == kw["iterations"]


def _per_env_fields(m, rng, names=tuple(sorted(pm.PER_ENV_SMOOTH_FIELDS)), E=None):
    """m with ``names`` per env (E, ...), drawn as a randomisation event
    would: offsets of centimetres, scales of +-20-50 %, springs on every
    joint, qpos0 moved; the actuators' three parameters scaled, their force
    ranges cut to 5-100 %."""
    upd = {}
    for n in names:
        v = getattr(m, n)
        shape = (E,) + tuple(v.shape)
        u = lambda lo, hi: torch.empty(shape, device=v.device).uniform_(  # noqa: E731
            lo, hi, generator=rng)
        g = lambda s: s * torch.randn(shape, device=v.device, generator=rng)  # noqa: E731
        x = v.expand(shape).clone()
        if n in ("body_ipos", "geom_pos"):
            x += g(0.02)
        elif n in ("body_mass", "body_inertia"):
            x *= u(0.8, 1.2)
        elif n == "dof_damping":
            x = x * u(0.5, 1.5) + u(0.0, 0.1)
        elif n == "dof_armature":
            x += u(0.0, 0.05)
        elif n == "jnt_stiffness":
            x += u(0.0, 5.0)
        elif n == "qpos0":
            x += g(0.05)
        elif n == "actuator_forcerange":
            x *= u(0.05, 1.0)[..., :1]  # ranges cut, so that some forces saturate
        else:
            x[..., :3] *= u(0.8, 1.2)[..., :3]
        upd[n] = x.contiguous()
    return dataclasses.replace(m, **upd)


@pytest.mark.parametrize("E", [256, 300])
def test_kernels_with_per_env_fields_match_plain_versions(E, cuda):
    """Kernels 1-3 (and the solve on their outputs) with every field of
    PER_ENV_SMOOTH_FIELDS per env against their plain versions, which read
    the same values through Params.plane: the G1 settled for 10 steps with
    those fields (the tracking task batches the torso's body_ipos), then
    joint_toy (springs on every joint type, a position actuator and a
    force-limited motor: qpos0, jnt_stiffness, gain and bias per env)."""
    m, key_qpos, key_ctrl = physics.load_saved_model(device=cuda)
    rng = torch.Generator(device=cuda).manual_seed(E)
    m = _per_env_fields(m, rng, E=E)
    assert pm.per_env_smooth(m) == tuple(sorted(pm.PER_ENV_SMOOTH_FIELDS))
    sim = Simulation(E, physics.sim_cfg(), m, device=cuda)
    q, v, c = _state(key_qpos, key_ctrl, E)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x), device=cuda)  # noqa: E731
    sim.data = sim.data.replace(qpos=t(q), qvel=t(v), ctrl=t(c))
    for _ in range(10):
        sim.step()
    assert int(sim.data.ncheck_reset.sum()) == 0
    _check_kernels(sim.model, sim.data, cuda, stable_only=True)

    toy, _ = pm.load_model(Path(__file__).parent / "models" / "joint_toy.npz", device=cuda)
    toy = _per_env_fields(toy, rng, E=E)
    gen = np.random.default_rng(E)
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,  # noqa: E731
                                  device=cuda)
    qT = f(toy.qpos0.cpu().numpy().T + 0.3 * gen.standard_normal((toy.nq, E)))
    vT = f(gen.standard_normal((toy.nv, E)))
    ctrlT = f(2 * gen.standard_normal((toy.nu, E)))
    xq_in = (f(0.1 * gen.standard_normal((toy.nbody, 6, E))), f(0.1 * gen.standard_normal((toy.nv, E))))
    kin_k = sk.kin_com(toy, qT)
    kin_p = sk.kin_com_plain(toy, qT)
    for p, k in zip(kin_p, kin_k):
        assert rel_err(p, k) < 2e-6
    _, _, subcom, cdof, cinA, cinc, xipos, _, _ = kin_p
    xq = (subcom, xipos) + xq_in
    vs_k = sk.vel_smooth(toy, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    vs_p = sk.vel_smooth_plain(toy, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    for p, k in zip(vs_p, vs_k):
        assert rel_err(p, k) < 5e-6
    crb_k = sk.crb_dense(toy, cdof, cinA, cinc, vs_p[3])
    crb_p = sk.crb_dense_plain(toy, cdof, cinA, cinc, vs_p[3])
    for p, k in zip(crb_p, crb_k):
        assert rel_err(p, k) < 5e-6
    # the envs differ: each read its own values
    assert not torch.equal(kin_k[6][:, :, 0], kin_k[6][:, :, 1])


# the toys' own options (their XML): dt 0.002, 8 Newton and 12 line-search
# iterations; the elliptic toy's impratio 10
_TOYS = {
    "eq_toy": MujocoCfg(iterations=8, ls_iterations=12),
    "nolimit_toy": MujocoCfg(iterations=8, ls_iterations=12),
    "nolimit_ell_toy": MujocoCfg(cone="elliptic", impratio=10.0, iterations=8,
                                 ls_iterations=12),
}


def _toy_sim(name, E, device, seed=0, settle=10):
    """A Simulation of the toy from its file (tests/models/), at a seeded
    state lowered into the ground and settled for ``settle`` steps."""
    m, _ = pm.load_model(Path(__file__).parent / "models" / f"{name}.npz", device="cpu")
    sim = Simulation(E, SimulationCfg(nconmax=12, mujoco=_TOYS[name]), m, device=device)
    rng = np.random.default_rng(seed)
    q = np.tile(m.qpos0.numpy(), (E, 1)) + 0.03 * rng.standard_normal((E, m.nq))
    q[:, 3:7] /= np.linalg.norm(q[:, 3:7], axis=1, keepdims=True)  # the free joint
    q[:, 2] -= np.linspace(0.03, 0.06, E)
    v = 0.3 * rng.standard_normal((E, m.nv))
    c = 0.2 * rng.standard_normal((E, m.nu))
    t = lambda x: torch.as_tensor(x, dtype=torch.float32, device=sim.device)  # noqa: E731
    sim.data = sim.data.replace(qpos=t(q), qvel=t(v), ctrl=t(c))
    for _ in range(settle):
        sim.step()
    return sim


@pytest.mark.parametrize("name", list(_TOYS))
def test_toy_kernels_match_plain_versions(name, cuda):
    """A joint equality under the pyramidal cone (kernel 4), and each cone
    (kernels 4 and 5) on a model without joint limits."""
    elliptic = name == "nolimit_ell_toy"
    # the elliptic toy (condim 6, impratio 10) settles for longer: after 10
    # steps some envs' plain solve moves by 0.1-0.2 under a few-ulp change
    # of its inputs
    sim = _toy_sim(name, 256, cuda, settle=30 if elliptic else 10)
    m = sim.model
    if name == "eq_toy":
        assert m.neq_jnt == 1 and int(m.opt.cone) == 0
    else:
        assert m.nlimit == 0
    _check_kernels(m, sim.data, cuda, stable_only=elliptic)
    assert bool(torch.isfinite(sim.data.qpos).all())


@pytest.mark.parametrize("E", [256, 300])
def test_smooth_kernels_on_every_joint_type(E, cuda):
    """kin_com and vel_smooth against their plain versions on joint_toy:
    free, ball, hinge and slide joints (a hinge and a slide on one body),
    a spring on each, a multi-geom body, a position actuator and a
    force-limited motor, implicitfast; at a seeded random state."""
    m, _ = pm.load_model(Path(__file__).parent / "models" / "joint_toy.npz", device=cuda)
    assert sorted(int(t) for t in m.jnt_type) == [0, 1, 2, 3]
    assert bool((m.jnt_stiffness > 0).all()) and m.nu == 2
    rng = np.random.default_rng(E)
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,  # noqa: E731
                                  device=cuda)
    qT = f(m.qpos0.cpu().numpy()[:, None] + 0.3 * rng.standard_normal((m.nq, E)))
    vT = f(rng.standard_normal((m.nv, E)))
    ctrlT = f(2 * rng.standard_normal((m.nu, E)))  # past the ranges and limits
    xfrcT = f(0.1 * rng.standard_normal((m.nbody, 6, E)))
    qfaT = f(0.1 * rng.standard_normal((m.nv, E)))
    launches = (sk.kin_com.launches, sk.vel_smooth.launches)
    kin_k = sk.kin_com(m, qT)
    kin_p = sk.kin_com_plain(m, qT)
    for p, k in zip(kin_p, kin_k):
        assert rel_err(p, k) < 2e-6
    _, _, subcom, cdof, cinA, cinc, xipos, _, _ = kin_p
    xq = (subcom, xipos, xfrcT, qfaT)
    vs_k = sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    vs_p = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    for p, k in zip(vs_p, vs_k):
        assert rel_err(p, k) < 5e-6
    assert (sk.kin_com.launches, sk.vel_smooth.launches) == (launches[0] + 1, launches[1] + 1)
    # the force limit and the implicitfast dF/dv both took effect
    assert bool((vs_p[1][1].abs() == 0.5).any())
    hinge = int(m.jnt_dofadr[list(m.jnt_type).index(3)])
    h_damping = float(m.opt.timestep) * float(m.dof_damping[hinge])
    assert bool((vs_p[3][hinge] != h_damping).all())


_CRB_MODELS = ("g1", "yam", *_TOYS, "joint_toy")


def _crb_model(name, device):
    if name == "g1":
        return physics.load_saved_model(device=device)[0]
    if name == "yam":
        return yam.load_saved_model(device=device)[0]
    return pm.load_model(Path(__file__).parent / "models" / f"{name}.npz", device=device)[0]


@pytest.mark.parametrize("E", [256, 300])
@pytest.mark.parametrize("name", _CRB_MODELS)
def test_crb_kernel_matches_plain_version(name, E, cuda):
    """The crb kernel (the dense qM and qM + the implicit diagonal in one
    launch) against its plain version, the eager code it replaces, on each
    model at a seeded state; with and without the implicit diagonal. Its
    shared memory is the one smooth_kernels.crb_smem_bytes mirrors."""
    from mjlab_tpu_torch import cuda_build

    m = _crb_model(name, cuda)
    rng = np.random.default_rng(E)
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,  # noqa: E731
                                  device=cuda)
    qT = f(m.qpos0.cpu().numpy()[:, None] + 0.3 * rng.standard_normal((m.nq, E)))
    mocap = [b for b in range(m.nbody) if int(m.body_mocapid[b]) >= 0]
    mcT = f(np.repeat(m.body_pos.cpu().numpy()[mocap][:, :, None], E, axis=2))
    mcqT = f(np.repeat(m.body_quat.cpu().numpy()[mocap][:, :, None], E, axis=2))
    _, _, _, cdof, cinA, cinc, _, _, _ = sk.kin_com_plain(m, qT, mcT, mcqT)
    mh = f(0.1 * rng.standard_normal((m.nv, E)))
    _, _, U = stages.crb_static(m)
    pairs = (U + U.T + np.eye(m.nv)) != 0
    off_pairs = torch.as_tensor(~pairs.reshape(-1), device=cuda)
    launches = sk.crb_dense.launches
    for diag in (mh, None):
        qM_k, Mh_k = sk.crb_dense(m, cdof, cinA, cinc, diag)
        qM_p, Mh_p = sk.crb_dense_plain(m, cdof, cinA, cinc, diag)
        torch.cuda.synchronize()
        assert rel_err(qM_p, qM_k) < 5e-6
        assert (Mh_k is None) == (diag is None)
        if diag is not None:
            assert rel_err(Mh_p, Mh_k) < 5e-6
        assert not bool(qM_k[off_pairs].any())  # the kernel writes the zeros itself
    assert sk.crb_dense.launches == launches + 2
    f_smem = cuda_build.launcher("crb_packed", "crb_packed_smem_bytes", (ctypes.c_int,) * 2)
    assert f_smem(m.nbody, m.nv) == sk.crb_smem_bytes(m)


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


def _check_dense(args, kw, cuda):
    """Kernel 6 against its plain version on (args, kw): qacc at
    SOLVE_TOL, the row forces at FORCE_TOL, qfrc_constraint under the
    iteration-count rule; returns (the plain forces, the plain iteration
    counts)."""
    E = args[0].shape[-1]
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
    return f_p, it_p


@pytest.mark.parametrize("E", [256, 300])
def test_dense_kernel_matches_plain_version(E, cuda):
    """Kernel 6 (the dense-Jacobian solve of forward()) against its plain
    version on the dense inputs of a settled G1 state's forward pass, with
    env 5 given no live row; then from a cold start (zero warmstart), where
    envs run to the 10-iteration cap."""
    sim = _settled_g1(E, cuda)
    d, k, _ = forward_stages(sim.model, sim.data)
    args, kw = solve_dense_inputs(sim.model, k, d)
    D = args[1].clone()
    D[:, 5] = 0.0  # env 5: no live row
    f_p, it_p = _check_dense(args[:1] + (D,) + args[2:], kw, cuda)
    first_contact_row = sim.model.nv + sim.model.nlimit
    assert int(it_p.max()) > 1 and bool((f_p[first_contact_row:] != 0).any())
    assert not bool(f_p[:, 5].any())
    _, it_p = _check_dense(args[:6] + (torch.zeros_like(args[6]),), kw, cuda)
    assert int(it_p.max()) == kw["iterations"]


def test_dense_kernel_on_equality_rows(cuda):
    """Kernel 6 on eq_toy's forward pass: a joint-equality row (two-sided)
    that carries a force, beside the dof-friction, limit and contact rows."""
    sim = _toy_sim("eq_toy", 256, cuda)
    d, k, _ = forward_stages(sim.model, sim.data)
    args, kw = solve_dense_inputs(sim.model, k, d)
    assert any(kw["eq_mask"])
    f_p, _ = _check_dense(args, kw, cuda)
    eq_rows = torch.as_tensor(kw["eq_mask"], device=cuda)
    assert bool((f_p[eq_rows] != 0).any())


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


def test_wrappers_reject_bad_inputs(cuda, monkeypatch):
    m, _, _ = physics.load_saved_model(device=cuda)
    with pytest.raises(ValueError, match="float32"):
        sk.kin_com(m, torch.zeros(m.nq, 8, dtype=torch.float64, device=cuda))
    with pytest.raises(ValueError, match="shape"):
        sk.kin_com(m, torch.zeros(m.nq + 1, 8, device=cuda))
    # the solves' launchers refuse a launch shape that is not their kernel's
    sim = _toy_sim("eq_toy", 8, cuda)
    args, kw = _solve_inputs(sim)
    d, k, _ = forward_stages(sim.model, sim.data)
    dargs, dkw = solve_dense_inputs(sim.model, k, d)
    sv.newton_assemble_solve(*args, **kw)
    sd.newton_solve_dense(*dargs, **dkw)
    shape = sv.newton_launch_shape
    monkeypatch.setattr(sv, "newton_launch_shape",
                        lambda *a: shape(*a)._replace(smem_bytes_per_env=4))
    with pytest.raises(RuntimeError, match="launch shape"):
        sv.newton_assemble_solve(*args, **kw)
    dshape = sd.dense_launch_shape
    monkeypatch.setattr(sd, "dense_launch_shape",
                        lambda *a: dshape(*a)._replace(smem_bytes_per_env=4))
    with pytest.raises(RuntimeError, match="launch shape"):
        sd.newton_solve_dense(*dargs, **dkw)


def _solve_inputs(sim):
    """newton_assemble_solve's (args, kwargs) at sim's state, from the
    plain smooth stages, as _check_kernels builds them."""
    m, d = sim.model, sim.data
    E, nv = d.qpos.shape[0], m.nv
    qT, vT, ctrlT = (x.T.contiguous() for x in (d.qpos, d.qvel, d.ctrl))
    mcT, mcqT = mocap_planes(m, d)
    gxpos, gxmat, subcom, cdof, cinA, cinc, xipos, _, _ = sk.kin_com_plain(m, qT, mcT, mcqT)
    zeros = lambda *s: torch.zeros(*s, E, device=qT.device)  # noqa: E731
    qfs, _, _, mh = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc,
                                        (subcom, xipos, zeros(m.nbody, 6), zeros(nv)))
    qM, Mh = sk.crb_dense_plain(m, cdof, cinA, cinc, mh)
    k = contact_stack(m, Params(m, E), qT, vT, gxpos, gxmat, subcom)
    return solve_args(m, k, qM, qfs, d.qacc_warmstart.T, vT, cdof.reshape(nv * 6, E), Mh)


# ---------------------------------------------------------------------------
# the captured control step (sim/sim.py ControlStep): one CUDA graph
# ---------------------------------------------------------------------------

# the step tolerances (tests/test_torch_step.py; the YAM's elliptic
# multistep ones, tests/test_pallas2_solver.py)
_STEP_TOL = {"g1": (("qpos", 1e-4), ("qvel", 1e-3), ("qacc", 5e-3)),
             "yam": (("qpos", 2e-4), ("qvel", 2e-2), ("qacc", 5e-3))}


def _g1_env_pair(cuda, E=256):
    """Two G1 Simulations on the card on one seeded state, each with the
    task's scene and env-side control step, the robot's joint targets at
    the keyframe plus noise."""
    m, key_qpos, key_ctrl = physics.load_saved_model(device=cuda)
    q, v, c = _state(key_qpos, key_ctrl, E, seed=3)
    q[:, 2] += 0.05
    out = []
    for _ in range(2):
        sim = Simulation(E, physics.sim_cfg(), m, device=cuda)
        t = lambda x: torch.as_tensor(x, device=cuda)  # noqa: E731
        sim.data = sim.data.replace(qpos=t(q), qvel=t(v), ctrl=t(c))
        scene = physics.make_scene(sim)
        scene["robot"].data.set_joint_position_target(t(c))
        out.append((sim, scene, physics.control_step(sim, scene)))
    return out


def _assert_steps_agree(a, b, path):
    for f, tol in _STEP_TOL[path]:
        err = rel_err(getattr(a, f), getattr(b, f))
        assert err < tol, f"{f}: {err:.2e}"
    for e in range(a.qpos.shape[0]):
        sa = a.con_sel[e][a.con_sel_active[e]].sort().values
        sb = b.con_sel[e][b.con_sel_active[e]].sort().values
        assert torch.equal(sa, sb), e
    assert int(b.ncheck_reset.sum()) == 0


def test_captured_g1_control_step_matches_eager(cuda):
    """The G1's env-side control step captured as one graph, 3 replays
    against 3 eager control steps; the capture records every kernel of the
    step (kernels 1-4) and the replays launch them."""
    (sim_e, sc_e, eager), (sim_c, sc_c, cap) = _g1_env_pair(cuda)
    wrappers = (sk.kin_com, sk.crb_dense, sk.vel_smooth, sv.newton_assemble_solve)
    cap.capture(warmup=2)
    before = [w.launches for w in wrappers]
    cap.capture(warmup=0)  # a second capture: the launches of one control step
    per_step = [w.launches - b for w, b in zip(wrappers, before)]
    assert per_step == [5, 4, 4, 4]
    for _ in range(3):
        eager.eager()
        cap.replay()
    torch.cuda.synchronize()
    _assert_steps_agree(sim_e.data, sim_c.data, "g1")
    for a, b in zip(sc_e.state_tensors(), sc_c.state_tensors()):
        assert rel_err(a, b) < 1e-5
    for name in ("robot/imu_lin_acc", "robot/imu_ang_vel"):
        assert rel_err(sc_e[name].data, sc_c[name].data) < 5e-3, name


def test_captured_yam_control_step_matches_eager(cuda):
    m, _ = yam.load_saved_model(device=cuda)
    sims = [Simulation(256, yam.sim_cfg(), m, device=cuda) for _ in range(2)]
    for s in sims:
        _yam_state(s, seed=2)
    eager, cap = ControlStep(sims[0], 4), ControlStep(sims[1], 4)
    cap.capture()
    for _ in range(3):
        eager.eager()
        cap.replay()
    torch.cuda.synchronize()
    _assert_steps_agree(sims[0].data, sims[1].data, "yam")


def test_replay_sees_reset_and_friction_writes(cuda):
    """A masked reset and a per-env friction write between replays land in
    the buffers the graph reads: the replays follow the eager twin, and
    the reset envs restart from qpos0."""
    pair = _g1_env_pair(cuda, E=128)
    for sim, _, _ in pair:
        sim.expand_model_fields(["geom_friction"])
    (sim_e, sc_e, eager), (sim_c, sc_c, cap) = pair
    cap.capture()
    eager.eager()
    cap.replay()
    mask = torch.zeros(128, dtype=torch.bool, device=cuda)
    mask[::3] = True
    feet = [i for i, n in enumerate(sim_c.model.geom_names) if "_foot" in n]
    draw = torch.linspace(0.3, 1.2, 128, device=cuda)[:, None]
    for sim, scene in ((sim_e, sc_e), (sim_c, sc_c)):
        sim.reset(mask)
        scene.reset(mask)
        sim.model.geom_friction[:, feet, 0] = draw
    eager.eager()
    cap.replay()
    torch.cuda.synchronize()
    _assert_steps_agree(sim_e.data, sim_c.data, "g1")
    dt = physics.sim_cfg().mujoco.timestep
    t = sim_c.data.time
    assert torch.allclose(t[mask], torch.full_like(t[mask], 4 * dt))
    assert torch.allclose(t[~mask], torch.full_like(t[~mask], 8 * dt))
    # the foot slots' sliding friction is the env's draw (a foot geom's
    # priority beats the plane's)
    pt = sim_c.model.pairs
    foot_slot = torch.as_tensor(np.isin(pt.con_geom1, feet) | np.isin(pt.con_geom2, feet),
                                device=cuda)
    on_foot = sim_c.data.con_sel_active & foot_slot[sim_c.data.con_sel.long()]
    mu = sim_c.data.con_packed_c[..., 5]
    assert bool(on_foot.any())
    assert torch.allclose(mu[on_foot], draw.expand_as(mu)[on_foot])
    # the graph holds the Model it captured: a new per-env field after
    # capture is refused
    with pytest.raises(RuntimeError, match="captured"):
        sim_c.expand_model_fields(["geom_solref"])



def test_replay_reads_per_env_body_ipos_written_between_replays(cuda):
    """The torso's body_ipos per env (the tracking task's base_com event),
    written in place between replays: the next replay reads the new values
    (kin_com reads the Model's tensor at every launch; nothing is
    snapshotted at capture), as its eager twin does."""
    pair = _g1_env_pair(cuda, E=128)
    for sim, _, _ in pair:
        sim.expand_model_fields(["body_ipos"])
    (sim_e, _, eager), (sim_c, _, cap) = pair
    cap.capture()
    eager.eager()
    cap.replay()
    torso = sim_c.model.body_names.index("robot/torso_link")
    shift = torch.zeros(128, 3, device=cuda)
    shift[:, 0] = torch.linspace(-0.025, 0.025, 128, device=cuda)
    shift[:, 2] = 0.05
    for sim in (sim_e, sim_c):
        sim.model.body_ipos[:, torso] += shift
    eager.eager()
    cap.replay()
    torch.cuda.synchronize()
    _assert_steps_agree(sim_e.data, sim_c.data, "g1")
    d = sim_c.data
    # the refresh after the replay placed the torso's com at the new offset
    rot = _quat_rotate(d.xquat[:, torso], sim_c.model.body_ipos[:, torso])
    assert torch.allclose(d.xipos[:, torso], d.xpos[:, torso] + rot, atol=1e-5)


def _quat_rotate(q, v):
    w, u = q[:, :1], q[:, 1:]
    uv = torch.linalg.cross(u, v, dim=-1)
    return v + 2.0 * (w * uv + torch.linalg.cross(u, uv, dim=-1))


# ---------------------------------------------------------------------------
# the G1 flat-velocity env's step captured as one CUDA graph
# (envs/manager_based_rl_env.py; chip_smoke.py's g1_env phase at 4096 envs)
# ---------------------------------------------------------------------------

# the env's outputs: the step tolerances on what they read
_ENV_TOL = {"policy": 1e-3, "critic": 5e-3, "reward": 1e-3}


def _g1_envs(cuda, E=256, seed=5):
    """An eager and a captured env of the task on one seed: the same
    generator state, so the same draws."""
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    out = []
    for capture in (False, True):
        cfg = load_env_cfg("Mjlab-Velocity-Flat-Unitree-G1")
        cfg.scene.num_envs = E
        cfg.seed = seed
        env = ManagerBasedRlEnv(cfg, device=cuda, capture=capture)
        env.reset()
        out.append(env)
    return out


def _tip_and_time_out(env, tip, late):
    import math

    qpos = env.sim.data.qpos.clone()
    a = math.radians(80.0) / 2
    qpos[tip, 3:7] = torch.tensor([math.cos(a), math.sin(a), 0.0, 0.0], device=qpos.device)
    env.sim.data = env.sim.data.replace(qpos=qpos)
    env.episode_length_buf[late] = env.max_episode_length - 1


def test_captured_env_step_matches_eager(cuda):
    """3 replays of the env step against 3 eager steps of a twin with the
    same generator state, across the reset of tipped and timed-out envs:
    the same flags and episode lengths, the observations and rewards and
    the state within the step tolerances, the same active slots; the
    capture recorded kernels 1-4 at their per-control-step counts."""
    eager, cap = _g1_envs(cuda)
    wrappers = (sk.kin_com, sk.crb_dense, sk.vel_smooth, sv.newton_assemble_solve)
    gen = torch.Generator(device=cuda).manual_seed(1)
    act = 0.5 * torch.randn(256, 29, generator=gen, device=cuda)
    before = [w.launches for w in wrappers]
    cap.step(act)  # captures (two warm-up steps and the capture), replays
    per_step = [(w.launches - b) / 3 for w, b in zip(wrappers, before)]
    assert cap.captured and per_step == [5, 4, 4, 4]
    eager.step(act)
    idx = torch.arange(256, device=cuda)
    for env in (eager, cap):
        _tip_and_time_out(env, idx % 7 == 0, idx % 11 == 3)
    for i in range(3):
        act = 0.5 * torch.randn(256, 29, generator=gen, device=cuda)
        oe = [t.clone() if isinstance(t, torch.Tensor) else {k: v.clone() for k, v in t.items()}
              for t in eager.step(act)[:4]]
        oc = cap.step(act)
        assert cap.captured
        torch.cuda.synchronize()
        for k in ("policy", "critic"):
            assert rel_err(oe[0][k], oc[0][k]) < _ENV_TOL[k], (i, k)
        assert rel_err(oe[1], oc[1]) < _ENV_TOL["reward"], i
        assert torch.equal(oe[2], oc[2]) and torch.equal(oe[3], oc[3]), i
        assert torch.equal(eager.episode_length_buf, cap.episode_length_buf), i
        if i == 0:
            assert bool(oc[2][idx % 7 == 0].all()) and bool(oc[3][idx % 11 == 3].all())
        _assert_steps_agree(eager.sim.data, cap.sim.data, "g1")


def test_env_replays_draw_fresh_numbers(cuda):
    """Two replays draw different numbers: the policy group's noise and
    the reset poses of envs reset in both."""
    _, cap = _g1_envs(cuda, E=128)
    act = torch.zeros(128, 29, device=cuda)
    noise, poses = [], []
    every = torch.ones(128, dtype=torch.bool, device=cuda)
    for _ in range(2):
        _tip_and_time_out(cap, ~every, every)
        obs = cap.step(act)[0]
        noise.append((obs["policy"][:, :67] - obs["critic"][:, :67]).clone())
        poses.append(cap.sim.data.qpos[:, :2] - cap.scene.env_origins[:, :2])
    torch.cuda.synchronize()
    assert cap.captured
    assert float((noise[0] == noise[1]).double().mean()) < 0.01
    assert float((poses[0] == poses[1]).all(1).double().mean()) < 0.01
    assert float(noise[0].abs().max()) <= 1.5 + 1e-6


# -- rough terrain (the height-field families) and the Go1 -------------------


def _rough_envs(cuda, task="Mjlab-Velocity-Rough-Unitree-G1", E=256, seed=5,
                captures=(False, True)):
    """Envs of a rough task on one seed and one generated terrain (seed 0):
    the same generator state, so the same draws."""
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    out = []
    for capture in captures:
        cfg = load_env_cfg(task)
        cfg.scene.num_envs = E
        cfg.seed = seed
        cfg.scene.terrain.terrain_generator.seed = 0
        env = ManagerBasedRlEnv(cfg, device=cuda, capture=capture)
        env.reset()
        out.append(env)
    return out


def test_captured_rough_env_matches_eager_across_a_promotion(cuda):
    """The rough G1 env, captured against its eager twin over 3 steps, the
    first resetting timed-out envs of which some were moved 5 m from their
    origin (promoted by the terrain curriculum) and others left near it
    (demoted where their command asks for it): terrain levels and origins
    equal bit for bit, the outputs within the env tolerances."""
    eager, cap = _rough_envs(cuda)
    terrain = cap.scene.terrain
    gen = torch.Generator(device=cuda).manual_seed(1)
    act = 0.5 * torch.randn(256, 29, generator=gen, device=cuda)
    cap.step(act)
    eager.step(act)
    idx = torch.arange(256, device=cuda)
    late, shift = idx % 11 == 3, idx % 22 == 3
    old = terrain.levels.clone()
    for env in (eager, cap):
        _tip_and_time_out(env, idx % 7 == 0, late)
        qpos = env.sim.data.qpos.clone()
        qpos[shift, :3] += torch.tensor([5.0, 0.0, 1.3], device=cuda)
        env.sim.data = env.sim.data.replace(qpos=qpos)
    for i in range(3):
        act = 0.5 * torch.randn(256, 29, generator=gen, device=cuda)
        oe = [t.clone() if isinstance(t, torch.Tensor) else {k: v.clone() for k, v in t.items()}
              for t in eager.step(act)[:4]]
        oc = cap.step(act)
        torch.cuda.synchronize()
        for k in ("policy", "critic"):
            assert rel_err(oe[0][k], oc[0][k]) < _ENV_TOL[k], (i, k)
        assert rel_err(oe[1], oc[1]) < _ENV_TOL["reward"], i
        assert torch.equal(oe[2], oc[2]) and torch.equal(oe[3], oc[3]), i
        for name in ("levels", "types", "origins"):
            assert torch.equal(getattr(eager.scene.terrain, name), getattr(terrain, name)), name
        _assert_steps_agree(eager.sim.data, cap.sim.data, "g1")
        if i == 0:
            up = shift & ~(idx % 7 == 0)
            rows = terrain.max_terrain_level
            assert bool(torch.where(old[up] + 1 < rows, terrain.levels[up] == old[up] + 1,
                                    terrain.levels[up] < rows).all())
            assert bool((terrain.levels[late & ~shift] <= old[late & ~shift]).all())


@pytest.mark.parametrize("task", ["Mjlab-Velocity-Rough-Unitree-G1",
                                  "Mjlab-Velocity-Rough-Unitree-Go1"])
def test_hfield_narrowphase_on_card_matches_cpu(task, cuda):
    """collision_lm's height-field slots on the card against the CPU port at
    float32, every robot geom at random poses over the whole terrain, a
    quarter on or past its four edges: finite, within chip_smoke.py's
    HFIELD_TOL (a few float32 steps of a coordinate at 100 m and of a grid
    coordinate at 2000 cells)."""
    from mjlab_tpu_torch.phys.lm import collision as pcol

    (env,) = _rough_envs(cuda, task, E=8, captures=(False,))
    m = env.sim.model
    cpu = pm.model_from_numpy(*pm.model_to_numpy(m), dtype=torch.float32, device="cpu")
    E, G = 2048, m.ngeom
    rs = np.random.default_rng(3)
    hf = m.geom_names.index("terrain/terrain")
    sx, sy, sz = (float(v) for v in m.hfield_size[0, :3].cpu())
    x = np.where(rs.random((G, E)) < 0.25, rs.choice([-sx - 0.5, -sx, sx, sx + 0.5], (G, E)),
                 rs.uniform(-sx, sx, (G, E)))
    y = np.where(rs.random((G, E)) < 0.25, rs.choice([-sy - 0.5, -sy, sy, sy + 0.5], (G, E)),
                 rs.uniform(-sy, sy, (G, E)))
    gx = np.stack([x, y, rs.uniform(-0.2, sz + 0.3, (G, E))], 1)
    gx += m.geom_pos[hf].cpu().numpy()[None, :, None]
    q = rs.standard_normal((G, 4, E))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, a, b, c = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    gm = np.stack([1 - 2 * (b * b + c * c), 2 * (a * b - w * c), 2 * (a * c + w * b),
                   2 * (a * b + w * c), 1 - 2 * (a * a + c * c), 2 * (b * c - w * a),
                   2 * (a * c - w * b), 2 * (b * c + w * a), 1 - 2 * (a * a + b * b)], 1)
    gx[hf] = m.geom_pos[hf].cpu().numpy()[:, None]
    gm[hf] = np.eye(3).reshape(9, 1)
    outs = []
    for mm, dev in ((m, cuda), (cpu, "cpu")):
        k = pcol.collision_lm(mm, Params(mm, E),
                              torch.as_tensor(gx, dtype=torch.float32, device=dev),
                              torch.as_tensor(gm, dtype=torch.float32, device=dev), {})
        outs.append(k)
    slots = torch.as_tensor(m.pairs.con_geom1 == hf)
    for key, tol in (("con_dist", 2e-5), ("con_pos", 5e-5), ("con_frame", 1e-4)):
        got, want = outs[0][key].cpu()[slots], outs[1][key][slots]
        assert bool(torch.isfinite(got).all()) and bool(torch.isfinite(want).all()), key
        assert float((got.double() - want.double()).abs().max()) < tol, key


def test_go1_kernels_match_plain_versions(cuda):
    """Kernels 1-4 on the Go1's shape (nq 19, nv 18, 15 bodies, 17 slots:
    the height-field families) against their plain versions, on the rough
    Go1 env's state after 3 steps, 300 envs (the smooth kernels' ragged
    edge). The robots stand up to ~100 m from the world origin: errors
    relative to max(1, |plain|max, their coordinate scale)."""
    (env,) = _rough_envs(cuda, "Mjlab-Velocity-Rough-Unitree-Go1", E=300, captures=(False,))
    gen = torch.Generator(device=cuda).manual_seed(2)
    for _ in range(3):
        env.step(0.5 * torch.randn(300, 12, generator=gen, device=cuda))
    m = env.sim.model
    assert (m.nq, m.nv, m.nbody, m.pairs.ncon) == (19, 18, 15, 17)
    length = float(env.sim.data.xpos.abs().max())
    assert length > 10
    _check_kernels(m, env.sim.data, cuda, length=length)


# -- the lift-cube env (the elliptic cone inside an env's graph) -------------

YAM_TASK = "Mjlab-Lift-Cube-Yam"


def _yam_envs(cuda, E=256, seed=5, captures=(False, True)):
    """Envs of the lift-cube task on one seed: the same generator state,
    so the same draws."""
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    out = []
    for capture in captures:
        cfg = load_env_cfg(YAM_TASK)
        cfg.scene.num_envs = E
        cfg.seed = seed
        env = ManagerBasedRlEnv(cfg, device=cuda, capture=capture)
        env.reset()
        out.append(env)
    return out


def _ground_late_and_resample(env, ground, late, resample):
    """chip_smoke.force_lift_resets: arms lowered into the table, envs one
    step before their time-out, commands run out with their cubes moved."""
    qpos = env.sim.data.qpos.clone()
    qpos[ground, 1], qpos[ground, 2] = 1.75, 0.8
    qpos[resample, 8] += 0.05
    env.sim.data = env.sim.data.replace(qpos=qpos)
    env.episode_length_buf[late] = env.max_episode_length - 1
    env.command_manager.get_term("lift_height").state["time_left"][resample] = 0.01


def test_captured_yam_env_matches_eager_bit_for_bit(cuda):
    """The lift-cube env captured against its eager twin over 3 steps: the
    first terminates envs on the ground contact, times out others and
    resamples others' commands mid-episode; the step counter is set past
    both curriculum stages between steps. Every output, qpos and qvel are
    equal bit for bit; the capture recorded kernels 1-3 and kernel 5 at
    their per-control-step counts and kernel 4 never."""
    eager, cap = _yam_envs(cuda)
    E = 256
    wrappers = (sk.kin_com, sk.crb_dense, sk.vel_smooth)
    gen = torch.Generator(device=cuda).manual_seed(1)
    act = torch.randn(E, 7, generator=gen, device=cuda)
    before = [w.launches for w in wrappers]
    by_cone = list(sv.newton_assemble_solve.launches_by_cone)
    cap.step(act)  # captures (two warm-up steps and the capture), replays
    per_step = [(w.launches - b) / 3 for w, b in zip(wrappers, before)]
    per_cone = [(a - b) / 3 for a, b in zip(sv.newton_assemble_solve.launches_by_cone, by_cone)]
    assert cap.captured and per_step == [5, 4, 4] and per_cone == [0, 4]
    eager.step(act)
    idx = torch.arange(E, device=cuda)
    ground, late = idx % 7 == 0, idx % 11 == 3
    resample = (idx % 13 == 5) & ~ground & ~late
    for env in (eager, cap):
        _ground_late_and_resample(env, ground, late, resample)
    for i, counter in enumerate((24000, 36000, 36001)):
        for env in (eager, cap):
            env.common_step_counter.fill_(counter)
        act = torch.randn(E, 7, generator=gen, device=cuda)
        oe = [t.clone() if isinstance(t, torch.Tensor) else {k: v.clone() for k, v in t.items()}
              for t in eager.step(act)[:4]]
        oc = cap.step(act)
        torch.cuda.synchronize()
        for k in ("policy", "critic"):
            assert torch.equal(oe[0][k], oc[0][k]), (i, k)
        for a, b in zip(oe[1:], oc[1:4]):
            assert torch.equal(a, b), i
        for f in ("qpos", "qvel", "qacc"):
            assert torch.equal(getattr(eager.sim.data, f), getattr(cap.sim.data, f)), (i, f)
        assert torch.equal(eager.episode_length_buf, cap.episode_length_buf), i
        if i == 0:
            assert bool(oc[2][ground].all()) and bool(oc[3][late].all())
            tl = cap.command_manager.get_term("lift_height").state["time_left"][resample]
            assert bool((tl >= 8.0).all())
        w = float(cap.reward_manager.weights["joint_vel_hinge"])
        assert w == np.float32(-0.1 if counter == 24000 else -1.0), (i, w)


def test_yam_env_solve_matches_plain_with_per_env_friction(cuda):
    """Kernel 5 and kernels 1-3 on the lift-cube env's state, 300 envs (the
    smooth kernels' ragged edge): after 3 env steps, half the envs pinch
    their cube (yam.task_states about each env's origin), with the
    fingertips' spin and roll friction drawn per env (log-uniform in the
    task's ranges; the env's startup events leave the roll axis per env),
    settled for 10 physics steps. The arms stand on a grid of origins
    about 17 m across: errors relative to max(1, |plain|max, the
    coordinate scale); the solve on the envs whose plain solve is stable
    under ulp nudges (a pinch is ill-conditioned)."""
    (env,) = _yam_envs(cuda, E=300, captures=(False,))
    E = 300
    gen = torch.Generator(device=cuda).manual_seed(2)
    for _ in range(3):
        env.step(torch.randn(E, 7, generator=gen, device=cuda))
    sim, m = env.sim, env.sim.model
    _, st = yam.load_saved_model(device="cpu")
    b = yam.task_states(m, st, E, seed=3)
    origins = env.scene.env_origins.cpu().numpy()
    b["qpos"][:, 8:10] += origins[:, :2]
    b["mocap_pos"][:, 0, :2] += origins[:, :2]
    sim.data = sim.data.replace(**{
        k: torch.as_tensor(v, dtype=torch.float32, device=cuda) for k, v in b.items()})
    fingertips = env.scene["robot"].indexing.geom_ids[
        env.event_manager._modes["startup"][0][1].params["asset_cfg"].geom_ids]
    rng = np.random.default_rng(4)
    fr = m.geom_friction
    for axis, (lo, hi) in ((1, (1e-4, 2e-2)), (2, (1e-5, 5e-3))):
        draw = np.exp(rng.uniform(np.log(lo), np.log(hi), (E, len(fingertips))))
        fr[:, fingertips, axis] = torch.as_tensor(draw, dtype=fr.dtype, device=cuda)
    assert float(fr[:, fingertips, 1].std(0).min()) > 0
    for _ in range(10):
        sim.step()
    length = float(sim.data.xpos.abs().max())
    assert length > 5 and int(m.opt.cone) == 1
    it_k, kw = _check_kernels(m, sim.data, cuda, stable_only=True, length=length)
    assert kw["cone"] == 1 and kw["R"] == 6


# -- the jump tasks (dt 0.002, decimation 2; a crouched start) ---------------

JUMP_TASK = "Mjlab-Jump-Flat-Unitree-G1"


def _jump_envs(cuda, E=256, seed=5, captures=(False, True)):
    """Envs of the jump task on one seed: the same generator state, so the
    same draws."""
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    out = []
    for capture in captures:
        cfg = load_env_cfg(JUMP_TASK)
        cfg.scene.num_envs = E
        cfg.seed = seed
        env = ManagerBasedRlEnv(cfg, device=cuda, capture=capture)
        env.reset()
        out.append(env)
    return out


def test_jump_kernels_match_plain_versions_at_dt_0002(cuda):
    """Kernels 1-4 on the jump env's state at its dt of 0.002 (crb_packed's
    implicit diagonal and vel_smooth's damping read it), 300 envs (the
    smooth kernels' ragged edge), after 60 control steps of 0.5 N(0, 1)
    actions from the crouched start: feet planted, knees deep. The solve on
    the envs whose plain solve is stable under ulp nudges (all 200 on a CPU
    rehearsal of this state)."""
    (env,) = _jump_envs(cuda, E=300, captures=(False,))
    gen = torch.Generator(device=cuda).manual_seed(2)
    for _ in range(60):
        env.step(0.5 * torch.randn(300, 29, generator=gen, device=cuda))
    m = env.sim.model
    assert float(m.opt.timestep) == np.float32(0.002) and env.cfg.decimation == 2
    found = env.scene["feet_ground_contact"].data.found > 0
    assert float(found.all(1).double().mean()) > 0.5
    length = float(env.sim.data.xpos.abs().max())
    it_k, kw = _check_kernels(m, env.sim.data, cuda, stable_only=True, length=length)
    assert kw["cone"] == 0


def test_captured_jump_env_matches_eager_bit_for_bit(cuda):
    """The jump env captured against its eager twin over 5 steps: the
    capture recorded kin_com 3 and the other smooth kernels and kernel 4
    twice per control step (decimation 2); the first step ends tipped envs
    (fell_over), low ones (height_too_low) and times out others, a drop
    flies; the global step count written between replays moves the
    curriculum's target, tolerance and weight in place. Every output, the
    state and the command's and terms' state equal bit for bit."""
    import math

    eager, cap = _jump_envs(cuda)
    E = 256
    wrappers = (sk.kin_com, sk.crb_dense, sk.vel_smooth)
    gen = torch.Generator(device=cuda).manual_seed(1)
    act = 0.5 * torch.randn(E, 29, generator=gen, device=cuda)
    before = [w.launches for w in wrappers]
    by_cone = list(sv.newton_assemble_solve.launches_by_cone)
    cap.step(act)
    per_step = [(w.launches - b) / 3 for w, b in zip(wrappers, before)]
    per_cone = [(a - b) / 3 for a, b in zip(sv.newton_assemble_solve.launches_by_cone, by_cone)]
    assert cap.captured and per_step == [3, 2, 2] and per_cone == [2, 0]
    eager.step(act)
    idx = torch.arange(E, device=cuda)
    tip, late = idx % 7 == 0, idx % 11 == 3
    low = (idx % 17 == 2) & ~tip & ~late
    drop = (idx % 19 == 4) & ~tip & ~late & ~low
    a = math.radians(80.0) / 2
    for env in (eager, cap):
        q, v = env.sim.data.qpos.clone(), env.sim.data.qvel.clone()
        q[tip, 3:7] = torch.tensor([math.cos(a), math.sin(a), 0.0, 0.0], device=cuda)
        q[low, 2] = 0.30
        q[drop, 2] += 0.18
        v[drop, 2] = -3.13
        env.sim.data = env.sim.data.replace(qpos=q, qvel=v)
        env.episode_length_buf[late] = env.max_episode_length - 1
    term = cap.command_manager.get_term("jump")
    for i, counter in enumerate((400_000, 900_000, 900_001, 900_002, 900_003)):
        for env in (eager, cap):
            env.common_step_counter.fill_(counter)
        act = 0.5 * torch.randn(E, 29, generator=gen, device=cuda)
        oe = [t.clone() if isinstance(t, torch.Tensor) else {k: v.clone() for k, v in t.items()}
              for t in eager.step(act)[:4]]
        oc = cap.step(act)
        torch.cuda.synchronize()
        for k in ("policy", "critic"):
            assert torch.equal(oe[0][k], oc[0][k]), (i, k)
        for x, y in zip(oe[1:], oc[1:4]):
            assert torch.equal(x, y), i
        for f in ("qpos", "qvel", "qacc"):
            assert torch.equal(getattr(eager.sim.data, f), getattr(cap.sim.data, f)), (i, f)
        for x, y in zip(eager.reward_manager.state_tensors(), cap.reward_manager.state_tensors()):
            assert torch.equal(x, y), i
        for x, y in zip(eager.command_manager.state_tensors(),
                        cap.command_manager.state_tensors()):
            assert torch.equal(x, y), i
        if i == 0:
            tm = cap.termination_manager
            assert bool(tm.get_term("fell_over")[tip].all())
            assert bool(tm.get_term("height_too_low")[low].all())
            assert bool(oc[3][late].all())
            air = cap.scene["feet_ground_contact"].data.current_air_time
            assert bool((air[drop] > 0).all())
        want = (0.15, 0.05, 2.5) if i == 0 else (0.25, 0.08, 4.0)
        got = (float(term.state["target_height"]), float(term.state["height_tolerance"]),
               float(cap.reward_manager.weights["landing_stability"]))
        np.testing.assert_allclose(got, want, rtol=1e-7)


def _explicit_envs(cuda, E=300, seed=5, captures=(False, True)):
    """The explicit-actuator G1 env (tasks/velocity/config/g1/explicit.py)
    on one seed, eager and captured: the same draws."""
    import tempfile

    from mjlab_tpu_torch.tasks.velocity.config.g1.explicit import make_g1_explicit_env

    out = []
    for capture in captures:
        env = make_g1_explicit_env(E, cuda, capture=capture, seed=seed,
                                   nan_dir=tempfile.mkdtemp())
        env.reset()
        out.append(env)
    return out


def test_vel_smooth_with_per_env_forcerange_matches_plain_version(cuda):
    """Kernels 1-4 against their plain versions on the explicit env's state
    (E = 300, the ragged edge): its delayed DC legs and PD arms drive
    motors, the wrists' force range, gain and bias per env (reset draws),
    then every actuator's force range cut to 5-100 % per env so that many
    forces saturate: kernel 3 reads the range per env in its force clip
    and its implicit diagonal's saturation test."""
    (env,) = _explicit_envs(cuda, captures=(False,))
    gen = torch.Generator(device=cuda).manual_seed(2)
    for _ in range(5):
        env.step(0.5 * torch.randn(env.num_envs, 29, generator=gen, device=cuda))
    fr = env.sim.model.actuator_forcerange
    assert fr.shape == (env.num_envs, 29, 2)
    fr.mul_(torch.empty(fr.shape[:2] + (1,), device=cuda).uniform_(0.05, 1.0, generator=gen))
    env.sim.step()
    hi = fr[..., 1]
    saturated = (env.sim.data.actuator_force.abs() - hi).abs() < 1e-5
    assert int(saturated.sum()) > 0
    # errors relative to the coordinate scale: 300 envs on a grid of env
    # origins tens of metres across
    length = float(env.sim.data.xpos.abs().max())
    _check_kernels(env.sim.model, env.sim.data, cuda, stable_only=True, length=length)


def test_captured_explicit_env_matches_eager_bit_for_bit(cuda):
    """The explicit env captured against its eager twin over 4 steps: the
    delayed legs' lags drawn inside the graph, the reset events' gains and
    effort limits, the NaN guard's window; a NaN written into env 3's
    wrist gain between replays ends env 3 through nan_detection in both,
    both guards flag it alone, and their dumps hold the same arrays."""
    eager, cap = _explicit_envs(cuda)
    gen = torch.Generator(device=cuda).manual_seed(1)
    robot = cap.scene["robot"]
    wrist = int(next(a for a in robot.actuators if a.is_passthrough).ctrl_ids[0])
    for i in range(4):
        if i == 2:
            for env in (eager, cap):
                env.sim.model.actuator_gainprm[3, wrist, 0] = float("nan")
        act = 0.5 * torch.randn(eager.num_envs, 29, generator=gen, device=cuda)
        oe = [t.clone() for t in eager.step(act)[1:4]]
        oc = cap.step(act)[1:4]
        torch.cuda.synchronize()
        for x, y in zip(oe, oc):
            assert torch.equal(torch.nan_to_num(x, 7.0), torch.nan_to_num(y, 7.0)), i
        for f in ("qpos", "qvel"):
            assert torch.equal(getattr(eager.sim.data, f), getattr(cap.sim.data, f)), (i, f)
        for x, y in zip(eager.scene.state_tensors(), cap.scene.state_tensors()):
            assert torch.equal(x, y), i
        if i == 2:
            assert torch.nonzero(oc[1]).flatten().tolist() == [3]
    assert cap.captured
    for x, y in zip(eager.nan_guard.state_tensors(), cap.nan_guard.state_tensors()):
        assert torch.equal(x, y)
    assert torch.nonzero(cap.nan_guard.bad_envs).flatten().tolist() == [3]
    paths = []
    for env in (eager, cap):
        env.close()
        paths.append(env.nan_guard.dumped)
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        for k in ("bad_envs", "qpos", "qvel", "ctrl"):
            np.testing.assert_array_equal(a[k], b[k])


def test_captured_sensors_env_matches_eager_bit_for_bit(cuda):
    """The sensor-suite G1 env (tasks/velocity/config/g1/sensors.py: every
    builtin type but the tendon types, three contact sensors, all read by
    the critic inside the graph) captured against its eager twin over 4
    steps (E = 300), every output equal bit for bit (the critic holds every
    reading, sensors.critic_columns); before step 2 env 7's left knee is
    put past its range in both (written between replays) and its action
    presses it into the limit: the joint-limit readings are live, and the
    pelvis's rangefinder hits in every env."""
    from mjlab_tpu_torch.tasks.velocity.config.g1 import sensors as S

    eager, cap = (S.make_g1_sensors_env(300, cuda, capture=c, seed=5) for c in (False, True))
    for env in (eager, cap):
        env.reset()
    cols = S.critic_columns(cap)
    assert cols["sensor/pelvis_range"].stop - cols["sensor/pelvis_range"].start == 1
    m = cap.sim.model
    knee = int(m.jnt_qposadr[m.joint_names.index("robot/left_knee_joint")])
    term = cap.action_manager.get_term("joint_pos")
    joints = [cap.scene["robot"].joint_names[i] for i in term._joint_ids.tolist()]
    col = joints.index("left_knee_joint")
    gen = torch.Generator(device=cuda).manual_seed(1)
    for i in range(4):
        act = 0.5 * torch.randn(300, 29, generator=gen, device=cuda)
        if i >= 2:
            act[7, col] = -4.0
        if i == 2:
            for env in (eager, cap):
                q = env.sim.data.qpos.clone()
                q[7, knee] = -0.35
                env.sim.data = env.sim.data.replace(qpos=q)
        oe = eager.step(act)
        oe = ({k: v.clone() for k, v in oe[0].items()}, *[t.clone() for t in oe[1:4]])
        oc = cap.step(act)
        torch.cuda.synchronize()
        for k in ("policy", "critic"):
            assert torch.equal(oe[0][k], oc[0][k]), (i, k)
        for x, y in zip(oe[1:], oc[1:4]):
            assert torch.equal(x, y), i
        for f in ("qpos", "qvel"):
            assert torch.equal(getattr(eager.sim.data, f), getattr(cap.sim.data, f)), (i, f)
        critic = oc[0]["critic"]
        assert bool((critic[:, cols["sensor/pelvis_range"]] > 0).all()), i
        if i >= 2:
            assert float(critic[7, cols["sensor/left_knee_limit_pos"]][0]) < 0, i
            assert float(critic[7, cols["sensor/left_knee_limit_frc"]][0]) > 0, i
    assert cap.captured
