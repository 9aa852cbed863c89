#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mjlab_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each of which raises on a failure (no phase failure is caught):

1. build the CUDA kernels from mjlab_tpu_torch/csrc (nvcc, one process per
   source, all at once) and print the build time;
2. build the Mjlab-Velocity-Flat-Unitree-G1 physics model and a Simulation
   of 4096 envs (nconmax 35, dt 0.005, 10 Newton / 20 line-search
   iterations, implicitfast, pyramidal cone);
3. reset, seed a state from the knees-bent keyframe plus numpy noise and
   settle it for a few control steps with ctrl held at the keyframe;
4. hold each kernel against its plain PyTorch version on that state, at
   the G1 shapes and 4096 envs (float32; TF32 matmuls off), and time both
   (the tolerances are those of the CPU parity tests; qfrc_constraint of
   an env whose Newton iteration count differs between the two, a flip of
   the f32 acceptance test at convergence, is held at the force
   tolerance);
5. the main path: 25 control steps of 4 physics substeps plus the
   kinematic refresh, random ctrl from a seeded generator, timed with CUDA
   events after one warm control step; every kernel's launch count must
   show the path went through it;
6. the output is right: finite qpos, no diverged-state resets, and three
   steps of a 64-env Simulation on the card agree with the same steps on
   the CPU (the plain versions) within the step tolerances of
   tests/test_torch_step.py.

The line before the last is the card's name and power limit (nvidia-smi);
the lines before hold the kernels (JSON), the substep breakdown and the
physics throughput. The last line is {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when there is no CUDA card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch

NUM_ENVS = 4096
CONTROL_STEPS = 25
DECIMATION = 4
SETTLE_STEPS = 10
SEED = 0

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# rate outside the tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel vs plain version, float32 (tests/test_torch_stages.py,
# tests/test_torch_solver.py): relative to max(1, |plain|max)
TOL_FRAMES = 2e-6  # kin_com outputs
TOL_SMOOTH = 5e-6  # crb_packed, vel_smooth
TOL_SOLVE = 2e-3  # qacc, qfrc_constraint, a_smooth, qacc_int
TOL_FORCE = 6e-3  # per-row constraint forces


def log(*a):
    print(*a, flush=True)


def rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double()
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    return float((ref - got.double()).abs().max()) / scale if ref.numel() else 0.0


def max_abs(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float((ref.double() - got.double()).abs().max()) if ref.numel() else 0.0


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean device time of fn over reps calls, CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time the card could take (ms) and what bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# operation counts (f32 FLOPs per env, counted from the kernels' sources)
# ---------------------------------------------------------------------------


def kin_com_flops(m, ncg: int) -> int:
    # per body: frame 70 (+135 per hinge/slide/ball joint, 15 for a free
    # joint's normalisation), xipos 36, com 10, cinert 130; per dof: cdof
    # 20; per collision geom: frame 36 + rotation 90
    njoint_moving = int(np.sum(m.jnt_type != 0))
    return (
        (m.nbody - 1) * 70 + njoint_moving * 135 + 15
        + m.nbody * (36 + 10 + 130) + m.nv * 20 + ncg * 126
    )


def crb_flops(m, npair: int) -> int:
    # composite inertias 13 per body, f = I cdof 36 per dof, 11 per pair
    return m.nbody * 13 + m.nv * 36 + npair * 11


def vel_smooth_flops(m) -> int:
    # cvel/cdof_dot 12+30 per dof, cacc 12 per dof, body forces 100 per
    # body, bias 11 per dof, passive 2 per dof, actuation 20 per actuator,
    # xfrc 15 per body + 12 per ancestor dof, the sum 4 per dof
    anc = int(np.sum(np.asarray(_ancestor_counts(m))))
    return (
        m.nv * (42 + 12 + 11 + 2 + 4) + m.nbody * (100 + 15)
        + m.nu * 20 + anc * 12
    )


def _ancestor_counts(m):
    from mjlab_tpu_torch.phys.lm.stages import ancestor_dof_mask

    return ancestor_dof_mask(m).sum(axis=1)


def newton_flops(nv, nlim, nlive, nact, iters, ls) -> float:
    """FLOPs of the fused solve for one env: nlive contact rows built and
    carried, nact of them active in the Hessian, iters Newton iterations."""
    chol = nv**3 / 3 + 3 * nv * nv
    solve = 4 * nv * nv
    matvec = 2 * nv * nv
    rows = 2 * nv * nlive  # one product of the rows with a vector
    build = 48 * nv * nlive
    cost = 6 * nv + 4 * nlim + 4 * nlive
    setup = chol + solve + 2 * (nv + nlim + rows + matvec + cost)
    per_iter = (
        matvec + rows + 1.5 * nv * nv * nact + chol + solve + rows + matvec
        + (12 + ls) * (6 * nv + 5 * nlim + 5 * nlive) + matvec + cost
    )
    tail = rows + matvec + chol + solve
    return build + setup + iters * per_iter + tail


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def build_kernels():
    from mjlab_tpu_torch import cuda_build

    t0 = time.perf_counter()
    times = cuda_build.build_all()
    log(f"[build] {len(times)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a): " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    for name in cuda_build.SOURCES:
        log(f"[build] {name}: {cuda_build.ptxas_report(name).splitlines()[-1:]}")


def make_sim(num_envs: int, device: str):
    """A Simulation of the G1 flat-velocity model, read from the model file
    the repo keeps (MuJoCo, the model compiler, need not be installed),
    and the knees-bent keyframe (qpos, ctrl)."""
    from mjlab_tpu_torch.sim.sim import Simulation
    from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

    m, key_qpos, key_ctrl = physics.load_saved_model(device=device)
    sim = Simulation(num_envs, physics.sim_cfg(), m, device=device)
    return sim, (key_qpos, key_ctrl)


def seed_state(sim, keyframe, seed: int):
    """Keyframe plus numpy noise; ctrl at the keyframe."""
    key_qpos, key_ctrl = keyframe
    m = sim.model
    E = sim.num_envs
    rng = np.random.default_rng(seed)
    qpos = np.tile(key_qpos, (E, 1))
    qpos[:, 7:] += 0.05 * rng.standard_normal((E, m.nq - 7))
    qpos[:, 2] += 0.02 * rng.standard_normal(E)
    qvel = 0.1 * rng.standard_normal((E, m.nv))
    ctrl = np.tile(key_ctrl, (E, 1))
    t = lambda x: torch.as_tensor(x, dtype=sim.dtype, device=sim.device)  # noqa: E731
    sim.reset()
    sim.data = sim.data.replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))
    return t(ctrl)


def control_step(sim, ctrl=None):
    if ctrl is not None:
        sim.data = sim.data.replace(ctrl=ctrl)
    for _ in range(DECIMATION):
        sim.step()
    sim.refresh()


def check_kernels(sim) -> list[dict]:
    """Each kernel against its plain version on the settled state."""
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys import solver_kernels as sv
    from mjlab_tpu_torch.phys.hybrid import contact_stack, has_implicit, solve_args
    from mjlab_tpu_torch.phys.lm.base import Params

    m, d = sim.model, sim.data
    E = d.qpos.shape[0]
    nv = m.nv
    qT = d.qpos.T.contiguous()
    vT = d.qvel.T.contiguous()
    ctrlT = d.ctrl.T.contiguous()
    xfrcT = d.xfrc_applied.permute(1, 2, 0).contiguous()
    qfaT = d.qfrc_applied.T.contiguous()
    rows = []

    def record(name, source, replaces, errs, outs_in_bytes, flops, fn_k, fn_p,
               reps):
        for label, (err, tol) in errs.items():
            log(f"[check] {name} {label}: rel err {err:.3e} (tol {tol:.0e})")
            if not err < tol:
                raise AssertionError(f"{name} {label}: {err:.3e} >= {tol:.0e}")
        ms = cuda_ms(fn_k, reps)
        plain_ms = cuda_ms(fn_p, 2)
        b_ms, b_by = bound(outs_in_bytes, flops * E)
        rows.append(dict(
            name=name, route="cuda", source=source, replaces=replaces,
            launches=None, max_abs_err=None, ms=ms, plain_ms=plain_ms,
            bound_ms=b_ms, bound_by=b_by, library_ms=None,
        ))
        log(f"[time] {name}: kernel {ms:.4f} ms, plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")

    # kernel 1: kin_com
    outs_k = sk.kin_com(m, qT)
    outs_p = sk.kin_com_plain(m, qT)
    names = ("gxpos", "gxmat", "subcom", "cdof", "cinA", "cinc", "xipos",
             "xpos", "xquat")
    errs = {n: (rel_err(p, k), TOL_FRAMES) for n, p, k in zip(names, outs_p, outs_k)}
    record("kin_com", "mjlab_tpu_torch/csrc/kin_com.cu",
           "mjlab_tpu/phys/smooth_pallas.py:237", errs,
           nbytes(qT, *outs_k), kin_com_flops(m, len(sk.collision_geoms(m))),
           lambda: sk.kin_com(m, qT), lambda: sk.kin_com_plain(m, qT), 20)
    rows[-1]["max_abs_err"] = max(max_abs(p, k) for p, k in zip(outs_p, outs_k))
    gxpos, gxmat, subcom, cdof, cinA, cinc, xipos, _, _ = outs_p

    # kernel 2: crb_packed
    qm_k = sk.crb_packed(m, cdof, cinA, cinc)
    qm_p = sk.crb_packed_plain(m, cdof, cinA, cinc)
    record("crb_packed", "mjlab_tpu_torch/csrc/crb_packed.cu",
           "mjlab_tpu/phys/smooth_pallas.py:321",
           {"qM_pairs": (rel_err(qm_p, qm_k), TOL_SMOOTH)},
           nbytes(cdof, cinA, cinc, qm_k), crb_flops(m, qm_k.shape[0]),
           lambda: sk.crb_packed(m, cdof, cinA, cinc),
           lambda: sk.crb_packed_plain(m, cdof, cinA, cinc), 20)
    rows[-1]["max_abs_err"] = max_abs(qm_p, qm_k)

    # kernel 3: vel_smooth
    xq = (subcom, xipos, xfrcT, qfaT)
    vs_k = sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    vs_p = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    names = ("qfrc_smooth", "actuator_force", "actuator_velocity", "mh_diag")
    record("vel_smooth", "mjlab_tpu_torch/csrc/vel_smooth.cu",
           "mjlab_tpu/phys/smooth_pallas.py:389",
           {n: (rel_err(p, k), TOL_SMOOTH) for n, p, k in zip(names, vs_p, vs_k)},
           nbytes(qT, vT, ctrlT, cdof, cinA, cinc, subcom, xipos, xfrcT, qfaT,
                  *vs_k),
           vel_smooth_flops(m),
           lambda: sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq),
           lambda: sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq),
           20)
    rows[-1]["max_abs_err"] = max(max_abs(p, k) for p, k in zip(vs_p, vs_k))
    qfs, _, _, mh_diag = vs_p

    # kernel 4: newton_assemble_solve (cone 0), on the plain versions' inputs
    P = Params(m, E)
    k = contact_stack(m, P, qT, vT, gxpos, gxmat, subcom)
    qM_cm = sk.qm_dense_cm(m, qm_p)
    Mh_cm = None
    if has_implicit(m):
        Mh_cm = qM_cm.clone()
        Mh_cm[torch.arange(nv, device=qT.device) * (nv + 1)] += mh_diag
    args, kw = solve_args(m, k, qM_cm, qfs, d.qacc_warmstart.T, vT,
                          cdof.reshape(nv * 6, E), Mh_cm)
    it_k = torch.zeros(E, dtype=torch.int32, device=qT.device)
    it_p = torch.zeros(E, dtype=torch.int32, device=qT.device)
    so_k = sv.newton_assemble_solve(*args, **kw, iters=it_k)
    so_p = sv.newton_assemble_solve_plain(*args, **kw, iters=it_p)
    names = ("qacc", "f_noncontact", "f_contact", "qfrc_constraint",
             "qacc_smooth", "qacc_int")
    tols = (TOL_SOLVE, TOL_FORCE, TOL_FORCE, TOL_SOLVE, TOL_SOLVE, TOL_SOLVE)
    errs = {n: (rel_err(p, kk), t) for n, p, kk, t in zip(names, so_p, so_k, tols)}
    # At convergence the acceptance test compares two f32 costs that differ
    # by rounding, so the Newton iteration count of an env depends on the
    # order of its sums (two builds of the kernel, with and without FMA
    # contraction, disagree as often). Where the counts agree, qfrc is held
    # at the solve tolerance; where they differ by that one step it is held
    # at the per-row force tolerance, qfrc being J^T f.
    same = it_k == it_p
    scale = max(1.0, float(so_p[3].abs().max()))
    diff = (so_p[3].double() - so_k[3].double()).abs().max(0).values / scale
    del errs["qfrc_constraint"]
    errs["qfrc_constraint, equal iteration counts"] = (
        float(diff[same].max()) if same.any() else 0.0, TOL_SOLVE)
    errs["qfrc_constraint, iteration counts differ"] = (
        float(diff[~same].max()) if (~same).any() else 0.0, TOL_FORCE)
    nlive = (args[20] != 0).sum(0).double()
    nact = (so_p[2] > 0).sum(0).double()
    flops = float(sum(
        newton_flops(nv, kw["nlim"], nl, na, it, kw["ls_iterations"])
        for nl, na, it in zip(nlive.tolist(), nact.tolist(), it_p.tolist())
    )) / E
    log(f"[check] newton: iterations mean {it_k.double().mean():.2f} kernel, "
        f"{it_p.double().mean():.2f} plain, different in {int((~same).sum())} "
        f"of {E} envs; live contact rows mean {float(nlive.mean()):.1f}, "
        f"active {float(nact.mean()):.1f}")
    in_args = [a for a in args if a.shape[0] > 1]
    record("newton_assemble_solve", "mjlab_tpu_torch/csrc/newton_solve.cu",
           "mjlab_tpu/phys/solver_pallas2.py:623",
           errs, nbytes(*in_args, *so_k), flops,
           lambda: sv.newton_assemble_solve(*args, **kw),
           lambda: sv.newton_assemble_solve_plain(*args, **kw), 10)
    rows[-1]["max_abs_err"] = max(max_abs(p, kk) for p, kk in zip(so_p, so_k))
    return rows


def device_profile(sim, ctrl) -> dict:
    """One control step under torch.profiler: CUDA kernels launched, their
    summed device time, and the device's idle share between the first
    kernel's start and the last one's end (the profiler slows the host,
    so this idle share is an upper bound)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        control_step(sim, ctrl)
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not kernels:
        return {"kernels": 0}
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    return {"kernels": len(kernels), "busy_ms": busy, "span_ms": span,
            "idle_share": 1.0 - busy / span}


def breakdown(sim, steps: int) -> dict:
    """Device time per substep phase (CUDA events at the step's phase
    marks) and of the refresh, averaged over ``steps`` control steps."""
    from mjlab_tpu_torch.phys.hybrid import refresh_envlast, step_envlast

    order = ("kin_com", "contact", "vel_smooth", "crb", "solve", "integrate")
    acc = {n: 0.0 for n in order + ("refresh",)}
    for _ in range(steps):
        for _ in range(DECIMATION):
            ev = [torch.cuda.Event(enable_timing=True)]
            ev[0].record()
            marks = []

            def mark(name):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ev.append(e)
                marks.append(name)

            sim.data = step_envlast(sim.model, sim.data, mark=mark)
            torch.cuda.synchronize()
            for name, a, b in zip(marks, ev[:-1], ev[1:]):
                acc[name] += a.elapsed_time(b)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        sim.data = refresh_envlast(sim.model, sim.data)
        b.record()
        torch.cuda.synchronize()
        acc["refresh"] += a.elapsed_time(b)
    out = {n: acc[n] / (steps * DECIMATION) for n in order}
    out["refresh"] = acc["refresh"] / steps
    return out


def end_to_end_check(seed: int):
    """3 steps of a 64-env Simulation on the card against the same steps
    on the CPU (the plain versions): the kernels carry the whole step."""
    sims = [make_sim(64, dev) for dev in ("cuda", "cpu")]
    for s, key in sims:
        seed_state(s, key, seed + 1)
    sims = [s for s, _ in sims]
    for _ in range(3):
        for s in sims:
            s.step()
    dc, dp = (s.data for s in sims)
    sel_same = float((dc.con_sel.cpu() == dp.con_sel).all(dim=1).double().mean())
    for f, tol in (("qpos", 1e-4), ("qvel", 1e-3), ("qacc", 5e-3)):
        err = rel_err(getattr(dp, f), getattr(dc, f).cpu())
        log(f"[e2e] 64 envs x 3 steps, card vs CPU: {f} rel err {err:.3e} (tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"end-to-end {f}: {err:.3e} >= {tol:.0e}")
    log(f"[e2e] envs with the same contact selection: {sel_same:.3f}")
    if not bool(torch.isfinite(dc.qpos).all()):
        raise AssertionError("non-finite qpos on the card")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys import solver_kernels as sv

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    # 1. build
    build_kernels()

    # 2-3. model, simulation, settled state
    sim, keyframe = make_sim(NUM_ENVS, "cuda")
    m = sim.model
    log(f"[model] G1 flat velocity: nq {m.nq} nv {m.nv} nu {m.nu} nbody "
        f"{m.nbody} ngeom {m.ngeom}, {m.pairs.ncon} contact slots, K "
        f"{m.ncon_max}, nefc {m.nefc}; {NUM_ENVS} envs")
    ctrl0 = seed_state(sim, keyframe, SEED)
    for _ in range(SETTLE_STEPS):
        control_step(sim, ctrl0)
    torch.cuda.synchronize()
    log(f"[settle] {SETTLE_STEPS} control steps; contacts active per env "
        f"{float(sim.data.con_sel_active.sum(1).double().mean()):.1f}")

    # 4. each kernel against its plain version
    rows = check_kernels(sim)

    # 5. the main path, counted and timed
    gen = torch.Generator(device=sim.device).manual_seed(SEED)

    def random_ctrl():
        return ctrl0 + 0.3 * torch.randn(ctrl0.shape, generator=gen,
                                         device=sim.device)

    control_step(sim, random_ctrl())  # warm
    torch.cuda.synchronize()
    wrappers = {
        "kin_com": sk.kin_com, "crb_packed": sk.crb_packed,
        "vel_smooth": sk.vel_smooth,
        "newton_assemble_solve": sv.newton_assemble_solve,
    }
    for w in wrappers.values():
        w.launches = 0
    ctrls = [random_ctrl() for _ in range(CONTROL_STEPS)]
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for c in ctrls:
        control_step(sim, c)
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    dev_ms = start.elapsed_time(end)
    launches = {n: w.launches for n, w in wrappers.items()}
    substeps = CONTROL_STEPS * DECIMATION
    expected = {"kin_com": substeps + CONTROL_STEPS, "crb_packed": substeps,
                "vel_smooth": substeps, "newton_assemble_solve": substeps}
    log(f"[main] launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"kernel launches {launches} != {expected}")
    for r in rows:
        r["launches"] = launches[r["name"]]

    # 6. the output is right
    d = sim.data
    if not bool(torch.isfinite(d.qpos).all()):
        raise AssertionError("non-finite qpos after the main path")
    resets = int(d.ncheck_reset.sum())
    overflow = int(d.ncon_overflow.sum())
    log(f"[main] diverged-state resets {resets}, contact-slot overflow {overflow}")
    if resets:
        raise AssertionError(f"{resets} diverged-state resets")
    env_steps = NUM_ENVS * CONTROL_STEPS / (dev_ms / 1e3)
    log(f"[main] {CONTROL_STEPS} control steps x {DECIMATION} substeps + refresh "
        f"at {NUM_ENVS} envs: {dev_ms:.1f} ms (CUDA events), {wall * 1e3:.1f} ms "
        f"(host clock); {dev_ms / CONTROL_STEPS:.2f} ms per control step, "
        f"{dev_ms / substeps:.3f} ms per substep incl. refresh share")
    log(f"[main] physics env-steps/s at {NUM_ENVS} envs: {env_steps:.1f}")

    parts = breakdown(sim, 4)
    sub = sum(v for k, v in parts.items() if k != "refresh")
    log("[breakdown] ms per substep: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items() if k != "refresh")
        + f" (sum {sub:.3f}); refresh {parts['refresh']:.3f} ms per control step")
    prof = device_profile(sim, random_ctrl())
    if prof["kernels"]:
        log(f"[profile] one control step: {prof['kernels']} CUDA kernels, "
            f"device busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms "
            f"span, idle share {prof['idle_share']:.3f} (under the profiler)")
    else:
        log("[profile] torch.profiler recorded no CUDA kernels: idle share "
            "not measured")

    end_to_end_check(SEED)

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(json.dumps({"kernels": rows}))
    log(json.dumps({
        "physics_env_steps_per_s": env_steps, "ms_per_substep": sub,
        "breakdown_ms_per_substep": parts, "profile": prof, "num_envs": NUM_ENVS,
        "seconds": time.perf_counter() - t_start,
    }))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
