#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mjlab_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Six main paths, each driven at 4096 envs through its public entry points,
and the six kernels they run. This slice's main path is the env's:

- g1_env: the Mjlab-Velocity-Flat-Unitree-G1 env (envs/
  manager_based_rl_env.py), built from the port's registry, its whole step
  (the action, 4 x (actuators, physics, sensors), terminations, rewards,
  masked resets, the refresh, the command, the push event, observations)
  captured as one CUDA graph by its first step(), on bench.py's traffic (a
  fresh action 0.5 N(0, 1) per control step): kin_com, crb_packed,
  vel_smooth and newton_assemble_solve cone 0 inside the graph;

and the captured physics control steps of the slice before:

- g1_capture: the G1 control step as the env runs it
  (tasks/velocity/config/g1/physics.py control_step): 4 substeps of the
  robot's actuator controls from its joint targets, the physics step and
  the sensors' update (contact air time), then the refresh, with the feet's
  friction per env (the task's startup event) and the task's scene (entity,
  two contact sensors, the XML's four builtin sensors); captured as one
  CUDA graph (sim.ControlStep): kin_com, crb_packed, vel_smooth and
  newton_assemble_solve cone 0 inside the graph;
- yam_capture: the YAM physics control step (4 substeps and the refresh,
  fingertip friction per env, the task's own traffic) captured the same
  way: the elliptic kernel inside the graph;

- g1: Mjlab-Velocity-Flat-Unitree-G1 physics (nconmax 35, pyramidal cone),
  reset, step and refresh: kin_com, crb_packed (the kernel of crb_dense:
  the dense mass matrix and its implicit diagonal in one launch),
  vel_smooth and newton_assemble_solve cone 0;
- yam: Mjlab-Lift-Cube-Yam physics (nconmax 55, elliptic cone with
  impratio 10, a joint equality, a mocap base, the box contact families),
  reset, step and refresh: kin_com with mocap frames, crb_packed,
  vel_smooth and newton_assemble_solve cone 1 (the elliptic kernel);
- g1_forward: the G1's Simulation.forward() (mj_forward over the whole
  Data surface: the batched stages, the dense contact rows, every efc row
  and the packed contact table written): newton_solve_dense, the solve
  over the dense constraint Jacobian (nefc 204).

All: dt 0.005, 10 Newton / 20 line-search iterations, implicitfast.

Phases, each of which raises on a failure (no phase failure is caught):

1. build the CUDA kernels from mjlab_tpu_torch/csrc (nvcc, one process per
   source, all at once) and print the build time;
then for each path:
2. build the model from the file the repo keeps and a Simulation;
3. reset, seed a state (G1: the knees-bent keyframe plus numpy noise; YAM:
   half the envs at the task's reset state, half pinching the cube, with
   noise on the arm, so that the kernels meet every contact regime) and
   settle it for a few control steps;
4. hold each kernel of the path against its plain PyTorch version on that
   state, at the path's shapes (float32; TF32 matmuls off), and time both
   (the tolerances are those of the CPU parity tests; qfrc_constraint
   under the iteration-count rule of solver_kernels.qfrc_errors, and the
   count of envs whose Newton iteration counts differ is printed, with the
   solve kernel's launch shape and resident threads per SM);
5. the main path on the path's traffic (G1: the settled state, random
   ctrl around the keyframe; YAM: the task's own, every env reset and
   random actions, as bench.py): 25 control steps of 4 physics substeps
   plus the kinematic refresh, ctrl from a seeded generator, timed with
   CUDA events after one warm control step; the launch counts, set to 0
   just before and read just after, must show the path went through each
   of its kernels (and through the solve kernel of its cone only);
6. the output is right: finite qpos, no diverged-state resets, and three
   steps of a 64-env Simulation on the card agree with the same steps on
   the CPU (the plain versions) within the step tolerances (E2E_TOL), with
   the same active contact slots in every env.

The g1_forward path seeds and settles the G1 state as the g1 path does,
holds newton_solve_dense against its plain version on the dense inputs of
that state's forward pass, times FORWARD_CALLS forward() calls after a
warm one (launch counts: newton_solve_dense once per call, no other
kernel) with a per-phase breakdown (position, contact, velocity, solve,
writeback), and checks forward() of 64 envs on the card against the CPU
field by field.

Each captured path (after the three above) builds two twins on one seeded
state, sets the launch counts to 0 and captures the second twin's control
step (two eager warm-up steps first, the last with host synchronisation an
error; the counts must show each kernel of the step once per control step
for the three steps the wrappers ran), then: 3 control steps, eager
against replays, within the step tolerances (E2E_TOL) with the same active
contact slots in every env; a masked reset and a per-env friction write
between replays, which the next replay must read (the reset envs restart,
the slots' friction is the mix of the new values); eager and captured
env-steps/s, each the median of CAPTURE_REPEATS x CAPTURE_STEPS control
steps (CUDA events, commands written between steps); one eager and one
captured control step under the profiler (CUDA kernels, device busy ms,
idle share; every kernel of the step must show in the replay). The G1
path then holds the scene's sensors on the card, after 3 replays of 64
envs, against the CPU port's on the same Data (SENSOR_TOL).

The g1_env path builds two envs on one seed (an eager twin and the
captured one), resets both, sets the launch counts to 0 and drives the
captured env's first step() (its two warm-up steps and the capture must
show each kernel once per control step: kin_com 5, the other three 4),
then: the captured env against its eager twin (the same generator state:
the same draws) over 3 more steps, the first after tipping every 7th env
past fell_over's limit and bringing every 11th to its time-out (the same
terminated and truncated envs, reset to episode length 0; observations,
reward and command within ENV_TOL, the state within E2E_TOL, the same
active contact slots); two replays that reset every env draw different
observation noise and reset poses; eager and captured env-steps/s (the
median of CAPTURE_REPEATS x CAPTURE_STEPS control steps); one eager and
one captured step under the profiler (CUDA kernels, busy ms, idle share,
the kernels the env adds over g1_capture's replay); and the env of 64
envs on the card against the CPU port's on the same draws (a reset and
one step).

The line before the last is the card's name and power limit (nvidia-smi);
the lines before hold the kernels, the captured steps and the env (JSON
each), the substep breakdowns and the physics throughputs. The last line is {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when there is no CUDA card (2) and when
mjlab_tpu_torch is not importable, e.g. the script copied alone into an
empty directory (1).
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
PATHS = ("g1", "yam")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# rate outside the tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel vs plain version, float32 (tests/test_torch_stages.py,
# tests/test_torch_solver.py): relative to max(1, |plain|max)
TOL_FRAMES = 2e-6  # kin_com outputs
TOL_SMOOTH = 5e-6  # crb_packed (qM, Mh), vel_smooth
# the solve kernels: phys/solver_kernels.py SOLVE_TOL and FORCE_TOL
# 64 envs x 3 steps on the card against the CPU: the step tolerances of
# tests/test_torch_step.py; under the elliptic cone the contact dynamics
# amplify an f32 difference about 3x per step, so the YAM path takes the
# elliptic multistep tolerances of tests/test_pallas2_solver.py
E2E_TOL = {
    "g1": (("qpos", 1e-4), ("qvel", 1e-3), ("qacc", 5e-3)),
    "yam": (("qpos", 2e-4), ("qvel", 2e-2), ("qacc", 5e-3)),
}

# the forward path: timed forward() calls, and the forward() fields held
# card against CPU on 64 envs (float32 tolerances of the CPU tests,
# tests/test_torch_forward.py; the solve's outputs at the solve
# tolerances, qfrc_constraint at the force tolerance where Newton
# iteration counts may differ by a step)
FORWARD_CALLS = 10
FORWARD_TOL = 5e-5

# the captured control steps: warm-up control steps before capture, the
# control steps held captured against eager, and the timed repeats
CAPTURE_WARMUP = 2
CAPTURE_CHECK_STEPS = 3
CAPTURE_REPEATS = 3
CAPTURE_STEPS = 10
# the G1 sensors on the card against the CPU port on the same Data, float32
SENSOR_TOL = 1e-5
# torch.profiler sessions: how many before a refused one fails, and the wait
# for the last kernel records before a session stops
PROFILE_TRIES = 3
PROFILE_DRAIN_S = 0.02

# the TPU kernels the rows replace
REPLACES = {
    "kin_com": "mjlab_tpu/phys/smooth_pallas.py:237",
    "crb_packed": "mjlab_tpu/phys/smooth_pallas.py:321",
    "vel_smooth": "mjlab_tpu/phys/smooth_pallas.py:389",
    "newton_assemble_solve": "mjlab_tpu/phys/solver_pallas2.py:623",
    "newton_assemble_solve_elliptic": "mjlab_tpu/phys/solver_pallas2.py:623",
    "newton_solve_dense": "mjlab_tpu/phys/solver_pallas.py:255",
}
# the CUDA kernel (entry function) of each row
KERNEL_NAMES = {
    "kin_com": "kin_com_kernel",
    "crb_packed": "crb_packed_kernel",
    "vel_smooth": "vel_smooth_kernel",
    "newton_assemble_solve": "newton_solve_kernel",
    "newton_assemble_solve_elliptic": "newton_solve_elliptic_kernel",
    "newton_solve_dense": "newton_solve_dense_kernel",
}
SOURCES = {
    "kin_com": "mjlab_tpu_torch/csrc/kin_com.cu",
    "crb_packed": "mjlab_tpu_torch/csrc/crb_packed.cu",
    "vel_smooth": "mjlab_tpu_torch/csrc/vel_smooth.cu",
    "newton_assemble_solve": "mjlab_tpu_torch/csrc/newton_solve.cu",
    "newton_assemble_solve_elliptic": "mjlab_tpu_torch/csrc/newton_solve_elliptic.cu",
    "newton_solve_dense": "mjlab_tpu_torch/csrc/newton_solve_dense.cu",
}


def log(*a):
    print(*a, flush=True)


def rel_err(ref: torch.Tensor, got: torch.Tensor) -> float:
    ref = ref.double()
    scale = max(1.0, float(ref.abs().max())) if ref.numel() else 1.0
    return float((ref - got.double()).abs().max()) / scale if ref.numel() else 0.0


def max_abs(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float((ref.double() - got.double()).abs().max()) if ref.numel() else 0.0


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean time of fn over reps calls back to back, CUDA events: for a
    kernel wrapper this includes the host's work between launches (output
    allocations, argument checks), where it is longer than the kernel."""
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


def profiled(run, accept, prepare=None, tries: int = PROFILE_TRIES) -> tuple[list, str | None]:
    """The CUDA kernel records of one call of run() under torch.profiler, and
    None, or the last session's records and why accept refused them. The
    profiler drops a record now and then, on a rare run every record of a
    short session: a session whose records accept refuses (it returns the
    reason, else None) is made again, up to ``tries`` sessions, each after
    prepare(). The session waits PROFILE_DRAIN_S after the last kernel has
    ended before it stops, for the last records to come in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    why = None
    for i in range(tries):
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_DRAIN_S)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        why = accept(kernels)
        if why is None:
            return kernels, None
        log(f"[profiler] session {i + 1} of {tries}: {why}")
    return kernels, why


def kernel_ms(fn, kernel: str, reps: int, warm: int = 1) -> float:
    """Mean device time per launch of the CUDA kernel whose name contains
    ``kernel`` over reps calls of fn, from the profiler's kernel records
    (the kernel's own execution, without the gaps between launches). The
    mean is over the records the profiler kept. Raises when no session kept
    half of them."""
    def launches(kernels):
        return [e.time_range.elapsed_us() for e in kernels if kernel in e.name]

    def accept(kernels):
        n = len(launches(kernels))
        return None if 2 * n >= reps else (
            f"recorded {n} launches of {kernel}, expected {reps}")

    for _ in range(warm):
        fn()
    kernels, why = profiled(lambda: [fn() for _ in range(reps)], accept)
    if why is not None:
        raise RuntimeError(f"the profiler {why}")
    times = launches(kernels)
    return sum(times) / len(times) / 1e3


def cuda_kernels_per_call(fn, reps: int = 10) -> tuple[float, set]:
    """(CUDA kernel records per call, the set of their names, shortened to
    the KERNEL_NAMES entry they contain where there is one) over reps calls
    of fn under the profiler, which may drop a record now and then."""
    fn()
    kernels, why = profiled(lambda: [fn() for _ in range(reps)],
                            lambda ks: None if ks else "recorded no CUDA kernel")
    if why is not None:
        raise RuntimeError(f"the profiler {why}")
    names = [e.name for e in kernels]
    short = {next((k for k in KERNEL_NAMES.values() if k in n), n) for n in names}
    return len(names) / reps, short


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
    # joint's normalisation, 15 for a mocap frame's), xipos 36, com 10,
    # cinert 130; per dof: cdof 20; per collision geom: frame 36 + rotation 90
    njoint_moving = int(np.sum(m.jnt_type != 0))
    nfree = int(np.sum(m.jnt_type == 0))
    return (
        (m.nbody - 1) * 70 + njoint_moving * 135 + 15 * (nfree + m.nmocap)
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


# a dense row's share of the Hessian J^T diag(D) J: D J once (nv), then a
# multiply-add per entry of the lower triangle (nv (nv + 1))
def hessian_row_flops(nv) -> int:
    return nv * (nv + 1) + nv


# one row in one line-search probe: the residual at the step (2), the force
# (1) and the slope's multiply-add (2); the curvature's D v v (3) only in
# the Newton-bisection probes, not in the 12 bracket doublings
SLOPE_ROW_FLOPS, CURVATURE_ROW_FLOPS = 5, 3


def line_search_flops(nrows, ls) -> int:
    return nrows * (12 * SLOPE_ROW_FLOPS + ls * (SLOPE_ROW_FLOPS + CURVATURE_ROW_FLOPS))


def newton_flops(nv, nlim, nlive, nact, iters, ls) -> float:
    """FLOPs of the pyramidal solve for one env: nlive contact rows built
    and carried, nact of them in the quadratic zone (in the Hessian),
    iters Newton iterations. The dof-friction and limit rows are unit
    rows: their Hessian terms are diagonal (nv + nlim)."""
    chol = nv**3 / 3 + 3 * nv * nv
    solve = 4 * nv * nv
    matvec = 2 * nv * nv
    rows = 2 * nv * nlive  # one product of the rows with a vector
    build = 48 * nv * nlive
    cost = 6 * nv + 4 * nlim + 4 * nlive
    setup = chol + solve + 2 * (nv + nlim + rows + matvec + cost)
    hessian = nact * hessian_row_flops(nv) + nv + nlim
    per_iter = (
        matvec + rows + hessian + chol + solve + rows + matvec
        + line_search_flops(nv + nlim + nlive, ls) + matvec + cost
    )
    tail = rows + matvec + chol + solve
    return build + setup + iters * per_iter + tail


def newton_flops_elliptic(nv, nlim, neq, R, nlive, ncon, nblock, iters, ls) -> float:
    """FLOPs of the elliptic solve for one env: nlive contact rows of ncon
    contacts, nblock of them with a nonzero cone block, neq equality
    rows, iters Newton iterations."""
    chol = nv**3 / 3 + 3 * nv * nv
    solve = 4 * nv * nv
    matvec = 2 * nv * nv
    rows = 2 * nv * (nlive + neq)
    state = 5 * R + 15  # one contact's 3-zone state
    cost = 6 * nv + 4 * nlim + ncon * (state + 6) + 5 * neq
    forces = ncon * (state + 8 * R) + rows
    build = 48 * nv * nlive
    setup = chol + solve + 2 * (nv + nlim + rows + matvec + cost)
    hessian = (
        ncon * (state + 12 * R * R) + 2 * nv * nblock * R * R
        + nv * (nv + 1) * R * nblock + 1.5 * nv * nv * neq
    )
    probe = 6 * nv + 5 * nlim + ncon * (state + 10 * R + 10 * R + 15) + 6 * neq
    per_iter = (
        matvec + forces + hessian + chol + solve + rows + matvec
        + (12 + ls) * probe + matvec + cost
    )
    tail = forces + matvec + chol + solve
    return build + setup + iters * per_iter + tail


def dense_flops(nv, nlive, nact, iters, ls) -> float:
    """FLOPs of the dense-Jacobian solve for one env: nlive live rows
    (D != 0) carried, nact of them in the quadratic zone (in the Hessian),
    iters Newton iterations."""
    chol = nv**3 / 3 + 3 * nv * nv
    solve = 4 * nv * nv
    matvec = 2 * nv * nv
    rows = 2 * nv * nlive  # one product of the rows with a vector
    cost = 6 * nv + 8 * nlive
    setup = 2 * (nv + rows + matvec + cost)
    per_iter = (
        matvec + rows + nact * hessian_row_flops(nv) + nv * (nv + 1) / 2
        + chol + solve + rows + matvec + line_search_flops(nlive, ls)
        + matvec + cost
    )
    return setup + iters * per_iter + 4 * nlive


# ---------------------------------------------------------------------------
# the two paths
# ---------------------------------------------------------------------------


def make_sim(path: str, num_envs: int, device: str):
    """A Simulation of the path's model, read from the model file the repo
    keeps (MuJoCo, the model compiler, need not be installed), and the
    path's initial state of one env."""
    from mjlab_tpu_torch.sim.sim import Simulation

    if path == "g1":
        from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

        m, key_qpos, key_ctrl = physics.load_saved_model(device=device)
        state = {"qpos": key_qpos, "ctrl": key_ctrl}
    else:
        from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

        m, state = physics.load_saved_model(device=device)
    return Simulation(num_envs, physics.sim_cfg(), m, device=device), state


def seed_state(sim, path: str, state: dict, seed: int):
    """G1: the keyframe plus numpy noise, ctrl at the keyframe. YAM: half
    the envs at the task's reset state, half pinching the cube, noise on
    the arm. Returns the ctrl the settling holds."""
    m = sim.model
    E = sim.num_envs
    t = lambda x: torch.as_tensor(x, dtype=sim.dtype, device=sim.device)  # noqa: E731
    sim.reset()
    if path == "g1":
        rng = np.random.default_rng(seed)
        qpos = np.tile(state["qpos"], (E, 1))
        qpos[:, 7:] += 0.05 * rng.standard_normal((E, m.nq - 7))
        qpos[:, 2] += 0.02 * rng.standard_normal(E)
        qvel = 0.1 * rng.standard_normal((E, m.nv))
        ctrl = np.tile(state["ctrl"], (E, 1))
        sim.data = sim.data.replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))
    else:
        from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

        batch = physics.task_states(m, state, E, seed)
        sim.data = sim.data.replace(**{k: t(v) for k, v in batch.items()})
    return sim.data.ctrl.clone()


def control_step(sim, ctrl=None):
    if ctrl is not None:
        sim.data = sim.data.replace(ctrl=ctrl)
    for _ in range(DECIMATION):
        sim.step()
    sim.refresh()


def build_kernels():
    from mjlab_tpu_torch import cuda_build

    t0 = time.perf_counter()
    times = cuda_build.build_all()
    log(f"[build] {len(times)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a): " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    for name in cuda_build.SOURCES:
        for k in cuda_build.ptxas_report(name):
            log(f"[build] {name}: {k['kernel']}: {k['registers']} registers, "
                f"{k['stack']} bytes stack frame, {k['spill_stores']} bytes spill "
                f"stores, {k['spill_loads']} bytes spill loads")


def check_kernels(sim, path: str) -> dict:
    """Each kernel of the path against its plain version on the settled
    state: {kernel name: its numbers at the path's shapes}."""
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys import solver_kernels as sv
    from mjlab_tpu_torch.phys.hybrid import (
        contact_stack, has_implicit, mocap_planes, solve_args,
    )
    from mjlab_tpu_torch.phys.lm.base import Params

    m, d = sim.model, sim.data
    E = d.qpos.shape[0]
    nv = m.nv
    qT = d.qpos.T.contiguous()
    vT = d.qvel.T.contiguous()
    ctrlT = d.ctrl.T.contiguous()
    mcT, mcqT = mocap_planes(m, d)
    xfrcT = d.xfrc_applied.permute(1, 2, 0).contiguous()
    qfaT = d.qfrc_applied.T.contiguous()
    out = {}

    def record(name, errs, outs_in_bytes, flops, fn_k, fn_p, reps, abs_err):
        for label, (err, tol) in errs.items():
            log(f"[check] {path} {name} {label}: rel err {err:.3e} (tol {tol:.0e})")
            if not err < tol:
                raise AssertionError(f"{path} {name} {label}: {err:.3e} >= {tol:.0e}")
        ms = kernel_ms(fn_k, KERNEL_NAMES[name], reps)
        wrapper_ms = cuda_ms(fn_k, reps)
        plain_ms = cuda_ms(fn_p, 2)
        b_ms, b_by = bound(outs_in_bytes, flops * E)
        out[name] = dict(
            ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, bytes=outs_in_bytes, flops=flops * E,
            max_abs_err=abs_err, max_rel_err=max(e for e, _ in errs.values()),
        )
        log(f"[time] {path} {name}: kernel {ms:.4f} ms (device, profiler), wrapper "
            f"{wrapper_ms:.4f} ms (back to back, CUDA events), plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")

    # kernel 1: kin_com (with the mocap frames where the model has them)
    outs_k = sk.kin_com(m, qT, mcT, mcqT)
    outs_p = sk.kin_com_plain(m, qT, mcT, mcqT)
    names = ("gxpos", "gxmat", "subcom", "cdof", "cinA", "cinc", "xipos",
             "xpos", "xquat")
    mocap_in = (mcT, mcqT) if m.nmocap else ()
    record("kin_com",
           {n: (rel_err(p, k), TOL_FRAMES) for n, p, k in zip(names, outs_p, outs_k)},
           nbytes(qT, *mocap_in, *outs_k),
           kin_com_flops(m, len(sk.collision_geoms(m))),
           lambda: sk.kin_com(m, qT, mcT, mcqT),
           lambda: sk.kin_com_plain(m, qT, mcT, mcqT), 20,
           max(max_abs(p, k) for p, k in zip(outs_p, outs_k)))
    gxpos, gxmat, subcom, cdof, cinA, cinc, xipos, _, _ = outs_p

    # kernel 3: vel_smooth
    xq = (subcom, xipos, xfrcT, qfaT)
    vs_k = sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    vs_p = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    names = ("qfrc_smooth", "actuator_force", "actuator_velocity", "mh_diag")
    record("vel_smooth",
           {n: (rel_err(p, k), TOL_SMOOTH) for n, p, k in zip(names, vs_p, vs_k)},
           nbytes(qT, vT, ctrlT, cdof, cinA, cinc, subcom, xipos, xfrcT, qfaT, *vs_k),
           vel_smooth_flops(m),
           lambda: sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq),
           lambda: sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq),
           20, max(max_abs(p, k) for p, k in zip(vs_p, vs_k)))
    qfs, _, _, mh_diag = vs_p

    # kernel 2: crb_packed, fused with the dense scatter and the implicit
    # diagonal (crb_dense): the whole crb phase of the step in one launch
    mh = mh_diag if has_implicit(m) else None
    crb_k = sk.crb_dense(m, cdof, cinA, cinc, mh)
    qM_cm, Mh_cm = sk.crb_dense_plain(m, cdof, cinA, cinc, mh)
    errs = {"qM": (rel_err(qM_cm, crb_k[0]), TOL_SMOOTH)}
    if mh is not None:
        errs["Mh"] = (rel_err(Mh_cm, crb_k[1]), TOL_SMOOTH)
    outs = [x for x in crb_k if x is not None]
    record("crb_packed", errs,
           nbytes(cdof, cinA, cinc, *([mh] if mh is not None else []), *outs),
           crb_flops(m, len(sk._crb_pairs(m))),
           lambda: sk.crb_dense(m, cdof, cinA, cinc, mh),
           lambda: sk.crb_dense_plain(m, cdof, cinA, cinc, mh), 20,
           max(max_abs(p, kk) for p, kk in zip((qM_cm, Mh_cm), crb_k) if p is not None))
    per_call, names = cuda_kernels_per_call(lambda: sk.crb_dense(m, cdof, cinA, cinc, mh))
    per_call_p, _ = cuda_kernels_per_call(lambda: sk.crb_dense_plain(m, cdof, cinA, cinc, mh))
    log(f"[check] {path} crb phase: {per_call:.2f} CUDA kernels per call (profiler, 10 "
        f"calls), all {sorted(names)}; the plain version {per_call_p:.1f}")
    if names != {KERNEL_NAMES["crb_packed"]}:
        raise AssertionError(f"{path}: the crb phase launched {sorted(names)}")
    out["crb_packed"]["phase_kernels_per_call"] = per_call

    # kernel 4 / 5: newton_assemble_solve (the path's cone), on the plain
    # versions' inputs
    k = contact_stack(m, Params(m, E), qT, vT, gxpos, gxmat, subcom)
    args, kw = solve_args(m, k, qM_cm, qfs, d.qacc_warmstart.T, vT,
                          cdof.reshape(nv * 6, E), Mh_cm)
    it_k = torch.zeros(E, dtype=torch.int32, device=qT.device)
    it_p = torch.zeros(E, dtype=torch.int32, device=qT.device)
    so_k = sv.newton_assemble_solve(*args, **kw, iters=it_k)
    so_p = sv.newton_assemble_solve_plain(*args, **kw, iters=it_p)
    names = ("qacc", "f_noncontact", "f_contact", "qfrc_constraint",
             "qacc_smooth", "qacc_int")
    S, F = sv.SOLVE_TOL, sv.FORCE_TOL
    tols = (S, F, F, S, S, S)
    errs = {n: (rel_err(p, kk), t) for n, p, kk, t in zip(names, so_p, so_k, tols)}
    # qfrc_constraint under the iteration-count rule (sv.qfrc_errors: under
    # the elliptic cone relative to the row forces' scale); its own scale,
    # the row forces' and the errors on its own scale are printed beside
    same = it_k == it_p
    del errs["qfrc_constraint"]
    force_scale = sv.row_force_scale(so_p)
    row_scale = force_scale if kw["cone"] else 0.0
    for label, e_t in sv.qfrc_errors(so_p[3], so_k[3], it_p, it_k, row_scale).items():
        errs[f"qfrc_constraint, {label}"] = e_t
    own = sv.qfrc_errors(so_p[3], so_k[3], it_p, it_k)
    qfrc_scale = float(so_p[3].abs().max())
    log(f"[check] {path} qfrc_constraint: |qfrc|max {qfrc_scale:.4g}, row forces "
        f"|f|max {force_scale:.4g} (ratio {force_scale / max(1.0, qfrc_scale):.3g}); "
        "on qfrc's own scale: " + ", ".join(f"{k} {e:.3e}" for k, (e, _) in own.items()))
    on = args[20]
    K, R = kw["K"], kw["R"]
    nlive = (on != 0).sum(0).double()
    if kw["cone"]:
        name = "newton_assemble_solve_elliptic"
        ncon = (on[:K] != 0).sum(0).double()
        nblock = (so_p[2][:K] != 0).sum(0).double()
        flops = float(sum(
            newton_flops_elliptic(nv, kw["nlim"], kw["neq"], R, nl, nc, nb, it,
                                  kw["ls_iterations"])
            for nl, nc, nb, it in zip(nlive.tolist(), ncon.tolist(),
                                      nblock.tolist(), it_p.tolist())
        )) / E
        rows_note = (f"contacts mean {float(ncon.mean()):.1f}, with a cone "
                     f"block {float(nblock.mean()):.1f}")
    else:
        name = "newton_assemble_solve"
        nact = (so_p[2] > 0).sum(0).double()
        flops = float(sum(
            newton_flops(nv, kw["nlim"], nl, na, it, kw["ls_iterations"])
            for nl, na, it in zip(nlive.tolist(), nact.tolist(), it_p.tolist())
        )) / E
        rows_note = f"active rows {float(nact.mean()):.1f}"
    shape = sv.newton_launch_shape(kw["cone"], nv, K, R, kw["neq"], kw["nlim"])
    blocks = sv.blocks_per_sm(kw["cone"], R, shape.smem_bytes_per_env)
    log(f"[check] {path} {name}: launch shape {shape.threads_per_env} threads per env, "
        f"{shape.envs_per_block} env per block, {shape.smem_bytes_per_env} bytes of shared "
        f"memory per env; {blocks} envs per SM, {blocks * shape.threads_per_env} resident "
        "threads per SM")
    log(f"[check] {path} {name}: iterations mean {it_k.double().mean():.2f} kernel, "
        f"{it_p.double().mean():.2f} plain, different in {int((~same).sum())} "
        f"of {E} envs; at the {kw['iterations']}-iteration cap {int((it_k == kw['iterations']).sum())} "
        f"kernel, {int((it_p == kw['iterations']).sum())} plain; live contact rows mean "
        f"{float(nlive.mean()):.1f}, {rows_note}")
    in_args = [a for a in args if a.shape[0] > 1]
    record(name, errs, nbytes(*in_args, *so_k), flops,
           lambda: sv.newton_assemble_solve(*args, **kw),
           lambda: sv.newton_assemble_solve_plain(*args, **kw), 10,
           max(max_abs(p, kk) for p, kk in zip(so_p, so_k)))
    out[name]["iteration_counts_differ"] = int((~same).sum())
    out[name]["resident_threads_per_sm"] = blocks * shape.threads_per_env
    return out


def traffic(sim, path: str, state: dict, ctrl0, seed: int):
    """Put the path's traffic on sim; return the function that draws each
    control step's ctrl. G1: the settled state, ctrl0 + 0.3 N(0, 1). YAM:
    the task's own, as bench.py measures it: every env reset to the task's
    reset state (yam.reset_states: home keyframe, the cube where the lifting
    command puts it), then random actions 0.5 N(0, 1) scaled by the task's
    action scale around the home targets, SETTLE_STEPS control steps of it
    before the timed run (bench.py's warm-up chunk)."""
    gen = torch.Generator(device=sim.device).manual_seed(seed)
    t = lambda x: torch.as_tensor(x, dtype=sim.dtype, device=sim.device)  # noqa: E731
    if path == "g1":
        noise = 0.3
    else:
        from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

        sim.reset()
        batch = physics.reset_states(sim.model, state, sim.num_envs, seed)
        sim.data = sim.data.replace(**{k: t(v) for k, v in batch.items()})
        ctrl0 = sim.data.ctrl.clone()
        noise = 0.5 * physics.action_scale(sim.model)

    def random_ctrl():
        return ctrl0 + noise * torch.randn(ctrl0.shape, generator=gen,
                                           device=sim.device)

    if path == "yam":
        for _ in range(SETTLE_STEPS):
            control_step(sim, random_ctrl())
        torch.cuda.synchronize()
        log(f"[traffic] yam: the task's reset and random actions, {SETTLE_STEPS} "
            f"control steps; contacts active per env "
            f"{float(sim.data.con_sel_active.sum(1).double().mean()):.2f}")
    return random_ctrl


def timed_launches(calls) -> dict:
    """Run the callables in ``calls`` timed with CUDA events, every kernel
    wrapper's launch count set to 0 just before and read just after."""
    torch.cuda.synchronize()
    zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for call in calls:
        call()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(launches=read_launches(), dev_ms=start.elapsed_time(end), wall=wall)


def zero_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys import solver_dense_kernels as sd
    from mjlab_tpu_torch.phys import solver_kernels as sv

    for w in (sk.kin_com, sk.crb_dense, sk.vel_smooth, sv.newton_assemble_solve,
              sd.newton_solve_dense):
        w.launches = 0
    sv.newton_assemble_solve.launches_by_cone = [0, 0]


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel row."""
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys import solver_dense_kernels as sd
    from mjlab_tpu_torch.phys import solver_kernels as sv

    by_cone = sv.newton_assemble_solve.launches_by_cone
    return {"kin_com": sk.kin_com.launches, "crb_packed": sk.crb_dense.launches,
            "vel_smooth": sk.vel_smooth.launches, "newton_assemble_solve": by_cone[0],
            "newton_assemble_solve_elliptic": by_cone[1],
            "newton_solve_dense": sd.newton_solve_dense.launches}


def main_path(sim, random_ctrl) -> dict:
    """CONTROL_STEPS control steps with random_ctrl's ctrl after a warm
    one, with launch counts (timed_launches)."""
    control_step(sim, random_ctrl())  # warm
    ctrls = [random_ctrl() for _ in range(CONTROL_STEPS)]
    run = timed_launches([lambda c=c: control_step(sim, c) for c in ctrls])
    return dict(run, random_ctrl=random_ctrl)


def device_profile(step, prepare=None, accept=None) -> dict:
    """One call of ``step`` under torch.profiler (after prepare(), outside
    the session): CUDA kernels launched, their summed device time, and the
    device's idle share between the first kernel's start and the last one's
    end (the profiler slows the host, so this idle share is an upper
    bound). ``accept(profile)`` returns why a profile is refused, else None;
    a refused or empty session is made again (``profiled``). {"kernels": 0,
    "refused": why} when no session passed."""
    profile = {}

    def check(kernels):
        if not kernels:
            return "recorded no CUDA kernel"
        profile.clear()
        profile.update(summarise(kernels))
        return accept(profile) if accept is not None else None

    _, why = profiled(step, check, prepare)
    return profile if why is None else {"kernels": 0, "refused": why}


def summarise(kernels) -> dict:
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    ours = {}
    for row, name in KERNEL_NAMES.items():
        times = [e.time_range.elapsed_us() / 1e3 for e in kernels if name in e.name]
        if times:
            ours[row] = {"launches": len(times), "ms_per_launch": sum(times) / len(times)}
    by_name: dict[str, list] = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"kernels": len(kernels), "busy_ms": busy, "span_ms": span,
            "idle_share": 1.0 - busy / span, "by_kernel": ours,
            "top": [{"name": n[:80], "launches": c, "ms": ms} for n, (c, ms) in top]}


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


def end_to_end_check(path: str, seed: int):
    """3 steps of a 64-env Simulation on the card against the same steps
    on the CPU (the plain versions): the kernels carry the whole step."""
    sims = [make_sim(path, 64, dev) for dev in ("cuda", "cpu")]
    for s, state in sims:
        seed_state(s, path, state, seed + 1)
    sims = [s for s, _ in sims]
    for _ in range(3):
        for s in sims:
            s.step()
    dc, dp = (s.data for s in sims)
    for f, tol in E2E_TOL[path]:
        err = rel_err(getattr(dp, f), getattr(dc, f).cpu())
        log(f"[e2e] {path} 64 envs x 3 steps, card vs CPU: {f} rel err {err:.3e} "
            f"(tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"{path} end-to-end {f}: {err:.3e} >= {tol:.0e}")
    # every env must select the same active contact slots; their order may
    # differ where mirrored slots tie to a few f32 ulps
    sel_c, act_c = dc.con_sel.cpu(), dc.con_sel_active.cpu()
    sel_p, act_p = dp.con_sel, dp.con_sel_active
    same_order = float((sel_c == sel_p).all(dim=1).double().mean())
    differ = [e for e in range(sel_p.shape[0])
              if not torch.equal(sel_c[e][act_c[e]].sort().values,
                                 sel_p[e][act_p[e]].sort().values)]
    log(f"[e2e] {path} envs with the same active contact slots: "
        f"{sel_p.shape[0] - len(differ)} of {sel_p.shape[0]}; in the same order: "
        f"{same_order:.3f}")
    if differ:
        raise AssertionError(f"{path}: envs {differ} select other active slots "
                             "on the card than on the CPU")
    if not bool(torch.isfinite(dc.qpos).all()):
        raise AssertionError(f"{path}: non-finite qpos on the card")


def run_path(path: str) -> tuple[dict, dict, dict]:
    """Phases 2-6 of one path: (kernel numbers, launches, summary)."""
    sim, state = make_sim(path, NUM_ENVS, "cuda")
    m = sim.model
    log(f"[model] {path}: nq {m.nq} nv {m.nv} nu {m.nu} nbody {m.nbody} "
        f"ngeom {m.ngeom} nmocap {m.nmocap} neq {m.neq_jnt}, {m.pairs.ncon} "
        f"contact slots, K {m.ncon_max}, R {m.rows_per_con}, cone "
        f"{int(m.opt.cone)}, nefc {m.nefc}; {NUM_ENVS} envs")
    ctrl0 = seed_state(sim, path, state, SEED)
    for _ in range(SETTLE_STEPS):
        control_step(sim, ctrl0)
    torch.cuda.synchronize()
    log(f"[settle] {path}: {SETTLE_STEPS} control steps; contacts active per "
        f"env {float(sim.data.con_sel_active.sum(1).double().mean()):.1f}")

    kernels = check_kernels(sim, path)

    run = main_path(sim, traffic(sim, path, state, ctrl0, SEED))
    launches = run["launches"]
    substeps = CONTROL_STEPS * DECIMATION
    elliptic = int(m.opt.cone) != 0
    expected = {
        "kin_com": substeps + CONTROL_STEPS, "crb_packed": substeps,
        "vel_smooth": substeps,
        "newton_assemble_solve": 0 if elliptic else substeps,
        "newton_assemble_solve_elliptic": substeps if elliptic else 0,
        "newton_solve_dense": 0,
    }
    log(f"[main] {path} launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"{path} kernel launches {launches} != {expected}")

    d = sim.data
    if not bool(torch.isfinite(d.qpos).all()):
        raise AssertionError(f"{path}: non-finite qpos after the main path")
    resets = int(d.ncheck_reset.sum())
    overflow = int(d.ncon_overflow.sum())
    log(f"[main] {path} diverged-state resets {resets}, contact-slot overflow "
        f"{overflow}; contacts active per env at the end "
        f"{float(d.con_sel_active.sum(1).double().mean()):.2f}")
    if resets:
        raise AssertionError(f"{path}: {resets} diverged-state resets")
    dev_ms = run["dev_ms"]
    env_steps = NUM_ENVS * CONTROL_STEPS / (dev_ms / 1e3)
    log(f"[main] {path} {CONTROL_STEPS} control steps x {DECIMATION} substeps + "
        f"refresh at {NUM_ENVS} envs: {dev_ms:.1f} ms (CUDA events), "
        f"{run['wall'] * 1e3:.1f} ms (host clock); {dev_ms / CONTROL_STEPS:.2f} ms "
        f"per control step")
    log(f"[main] {path} physics env-steps/s at {NUM_ENVS} envs: {env_steps:.1f}")

    parts = breakdown(sim, 4)
    sub = sum(v for k, v in parts.items() if k != "refresh")
    log(f"[breakdown] {path} ms per substep: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items() if k != "refresh")
        + f" (sum {sub:.3f}); refresh {parts['refresh']:.3f} ms per control step")
    ctrl = run["random_ctrl"]()
    prof = device_profile(lambda: control_step(sim, ctrl))
    if prof["kernels"]:
        log(f"[profile] {path} one control step: {prof['kernels']} CUDA kernels, "
            f"device busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms "
            f"span, idle share {prof['idle_share']:.3f} (under the profiler); "
            + ", ".join(f"{k} {v['launches']} x {v['ms_per_launch']:.4f} ms"
                        for k, v in prof["by_kernel"].items()))
    else:
        log(f"[profile] {path}: torch.profiler recorded no CUDA kernels: idle "
            "share not measured")
    del sim, d
    torch.cuda.empty_cache()

    end_to_end_check(path, SEED)
    summary = {"physics_env_steps_per_s": env_steps, "ms_per_control_step":
               dev_ms / CONTROL_STEPS, "ms_per_substep": sub,
               "breakdown_ms_per_substep": parts, "profile": prof}
    return kernels, launches, summary


# ---------------------------------------------------------------------------
# the captured control steps (sim.ControlStep): one CUDA graph per step
# ---------------------------------------------------------------------------


def joint_targets(robot, ctrl: torch.Tensor) -> torch.Tensor:
    """The robot's joint position targets (joint order) whose position
    actuators write ``ctrl`` (actuator order)."""
    joints = [j for a in robot.actuators for j in a.joint_ids]
    target = torch.zeros(ctrl.shape[0], robot.num_joints, device=ctrl.device)
    target[:, joints] = ctrl[:, robot.indexing.ctrl_ids].float()
    return target


def capture_twins(path: str, num_envs: int, seed: int, count: int = 2) -> list[dict]:
    """``count`` Simulations of the path on one seeded state (twins: the
    first to run its control step eagerly, the second captured): the G1's
    env-side step
    (the task's scene: the robot's actuators from joint targets, the
    sensors' update) with the feet's friction per env, as the task's
    startup event leaves it; the YAM's physics step with the fingertips'
    friction per env (lift_cube_env_cfg.py's three startup events) on the
    task's own traffic (every env at its reset state, random actions). Each
    twin: {sim, scene, step, inputs}, inputs(c) writing the control step's
    command c (G1: joint targets; YAM: ctrl)."""
    from mjlab_tpu_torch.sim.sim import ControlStep

    twins = []
    for _ in range(count):
        sim, state = make_sim(path, num_envs, "cuda")
        ctrl0 = seed_state(sim, path, state, seed)
        sim.expand_model_fields(["geom_friction"])
        gf = sim.model.geom_friction
        names = sim.model.geom_names
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if path == "g1":
            from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

            geoms = [i for i, n in enumerate(names) if "_foot" in n and n.startswith("robot/")]
            draw = 0.3 + 0.9 * torch.rand(num_envs, len(geoms), generator=gen, device="cuda")
            gf[:, geoms, 0] = draw
            scene = physics.make_scene(sim)
            robot = scene["robot"]
            robot.data.set_joint_position_target(joint_targets(robot, ctrl0))
            step = physics.control_step(sim, scene)
            inputs = robot.data.set_joint_position_target
        else:
            # the task's own traffic, as the yam path's (bench.py): every
            # env at the task's reset state
            from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

            sim.reset()
            batch = physics.reset_states(sim.model, state, num_envs, seed)
            sim.data = sim.data.replace(**{k: torch.as_tensor(v, dtype=sim.dtype, device="cuda")
                                           for k, v in batch.items()})
            ctrl0 = sim.data.ctrl.clone()
            geoms = [i for i, n in enumerate(names) if n.startswith("robot/")]
            gf[:, geoms, 0] = 0.3 + 1.2 * torch.rand(num_envs, len(geoms), generator=gen,
                                                     device="cuda")
            scene = None
            step = ControlStep(sim, DECIMATION)
            inputs = lambda c, sim=sim: setattr(sim, "data", sim.data.replace(ctrl=c))  # noqa: E731
        twins.append(dict(sim=sim, scene=scene, step=step, inputs=inputs, ctrl0=ctrl0,
                          geoms=geoms))
    return twins


def capture_commands(path: str, twin: dict, steps: int, seed: int) -> list:
    """Seeded commands for ``steps`` control steps: G1 joint targets at the
    keyframe + 0.3 N(0, 1); YAM ctrl at the task's home targets + 0.5 N(0,
    1) times its action scale (the eager paths' traffic)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c0 = twin["ctrl0"]
    if path == "g1":
        robot = twin["scene"]["robot"]
        base = joint_targets(robot, c0)
        return [base + 0.3 * torch.randn(base.shape, generator=gen, device="cuda")
                for _ in range(steps)]
    from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

    scale = 0.5 * physics.action_scale(twin["sim"].model)
    return [c0 + scale * torch.randn(c0.shape, generator=gen, device="cuda")
            for _ in range(steps)]


def assert_twins_agree(path: str, label: str, de, dc) -> dict:
    """The captured twin's Data against the eager one's: the step
    tolerances (E2E_TOL) and the same active contact slots in every env."""
    errs = {}
    for f, tol in E2E_TOL[path]:
        errs[f] = err = rel_err(getattr(de, f), getattr(dc, f))
        log(f"[capture] {path} {label}: {f} rel err {err:.3e} (tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"{path} captured vs eager {label} {f}: {err:.3e} >= {tol:.0e}")
    differ = [e for e in range(de.qpos.shape[0])
              if not torch.equal(de.con_sel[e][de.con_sel_active[e]].sort().values,
                                 dc.con_sel[e][dc.con_sel_active[e]].sort().values)]
    log(f"[capture] {path} {label}: envs with the same active contact slots "
        f"{de.qpos.shape[0] - len(differ)} of {de.qpos.shape[0]}")
    if differ:
        raise AssertionError(f"{path} captured vs eager {label}: envs {differ[:10]} "
                             "select other active slots")
    if int(dc.ncheck_reset.sum()) or not bool(torch.isfinite(dc.qpos).all()):
        raise AssertionError(f"{path} captured {label}: diverged or non-finite state")
    return errs


def timed_control_steps(run, commands) -> float:
    """Milliseconds (CUDA events) of one control step per command, each
    command written just before its step."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for c in commands:
        run(c)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / len(commands)


def sensors_on_card_match_cpu(seed: int) -> dict:
    """The G1 scene's sensors on the card after 3 captured control steps of
    64 envs against the CPU port's sensors on the same Data and state (the
    plain PyTorch path): builtin sensors within SENSOR_TOL relative, the
    contact sensors' found counts and air times equal, the net foot
    forces within SENSOR_TOL."""
    from mjlab_tpu_torch.phys.data import data_from_numpy, tensor_fields
    from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

    twin = capture_twins("g1", 64, seed, count=1)[0]
    sim, scene = twin["sim"], twin["scene"]
    twin["step"].capture(warmup=CAPTURE_WARMUP)
    for c in capture_commands("g1", twin, 3, seed):
        twin["inputs"](c)
        twin["step"].replay()
    torch.cuda.synchronize()
    cpu_sim, _ = make_sim("g1", 64, "cpu")
    cpu_sim.expand_model_fields(["geom_friction"])
    cpu_sim.model.geom_friction.copy_(sim.model.geom_friction.cpu())
    d = sim.data
    cpu_sim.data = data_from_numpy({n: (d.contact.packed if n == "contact" else getattr(d, n))
                                    .cpu().numpy() for n in tensor_fields()}, device="cpu")
    cpu_scene = physics.make_scene(cpu_sim)
    for a, b in zip(cpu_scene.state_tensors(), scene.state_tensors()):
        a.copy_(b.cpu())
    errs = {}
    for name, s in scene.sensors.items():
        got, ref = s.data, cpu_scene[name].data
        if isinstance(got, torch.Tensor):
            errs[name] = rel_err(ref, got.cpu())
            ok = errs[name] < SENSOR_TOL
        else:
            fields = [f for f in ("found", "force", "current_air_time", "last_air_time")
                      if getattr(ref, f) is not None]
            errs[name] = max(rel_err(getattr(ref, f), getattr(got, f).cpu()) for f in fields)
            ok = errs[name] < SENSOR_TOL and all(
                torch.equal(getattr(ref, f), getattr(got, f).cpu())
                for f in fields if f != "force")
        log(f"[capture] g1 sensor {name} on the card vs the CPU port, 64 envs: rel err "
            f"{errs[name]:.3e} (tol {SENSOR_TOL:.0e})")
        if not ok:
            raise AssertionError(f"g1 sensor {name}: card and CPU disagree ({errs[name]:.3e})")
    return errs


def run_capture_path(path: str) -> tuple[dict, dict]:
    """The path's control step captured as one CUDA graph at NUM_ENVS envs:
    (launches, summary). The kernel launch counts are set to 0 just
    before the twins are built and read after the capture: the capture
    records each kernel once per control step (the warm-up steps launch
    them too); replays do not pass through the wrappers, and the profile of
    one replay shows the graph launching them."""
    zero_launches()
    eager, cap = capture_twins(path, NUM_ENVS, SEED)
    t0 = time.perf_counter()
    cap["step"].capture(warmup=CAPTURE_WARMUP)
    capture_s = time.perf_counter() - t0
    launches = read_launches()
    per_step = {k: v / (CAPTURE_WARMUP + 1) for k, v in launches.items()}
    elliptic = path == "yam"
    expected = {
        "kin_com": DECIMATION + 1, "crb_packed": DECIMATION, "vel_smooth": DECIMATION,
        "newton_assemble_solve": 0 if elliptic else DECIMATION,
        "newton_assemble_solve_elliptic": DECIMATION if elliptic else 0,
        "newton_solve_dense": 0,
    }
    log(f"[capture] {path}: captured in {capture_s:.2f} s ({CAPTURE_WARMUP} warm-up "
        f"control steps, the last with host synchronisation an error); launches "
        f"{launches}, per control step {per_step}, expected {expected}")
    if per_step != expected:
        raise AssertionError(f"{path} captured launches per control step {per_step} "
                             f"!= {expected}")

    # captured against eager after CAPTURE_CHECK_STEPS control steps
    commands = capture_commands(path, eager, CAPTURE_CHECK_STEPS + 2 * CAPTURE_STEPS
                                * CAPTURE_REPEATS, SEED + 1)
    check, timed = commands[:CAPTURE_CHECK_STEPS], commands[CAPTURE_CHECK_STEPS:]
    for c in check:
        for t, run in ((eager, eager["step"].eager), (cap, cap["step"].replay)):
            t["inputs"](c)
            run()
    torch.cuda.synchronize()
    errs = assert_twins_agree(path, f"{CAPTURE_CHECK_STEPS} control steps",
                              eager["sim"].data, cap["sim"].data)

    # a masked reset and a friction write between replays: the graph reads
    # the buffers they wrote
    mask = torch.zeros(NUM_ENVS, dtype=torch.bool, device="cuda")
    mask[::3] = True
    draw = torch.linspace(0.35, 1.15, NUM_ENVS, device="cuda")[:, None]
    for t in (eager, cap):
        t["sim"].reset(mask)
        if t["scene"] is not None:
            t["scene"].reset(mask)
        t["sim"].model.geom_friction[:, t["geoms"], 0] = draw
        t["inputs"](check[-1])
    eager["step"].eager()
    cap["step"].replay()
    torch.cuda.synchronize()
    assert_twins_agree(path, "after a masked reset and a friction write",
                       eager["sim"].data, cap["sim"].data)
    d = cap["sim"].data
    dt = cap["sim"].cfg.mujoco.timestep
    if not torch.allclose(d.time[mask], torch.full_like(d.time[mask], DECIMATION * dt)):
        raise AssertionError(f"{path}: the replay did not restart the reset envs")
    # the slots' friction is what the per-env mixing makes of the new
    # values (slot_params, evaluated now, outside the graph)
    from mjlab_tpu_torch.phys.lm.base import Params
    from mjlab_tpu_torch.phys.lm.collision import slot_params

    m = cap["sim"].model
    f5 = slot_params(m, Params(m, NUM_ENVS), d.qpos.dtype)[0][:, 0]  # (S, E)
    sel = d.con_sel.long().T  # (K, E)
    want = torch.gather(f5.expand(-1, NUM_ENVS), 0, sel).T
    pt = m.pairs
    geoms = np.asarray(cap["geoms"])
    on_geom = torch.as_tensor(np.isin(pt.con_geom1, geoms) | np.isin(pt.con_geom2, geoms),
                              device="cuda")[d.con_sel.long()] & d.con_sel_active
    act = d.con_sel_active
    ok = torch.equal(d.con_packed_c[..., 5][act], want[act])
    log(f"[capture] {path}: after the reset, {int(mask.sum())} reset envs at time "
        f"{DECIMATION * dt:.3f} s; the friction of all {int(act.sum())} active slots "
        f"({int(on_geom.sum())} on the written geoms) is the mix of the new values: {ok}")
    if not (ok and bool(on_geom.any())):
        raise AssertionError(f"{path}: the replay did not read the friction write")

    # throughput: eager and captured control steps, CAPTURE_REPEATS repeats
    # of CAPTURE_STEPS each, in turns
    def runner(t, fn):
        def run(c):
            t["inputs"](c)
            fn()
        return run

    ms = {"eager": [], "captured": []}
    for r in range(CAPTURE_REPEATS):
        chunk = timed[2 * r * CAPTURE_STEPS:(2 * r + 2) * CAPTURE_STEPS]
        ms["eager"].append(timed_control_steps(runner(eager, eager["step"].eager),
                                               chunk[:CAPTURE_STEPS]))
        ms["captured"].append(timed_control_steps(runner(cap, cap["step"].replay),
                                                  chunk[CAPTURE_STEPS:]))
    rates = {k: [NUM_ENVS / (v / 1e3) for v in vals] for k, vals in ms.items()}
    med = {k: float(np.median(v)) for k, v in rates.items()}
    for k in ("eager", "captured"):
        log(f"[capture] {path} {k}: env-steps/s at {NUM_ENVS} envs, median of "
            f"{CAPTURE_REPEATS} x {CAPTURE_STEPS} control steps: {med[k]:.1f} (repeats "
            + ", ".join(f"{x:.1f}" for x in rates[k]) + "); ms per control step "
            + ", ".join(f"{x:.3f}" for x in ms[k]))
    c = timed[-1]
    want = {n: v for n, v in expected.items() if v}

    def replay_launched(prof):
        # the profiler may drop a record now and then: every kernel of the
        # step must show, at most as often as the capture recorded it
        seen = {n: v["launches"] for n, v in prof["by_kernel"].items()}
        if set(seen) != set(want) or any(seen[n] > want[n] for n in seen):
            return f"one replay launched {seen}, expected {want}"
        return None

    profiles = {}
    for k, t, fn in (("eager", eager, eager["step"].eager), ("captured", cap, cap["step"].replay)):
        prof = device_profile(fn, prepare=lambda t=t: t["inputs"](c),
                              accept=replay_launched if k == "captured" else None)
        if not prof["kernels"]:
            raise AssertionError(f"{path} {k}: the profiler {prof['refused']}")
        profiles[k] = prof
        log(f"[capture] {path} {k} control step under the profiler: {prof['kernels']} CUDA "
            f"kernels, device busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms "
            f"span, idle share {prof['idle_share']:.3f}; " + ", ".join(
                f"{n} {v['launches']} x {v['ms_per_launch']:.4f} ms"
                for n, v in prof["by_kernel"].items()))
        log(f"[capture] {path} {k}: the CUDA kernels with the most device time: " + "; ".join(
            f"{t['name'][:60]} {t['launches']} x, {t['ms']:.3f} ms" for t in prof["top"]))
    del eager, cap, d
    torch.cuda.empty_cache()
    summary = {"env_steps_per_s": med, "env_steps_per_s_repeats": rates,
               "ms_per_control_step": {k: float(np.median(v)) for k, v in ms.items()},
               "device_ms_per_control_step": {k: p["busy_ms"] for k, p in profiles.items()},
               "idle_share": {k: p["idle_share"] for k, p in profiles.items()},
               "cuda_kernels_per_control_step": {k: p["kernels"] for k, p in profiles.items()},
               "capture_s": capture_s, "launches_per_control_step": per_step,
               "check_rel_err": errs}
    if path == "g1":
        summary["sensor_rel_err_card_vs_cpu"] = sensors_on_card_match_cpu(SEED + 2)
    return launches, summary


# ---------------------------------------------------------------------------
# the env path: the G1 flat-velocity env's step (managers, MDP terms, the
# velocity task) captured as one CUDA graph
# ---------------------------------------------------------------------------

ENV_TASK = "Mjlab-Velocity-Flat-Unitree-G1"
# bench.py's traffic: a fresh action 0.5 N(0, 1) per control step
ENV_ACTION_STD = 0.5
# the env's outputs, captured against eager after ENV_CHECK_STEPS steps
# across resets and the card against the CPU: the step tolerances on the
# state (E2E_TOL), and on what each output reads of it
# (tests/test_torch_env.py): the policy observations and the reward
# qvel's, the critic observations (the feet's contact forces)
# con_force_c's, the command (the heading) qpos's
ENV_TOL = {"policy": 1e-3, "critic": 5e-3, "reward": 1e-3, "command": 1e-4}
ENV_CHECK_STEPS = 3
# the card's env against the CPU port's on the same draws, 64 envs
ENV_CPU_ENVS = 64
# the policy group's terms with noise (base velocities, gravity, joint
# positions and velocities): its first 67 columns, which the critic group
# repeats without noise
NOISY_POLICY_COLUMNS = 3 + 3 + 3 + 29 + 29


def make_env(num_envs: int, device: str, capture: bool = True, seed: int = SEED):
    """The port's env of ENV_TASK, built from the port's registry."""
    import os

    os.environ.setdefault("MJLAB_QUIET", "1")
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    cfg = load_env_cfg(ENV_TASK)
    cfg.scene.num_envs = num_envs
    cfg.seed = seed
    return ManagerBasedRlEnv(cfg, device=device, capture=capture)


def env_actions(env, steps: int, seed: int) -> list:
    gen = torch.Generator(device=env.device).manual_seed(seed)
    A = env.action_manager.total_action_dim
    return [ENV_ACTION_STD * torch.randn(env.num_envs, A, generator=gen, device=env.device)
            for _ in range(steps)]


def force_resets(env, tip: torch.Tensor, late: torch.Tensor) -> None:
    """Tip the ``tip`` envs 80 degrees about x (past fell_over's 70) and set
    the ``late`` envs one step before their time-out: the next step resets
    both sets."""
    import math

    qpos = env.sim.data.qpos.clone()
    a = math.radians(80.0) / 2
    q = torch.tensor([math.cos(a), math.sin(a), 0.0, 0.0], dtype=qpos.dtype, device=qpos.device)
    qpos[tip, 3:7] = q
    env.sim.data = env.sim.data.replace(qpos=qpos)
    env.episode_length_buf[late] = env.max_episode_length - 1


def env_outputs(env, out) -> dict:
    obs, rew, term, trunc, extras = out
    return {"policy": obs["policy"].clone(), "critic": obs["critic"].clone(),
            "reward": rew.clone(), "terminated": term.clone(), "truncated": trunc.clone(),
            "episode_length": env.episode_length_buf.clone(),
            "command": env.command_manager.get_command("twist").clone()}


def assert_envs_agree(label: str, a_env, a: dict, b_env, b: dict) -> dict:
    """Two envs' outputs and Data: equal flags and episode lengths, the
    observations and rewards within ENV_TOL, the state within E2E_TOL and
    the same active contact slots (assert_twins_agree)."""
    for k in ("terminated", "truncated", "episode_length"):
        if not torch.equal(a[k].cpu(), b[k].cpu()):
            raise AssertionError(f"g1_env {label}: {k} differ")
    errs = {}
    for k, tol in ENV_TOL.items():
        errs[k] = rel_err(a[k].cpu(), b[k].cpu())
        if not errs[k] < tol:
            raise AssertionError(f"g1_env {label}: {k} rel err {errs[k]:.3e} >= {tol:.0e}")
    log(f"[env] {label}: " + ", ".join(f"{k} rel err {v:.3e} (tol {ENV_TOL[k]:.0e})"
                                       for k, v in errs.items())
        + f"; terminated {int(a['terminated'].sum())}, truncated "
        f"{int(a['truncated'].sum())} in both")
    da, db = a_env.sim.data, b_env.sim.data
    if da.qpos.device == db.qpos.device:
        errs.update(assert_twins_agree("g1", f"env {label}", da, db))
    return errs


class _HostRng:
    """The env's draws made on the host from one numpy seed and moved to
    the env's device: two envs on different devices draw the same numbers
    (used by the card-against-CPU check only, never captured)."""

    def __init__(self, seed: int, device):
        self.rs = np.random.default_rng(seed)
        self.device = torch.device(device)

    def draw(self, kind, shape, dtype, low=0, high=1):
        if kind == "uniform":
            x = self.rs.random(shape, dtype=np.float32)
        elif kind == "normal":
            x = self.rs.standard_normal(shape, dtype=np.float32)
        else:
            x = self.rs.integers(low, high, shape).astype(np.int32)
        return torch.as_tensor(x, device=self.device).to(dtype)


def env_on_card_matches_cpu(seed: int) -> dict:
    """The env of ENV_CPU_ENVS envs on the card (eager) against the CPU
    port's (the plain versions, held against the JAX env by the CPU
    tests) on the same draws: a reset and one step of bench.py's
    traffic."""
    envs = []
    for dev in ("cuda", "cpu"):
        env = make_env(ENV_CPU_ENVS, dev, capture=False, seed=seed)
        host = _HostRng(seed, dev)
        env.rng.draw = host.draw  # every draw goes through Rng.draw
        envs.append(env)
    card, cpu = envs
    # the draws made at construction (the startup friction, the interval
    # timers) came from each env's own generator: the card's are copied
    cpu.sim.model.geom_friction.copy_(card.sim.model.geom_friction.cpu())
    for name, t in card.event_manager.interval_left.items():
        cpu.event_manager.interval_left[name].copy_(t.cpu())
    for e in envs:
        e.reset()
    act = env_actions(cpu, 1, seed)[0]
    outs = [env_outputs(e, e.step(act.to(e.device))) for e in envs]
    errs = assert_envs_agree(f"card vs CPU, {ENV_CPU_ENVS} envs, reset and one step",
                             cpu, outs[1], card, outs[0])
    dc, dp = card.sim.data, cpu.sim.data
    for f, tol in E2E_TOL["g1"]:
        errs[f] = err = rel_err(getattr(dp, f), getattr(dc, f).cpu())
        log(f"[env] card vs CPU, {ENV_CPU_ENVS} envs, reset and one step: {f} rel err "
            f"{err:.3e} (tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"g1_env card vs CPU {f}: {err:.3e} >= {tol:.0e}")
    return errs


def run_env_path(g1_capture_kernels: int | None) -> tuple[dict, dict]:
    """The G1 flat-velocity env's step at NUM_ENVS envs, captured as one
    CUDA graph: (launches, summary). The launch counts are set to 0 just
    before the captured env's first step() and read after it: its two
    warm-up steps and the capture each run the step once through the
    wrappers (replays do not pass through them; the profile of one replay
    shows the graph launching them)."""
    t0 = time.perf_counter()
    eager, cap = make_env(NUM_ENVS, "cuda", capture=False), make_env(NUM_ENVS, "cuda")
    build_s = time.perf_counter() - t0
    m = cap.sim.model
    log(f"[env] {ENV_TASK} at {NUM_ENVS} envs built from the port's registry in "
        f"{build_s:.2f} s (two envs): action dim {cap.action_manager.total_action_dim}, "
        f"policy obs {cap.observation_manager.group_obs_dim('policy')}, critic obs "
        f"{cap.observation_manager.group_obs_dim('critic')}; nq {m.nq} nv {m.nv} nu {m.nu}; "
        f"decimation {cap.cfg.decimation}, step_dt {cap.step_dt}, max episode length "
        f"{cap.max_episode_length}")
    for e in (eager, cap):
        e.reset()
    if not torch.equal(eager.sim.data.qpos, cap.sim.data.qpos):
        raise AssertionError("g1_env: the twins' resets differ")

    acts = env_actions(cap, 1 + ENV_CHECK_STEPS + 2 * CAPTURE_REPEATS * CAPTURE_STEPS,
                       SEED + 1)
    first, check, timed = acts[0], acts[1:1 + ENV_CHECK_STEPS], acts[1 + ENV_CHECK_STEPS:]

    # the main path: the captured env's first step() captures the graph
    # (CAPTURE_WARMUP eager warm-up steps, then the capture, each through
    # the kernel wrappers) and replays it; the counts are set to 0 just
    # before and read just after
    zero_launches()
    t0 = time.perf_counter()
    oc = env_outputs(cap, cap.step(first))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches = read_launches()
    per_step = {k: v / (CAPTURE_WARMUP + 1) for k, v in launches.items()}
    expected = {"kin_com": DECIMATION + 1, "crb_packed": DECIMATION,
                "vel_smooth": DECIMATION, "newton_assemble_solve": DECIMATION,
                "newton_assemble_solve_elliptic": 0, "newton_solve_dense": 0}
    log(f"[env] the first step() captured the env step and replayed it in {capture_s:.2f} s "
        f"({CAPTURE_WARMUP} warm-up steps, the last with host synchronisation an error); "
        f"launches {launches}, per control step {per_step}, expected {expected}")
    if not cap.captured or per_step != expected:
        raise AssertionError(f"g1_env launches per control step {per_step} != {expected}")
    errs = assert_envs_agree("captured vs eager, the capturing step", eager,
                             env_outputs(eager, eager.step(first)), cap, oc)

    # captured against eager: ENV_CHECK_STEPS steps, the first after
    # tipping some envs and bringing others to their time-out
    E = NUM_ENVS
    idx = torch.arange(E, device="cuda")
    tip, late = idx % 7 == 0, idx % 11 == 3
    for e in (eager, cap):
        force_resets(e, tip, late)
    for i, act in enumerate(check):
        oe = env_outputs(eager, eager.step(act))
        oc = env_outputs(cap, cap.step(act))
        torch.cuda.synchronize()
        if i == 0:
            fell = cap.termination_manager.get_term("fell_over")
            timed_out = cap.termination_manager.get_term("time_out")
            log(f"[env] step 1: fell_over in {int(fell.sum())} envs (tipped "
                f"{int(tip.sum())}), time_out in {int(timed_out.sum())} (set {int(late.sum())}); "
                f"their episode lengths after the reset: "
                f"{int(cap.episode_length_buf[fell | timed_out].max())}")
            if not (bool(fell[tip].all()) and bool(timed_out[late].all())):
                raise AssertionError("g1_env: the tipped or late envs did not terminate")
            if int(cap.episode_length_buf[fell | timed_out].max()) != 0:
                raise AssertionError("g1_env: the done envs were not reset")
        errs = assert_envs_agree(f"captured vs eager, step {i + 1}", eager, oe, cap, oc)
    for k in ("policy", "critic", "reward"):
        if not bool(torch.isfinite(oc[k]).all()):
            raise AssertionError(f"g1_env: non-finite {k}")
    if oc["policy"].shape != (E, 99) or oc["critic"].shape[0] != E:
        raise AssertionError(f"g1_env: obs shapes {oc['policy'].shape}, {oc['critic'].shape}")

    # fresh draws per replay: the policy group's noise (policy obs minus
    # the noise-free critic terms it shares) and the reset poses of envs
    # reset in two consecutive replays
    noise, poses = [], []
    reset_all = torch.ones(E, dtype=torch.bool, device="cuda")
    for _ in range(2):
        force_resets(cap, ~reset_all, reset_all)
        o = cap.step(timed[0])[0]
        noisy = NOISY_POLICY_COLUMNS
        noise.append((o["policy"][:, :noisy] - o["critic"][:, :noisy]).clone())
        poses.append(cap.sim.data.qpos[:, :2].clone() - cap.scene.env_origins[:, :2])
    torch.cuda.synchronize()
    same_noise = float((noise[0] == noise[1]).double().mean())
    same_pose = float((poses[0] == poses[1]).all(1).double().mean())
    log(f"[env] two replays: share of equal policy-noise entries {same_noise:.4f}, of "
        f"envs reset to equal xy offsets {same_pose:.4f}; noise range "
        f"[{float(noise[0].min()):.3f}, {float(noise[0].max()):.3f}], reset xy offsets in "
        f"[{float(poses[1].min()):.3f}, {float(poses[1].max()):.3f}]")
    if same_noise > 0.01 or same_pose > 0.01:
        raise AssertionError("g1_env: two replays drew the same numbers")

    # throughput on bench.py's traffic: eager and captured, in turns
    ms = {"eager": [], "captured": []}
    for r in range(CAPTURE_REPEATS):
        chunk = timed[2 * r * CAPTURE_STEPS:(2 * r + 2) * CAPTURE_STEPS]
        ms["eager"].append(timed_control_steps(eager.step, chunk[:CAPTURE_STEPS]))
        ms["captured"].append(timed_control_steps(cap.step, chunk[CAPTURE_STEPS:]))
    rates = {k: [NUM_ENVS / (v / 1e3) for v in vals] for k, vals in ms.items()}
    med = {k: float(np.median(v)) for k, v in rates.items()}
    for k in ("eager", "captured"):
        log(f"[env] {k}: env-steps/s at {NUM_ENVS} envs, median of {CAPTURE_REPEATS} x "
            f"{CAPTURE_STEPS} control steps: {med[k]:.1f} (repeats "
            + ", ".join(f"{x:.1f}" for x in rates[k]) + "); ms per control step "
            + ", ".join(f"{x:.3f}" for x in ms[k]))

    want = {n: v for n, v in expected.items() if v}

    def replay_launched(prof):
        seen = {n: v["launches"] for n, v in prof["by_kernel"].items()}
        if set(seen) != set(want) or any(seen[n] > want[n] for n in seen):
            return f"one replay launched {seen}, expected {want}"
        return None

    act = timed[-1]
    profiles = {}
    for k, env, accept in (("eager", eager, None), ("captured", cap, replay_launched)):
        prof = device_profile(lambda env=env: env.step(act), accept=accept)
        if not prof["kernels"]:
            raise AssertionError(f"g1_env {k}: the profiler {prof['refused']}")
        profiles[k] = prof
        log(f"[env] {k} env step under the profiler: {prof['kernels']} CUDA kernels, "
            f"device busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span, "
            f"idle share {prof['idle_share']:.3f}; " + ", ".join(
                f"{n} {v['launches']} x {v['ms_per_launch']:.4f} ms"
                for n, v in prof["by_kernel"].items()))
        log(f"[env] {k}: the CUDA kernels with the most device time: " + "; ".join(
            f"{t['name'][:60]} {t['launches']} x, {t['ms']:.3f} ms" for t in prof["top"]))
    added = (None if g1_capture_kernels is None
             else profiles["captured"]["kernels"] - g1_capture_kernels)
    log(f"[env] the managers, terms and resets add {added} CUDA kernels per control step "
        f"over g1_capture's replay ({g1_capture_kernels})")
    del eager, cap
    torch.cuda.empty_cache()
    summary = {"env_steps_per_s": med, "env_steps_per_s_repeats": rates,
               "ms_per_control_step": {k: float(np.median(v)) for k, v in ms.items()},
               "device_ms_per_control_step": {k: p["busy_ms"] for k, p in profiles.items()},
               "idle_share": {k: p["idle_share"] for k, p in profiles.items()},
               "cuda_kernels_per_control_step": {k: p["kernels"] for k, p in profiles.items()},
               "kernels_added_over_g1_capture": added, "capture_s": capture_s,
               "launches_per_control_step": per_step, "check_rel_err": errs,
               "equal_noise_share": same_noise, "equal_reset_pose_share": same_pose,
               "card_vs_cpu_rel_err": env_on_card_matches_cpu(SEED + 3)}
    return launches, summary


# ---------------------------------------------------------------------------
# the forward path: Simulation.forward() of the G1 (kernel 6)
# ---------------------------------------------------------------------------


def check_dense_kernel(sim) -> dict:
    """Kernel 6 against its plain version on the dense inputs of the
    settled state's forward pass: {"newton_solve_dense": its numbers}."""
    from mjlab_tpu_torch.phys import solver_dense_kernels as sd
    from mjlab_tpu_torch.phys import solver_kernels as sv
    from mjlab_tpu_torch.phys.hybrid import forward_stages, solve_dense_inputs

    m = sim.model
    E = sim.num_envs
    d, k, _ = forward_stages(m, sim.data)
    args, kw = solve_dense_inputs(m, k, d)
    it_k = torch.zeros(E, dtype=torch.int32, device=sim.device)
    it_p = torch.zeros(E, dtype=torch.int32, device=sim.device)
    x_k, f_k = sd.newton_solve_dense(*args, **kw, iters=it_k)
    x_p, f_p = sd.newton_solve_dense_plain(*args, **kw, iters=it_p)
    torch.cuda.synchronize()
    Jt = args[0]
    q_k = torch.einsum("vre,re->ve", Jt, f_k)
    q_p = torch.einsum("vre,re->ve", Jt, f_p)
    errs = {"qacc": (rel_err(x_p, x_k), sv.SOLVE_TOL),
            "efc_force": (rel_err(f_p, f_k), sv.FORCE_TOL)}
    for label, e_t in sv.qfrc_errors(q_p, q_k, it_p, it_k).items():
        errs[f"qfrc_constraint, {label}"] = e_t
    for label, (err, tol) in errs.items():
        log(f"[check] g1_forward newton_solve_dense {label}: rel err {err:.3e} "
            f"(tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"g1_forward newton_solve_dense {label}: "
                                 f"{err:.3e} >= {tol:.0e}")
    # live rows (D != 0: the kernel reads and carries only these) and the
    # rows in the quadratic zone at the final residuals (row_quad: every
    # equality row, a dof-friction row below its frictionloss, a one-sided
    # row with a positive force), which stand for every iteration's
    D, fl = args[1], args[3]
    mask = lambda c: torch.as_tensor(c, device=D.device)[:, None]  # noqa: E731
    live = (D != 0) & (mask(kw["os_mask"]) | mask(kw["fr_mask"]) | mask(kw["eq_mask"]))
    quad = live & (D > 0) & (mask(kw["eq_mask"]) | (mask(kw["fr_mask"]) & (f_p.abs() < fl))
                             | (mask(kw["os_mask"]) & (f_p > 0)))
    nlive = live.sum(0).double()
    nact = quad.sum(0).double()
    differ = int((it_k != it_p).sum())
    shape = sd.dense_launch_shape(m.nv, m.nefc, int(nlive.max()))
    blocks = sd.dense_blocks_per_sm(shape.smem_bytes_per_env)
    log(f"[check] g1_forward newton_solve_dense: launch shape {shape.threads_per_env} "
        f"threads per env, {shape.smem_bytes_per_env} bytes of shared memory per env "
        f"({int(nlive.max())} live rows); {blocks} envs per SM, "
        f"{blocks * shape.threads_per_env} resident threads per SM")
    log(f"[check] g1_forward newton_solve_dense: iterations mean "
        f"{it_k.double().mean():.2f} kernel, {it_p.double().mean():.2f} plain, "
        f"different in {differ} of {E} envs; at the {kw['iterations']}-iteration cap "
        f"{int((it_k == kw['iterations']).sum())} kernel, "
        f"{int((it_p == kw['iterations']).sum())} plain; live rows max "
        f"{int(nlive.max())}, mean {float(nlive.mean()):.1f}, rows in the quadratic "
        f"zone {float(nact.mean()):.1f} of {m.nefc}")
    flops = float(sum(
        dense_flops(m.nv, nl, na, it, kw["ls_iterations"])
        for nl, na, it in zip(nlive.tolist(), nact.tolist(), it_p.tolist())
    ))
    # Jt's live rows only: a row with D = 0 adds nothing and is not read
    moved = (nbytes(*args[1:], x_k, f_k)
             + int(live.sum()) * m.nv * Jt.element_size())
    fn_k = lambda: sd.newton_solve_dense(*args, **kw)  # noqa: E731
    ms = kernel_ms(fn_k, KERNEL_NAMES["newton_solve_dense"], 10)
    wrapper_ms = cuda_ms(fn_k, 10)
    plain_ms = cuda_ms(lambda: sd.newton_solve_dense_plain(*args, **kw), 2)
    b_ms, b_by = bound(moved, flops)
    log(f"[time] g1_forward newton_solve_dense: kernel {ms:.4f} ms (device, profiler), "
        f"wrapper {wrapper_ms:.4f} ms (back to back, CUDA events), plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: {moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    return {"newton_solve_dense": dict(
        ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        bytes=moved,
        flops=flops, max_abs_err=max(max_abs(x_p, x_k), max_abs(f_p, f_k)),
        max_rel_err=max(e for e, _ in errs.values()),
        iteration_counts_differ=differ, live_rows_max=int(nlive.max()),
        live_rows_mean=float(nlive.mean()),
        resident_threads_per_sm=blocks * shape.threads_per_env,
    )}


def forward_breakdown(sim, calls: int) -> dict:
    """Device time per phase of forward() (CUDA events at its phase
    marks) and kernel 6's mean Newton iteration count, averaged over
    ``calls`` calls."""
    from mjlab_tpu_torch.phys.hybrid import forward_hybrid

    order = ("position", "contact", "velocity", "solve", "writeback")
    acc = {n: 0.0 for n in order}
    iters = torch.zeros(sim.num_envs, dtype=torch.int32, device=sim.device)
    acc["newton_iterations"] = 0.0
    for _ in range(calls):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append(e)
            marks.append(name)

        sim.data = forward_hybrid(sim.model, sim.data, iters=iters, mark=mark)
        torch.cuda.synchronize()
        for name, a, b in zip(marks, ev[:-1], ev[1:]):
            acc[name] += a.elapsed_time(b)
        acc["newton_iterations"] += float(iters.double().mean())
    return {n: v / calls for n, v in acc.items()}


def forward_op_counts(sim) -> dict:
    """Torch operators dispatched per phase of one forward() call (views
    included: an upper bound on the CUDA kernels each phase launches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from mjlab_tpu_torch.phys.hybrid import forward_hybrid

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    counts, last = {}, [0]

    def mark(name):
        counts[name] = Count.n - last[0]
        last[0] = Count.n

    with Count():
        sim.data = forward_hybrid(sim.model, sim.data, mark=mark)
    torch.cuda.synchronize()
    return counts


def forward_check(seed: int):
    """forward() of 64 settled envs on the card against forward() on the
    CPU (the plain versions) from the same Data."""
    from mjlab_tpu_torch.phys import solver_kernels as sv
    from mjlab_tpu_torch.phys.data import data_from_numpy, tensor_fields

    card, state = make_sim("g1", 64, "cuda")
    seed_state(card, "g1", state, seed)
    for _ in range(3):
        control_step(card)
    cpu, _ = make_sim("g1", 64, "cpu")
    get = lambda d, n: d.contact.packed if n == "contact" else getattr(d, n)  # noqa: E731
    cpu.data = data_from_numpy(
        {n: get(card.data, n).cpu().numpy() for n in tensor_fields()}, device="cpu")
    card.forward()
    cpu.forward()
    dc, dp = card.data, cpu.data
    # the same active contact slots in every env; rows compared row by row
    # in the envs whose slots are in the same order (mirrored slots may
    # tie to a few f32 ulps and swap)
    sel_c, act_c = dc.con_sel.cpu(), dc.con_sel_active.cpu()
    sel_p, act_p = dp.con_sel, dp.con_sel_active
    differ = [e for e in range(64)
              if not torch.equal(sel_c[e][act_c[e]].sort().values,
                                 sel_p[e][act_p[e]].sort().values)]
    if differ:
        raise AssertionError(f"g1_forward: envs {differ} select other active "
                             "slots on the card than on the CPU")
    same = (sel_c == sel_p).all(dim=1) & (act_c == act_p).all(dim=1)
    log(f"[e2e] g1_forward 64 envs, card vs CPU: the same active contact slots "
        f"in all 64, in the same order in {int(same.sum())}")
    if int(same.sum()) < 32:
        raise AssertionError("g1_forward: fewer than half the envs keep the "
                             "CPU's slot order")
    active = dp.efc_active[same]
    checks = (
        ("qacc", sv.SOLVE_TOL, None), ("qacc_smooth", FORWARD_TOL, None),
        ("efc_force", sv.FORCE_TOL, same), ("qfrc_constraint", sv.FORCE_TOL, None),
        ("qM", FORWARD_TOL, None), ("qLD", FORWARD_TOL, None),
        ("efc_D", FORWARD_TOL, same), ("efc_aref", FORWARD_TOL, same),
        ("efc_Jc", FORWARD_TOL, same), ("geom_xpos", FORWARD_TOL, None),
        ("geom_xmat", FORWARD_TOL, None), ("site_xpos", FORWARD_TOL, None),
        ("site_xmat", FORWARD_TOL, None), ("xanchor", FORWARD_TOL, None),
        ("xaxis", FORWARD_TOL, None), ("contact", FORWARD_TOL, None),
    )
    for f, tol, envs in checks:
        ref, got = get(dp, f), get(dc, f).cpu()
        if envs is not None:
            ref, got = ref[envs], got[envs]
        if f == "efc_Jc":  # the contact rows that are active
            on = active[:, -ref.shape[1]:, None]
            ref, got = ref * on, got * on
        err = rel_err(ref, got)
        log(f"[e2e] g1_forward {f}: rel err {err:.3e} (tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"g1_forward {f}: {err:.3e} >= {tol:.0e}")
    if not torch.equal(dp.efc_active[same], dc.efc_active.cpu()[same]):
        raise AssertionError("g1_forward: other active rows on the card")
    if not bool(torch.isfinite(dc.qacc).all()):
        raise AssertionError("g1_forward: non-finite qacc on the card")


def run_forward_path() -> tuple[dict, dict, dict]:
    """The g1_forward path: (kernel numbers, launches, summary)."""
    sim, state = make_sim("g1", NUM_ENVS, "cuda")
    m = sim.model
    log(f"[model] g1_forward: nq {m.nq} nv {m.nv} nefc {m.nefc}, K "
        f"{m.ncon_max}, R {m.rows_per_con}; {NUM_ENVS} envs, Simulation.forward()")
    ctrl0 = seed_state(sim, "g1", state, SEED)
    for _ in range(SETTLE_STEPS):
        control_step(sim, ctrl0)
    torch.cuda.synchronize()
    log(f"[settle] g1_forward: {SETTLE_STEPS} control steps; contacts active per "
        f"env {float(sim.data.con_sel_active.sum(1).double().mean()):.1f}")

    kernels = check_dense_kernel(sim)

    sim.forward()  # warm
    run = timed_launches([sim.forward] * FORWARD_CALLS)
    launches = run["launches"]
    expected = {"kin_com": 0, "crb_packed": 0, "vel_smooth": 0,
                "newton_assemble_solve": 0, "newton_assemble_solve_elliptic": 0,
                "newton_solve_dense": FORWARD_CALLS}
    log(f"[main] g1_forward launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"g1_forward kernel launches {launches} != {expected}")
    d = sim.data
    if not (bool(torch.isfinite(d.qacc).all()) and bool(torch.isfinite(d.efc_force).all())):
        raise AssertionError("g1_forward: non-finite qacc or efc_force")
    ms = run["dev_ms"] / FORWARD_CALLS
    log(f"[main] g1_forward {FORWARD_CALLS} forward() calls at {NUM_ENVS} envs: "
        f"{run['dev_ms']:.1f} ms (CUDA events), {run['wall'] * 1e3:.1f} ms (host "
        f"clock); {ms:.2f} ms per forward()")
    parts = forward_breakdown(sim, 3)
    its = parts.pop("newton_iterations")
    log("[breakdown] g1_forward ms per forward(): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f" (sum {sum(parts.values()):.3f}); "
        f"Newton iterations per env {its:.2f} (warm-started from the previous "
        "forward()'s qacc)")
    ops = forward_op_counts(sim)
    log("[ops] g1_forward torch operators per forward(): " + ", ".join(
        f"{k} {v}" for k, v in ops.items()) + f" (sum {sum(ops.values())})")
    prof = device_profile(sim.forward)
    if prof["kernels"]:
        log(f"[profile] g1_forward one forward(): {prof['kernels']} CUDA kernels, "
            f"device busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms "
            f"span, idle share {prof['idle_share']:.3f} (under the profiler)")
    del sim, d
    torch.cuda.empty_cache()

    forward_check(SEED + 1)
    summary = {"ms_per_forward": ms, "breakdown_ms_per_forward": parts,
               "newton_iterations_per_env": its, "torch_ops_per_phase": ops,
               "profile": prof}
    return kernels, launches, summary


# the kernel rows' numbers: the kernel checks of the path that runs the
# kernel (the G1 physics for kernels 1-4, the YAM for 5, g1_forward for 6),
# and the launches of this slice's main paths, the captured control steps
# (g1_capture, yam_capture; kernel 6: g1_forward)
CHECK_PATH = {"kin_com": "g1", "crb_packed": "g1", "vel_smooth": "g1",
              "newton_assemble_solve": "g1", "newton_assemble_solve_elliptic": "yam",
              "newton_solve_dense": "g1_forward"}
LAUNCH_PATH = {"kin_com": "g1_env", "crb_packed": "g1_env",
               "vel_smooth": "g1_env", "newton_assemble_solve": "g1_env",
               "newton_assemble_solve_elliptic": "yam_capture",
               "newton_solve_dense": "g1_forward"}


def kernel_rows(per_path: dict, launches: dict, per_step: dict) -> list[dict]:
    """One row per kernel: its check's numbers (CHECK_PATH), its launches
    on this slice's main path (LAUNCH_PATH, with the launches per control
    step its capture recorded, ``per_step`` by path), and every path's
    numbers under "per_path"."""
    rows = []
    for name in REPLACES:
        runs = {p: per_path[p][name] for p in per_path if name in per_path[p]}
        top, lp = CHECK_PATH[name], LAUNCH_PATH[name]
        r = runs[top]
        row = dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[lp][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], wrapper_ms=r["wrapper_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, path=top, launch_path=lp,
            **({"launches_per_forward": launches[lp][name] / FORWARD_CALLS}
               if lp == "g1_forward" else
               {"launches_per_control_step": per_step[lp][name]}),
            max_rel_err=r["max_rel_err"], bytes=r["bytes"], flops=r["flops"],
        )
        if "iteration_counts_differ" in r:
            row["iteration_counts_differ"] = r["iteration_counts_differ"]
        row["per_path"] = {p: dict(runs[p], launches=launches[p][name]) for p in runs}
        rows.append(row)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2

    try:
        import mjlab_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the package mjlab_tpu_torch is not importable: run this "
              "script from the root of a checkout of the repository", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    build_kernels()
    if sys.argv[1:2] == ["--only-env"]:
        # a quick run of this slice's path alone: no result line
        run_env_path(None)
        log("[partial] --only-env: the other paths did not run; no result")
        return 0
    per_path, launches, summary = {}, {}, {}
    for path in PATHS:
        per_path[path], launches[path], summary[path] = run_path(path)
    path = "g1_forward"
    per_path[path], launches[path], summary[path] = run_forward_path()
    capture = {}
    for path in PATHS:
        launches[f"{path}_capture"], capture[path] = run_capture_path(path)
    launches["g1_env"], env = run_env_path(
        capture["g1"]["cuda_kernels_per_control_step"]["captured"])
    per_step = {f"{p}_capture": capture[p]["launches_per_control_step"] for p in PATHS}
    per_step["g1_env"] = env["launches_per_control_step"]

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(json.dumps({"kernels": kernel_rows(per_path, launches, per_step)}))
    log(json.dumps({"capture": capture, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"g1_env": env, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"paths": summary, "num_envs": NUM_ENVS,
                    "control_steps": CONTROL_STEPS,
                    "seconds": time.perf_counter() - t_start}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
