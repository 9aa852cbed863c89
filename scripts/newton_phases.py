#!/usr/bin/env python3
"""Cycles by phase of the port's three Newton solve kernels on one CUDA card.

    python scripts/newton_phases.py [--root DIR] [--label NAME] [--paths ...]

Builds every CUDA source of DIR/mjlab_tpu_torch (default: this checkout)
with -DNEWTON_PHASES into DIR/build/phase_kernels, which compiles in the
clock64() marks of csrc/newton_phases.cuh, and runs the solve kernels on
chip_smoke.py's check states at 4096 envs: the G1's settled state
(pyramidal cone, newton_solve.cu), the YAM's half-pinching mix (elliptic
cone, newton_solve_elliptic.cu) and the dense inputs of the settled G1's
forward pass (g1_forward, newton_solve_dense.cu; its live rows per env
are printed too). For each it prints the cycles per env of every phase,
the per-iteration phases also per Newton iteration, and the instrumented
kernel's ms per launch (CUDA events), and last one JSON line with all of
it. A tree whose kernels carry the same marks (csrc/newton_phases.cuh) can
be measured with --root, so that two versions compare in one run on one
card. With --times the sources build without the marks (into
DIR/build/kernels) and each kernel's device time per launch is read from
the profiler's kernel records (chip_smoke.kernel_ms), and on g1_forward
also the ms per Simulation.forward() (20 calls, CUDA events and the host's
clock), for paired timings:

    for r in build/parent . . build/parent; do
        python scripts/newton_phases.py --times --root $r; done

Cycles are the SM clock read by thread 0 of an env's block, so a phase's
count includes the time the block waits while other blocks on its SM run.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

PHASES = ("load", "smooth", "init", "grad", "hess", "factor", "dir", "doubling",
          "bisect", "accept", "out")
PER_ITERATION = ("grad", "hess", "factor", "dir", "doubling", "bisect", "accept")
LAUNCHES = 5


def solve_inputs(sim):
    """The solve's inputs on the settled state, as chip_smoke.py's
    check_kernels builds them (the plain smooth stages, the contact stack)."""
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys.hybrid import (
        contact_stack, has_implicit, mocap_planes, solve_args,
    )
    from mjlab_tpu_torch.phys.lm.base import Params

    m, d = sim.model, sim.data
    E, nv = d.qpos.shape[0], m.nv
    qT, vT, ctrlT = (x.T.contiguous() for x in (d.qpos, d.qvel, d.ctrl))
    mcT, mcqT = mocap_planes(m, d)
    xfrcT = d.xfrc_applied.permute(1, 2, 0).contiguous()
    qfaT = d.qfrc_applied.T.contiguous()
    gxpos, gxmat, subcom, cdof, cinA, cinc, xipos, _, _ = sk.kin_com_plain(m, qT, mcT, mcqT)
    qfs, _, _, mh_diag = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc,
                                             (subcom, xipos, xfrcT, qfaT))
    k = contact_stack(m, Params(m, E), qT, vT, gxpos, gxmat, subcom)
    qM_cm, Mh_cm = sk.crb_dense_plain(m, cdof, cinA, cinc,
                                      mh_diag if has_implicit(m) else None)
    return solve_args(m, k, qM_cm, qfs, d.qacc_warmstart.T, vT,
                      cdof.reshape(nv * 6, E), Mh_cm)


def dense_inputs(sim):
    """Kernel 6's inputs on the settled state's forward pass, as
    chip_smoke.py's check_dense_kernel builds them, and each env's live
    rows (D != 0)."""
    from mjlab_tpu_torch.phys.hybrid import forward_stages, solve_dense_inputs

    d, k, _ = forward_stages(sim.model, sim.data)
    args, kw = solve_dense_inputs(sim.model, k, d)
    return args, kw, (args[1] != 0).sum(0)


def forward_ms(sim, calls: int = 20) -> dict:
    """ms per Simulation.forward() over `calls` calls back to back after a
    warm call, on the CUDA events' clock and on the host's."""
    import time

    import torch

    sim.forward()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for _ in range(calls):
        sim.forward()
    end.record()
    torch.cuda.synchronize()
    return dict(forward_ms=start.elapsed_time(end) / calls,
                forward_host_ms=(time.perf_counter() - t0) * 1e3 / calls)


KERNEL_ROWS = {"newton_solve": "newton_assemble_solve",
               "newton_solve_elliptic": "newton_assemble_solve_elliptic",
               "newton_solve_dense": "newton_solve_dense"}


def measure(path: str, cs, times: bool = False) -> dict:
    import torch

    from mjlab_tpu_torch import cuda_build
    from mjlab_tpu_torch.phys import solver_kernels as sv

    from mjlab_tpu_torch.phys import solver_dense_kernels as sd

    dense = path == "g1_forward"
    sim, state = cs.make_sim("g1" if dense else path, cs.NUM_ENVS, "cuda")
    ctrl0 = cs.seed_state(sim, "g1" if dense else path, state, cs.SEED)
    for _ in range(cs.SETTLE_STEPS):
        cs.control_step(sim, ctrl0)
    E = sim.num_envs
    extra = {}
    if dense:
        args, kw, live = dense_inputs(sim)
        extra = dict(live_rows_max=int(live.max()), live_rows_mean=float(live.double().mean()),
                     nefc=sim.model.nefc)
        kernel = "newton_solve_dense"
        solve = sd.newton_solve_dense
    else:
        args, kw = solve_inputs(sim)
        kernel = "newton_solve_elliptic" if kw["cone"] else "newton_solve"
        solve = sv.newton_assemble_solve
    iters = torch.zeros(E, dtype=torch.int32, device="cuda")
    if times:
        ms = cs.kernel_ms(lambda: solve(*args, **kw, iters=iters),
                          cs.KERNEL_NAMES[KERNEL_ROWS[kernel]], 2 * LAUNCHES)
        if dense:
            extra.update(forward_ms(sim))
        return dict(kernel=kernel, **extra, envs=E, ms_per_launch=ms,
                    newton_iterations_per_env=float(iters.double().mean()))
    lib = cuda_build.library(kernel)
    lib.newton_phases_read.argtypes = [ctypes.c_void_p]
    lib.newton_phases_read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    solve(*args, **kw, iters=iters)  # warm
    torch.cuda.synchronize()
    cuda_build.check(lib, lib.newton_phases_read(counts), "newton_phases_read")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        solve(*args, **kw, iters=iters)
    end.record()
    torch.cuda.synchronize()
    cuda_build.check(lib, lib.newton_phases_read(counts), "newton_phases_read")
    total_iters = counts[len(PHASES)]
    per_env = {p: counts[i] / (E * LAUNCHES) for i, p in enumerate(PHASES)}
    per_iter = {p: counts[PHASES.index(p)] / max(1, total_iters) for p in PER_ITERATION}
    return dict(
        kernel=kernel, **extra,
        envs=E, launches=LAUNCHES, ms_per_launch=start.elapsed_time(end) / LAUNCHES,
        newton_iterations_per_env=total_iters / (E * LAUNCHES),
        cycles_per_env=per_env, cycles_per_env_total=sum(per_env.values()),
        cycles_per_newton_iteration=per_iter,
    )


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parents[1]),
                    help="tree holding chip_smoke.py and mjlab_tpu_torch")
    ap.add_argument("--label", default="this")
    ap.add_argument("--paths", nargs="+", default=["g1", "yam", "g1_forward"])
    ap.add_argument("--times", action="store_true",
                    help="build without the marks; device ms per launch only")
    a = ap.parse_args()
    root = Path(a.root).resolve()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("newton_phases: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke as cs
    from mjlab_tpu_torch import cuda_build

    if not a.times:
        cuda_build.NVCC_FLAGS = cuda_build.NVCC_FLAGS + ("-DNEWTON_PHASES",)
        cuda_build.BUILD_DIR = root / "build" / "phase_kernels"
    cuda_build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    out = {"label": a.label, "root": str(root), "card": smi, "paths": {}}
    for path in a.paths:
        r = measure(path, cs, a.times)
        out["paths"][path] = r
        torch.cuda.empty_cache()
        if a.times:
            print(f"[times] {a.label} {path} {r['kernel']}: {r['ms_per_launch']:.4f} ms per "
                  f"launch (device, profiler), {r['newton_iterations_per_env']:.3f} Newton "
                  "iterations per env", flush=True)
            if "forward_ms" in r:
                print(f"[times] {a.label} {path} forward(): {r['forward_ms']:.4f} ms per call "
                      f"(CUDA events), {r['forward_host_ms']:.4f} ms (host clock)", flush=True)
            continue
        print(f"[phases] {a.label} {path} {r['kernel']}: {r['ms_per_launch']:.4f} ms "
              f"per launch (instrumented), {r['newton_iterations_per_env']:.3f} Newton "
              f"iterations per env, {r['cycles_per_env_total']:.0f} cycles per env",
              flush=True)
        if "live_rows_max" in r:
            print(f"[phases] {a.label} {path} live rows per env: max {r['live_rows_max']}, "
                  f"mean {r['live_rows_mean']:.1f} of nefc {r['nefc']}", flush=True)
        print(f"[phases] {a.label} {path} cycles per env: " + ", ".join(
            f"{p} {v:.0f}" for p, v in r["cycles_per_env"].items()), flush=True)
        print(f"[phases] {a.label} {path} cycles per Newton iteration: " + ", ".join(
            f"{p} {v:.0f}" for p, v in r["cycles_per_newton_iteration"].items()),
            flush=True)
    print(f"[phases] card: {smi}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
