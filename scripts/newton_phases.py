#!/usr/bin/env python3
"""Cycles by phase of the port's two Newton solve kernels on one CUDA card.

    python scripts/newton_phases.py [--root DIR] [--label NAME]

Builds every CUDA source of DIR/mjlab_tpu_torch (default: this checkout)
with -DNEWTON_PHASES into DIR/build/phase_kernels, which compiles in the
clock64() marks of csrc/newton_phases.cuh, and runs the two solve kernels
on chip_smoke.py's check states at 4096 envs: the G1's settled state
(pyramidal cone, newton_solve.cu) and the YAM's half-pinching mix
(elliptic cone, newton_solve_elliptic.cu). For each it prints the cycles
per env of every phase, the per-iteration phases also per Newton
iteration, and the instrumented kernel's ms per launch (CUDA events), and
last one JSON line with all of it. A tree whose kernels carry the same
marks (csrc/newton_phases.cuh) can be measured with --root, so that two
versions compare in one run on one card.

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
    import torch

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
    qm = sk.crb_packed_plain(m, cdof, cinA, cinc)
    qfs, _, _, mh_diag = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc,
                                             (subcom, xipos, xfrcT, qfaT))
    k = contact_stack(m, Params(m, E), qT, vT, gxpos, gxmat, subcom)
    qM_cm = sk.qm_dense_cm(m, qm)
    Mh_cm = None
    if has_implicit(m):
        Mh_cm = qM_cm.clone()
        Mh_cm[torch.arange(nv, device=qT.device) * (nv + 1)] += mh_diag
    return solve_args(m, k, qM_cm, qfs, d.qacc_warmstart.T, vT,
                      cdof.reshape(nv * 6, E), Mh_cm)


def measure(path: str, cs) -> dict:
    import torch

    from mjlab_tpu_torch import cuda_build
    from mjlab_tpu_torch.phys import solver_kernels as sv

    sim, state = cs.make_sim(path, cs.NUM_ENVS, "cuda")
    ctrl0 = cs.seed_state(sim, path, state, cs.SEED)
    for _ in range(cs.SETTLE_STEPS):
        cs.control_step(sim, ctrl0)
    args, kw = solve_inputs(sim)
    E = sim.num_envs
    iters = torch.zeros(E, dtype=torch.int32, device="cuda")
    lib = cuda_build.library("newton_solve_elliptic" if kw["cone"] else "newton_solve")
    lib.newton_phases_read.argtypes = [ctypes.c_void_p]
    lib.newton_phases_read.restype = ctypes.c_int
    counts = (ctypes.c_ulonglong * (len(PHASES) + 1))()
    sv.newton_assemble_solve(*args, **kw, iters=iters)  # warm
    torch.cuda.synchronize()
    cuda_build.check(lib, lib.newton_phases_read(counts), "newton_phases_read")
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(LAUNCHES):
        sv.newton_assemble_solve(*args, **kw, iters=iters)
    end.record()
    torch.cuda.synchronize()
    cuda_build.check(lib, lib.newton_phases_read(counts), "newton_phases_read")
    total_iters = counts[len(PHASES)]
    per_env = {p: counts[i] / (E * LAUNCHES) for i, p in enumerate(PHASES)}
    per_iter = {p: counts[PHASES.index(p)] / max(1, total_iters) for p in PER_ITERATION}
    return dict(
        kernel="newton_solve_elliptic" if kw["cone"] else "newton_solve",
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
    ap.add_argument("--paths", nargs="+", default=["g1", "yam"])
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

    cuda_build.NVCC_FLAGS = cuda_build.NVCC_FLAGS + ("-DNEWTON_PHASES",)
    cuda_build.BUILD_DIR = root / "build" / "phase_kernels"
    cuda_build.build_all()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    out = {"label": a.label, "root": str(root), "card": smi, "paths": {}}
    for path in a.paths:
        r = measure(path, cs)
        out["paths"][path] = r
        print(f"[phases] {a.label} {path} {r['kernel']}: {r['ms_per_launch']:.4f} ms "
              f"per launch (instrumented), {r['newton_iterations_per_env']:.3f} Newton "
              f"iterations per env, {r['cycles_per_env_total']:.0f} cycles per env",
              flush=True)
        print(f"[phases] {a.label} {path} cycles per env: " + ", ".join(
            f"{p} {v:.0f}" for p, v in r["cycles_per_env"].items()), flush=True)
        print(f"[phases] {a.label} {path} cycles per Newton iteration: " + ", ".join(
            f"{p} {v:.0f}" for p, v in r["cycles_per_newton_iteration"].items()),
            flush=True)
        torch.cuda.empty_cache()
    print(f"[phases] card: {smi}")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
