#!/usr/bin/env python3
"""Device time of the port's three smooth-stage kernels on one CUDA card.

    python scripts/smooth_kernel_times.py [--root DIR] [--label NAME] [--reps N]
                                          [--per-env FIELD,... | --per-env all]

Imports mjlab_tpu_torch from DIR (default: this checkout), builds its CUDA
sources into DIR/build/kernels, and runs kin_com, crb_packed and
vel_smooth at 4096 envs on the G1 and the YAM models, at a seeded state
(the model's keyframe or initial state plus numpy noise; the kernels' work
does not depend on the state). Each kernel is held against its plain
version (chip_smoke.py's tolerances) and timed by the profiler's kernel
records over N launches (chip_smoke.kernel_ms of this checkout). The crb
phase of a step (crb_dense: the dense qM and qM + the implicit diagonal
from cdof and cinert) is also timed as the sum of every kernel record per
call ("crb_phase", with its kernels per call). DIR must hold crb_dense;
for an older tree, measure from a copy given the same entry point.
The last line is one JSON object with the times, the card's name and
power limit.

Two trees compare on one card in one call, in turns:

    git archive <commit> mjlab_tpu_torch | tar -x -C build/parent
    for r in build/parent . . build/parent; do
        python scripts/smooth_kernel_times.py --root $r; done

--no-check times a copy whose kernels skip work on purpose, without the
comparison: e.g. a copy with `return;` put before a phase of kin_com.cu
and vel_smooth.cu times the phases before it (PERF.md's phase split).

--per-env gives the models the named fields per env (phys/model.py
PER_ENV_SMOOTH_FIELDS; "all" for every one): (E, ...) tensors of the
shared values times 1 + 1 % seeded noise, which the kernels read through
their per-env accessor (csrc/smooth_tree.cuh mcv) and the plain versions
through Params.plane. A tree without per-env fields cannot take it.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parent.parent
E = 4096


def load_chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def inputs(path: str, device):
    """(model, qT, vT, ctrlT, mcT, mcqT, xfrcT, qfaT) at a seeded state."""
    import numpy as np
    import torch

    rng = np.random.default_rng(0)
    if path == "g1":
        from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

        m, qpos, ctrl = physics.load_saved_model(device=device)
    else:
        from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

        m, state = physics.load_saved_model(device=device)
        qpos, ctrl = state["qpos"], state["ctrl"]
    q = np.tile(np.asarray(qpos, np.float64), (E, 1))
    free = 7 if int(m.jnt_type[0]) == 0 else 0
    q[:, free:] += 0.05 * rng.standard_normal((E, m.nq - free))
    f = lambda x: torch.as_tensor(np.ascontiguousarray(x), dtype=torch.float32,  # noqa: E731
                                  device=device)
    qT = f(q.T)
    vT = f(0.1 * rng.standard_normal((m.nv, E)))
    ctrlT = f(np.tile(np.asarray(ctrl, np.float64), (E, 1)).T
              + 0.1 * rng.standard_normal((m.nu, E)))
    body = m.body_pos.detach().cpu().numpy()
    mocap = [b for b in range(m.nbody) if int(m.body_mocapid[b]) >= 0]
    mcT = f(np.repeat(body[mocap][:, :, None], E, axis=2))
    mcqT = f(np.repeat(m.body_quat.detach().cpu().numpy()[mocap][:, :, None], E, axis=2))
    xfrcT = f(0.1 * rng.standard_normal((m.nbody, 6, E)))
    qfaT = f(0.1 * rng.standard_normal((m.nv, E)))
    return m, qT, vT, ctrlT, mcT, mcqT, xfrcT, qfaT


def per_env(m, names):
    """m with ``names`` carried per env: the shared values times 1 + 1 %
    noise, one (E, ...) tensor each."""
    import dataclasses

    import torch

    gen = torch.Generator(device=m.device).manual_seed(1)
    upd = {}
    for n in names:
        v = getattr(m, n)
        shape = (E,) + tuple(v.shape)
        noise = 1 + 0.01 * torch.randn(shape, generator=gen, device=v.device, dtype=v.dtype)
        upd[n] = (v.expand(shape) * noise).contiguous()
    return dataclasses.replace(m, **upd)


def device_ms_per_call(fn, reps: int) -> tuple[float, float]:
    """(device ms per call of fn, CUDA kernels per call): every kernel
    record of reps calls under the profiler, summed, after a warm call."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    times = [e.time_range.elapsed_us() for e in prof.events()
             if e.device_type == DeviceType.CUDA]
    return sum(times) / reps / 1e3, len(times) / reps


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(HERE))
    ap.add_argument("--label", default=None)
    ap.add_argument("--reps", type=int, default=50)
    ap.add_argument("--no-check", action="store_true",
                    help="time only (for builds whose kernels skip work on purpose)")
    ap.add_argument("--per-env", default="",
                    help="model fields carried per env, comma-separated, or 'all'")
    args = ap.parse_args()
    root = Path(args.root).resolve()
    cs = load_chip_smoke()
    sys.path.insert(0, str(root))
    import torch

    if not torch.cuda.is_available():
        print("smooth_kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from mjlab_tpu_torch import cuda_build
    from mjlab_tpu_torch.phys import smooth_kernels as sk

    assert Path(sk.__file__).resolve().is_relative_to(root), sk.__file__
    cuda_build.build_all()
    regs = {name: cuda_build.ptxas_report(name)
            for name in ("kin_com", "crb_packed", "vel_smooth")}
    fields = []
    if args.per_env:
        from mjlab_tpu_torch.phys.model import PER_ENV_SMOOTH_FIELDS

        fields = (sorted(PER_ENV_SMOOTH_FIELDS) if args.per_env == "all"
                  else args.per_env.split(","))
    label = args.label or str(root) + (f" per-env {','.join(fields)}" if fields else "")
    out = {"label": label, "root": str(root), "registers": regs, "per_env": fields}
    for path in ("g1", "yam"):
        m, qT, vT, ctrlT, mcT, mcqT, xfrcT, qfaT = inputs(path, "cuda")
        if fields:
            m = per_env(m, fields)
        kin = sk.kin_com_plain(m, qT, mcT, mcqT)
        _, _, subcom, cdof, cinA, cinc, xipos, _, _ = kin
        xq = (subcom, xipos, xfrcT, qfaT)
        vs_plain = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
        mh = vs_plain[3]
        crb_fn = lambda: sk.crb_dense(m, cdof, cinA, cinc, mh)  # noqa: E731
        crb_plain = sk.crb_dense_plain(m, cdof, cinA, cinc, mh)
        runs = {
            "kin_com": (lambda: sk.kin_com(m, qT, mcT, mcqT), kin, cs.TOL_FRAMES),
            "crb_packed": (crb_fn, crb_plain, cs.TOL_SMOOTH),
            "vel_smooth": (lambda: sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq),
                           vs_plain, cs.TOL_SMOOTH),
        }
        for name, (fn, plain, tol) in runs.items():
            got = fn()
            got = got if isinstance(got, tuple) else (got,)
            plain = plain if isinstance(plain, tuple) else (plain,)
            err = max(cs.rel_err(p, g) for p, g in zip(plain, got))
            if not (err < tol or args.no_check):
                raise AssertionError(f"{path} {name}: rel err {err:.3e} >= {tol:.0e}")
            ms = cs.kernel_ms(fn, cs.KERNEL_NAMES[name], args.reps)
            out[f"{path}.{name}"] = {"ms": ms, "rel_err": err}
            print(f"[time] {out['label']} {path} {name}: {ms:.4f} ms per launch "
                  f"(device, profiler, {args.reps} launches), rel err {err:.2e}",
                  flush=True)
            if name == "crb_packed":
                phase_ms, kernels = device_ms_per_call(fn, args.reps)
                out[f"{path}.crb_phase"] = {"ms": phase_ms, "kernels_per_call": kernels}
                print(f"[time] {out['label']} {path} crb phase: {phase_ms:.4f} ms per call "
                      f"(device, the sum of its kernel records), {kernels:.1f} CUDA "
                      "kernels per call", flush=True)
        del m, qT, vT, ctrlT, kin, runs, vs_plain, crb_plain
        torch.cuda.empty_cache()
    out["device"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
