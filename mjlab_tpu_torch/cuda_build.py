"""Build and load the package's CUDA kernels (csrc/*.cu) with nvcc.

Each source compiles on first use into its own shared library with a
plain C interface, loaded with ctypes. All sources build at once, one nvcc
process each, into ``build/kernels/`` at the repository root (listed in
.gitignore); a library is rebuilt when its source or a header is newer.
Nothing here runs at import time.
"""

from __future__ import annotations

import ctypes
import functools
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "kernels"
SOURCES = (
    "kin_com", "crb_packed", "vel_smooth", "newton_solve", "newton_solve_elliptic",
    "newton_solve_dense",
)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v", "-lineinfo",
)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA toolkit is required")


def _stale(src: Path, lib: Path) -> bool:
    if not lib.exists():
        return True
    newest = max(
        [src.stat().st_mtime]
        + [h.stat().st_mtime for h in CSRC.glob("*.cuh")]
    )
    return lib.stat().st_mtime < newest


def build_all() -> dict[str, float]:
    """Compile every stale source in parallel; return {name: seconds}
    (0.0 for an up-to-date library). Raises with nvcc's output on a
    failure. ptxas reports go to build/kernels/<name>.log."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    t0 = time.perf_counter()
    for name in SOURCES:
        src = CSRC / f"{name}.cu"
        lib = BUILD_DIR / f"lib{name}.so"
        if not _stale(src, lib):
            continue
        tmp = BUILD_DIR / f"lib{name}.so.tmp{os.getpid()}"
        log = open(BUILD_DIR / f"{name}.log", "w")
        procs[name] = (
            subprocess.Popen(
                [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(src)],
                stdout=log, stderr=subprocess.STDOUT,
            ),
            log, tmp, lib,
        )
    times = {name: 0.0 for name in SOURCES}
    failed = []
    for name, (proc, log, tmp, lib) in procs.items():
        rc = proc.wait()
        log.close()
        times[name] = time.perf_counter() - t0
        if rc != 0:
            failed.append(name)
            continue
        os.replace(tmp, lib)
    if failed:
        msgs = [
            f"--- {n} ---\n" + (BUILD_DIR / f"{n}.log").read_text()
            for n in failed
        ]
        raise RuntimeError("nvcc failed:\n" + "\n".join(msgs))
    return times


def ptxas_report(name: str) -> list[dict]:
    """What ptxas printed for each kernel (entry function) of a source's
    build: [{"kernel", "registers", "stack", "spill_stores",
    "spill_loads"}] (bytes for the last three)."""
    log = BUILD_DIR / f"{name}.log"
    if not log.exists():
        return []
    out, entry, props = [], None, {}
    for ln in log.read_text().splitlines():
        if "Compiling entry function" in ln:
            entry = ln.split("'")[1]
            props = {}
        elif "Function properties for" in ln:
            props = {"for": ln.split("for", 1)[1].strip()}
        elif "bytes stack frame" in ln:
            n = [int(w) for w in ln.replace(",", " ").split() if w.isdigit()]
            props.update(stack=n[0], spill_stores=n[1], spill_loads=n[2])
        elif "Used" in ln and "registers" in ln and entry is not None:
            regs = int(ln.split("Used", 1)[1].split()[0])
            out.append(dict(kernel=entry, registers=regs, stack=props.get("stack", 0),
                            spill_stores=props.get("spill_stores", 0),
                            spill_loads=props.get("spill_loads", 0)))
            entry = None
    return out


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name`` (building all sources first)."""
    build_all()
    lib = ctypes.CDLL(str(BUILD_DIR / f"lib{name}.so"))
    lib.mjt_error_string.restype = ctypes.c_char_p
    lib.mjt_error_string.argtypes = [ctypes.c_int]
    return lib


@functools.cache
def launcher(name: str, fn: str, argtypes: tuple) -> ctypes._CFuncPtr:
    """The C launcher ``fn`` of library ``name`` with its argument types
    declared; it returns cudaGetLastError() as an int."""
    f = getattr(library(name), fn)
    f.argtypes = list(argtypes)
    f.restype = ctypes.c_int
    return f


def check(lib: ctypes.CDLL, rc: int, what: str) -> None:
    """Raise if a launcher returned a CUDA error (cudaGetLastError)."""
    if rc != 0:
        msg = lib.mjt_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def ptr(t) -> ctypes.c_void_p:
    return ctypes.c_void_p(t.data_ptr())


def stream() -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream().cuda_stream)
