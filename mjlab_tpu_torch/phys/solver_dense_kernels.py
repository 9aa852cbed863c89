"""Newton constraint solve over a dense, materialised Jacobian, env-last.

PyTorch counterpart of mjlab_tpu/phys/solver_pallas.py
(``newton_solve_pallas_envlast``): the solve of Simulation.forward(), whose
constraint rows (phys/lm/constraint.py with assemble_j) are written out
whole. The CUDA kernel csrc/newton_solve_dense.cu (one env per block of
128 threads, on csrc/newton_block.cuh) and the plain PyTorch version below
share inputs, outputs and arithmetic; the wrapper runs the plain version
for CPU tensors and launches the kernel for CUDA tensors, in the shape
dense_launch_shape gives, and ``newton_solve_dense.launches`` counts kernel
launches.

Every row is dense and carries a class: equality (two-sided quadratic),
dof friction (quadratic inside |f| <= frictionloss, linear outside) or
one-sided (limits and pyramidal contacts: quadratic where the residual is
negative). Numerics follow the TPU kernel: the cheaper of warmstart and
a_smooth by total cost as the start, the exact Hessian M + J^T diag(D q) J,
a Jacobi-equilibrated Cholesky with a 1e-6 ridge (1e-14 at float64, the
JAX package's float64 ridge), 12 doubling probes then max(ls_iterations,
8) safeguarded Newton/bisection line-search steps, a step accepted only
when it is finite and lowers the cost, and an env done when
gnorm^2 < (tolerance nv)^2 or a step is rejected.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mjlab_tpu_torch import cuda_build
from mjlab_tpu_torch.phys.linalg import _EPS, _default_ridge
from mjlab_tpu_torch.phys.solver_kernels import (
    _DOF_VECS_DENSE, _MAX_NV, _ROW_VECS, _SMALL_FLOATS, _SMEM_OPTIN, _THREADS_PER_ENV,
    LaunchShape, _chol_solve,
)

# row classes (the kernel's encoding): equality, dof friction, one-sided,
# and a row of no class, which takes no force
ROW_EQUALITY, ROW_FRICTION, ROW_ONE_SIDED, ROW_NONE = 0, 1, 2, 3


def row_classes(os_mask, fr_mask, eq_mask) -> tuple[int, ...]:
    """Per-row class codes from the three row-class masks (a row is in one
    class at most)."""
    out = []
    for r, flags in enumerate(zip(eq_mask, fr_mask, os_mask)):
        if sum(bool(f) for f in flags) > 1:
            raise ValueError(f"row {r} is in more than one row class")
        cls = [c for c, f in enumerate(flags) if f]
        out.append(cls[0] if cls else ROW_NONE)
    return tuple(out)


def newton_solve_dense_plain(
    Jt, D, aref, fl, M, a_smooth, x_ws, *, nv, nefc, os_mask, fr_mask,
    eq_mask, iterations, ls_iterations, tolerance, iters=None,
):
    """Plain PyTorch newton_solve_dense (same contract)."""
    E = Jt.shape[-1]
    dev, dt = Jt.device, Jt.dtype
    mask = lambda m: torch.as_tensor(m, dtype=dt, device=dev)[:, None]  # noqa: E731
    osm, frm, eqm = mask(os_mask), mask(fr_mask), mask(eq_mask)
    ridge = _default_ridge(dt)

    def row_forces(jar):
        f_quad = -D * jar
        force = (frm * torch.clamp(f_quad, -fl, fl) + eqm * f_quad
                 + osm * torch.where(jar < 0, f_quad, 0.0))
        quad = (frm * (torch.abs(f_quad) <= fl).to(dt) + eqm
                + osm * (jar < 0).to(dt)) * (D > 0).to(dt)
        return force, quad

    def cost_rows(jar):
        quad_cost = 0.5 * D * jar * jar
        lin_cost = fl * torch.abs(jar) - 0.5 * fl * fl / torch.clamp(D, min=_EPS)
        fr_cost = torch.where(torch.abs(D * jar) <= fl, quad_cost, lin_cost)
        os_cost = torch.where(jar < 0, quad_cost, 0.0)
        return torch.sum(frm * fr_cost + eqm * quad_cost + osm * os_cost, dim=0)

    def Mv(vec):
        return torch.einsum("ije,je->ie", M, vec)

    def Jv(vec):
        return torch.einsum("ire,ie->re", Jt, vec)

    def total_cost(x, jar):
        dx = x - a_smooth
        return 0.5 * torch.sum(dx * Mv(dx), dim=0) + cost_rows(jar)

    jar_ws = Jv(x_ws) - aref
    jar_sm = Jv(a_smooth) - aref
    c_ws = total_cost(x_ws, jar_ws)
    c_sm = total_cost(a_smooth, jar_sm)
    take = c_ws < c_sm
    x = torch.where(take, x_ws, a_smooth)
    jar = torch.where(take, jar_ws, jar_sm)
    cost_x = torch.where(take, c_ws, c_sm)
    done = torch.zeros(E, dtype=torch.bool, device=dev)
    n_iter = torch.zeros(E, dtype=torch.int32, device=dev)
    tol2 = (tolerance * nv) ** 2

    it = 0
    while it < iterations and not bool(done.all()):
        n_iter += (~done).to(torch.int32)
        force, quad = row_forces(jar)
        grad = Mv(x - a_smooth) - torch.einsum("ire,re->ie", Jt, force)
        H = M + torch.einsum("ire,jre->ije", Jt, Jt * (D * quad)[None])
        dx = -_chol_solve(H, grad, ridge)

        v = Jv(dx)
        q1 = torch.sum(dx * Mv(x - a_smooth), dim=0)
        q2 = torch.sum(dx * Mv(dx), dim=0)

        def dphi(a, need_h=True):
            f_a, quad_a = row_forces(jar + a * v)
            d1 = q1 + a * q2 - torch.sum(v * f_a, dim=0)
            if not need_h:
                return d1, None
            return d1, q2 + torch.sum(D * quad_a * v * v, dim=0)

        hi = torch.ones_like(q1)
        for _ in range(12):
            g_hi, _ = dphi(hi, need_h=False)
            hi = torch.where(g_hi < 0, hi * 2.0, hi)
        lo = torch.zeros_like(q1)
        a = torch.clamp(hi, max=1.0)
        for _ in range(ls_iterations):
            g, h = dphi(a)
            lo = torch.where(g < 0, a, lo)
            hi = torch.where(g < 0, hi, a)
            a_newton = a - g / torch.clamp(h, min=_EPS)
            inside = (a_newton > lo) & (a_newton < hi)
            a = torch.where(inside, a_newton, 0.5 * (lo + hi))
        alpha = torch.clamp(a, min=0.0)

        step = torch.where(done, 0.0, alpha)
        x_new = x + step * dx
        jar_new = jar + step * v
        cost_new = total_cost(x_new, jar_new)
        ok = torch.isfinite(cost_new) & (cost_new < cost_x)
        x = torch.where(ok, x_new, x)
        jar = torch.where(ok, jar_new, jar)
        cost_x = torch.where(ok, cost_new, cost_x)
        done = done | (torch.sum(grad * grad, dim=0) < tol2) | ~ok
        it += 1

    force, _ = row_forces(jar)
    if iters is not None:
        iters.copy_(n_iter)
    return x, force


@functools.cache
def _class_table(classes: tuple, device: str) -> torch.Tensor:
    """The rows' class codes on the device, copied once."""
    return torch.as_tensor(classes, dtype=torch.int32, device=device)


_MIN_BLOCKS_PER_SM_DENSE = 6  # kMinBlocks of csrc/newton_solve_dense.cu


def dense_launch_shape(nv: int, nefc: int, ncap: int) -> LaunchShape:
    """The dense kernel's launch shape for at most ncap live rows per env:
    one env per block of 128 threads, and the shared memory of its layout
    (csrc/newton_solve_dense.cu dense_env_floats, which the launcher
    checks this against: it refuses another shape). J holds ncap rows, and
    first every row's D and class (2 nefc floats)."""
    if nv > _MAX_NV:
        raise ValueError(f"the solve kernels take at most {_MAX_NV} dofs, got {nv}")
    floats = (
        max(ncap * nv, 2 * nefc) + 2 * nv * nv + (_ROW_VECS + 1) * ncap
        + _DOF_VECS_DENSE * nv + _SMALL_FLOATS + 2 * ncap + nefc
    )
    return LaunchShape(_THREADS_PER_ENV, 1, 4 * floats, _MIN_BLOCKS_PER_SM_DENSE)


def dense_blocks_per_sm(smem_bytes: int) -> int:
    """Envs (blocks) of the dense kernel one SM holds at smem_bytes per env:
    the CUDA occupancy calculator, registers included."""
    f = cuda_build.launcher("newton_solve_dense", "newton_solve_dense_blocks_per_sm",
                            (ctypes.c_int,))
    return int(f(smem_bytes))


def live_rows(D, cls) -> torch.Tensor:
    """(E,) count of each env's live rows, from D (nefc, E) and the rows'
    class codes cls (nefc,): D != 0 and a class (the rows the kernel loads
    and carries)."""
    return ((D != 0) & (cls != ROW_NONE)[:, None]).sum(0)


def newton_solve_dense(
    Jt, D, aref, fl, M, a_smooth, x_ws, *, nv, nefc, os_mask, fr_mask,
    eq_mask, iterations, ls_iterations, tolerance, iters=None,
):
    """Batched Newton solve, every input env-last float32:

    Jt (nv, nefc, E) the constraint Jacobian, D/aref/fl (nefc, E) the rows'
    D, reference acceleration and frictionloss, M (nv, nv, E) the mass
    matrix, a_smooth/x_ws (nv, E) the unconstrained acceleration and the
    warmstart; os_mask/fr_mask/eq_mask (nefc,) static row-class flags
    (one-sided, dof friction, equality). ``iters``, if given, is an (E,)
    int32 tensor that receives each env's Newton iteration count.

    Returns (qacc (nv, E), efc_force (nefc, E)). On the card it launches
    csrc/newton_solve_dense.cu with shared memory for the batch's largest
    live-row count, which costs one read from the device to the host per
    call; ``newton_solve_dense.launches`` counts those launches."""
    kw = dict(nv=nv, nefc=nefc, os_mask=os_mask, fr_mask=fr_mask,
              eq_mask=eq_mask, iterations=iterations,
              ls_iterations=ls_iterations, tolerance=tolerance, iters=iters)
    args = (Jt, D, aref, fl, M, a_smooth, x_ws)
    if not len(os_mask) == len(fr_mask) == len(eq_mask) == nefc:
        raise ValueError(f"the row-class masks must have nefc = {nefc} entries")
    classes = row_classes(os_mask, fr_mask, eq_mask)
    if Jt.device.type == "cpu":
        return newton_solve_dense_plain(*args, **kw)

    E = Jt.shape[-1]
    shapes = dict(Jt=(nv, nefc, E), D=(nefc, E), aref=(nefc, E), fl=(nefc, E),
                  M=(nv, nv, E), a_smooth=(nv, E), x_ws=(nv, E))
    for (name, shape), x in zip(shapes.items(), args):
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected a float32 CUDA tensor")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(f"{name}: expected contiguous {shape}, got {tuple(x.shape)}")
    if iters is not None and (iters.dtype != torch.int32 or tuple(iters.shape) != (E,)
                              or iters.device != Jt.device):
        raise ValueError(f"iters: expected an int32 ({E},) tensor on {Jt.device}")
    dev = Jt.device
    cls = _class_table(classes, str(dev))
    ncap = int(live_rows(D, cls).max()) if E else 0
    shape = dense_launch_shape(nv, nefc, ncap)
    limit = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", _SMEM_OPTIN)
    if shape.smem_bytes_per_env > limit:
        raise ValueError(
            f"one env of this batch needs {shape.smem_bytes_per_env} bytes of shared "
            f"memory ({ncap} live rows), more than a block can have ({limit})"
        )
    x = torch.empty((nv, E), dtype=torch.float32, device=dev)
    force = torch.empty((nefc, E), dtype=torch.float32, device=dev)
    it_out = iters if iters is not None else torch.empty(E, dtype=torch.int32, device=dev)
    vp, ci = ctypes.c_void_p, ctypes.c_int
    P = cuda_build.ptr
    launch = cuda_build.launcher(
        "newton_solve_dense", "newton_solve_dense_launch",
        (vp,) * 11 + (ci,) * 5 + (ctypes.c_float,) + (ci,) * 4 + (vp,),
    )
    rc = launch(
        P(Jt), P(D), P(aref), P(fl), P(M), P(a_smooth), P(x_ws),
        P(cls), P(x), P(force), P(it_out),
        ci(nv), ci(nefc), ci(ncap), ci(iterations), ci(ls_iterations),
        ctypes.c_float(tolerance), ci(E), ci(shape.threads_per_env),
        ci(shape.envs_per_block), ci(shape.smem_bytes_per_env), cuda_build.stream(),
    )
    cuda_build.check(cuda_build.library("newton_solve_dense"), rc, "newton_solve_dense")
    newton_solve_dense.launches += 1
    return x, force


newton_solve_dense.launches = 0
