"""Fused contact-Jacobian assembly + Newton constraint solve, env-last.

PyTorch counterpart of mjlab_tpu/phys/solver_pallas2.py
(``newton_assemble_solve``), pyramidal cone. The CUDA kernel
(csrc/newton_solve.cu, one warp per env) and the plain PyTorch version
below share inputs, outputs and arithmetic; the wrapper runs the plain
version for CPU tensors and launches the kernel for CUDA tensors, and
``newton_assemble_solve.launches`` counts kernel launches.

Row layout: [dof friction (nv), joint limits (nlim), contacts r-major]
(row r of every slot contiguous). The friction rows are the identity and
a limit row is one signed entry at a static dof, so only the contact rows
are dense. Numerics follow the TPU kernel: exact Hessian, Jacobi-
equilibrated Cholesky with a 1e-6 ridge, 12 doubling probes then
safeguarded Newton/bisection line-search steps, early exit on a small
gradient or a step that does not lower the cost.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from mjlab_tpu_torch import cuda_build

_EPS = 1e-12
_RIDGE = 1e-6


def _chol_solve(A: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """Solve A x = g for SPD A (nv, nv, E) with g (nv, E): Jacobi-scaled
    column Cholesky with a ridge (solver_pallas2.py chol_solve)."""
    nv = g.shape[0]
    diag = torch.stack([A[j, j] for j in range(nv)])
    scale = torch.rsqrt(torch.clamp(diag, min=_EPS))
    g = g * scale
    rows = torch.arange(nv, device=g.device)[:, None]
    L = []
    for j in range(nv):
        s = A[:, j] * (scale * scale[j])
        s = s + torch.where(rows == j, _RIDGE, 0.0)
        for k in range(j):
            s = s - L[k] * L[k][j]
        dcol = torch.sqrt(torch.clamp(s[j], min=_RIDGE))
        L.append(torch.where(rows >= j, s / dcol, 0.0))
    r = g
    ys = []
    for j in range(nv):
        yj = r[j] / L[j][j]
        r = r - L[j] * yj
        ys.append(yj)
    xs = [None] * nv
    xacc = torch.zeros_like(g)
    for k in reversed(range(nv)):
        s = torch.sum(L[k] * xacc, dim=0)
        xs[k] = (ys[k] - s) / L[k][k]
        xacc = torch.where(rows == k, xs[k], xacc)
    return torch.stack(xs) * scale


def newton_assemble_solve_plain(
    Mc, qfrc_smooth, x_ws, qvel, Mh, Dnc, arefnc, flnc, side, Jeq,
    cdof, pos_k, O1, O2, frame_k, mu_dirs, mut, Dc, bb, kimp, on_rm,
    W1, W2, *, nv, K, R, ndirs, neq, nlim, lim_dofs, iterations,
    ls_iterations, tolerance, do_int, cone=0, iters=None,
):
    """Plain PyTorch newton_assemble_solve (same contract)."""
    E = qvel.shape[-1]
    RK = R * K
    on = on_rm
    M = Mc.reshape(nv, nv, E)  # (column j, row i) == (i, j): symmetric

    # ---------- phase A: dense contact rows, r-major ----------
    cd = cdof.reshape(nv, 6, E)
    posk = pos_k.reshape(3, K, E)
    r1 = posk - O1.reshape(3, K, E)
    r2 = posk - O2.reshape(3, K, E)
    w1 = W1.reshape(nv, K, E)
    w2 = W2.reshape(nv, K, E)
    jd = []
    for c in range(3):
        c1, c2 = (c + 1) % 3, (c + 2) % 3
        a1 = cd[:, c1][:, None]
        a2 = cd[:, c2][:, None]
        lin = cd[:, 3 + c][:, None]
        j2 = lin + a1 * r2[c2] - a2 * r2[c1]
        j1 = lin + a1 * r1[c2] - a2 * r1[c1]
        jd.append(j2 * w2 - j1 * w1)  # (nv, K, E)
    fr = frame_k.reshape(9, K, E)
    f3 = [fr[3 * f] * jd[0] + fr[3 * f + 1] * jd[1] + fr[3 * f + 2] * jd[2]
          for f in range(3)]
    onr = on.reshape(R, K, E)
    mu = mu_dirs.reshape(ndirs, K, E)
    pieces = [None] * R
    for j in range(ndirs):
        pieces[2 * j] = onr[2 * j] * (f3[0] + mu[j] * f3[1 + j])
        pieces[2 * j + 1] = onr[2 * j + 1] * (f3[0] - mu[j] * f3[1 + j])
    J = torch.stack(pieces, dim=1).reshape(nv, RK, E)

    Dd = (onr * Dc[None]).reshape(RK, E)
    velc = torch.sum(J * qvel[:, None, :], dim=0)
    arefd = (onr * (-bb[None] * velc.reshape(R, K, E) - kimp[None])).reshape(RK, E)

    # ---------- phase B: Newton ----------
    D_fr, aref_fr, fl_fr = Dnc[:nv], arefnc[:nv], flnc[:nv]
    D_lim, aref_lim = Dnc[nv:nv + nlim], arefnc[nv:nv + nlim]
    lim_idx = torch.as_tensor(list(lim_dofs), device=qvel.device,
                              dtype=torch.long)

    def Mv(vec):
        return torch.einsum("ije,je->ie", M, vec)

    def lim_mul(vec):
        return side * vec[lim_idx]

    def lim_scatter(f_lim):
        return torch.zeros_like(qvel).index_add(0, lim_idx, side * f_lim)

    def JT_all(f_fr, f_lim, f_d):
        return f_fr + torch.sum(J * f_d[None], dim=1) + lim_scatter(f_lim)

    def forces(jf, jl, jdd):
        fq_fr = -D_fr * jf
        f_fr = torch.clamp(fq_fr, -fl_fr, fl_fr)
        q_fr = ((torch.abs(fq_fr) <= fl_fr) & (D_fr > 0)).to(jf.dtype)
        fq_l = -D_lim * jl
        f_lim = torch.where(jl < 0, fq_l, 0.0)
        q_lim = ((jl < 0) & (D_lim > 0)).to(jf.dtype)
        fq_d = -Dd * jdd
        f_d = torch.where(jdd < 0, fq_d, 0.0)
        q_d = ((jdd < 0) & (Dd > 0)).to(jf.dtype)
        return f_fr, f_lim, f_d, q_fr, q_lim, q_d

    def cost_rows(jf, jl, jdd):
        qc_fr = 0.5 * D_fr * jf * jf
        lin = fl_fr * torch.abs(jf) - 0.5 * fl_fr * fl_fr / torch.clamp(D_fr, min=_EPS)
        c_fr = torch.where(torch.abs(D_fr * jf) <= fl_fr, qc_fr, lin)
        c_lim = torch.where(jl < 0, 0.5 * D_lim * jl * jl, 0.0)
        c_d = torch.where(jdd < 0, 0.5 * Dd * jdd * jdd, 0.0)
        return c_fr.sum(0) + c_lim.sum(0) + c_d.sum(0)

    def jar_of(x):
        return (x - aref_fr, lim_mul(x) - aref_lim,
                torch.sum(J * x[:, None, :], dim=0) - arefd)

    def total_cost(x, jars):
        dx = x - a_smooth
        return 0.5 * torch.sum(dx * Mv(dx), dim=0) + cost_rows(*jars)

    a_smooth = _chol_solve(M, qfrc_smooth)
    jars_ws = jar_of(x_ws)
    jars_sm = jar_of(a_smooth)
    c_ws = total_cost(x_ws, jars_ws)
    c_sm = total_cost(a_smooth, jars_sm)
    take = c_ws < c_sm
    x = torch.where(take, x_ws, a_smooth)
    jar_fr, jar_lim, jar_d = (
        torch.where(take, a, b) for a, b in zip(jars_ws, jars_sm)
    )
    cost_x = torch.where(take, c_ws, c_sm)
    done = torch.zeros(E, dtype=torch.bool, device=qvel.device)
    n_iter = torch.zeros(E, dtype=torch.int32, device=qvel.device)
    tol2 = (tolerance * nv) ** 2
    rows = torch.arange(nv, device=qvel.device)

    it = 0
    while it < iterations and not bool(done.all()):
        n_iter += (~done).to(torch.int32)
        f_fr, f_lim, f_d, q_fr, q_lim, q_d = forces(jar_fr, jar_lim, jar_d)
        grad = Mv(x - a_smooth) - JT_all(f_fr, f_lim, f_d)
        diagv = D_fr * q_fr + torch.zeros_like(qvel).index_add(
            0, lim_idx, D_lim * q_lim
        )
        Dq_d = Dd * q_d
        H = M + torch.einsum("ire,jre->ije", J, J * Dq_d[None])
        H[rows, rows] += diagv
        dx = -_chol_solve(H, grad)

        v_fr = dx
        v_lim = lim_mul(dx)
        v_d = torch.sum(J * dx[:, None, :], dim=0)
        q1 = torch.sum(dx * Mv(x - a_smooth), dim=0)
        q2 = torch.sum(dx * Mv(dx), dim=0)

        def dphi(a, need_h=True):
            ff, fll, fd, qf, ql, qd = forces(
                jar_fr + a * v_fr, jar_lim + a * v_lim, jar_d + a * v_d
            )
            d1 = q1 + a * q2 - (
                (v_fr * ff).sum(0) + (v_lim * fll).sum(0) + (v_d * fd).sum(0)
            )
            if not need_h:
                return d1, None
            d2 = q2 + (
                (D_fr * qf * v_fr * v_fr).sum(0)
                + (D_lim * ql * v_lim * v_lim).sum(0)
            ) + (Dd * qd * v_d * v_d).sum(0)
            return d1, d2

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
        jf_new = jar_fr + step * v_fr
        jl_new = jar_lim + step * v_lim
        jd_new = jar_d + step * v_d
        cost_new = total_cost(x_new, (jf_new, jl_new, jd_new))
        ok = torch.isfinite(cost_new) & (cost_new < cost_x)
        x = torch.where(ok, x_new, x)
        jar_fr = torch.where(ok, jf_new, jar_fr)
        jar_lim = torch.where(ok, jl_new, jar_lim)
        jar_d = torch.where(ok, jd_new, jar_d)
        cost_x = torch.where(ok, cost_new, cost_x)
        gnorm2 = torch.sum(grad * grad, dim=0)
        done = done | (gnorm2 < tol2) | ~ok
        it += 1

    f_fr, f_lim, f_d, _, _, _ = forces(jar_fr, jar_lim, jar_d)
    fnc = torch.cat([f_fr, f_lim], dim=0)
    qfrc = JT_all(f_fr, f_lim, f_d)
    qint = _chol_solve(Mh.reshape(nv, nv, E), Mv(x)) if do_int else x
    if iters is not None:
        iters.copy_(n_iter)
    return x, fnc, f_d, qfrc, a_smooth, qint


@functools.cache
def _lim_table(lim_dofs: tuple, device: str) -> torch.Tensor:
    """The limit rows' dof addresses on the device, copied once."""
    return torch.as_tensor(lim_dofs, dtype=torch.int32, device=device)


def newton_assemble_solve(
    Mc, qfrc_smooth, x_ws, qvel, Mh, Dnc, arefnc, flnc, side, Jeq,
    cdof, pos_k, O1, O2, frame_k, mu_dirs, mut, Dc, bb, kimp, on_rm,
    W1, W2, *, nv, K, R, ndirs, neq, nlim, lim_dofs, iterations,
    ls_iterations, tolerance, do_int, cone=0, iters=None,
):
    """Fused assembly + solve, all inputs env-last float32:

    Mc (nv*nv, E) column-major mass; qfrc_smooth/x_ws/qvel (nv, E); Mh
    (nv*nv, E) integrator system matrix (ignored when do_int is false);
    Dnc/arefnc/flnc (nv+nlim, E) non-contact rows; side (nlim, E); Jeq the
    (neq*nv, E) equality rows (neq must be 0); cdof (nv*6, E); pos_k/O1/O2
    (3*K, E) component-major; frame_k (9*K, E) rows [n, t1, t2]; mu_dirs
    (ndirs*K, E); mut unused (elliptic only); Dc/bb/kimp (K, E); on_rm
    (R*K, E) r-major row activity; W1/W2 (nv*K, E) dof-major. ``iters``,
    if given, is an (E,) int32 tensor that receives each env's Newton
    iteration count.

    Returns (x (nv, E), f_noncon (nv+nlim, E), f_con r-major (R*K, E),
    qfrc_constraint (nv, E), a_smooth (nv, E), qacc_int (nv, E))."""
    if cone != 0:
        raise NotImplementedError("the elliptic cone kernel is not ported yet")
    if neq:
        raise NotImplementedError("equality rows are not ported yet")
    kw = dict(nv=nv, K=K, R=R, ndirs=ndirs, neq=neq, nlim=nlim,
              lim_dofs=lim_dofs, iterations=iterations,
              ls_iterations=ls_iterations, tolerance=tolerance,
              do_int=do_int, cone=cone, iters=iters)
    args = (Mc, qfrc_smooth, x_ws, qvel, Mh, Dnc, arefnc, flnc, side, Jeq,
            cdof, pos_k, O1, O2, frame_k, mu_dirs, mut, Dc, bb, kimp, on_rm,
            W1, W2)
    if qvel.device.type == "cpu":
        return newton_assemble_solve_plain(*args, **kw)

    E = qvel.shape[-1]
    RK = R * K
    NC = nv + nlim
    shapes = dict(
        Mc=(nv * nv, E), qfrc_smooth=(nv, E), x_ws=(nv, E), qvel=(nv, E),
        Dnc=(NC, E), arefnc=(NC, E), flnc=(NC, E), side=(nlim, E),
        cdof=(nv * 6, E), pos_k=(3 * K, E), O1=(3 * K, E), O2=(3 * K, E),
        frame_k=(9 * K, E), mu_dirs=(ndirs * K, E), Dc=(K, E), bb=(K, E),
        kimp=(K, E), on_rm=(RK, E), W1=(nv * K, E), W2=(nv * K, E),
    )
    if do_int:
        shapes["Mh"] = (nv * nv, E)
    local = dict(zip(
        ("Mc", "qfrc_smooth", "x_ws", "qvel", "Mh", "Dnc", "arefnc", "flnc",
         "side", "Jeq", "cdof", "pos_k", "O1", "O2", "frame_k", "mu_dirs",
         "mut", "Dc", "bb", "kimp", "on_rm", "W1", "W2"), args,
    ))
    for name, shape in shapes.items():
        x = local[name]
        if x.device.type != "cuda" or x.dtype != torch.float32:
            raise ValueError(f"{name}: expected a float32 CUDA tensor")
        if tuple(x.shape) != shape or not x.is_contiguous():
            raise ValueError(
                f"{name}: expected contiguous {shape}, got {tuple(x.shape)}"
            )
    if nlim == 0:
        raise ValueError("the kernel takes a nonempty limit block")
    dev = qvel.device
    f32 = dict(dtype=torch.float32, device=dev)
    outs = [
        torch.empty((nv, E), **f32), torch.empty((NC, E), **f32),
        torch.empty((RK, E), **f32), torch.empty((nv, E), **f32),
        torch.empty((nv, E), **f32), torch.empty((nv, E), **f32),
    ]
    it_out = iters if iters is not None else torch.empty(
        E, dtype=torch.int32, device=dev
    )
    lim = _lim_table(lim_dofs, str(dev))
    Mh_arg = Mh if do_int else Mc
    vp, ci = ctypes.c_void_p, ctypes.c_int
    launch = cuda_build.launcher(
        "newton_solve", "newton_solve_launch",
        (vp,) * 29 + (ci,) * 6 + (ctypes.c_float, ci, ci, vp),
    )
    P = cuda_build.ptr
    rc = launch(
        P(Mc), P(qfrc_smooth), P(x_ws), P(qvel), P(Mh_arg), P(Dnc),
        P(arefnc), P(flnc), P(side), P(cdof), P(pos_k), P(O1), P(O2),
        P(frame_k), P(mu_dirs), P(Dc), P(bb), P(kimp), P(on_rm), P(W1),
        P(W2), P(lim), *[P(o) for o in outs], P(it_out),
        ctypes.c_int(nv), ctypes.c_int(K), ctypes.c_int(R),
        ctypes.c_int(nlim), ctypes.c_int(iterations),
        ctypes.c_int(ls_iterations), ctypes.c_float(tolerance),
        ctypes.c_int(int(do_int)), ctypes.c_int(E), cuda_build.stream(),
    )
    cuda_build.check(
        cuda_build.library("newton_solve"), rc, "newton_assemble_solve"
    )
    newton_assemble_solve.launches += 1
    return tuple(outs)


newton_assemble_solve.launches = 0
