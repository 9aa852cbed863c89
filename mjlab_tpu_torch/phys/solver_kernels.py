"""Fused contact-Jacobian assembly + Newton constraint solve, env-last.

PyTorch counterpart of mjlab_tpu/phys/solver_pallas2.py
(``newton_assemble_solve``), both friction cones, with joint-equality rows.
The CUDA kernels (csrc/newton_solve.cu for the pyramidal cone,
csrc/newton_solve_elliptic.cu for the elliptic one, both built on
csrc/newton_block.cuh; one env per block of 128 threads, launch shape from
newton_launch_shape) and the plain PyTorch version below share inputs,
outputs and arithmetic; the wrapper runs the plain version for CPU tensors
and launches the kernel for CUDA tensors, and
``newton_assemble_solve.launches`` counts kernel launches
(``launches_by_cone`` per cone).

Row layout: [equality (neq), dof friction (nv), joint limits (nlim),
contacts r-major] (row r of every slot contiguous). The friction rows are
the identity and a limit row is one signed entry at a static dof, so only
the contact and equality rows are dense. Pyramidal contact rows are
independent one-sided quadratics; an elliptic contact's rows [n, t1, t2,
torsion, roll1, roll2][:R] share the 3-zone cone cost of lm/solver.py
(_ell_*), with a dense (R, R) Hessian block per contact; the plain
elliptic version is held against the JAX package's solve_lm. Numerics
follow the TPU kernel: exact Hessian, Jacobi-
equilibrated Cholesky with a 1e-6 ridge, 12 doubling probes then
safeguarded Newton/bisection line-search steps, early exit on a small
gradient or a step that does not lower the cost.
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from mjlab_tpu_torch import cuda_build

_EPS = 1e-12
_RIDGE = 1e-6
_MAX_ROWS_PER_CONTACT = 6  # the elliptic kernel's R templates: 3 to 6
_MAX_PYRAMID_ROWS = 4  # pyramid rows come from the frame's two tangents
_SMEM_OPTIN = 232448  # shared memory a block may opt in to on an H100
_DOUBLING_PROBES = 12


def _chol_solve(A: torch.Tensor, g: torch.Tensor, ridge: float = _RIDGE) -> torch.Tensor:
    """Solve A x = g for SPD A (nv, nv, E) with g (nv, E): Jacobi-scaled
    column Cholesky with a ridge, pivots floored at max(ridge, 1e-12)
    (solver_pallas2.py chol_solve)."""
    nv = g.shape[0]
    diag = torch.stack([A[j, j] for j in range(nv)])
    scale = torch.rsqrt(torch.clamp(diag, min=_EPS))
    g = g * scale
    rows = torch.arange(nv, device=g.device)[:, None]
    L = []
    for j in range(nv):
        s = A[:, j] * (scale * scale[j])
        s = s + torch.where(rows == j, ridge, 0.0)
        for k in range(j):
            s = s - L[k] * L[k][j]
        dcol = torch.sqrt(torch.clamp(s[j], min=max(ridge, _EPS)))
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


def _ell_zone(jc, Dc, mut):
    """3-zone elliptic cone state of the contact rows jc (R, K, E), r-major
    [n, t1, t2, torsion, roll1, roll2], row D values Dc (R, K, E) and the
    whitened cone coefficient mut (K, E) (lm/solver._ell_scaled_lm)."""
    sD = torch.sqrt(Dc)
    x = jc * sD
    xn = x[0]
    tt = x[1] * x[1]
    for r in range(2, x.shape[0]):
        tt = tt + x[r] * x[r]
    T = torch.sqrt(torch.clamp(tt, min=_EPS * _EPS))
    w = mut * xn + T
    mu_pos = mut > 1e-9
    bottom = torch.where(mu_pos, w <= 0, xn < 0)
    top = ~bottom & torch.where(mu_pos, xn >= mut * T, xn >= 0)
    return dict(sD=sD, x=x, xn=xn, tt=tt, T=T, w=w, mut=mut,
                c1=1.0 + mut * mut, bottom=bottom, mid=~bottom & ~top)


def _ell_force(z, jc, Dc):
    """(R, K, E) contact row forces, -grad of the cone cost."""
    fn = z["sD"][0] * (z["mut"] * z["w"] / z["c1"] - z["xn"])
    ft = -z["sD"][1:] * z["x"][1:] * (1.0 - z["w"] / (z["c1"] * z["T"]))
    f_mid = torch.cat([fn[None], ft], dim=0)
    return torch.where(z["bottom"], -Dc * jc, torch.where(z["mid"], f_mid, 0.0))


def _ell_cost(z):
    """(E,) cost of the contact rows."""
    norm2 = z["xn"] * z["xn"] + z["tt"]
    s_mid = 0.5 * (norm2 - z["w"] * z["w"] / z["c1"])
    per = torch.where(z["bottom"], 0.5 * norm2, torch.where(z["mid"], s_mid, 0.0))
    return per.sum(0)


def _ell_hess(z, Dc):
    """(R, R, K, E) per-contact Hessian blocks of the cone cost."""
    R = Dc.shape[0]
    that = z["x"][1:] / z["T"]
    zero = torch.zeros_like(z["xn"])[None]
    gradw = torch.cat([z["mut"][None], that], dim=0)  # (R, K, E)
    that_full = torch.cat([zero, that], dim=0)
    eye = torch.eye(R, dtype=Dc.dtype, device=Dc.device)[:, :, None, None]
    P_t = eye.clone()
    P_t[0, 0] = 0.0
    B_mid = eye - (
        gradw[:, None] * gradw[None]
        + (z["w"] / z["T"]) * (P_t - that_full[:, None] * that_full[None])
    ) / z["c1"]
    B_mid = z["sD"][:, None] * B_mid * z["sD"][None]
    return torch.where(z["bottom"], eye * Dc[:, None],
                       torch.where(z["mid"], B_mid, 0.0))


def _ell_curv(z, vc):
    """(E,) v' (hess of the cone cost) v along the row-space direction
    vc (R, K, E) (lm/solver._ell_curv_lm)."""
    vt = vc * z["sD"]
    vtt2 = vt[1] * vt[1]
    tv = (z["x"][1] / z["T"]) * vt[1]
    for r in range(2, vt.shape[0]):
        vtt2 = vtt2 + vt[r] * vt[r]
        tv = tv + (z["x"][r] / z["T"]) * vt[r]
    quad = vt[0] * vt[0] + vtt2
    gw = z["mut"] * vt[0] + tv
    mid_term = quad - (gw * gw + (z["w"] / z["T"]) * (vtt2 - tv * tv)) / z["c1"]
    per = torch.where(z["bottom"], quad,
                      torch.where(z["mid"], torch.clamp(mid_term, min=0.0), 0.0))
    return per.sum(0)


def newton_assemble_solve_plain(
    Mc, qfrc_smooth, x_ws, qvel, Mh, Dnc, arefnc, flnc, side, Jeq,
    cdof, pos_k, O1, O2, frame_k, mu_dirs, mut, Dc, bb, kimp, on_rm,
    W1, W2, *, nv, K, R, ndirs, neq, nlim, lim_dofs, iterations,
    ls_iterations, tolerance, do_int, cone=0, iters=None,
):
    """Plain PyTorch newton_assemble_solve (same contract)."""
    E = qvel.shape[-1]
    RK = R * K
    elliptic = cone != 0
    on = on_rm
    M = Mc.reshape(nv, nv, E)  # (column j, row i) == (i, j): symmetric

    # ---------- phase A: dense rows, contacts r-major then equality ----------
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

    def rotate(v3, f):  # frame row f of the (nv, K, E) components v3
        return fr[3 * f] * v3[0] + fr[3 * f + 1] * v3[1] + fr[3 * f + 2] * v3[2]

    f3 = [rotate(jd, f) for f in range(3)]
    onr = on.reshape(R, K, E)
    pieces = [None] * R
    if elliptic:
        # rows [normal, t1, t2, torsion, roll1, roll2][:R]: the frame's
        # rows of the point Jacobian, then of the angular Jacobian
        rows = f3[: 1 + min(ndirs, 2)]
        if ndirs > 2:
            ja = [cd[:, c][:, None] * (w2 - w1) for c in range(3)]
            rows += [rotate(ja, f) for f in range(ndirs - 2)]
        pieces = [onr[r] * rows[r] for r in range(R)]
    else:
        mu = mu_dirs.reshape(ndirs, K, E)
        for j in range(ndirs):
            pieces[2 * j] = onr[2 * j] * (f3[0] + mu[j] * f3[1 + j])
            pieces[2 * j + 1] = onr[2 * j + 1] * (f3[0] - mu[j] * f3[1 + j])
    Jc = torch.stack(pieces, dim=1).reshape(nv, RK, E)
    Jq = Jeq[:neq * nv].reshape(neq, nv, E).permute(1, 0, 2)  # (nv, neq, E)
    J = torch.cat([Jc, Jq], dim=1)  # (nv, ND, E)

    if elliptic:  # friction rows carry their own D (mu_dirs holds them)
        Dr = torch.cat([Dc[None], mu_dirs.reshape(ndirs, K, E)], dim=0)
        kimp_r = torch.cat([kimp[None], torch.zeros_like(onr[1:])], dim=0)
    else:
        Dr, kimp_r = Dc[None], kimp[None]
    D_c = (onr * Dr).reshape(RK, E)
    velc = torch.sum(Jc * qvel[:, None, :], dim=0)
    arefc = (onr * (-bb[None] * velc.reshape(R, K, E) - kimp_r)).reshape(RK, E)
    D_eq, aref_eq = Dnc[:neq], arefnc[:neq]
    Dd = torch.cat([D_c, D_eq], dim=0)
    arefd = torch.cat([arefc, aref_eq], dim=0)

    # ---------- phase B: Newton ----------
    D_fr, aref_fr, fl_fr = Dnc[neq:neq + nv], arefnc[neq:neq + nv], flnc[neq:neq + nv]
    D_lim, aref_lim = Dnc[neq + nv:neq + nv + nlim], arefnc[neq + nv:neq + nv + nlim]
    lim_idx = torch.as_tensor(list(lim_dofs), device=qvel.device,
                              dtype=torch.long)
    Dc3 = D_c.reshape(R, K, E)

    def Mv(vec):
        return torch.einsum("ije,je->ie", M, vec)

    def lim_mul(vec):
        return side * vec[lim_idx]

    def lim_scatter(f_lim):
        return torch.zeros_like(qvel).index_add(0, lim_idx, side * f_lim)

    def JT_all(f_fr, f_lim, f_d):
        return f_fr + torch.sum(J * f_d[None], dim=1) + lim_scatter(f_lim)

    def dense_forces(jdd):
        """Dense-row forces, their quadratic-zone flags (pyramidal; None
        for elliptic contacts) and the cone state (elliptic)."""
        jc, je = jdd[:RK], jdd[RK:]
        f_eq = -D_eq * je
        q_eq = (D_eq > 0).to(jdd.dtype)
        if elliptic:
            z = _ell_zone(jc.reshape(R, K, E), Dc3, mut)
            f_c = _ell_force(z, jc.reshape(R, K, E), Dc3).reshape(RK, E)
            return torch.cat([f_c, f_eq]), q_eq, z
        f_c = torch.where(jc < 0, -D_c * jc, 0.0)
        q_c = ((jc < 0) & (D_c > 0)).to(jdd.dtype)
        return torch.cat([f_c, f_eq]), torch.cat([q_c, q_eq]), None

    def forces(jf, jl, jdd):
        fq_fr = -D_fr * jf
        f_fr = torch.clamp(fq_fr, -fl_fr, fl_fr)
        q_fr = ((torch.abs(fq_fr) <= fl_fr) & (D_fr > 0)).to(jf.dtype)
        fq_l = -D_lim * jl
        f_lim = torch.where(jl < 0, fq_l, 0.0)
        q_lim = ((jl < 0) & (D_lim > 0)).to(jf.dtype)
        f_d, q_d, z = dense_forces(jdd)
        return f_fr, f_lim, f_d, q_fr, q_lim, q_d, z

    def cost_rows(jf, jl, jdd):
        qc_fr = 0.5 * D_fr * jf * jf
        lin = fl_fr * torch.abs(jf) - 0.5 * fl_fr * fl_fr / torch.clamp(D_fr, min=_EPS)
        c_fr = torch.where(torch.abs(D_fr * jf) <= fl_fr, qc_fr, lin)
        c_lim = torch.where(jl < 0, 0.5 * D_lim * jl * jl, 0.0)
        jc, je = jdd[:RK], jdd[RK:]
        if elliptic:
            c_c = _ell_cost(_ell_zone(jc.reshape(R, K, E), Dc3, mut))
        else:
            c_c = torch.where(jc < 0, 0.5 * D_c * jc * jc, 0.0).sum(0)
        c_eq = (0.5 * D_eq * je * je).sum(0)
        return c_fr.sum(0) + c_lim.sum(0) + c_c + c_eq

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
    rows_nv = torch.arange(nv, device=qvel.device)

    it = 0
    while it < iterations and not bool(done.all()):
        n_iter += (~done).to(torch.int32)
        f_fr, f_lim, f_d, q_fr, q_lim, q_d, z = forces(jar_fr, jar_lim, jar_d)
        grad = Mv(x - a_smooth) - JT_all(f_fr, f_lim, f_d)
        diagv = D_fr * q_fr + torch.zeros_like(qvel).index_add(
            0, lim_idx, D_lim * q_lim
        )
        if elliptic:
            # H = M + J_c' B J_c (per-contact cone blocks) + J_eq' D J_eq
            Jc4 = Jc.reshape(nv, R, K, E)
            BJ = torch.einsum("rske,jske->jrke", _ell_hess(z, Dc3), Jc4)
            H = M + torch.einsum("irke,jrke->ije", Jc4, BJ)
            if neq:
                H = H + torch.einsum("ine,jne->ije", Jq, Jq * (D_eq * q_d)[None])
        else:
            H = M + torch.einsum("ire,jre->ije", J, J * (Dd * q_d)[None])
        H[rows_nv, rows_nv] += diagv
        dx = -_chol_solve(H, grad)

        v_fr = dx
        v_lim = lim_mul(dx)
        v_d = torch.sum(J * dx[:, None, :], dim=0)
        q1 = torch.sum(dx * Mv(x - a_smooth), dim=0)
        q2 = torch.sum(dx * Mv(dx), dim=0)

        def dphi(a, need_h=True):
            ff, fll, fd, qf, ql, qd, za = forces(
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
            )
            if elliptic:
                ve = v_d[RK:]
                d2 = d2 + _ell_curv(za, v_d[:RK].reshape(R, K, E)) + (
                    D_eq * qd * ve * ve).sum(0)
            else:
                d2 = d2 + (Dd * qd * v_d * v_d).sum(0)
            return d1, d2

        hi = doubling_replay(torch.stack([
            dphi(torch.full_like(q1, 2.0 ** k), need_h=False)[0]
            for k in range(_DOUBLING_PROBES)
        ]))
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

    f_fr, f_lim, f_d, _, _, _, _ = forces(jar_fr, jar_lim, jar_d)
    fnc = torch.cat([f_d[RK:], f_fr, f_lim], dim=0)
    qfrc = JT_all(f_fr, f_lim, f_d)
    qint = _chol_solve(Mh.reshape(nv, nv, E), Mv(x)) if do_int else x
    if iters is not None:
        iters.copy_(n_iter)
    return x, fnc, f_d[:RK], qfrc, a_smooth, qint


def doubling_replay(slopes: torch.Tensor) -> torch.Tensor:
    """hi of the line search's 12 doubling probes (hi = 1; 12 times: if
    the slope at hi is negative, hi doubles) from the slopes at 2^0 ..
    2^11, (12, E). hi is always 2^k with k at most the probe's number,
    and it stays where the slope is first not negative (0 or NaN): every
    later probe reads that same slope. So hi = 2^k for the first such k,
    2^12 if there is none. The kernels evaluate the 12 slopes in one
    batched sum and replay them so (csrc/newton_block.cuh
    line_search_w)."""
    k = torch.cumprod((slopes < 0).to(torch.int32), dim=0).sum(0)
    return torch.exp2(k.to(slopes.dtype))


class LaunchShape(NamedTuple):
    """How newton_assemble_solve launches its kernel: threads per env,
    envs per block, shared memory per env (bytes), and the envs per SM
    the kernel's registers are budgeted for (its __launch_bounds__)."""

    threads_per_env: int
    envs_per_block: int
    smem_bytes_per_env: int
    min_blocks_per_sm: int


# csrc/newton_block.cuh: kThreads, kNumDofVecs (the dense kernel's layout
# ends at kYb), kNumLimVecs, kNumRowVecs, warp 0's kNumBcast results and 4
# counts, kMaxNv; kMinBlocks of csrc/newton_solve.cu and
# csrc/newton_solve_elliptic.cu
_THREADS_PER_ENV = 128
_DOF_VECS, _LIM_VECS, _ROW_VECS = 15, 5, 5
_DOF_VECS_DENSE = 10
_SMALL_FLOATS = 4 + 4
_MIN_BLOCKS_PER_SM = (6, 5)
_MAX_NV = 45


def newton_launch_shape(cone, nv, K, R, neq, nlim) -> LaunchShape:
    """The solve kernel's launch shape at these sizes: one env per block
    of 128 threads, and the shared memory of the env's layout
    (csrc/newton_block.cuh env_floats, which the launcher checks this
    against: it refuses another shape)."""
    if nv > _MAX_NV:
        raise ValueError(f"the solve kernels take at most {_MAX_NV} dofs, got {nv}")
    ND = R * K + neq
    floats = (
        ND * nv + nv * nv + max(nv * nv, 6 * nv) + (_ROW_VECS + 1) * ND
        + (_DOF_VECS + 1) * nv + (_LIM_VECS + 1) * nlim + K + _SMALL_FLOATS
    )
    if cone:
        floats += 2 * K + 2 * R * nv
    return LaunchShape(_THREADS_PER_ENV, 1, 4 * floats, _MIN_BLOCKS_PER_SM[int(cone != 0)])


def blocks_per_sm(cone, R, smem_bytes) -> int:
    """Envs (blocks) of the cone's kernel one SM holds at smem_bytes per
    env: the CUDA occupancy calculator, registers included."""
    name = "newton_solve_elliptic" if cone else "newton_solve"
    f = cuda_build.launcher(name, f"{name}_blocks_per_sm", (ctypes.c_int, ctypes.c_int))
    return int(f(R, smem_bytes))


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
    Dnc/arefnc/flnc (neq+nv+nlim, E) non-contact rows [equality, dof
    friction, limits]; side (nlim, E); Jeq (neq*nv, E) the equality rows
    (ignored when neq is 0); cdof (nv*6, E); pos_k/O1/O2 (3*K, E)
    component-major; frame_k (9*K, E) rows [n, t1, t2]; mu_dirs (ndirs*K,
    E) the pyramidal friction coefficients (cone 0, ndirs = R/2) or the
    elliptic friction rows' D values (cone 1, ndirs = R-1); mut (K, E) the
    whitened cone coefficient (cone 1 only); Dc/bb/kimp (K, E); on_rm (R*K,
    E) r-major row activity; W1/W2 (nv*K, E) dof-major. ``iters``, if
    given, is an (E,) int32 tensor that receives each env's Newton
    iteration count.

    On the card, cone 0 launches csrc/newton_solve.cu and cone 1
    csrc/newton_solve_elliptic.cu, in the shape newton_launch_shape gives.

    Returns (x (nv, E), f_noncon (neq+nv+nlim, E), f_con r-major (R*K, E),
    qfrc_constraint (nv, E), a_smooth (nv, E), qacc_int (nv, E)).
    ``newton_assemble_solve.launches`` counts kernel launches, and
    ``launches_by_cone[cone]`` those of each cone's kernel."""
    kw = dict(nv=nv, K=K, R=R, ndirs=ndirs, neq=neq, nlim=nlim,
              lim_dofs=lim_dofs, iterations=iterations,
              ls_iterations=ls_iterations, tolerance=tolerance,
              do_int=do_int, cone=cone, iters=iters)
    args = (Mc, qfrc_smooth, x_ws, qvel, Mh, Dnc, arefnc, flnc, side, Jeq,
            cdof, pos_k, O1, O2, frame_k, mu_dirs, mut, Dc, bb, kimp, on_rm,
            W1, W2)
    elliptic = cone != 0
    if ndirs != (R - 1 if elliptic else R // 2):
        raise ValueError(f"ndirs {ndirs} does not match R {R} and cone {cone}")
    if elliptic and not 3 <= R <= _MAX_ROWS_PER_CONTACT:
        raise ValueError(f"the elliptic cone takes 3 to 6 rows per contact, got {R}")
    if not elliptic and R > _MAX_PYRAMID_ROWS:
        raise ValueError(
            "the pyramidal cone takes contacts of condim <= 3 (pyramid rows along "
            f"the frame's two tangents, R <= 4), got R {R}"
        )
    if qvel.device.type == "cpu":
        return newton_assemble_solve_plain(*args, **kw)

    E = qvel.shape[-1]
    RK = R * K
    NC = neq + nv + nlim
    shapes = dict(
        Mc=(nv * nv, E), qfrc_smooth=(nv, E), x_ws=(nv, E), qvel=(nv, E),
        Dnc=(NC, E), arefnc=(NC, E), flnc=(NC, E), side=(nlim, E),
        cdof=(nv * 6, E), pos_k=(3 * K, E), O1=(3 * K, E), O2=(3 * K, E),
        frame_k=(9 * K, E), mu_dirs=(ndirs * K, E), Dc=(K, E), bb=(K, E),
        kimp=(K, E), on_rm=(RK, E), W1=(nv * K, E), W2=(nv * K, E),
    )
    if do_int:
        shapes["Mh"] = (nv * nv, E)
    if neq:
        shapes["Jeq"] = (neq * nv, E)
    if elliptic:
        shapes["mut"] = (K, E)
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
    if len(set(lim_dofs)) != len(lim_dofs):
        raise ValueError("the kernel takes at most one limit row per dof")
    dev = qvel.device
    shape = newton_launch_shape(cone, nv, K, R, neq, nlim)
    limit = getattr(torch.cuda.get_device_properties(dev),
                    "shared_memory_per_block_optin", _SMEM_OPTIN)
    if shape.smem_bytes_per_env > limit:
        raise ValueError(
            f"one env of this model needs {shape.smem_bytes_per_env} bytes of "
            f"shared memory, more than a block can have ({limit})"
        )
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
    vp, ci = ctypes.c_void_p, ctypes.c_int
    P = cuda_build.ptr
    # inputs a model does not have (no implicit integrator, no equality
    # rows, the pyramidal cone's mut) are never read: any tensor stands in
    Mh_arg = Mh if do_int else Mc
    name = "newton_solve_elliptic" if elliptic else "newton_solve"
    launch = cuda_build.launcher(
        name, f"{name}_launch", (vp,) * 31 + (ci,) * 7 + (ctypes.c_float,) + (ci,) * 5 + (vp,),
    )
    rc = launch(
        P(Mc), P(qfrc_smooth), P(x_ws), P(qvel), P(Mh_arg), P(Dnc), P(arefnc),
        P(flnc), P(side), P(Jeq), P(cdof), P(pos_k), P(O1), P(O2), P(frame_k),
        P(mu_dirs), P(mut), P(Dc), P(bb), P(kimp), P(on_rm), P(W1), P(W2),
        P(lim), *[P(o) for o in outs], P(it_out),
        ci(nv), ci(K), ci(R), ci(neq), ci(nlim), ci(iterations),
        ci(ls_iterations), ctypes.c_float(tolerance), ci(int(do_int)), ci(E),
        ci(shape.threads_per_env), ci(shape.envs_per_block),
        ci(shape.smem_bytes_per_env), cuda_build.stream(),
    )
    cuda_build.check(cuda_build.library(name), rc, "newton_assemble_solve")
    newton_assemble_solve.launches += 1
    newton_assemble_solve.launches_by_cone[int(elliptic)] += 1
    return tuple(outs)


newton_assemble_solve.launches = 0
newton_assemble_solve.launches_by_cone = [0, 0]


# A solve kernel against its plain version at float32, relative to
# max(1, |plain|max): the solve's measured f32 sensitivity
# (tests/test_pallas2_solver.py)
SOLVE_TOL = 2e-3  # qacc, qacc_smooth, qacc_int, qfrc_constraint
FORCE_TOL = 6e-3  # per-row forces


def qfrc_errors(q_ref, q_got, iters_ref, iters_got, row_scale: float = 0.0) -> dict:
    """qfrc_constraint of a solve kernel (q_got, (nv, E)) against its plain
    version (q_ref) under the iteration-count rule; ``iters_*`` are the two
    solves' (E,) Newton iteration counts. Returns {label: (error,
    tolerance)}.

    At convergence the acceptance test compares two f32 costs that differ
    by rounding, so an env's Newton iteration count depends on the order
    of its sums. Where the counts agree, qfrc is held at SOLVE_TOL; where
    they differ by that one step it is held at FORCE_TOL, qfrc being J^T f.
    Errors are relative to max(1, |qfrc|max, row_scale). Under the
    elliptic cone row_scale is the row forces' |f|max: when fingers pinch
    an object their row forces cancel on its dofs, so qfrc there is a
    small difference of large row forces and carries their error; 0 gives
    the errors on qfrc's own scale."""
    q = q_ref.double()
    scale = max(1.0, float(q.abs().max()), row_scale)
    diff = (q - q_got.to(q.device).double()).abs().amax(0) / scale
    same = (iters_ref == iters_got.to(iters_ref.device)).to(diff.device)
    worst = lambda m: float(diff[m].max()) if bool(m.any()) else 0.0  # noqa: E731
    return {
        "equal iteration counts": (worst(same), SOLVE_TOL),
        "iteration counts differ": (worst(~same), FORCE_TOL),
    }


def row_force_scale(out) -> float:
    """|f|max of newton_assemble_solve's row forces (non-contact and
    contact), the scale qfrc_errors takes under the elliptic cone."""
    return max(float(out[1].abs().max()), float(out[2].abs().max()))
