// newton_common.cuh: the parts of the Newton constraint solve that do not
// depend on the friction cone, shared by newton_solve.cu (pyramidal) and
// newton_solve_elliptic.cu (elliptic): the env's common shared-memory
// layout, the warp reductions, the mass-matrix products, the
// Jacobi-equilibrated Cholesky and its solves, the dof-friction and limit
// rows (implicit rows: cost, slope, Hessian diagonal, forces), the line
// search, and the loads and stores around the solve.
//
// One warp per env: lane is the thread's lane, every loop over dofs or
// rows strides by 32, and every sum that feeds a branch is a butterfly
// reduction, which leaves every lane the same bits. IN(p, r) reads row r
// of an env-last (rows, E) input for env e; the callers name the env count
// E and the env e.
#pragma once

#include <cuda_runtime.h>

#define FULL 0xffffffffu
#define IN(p, r) (p)[(size_t)(r) * E + e]

namespace {

constexpr float kEps = 1e-12f;
constexpr float kRidge = 1e-6f;

// the part of an env's shared-memory layout both cones have: the dense
// contact rows (J [row][dof], D, aref, residual jar, search direction v)
// with the list of live ones, the mass matrix M, the Hessian / factor L,
// the dof vectors, and the friction and limit rows
struct EnvBase {
  int lane, nv, nlim;
  float *J, *M, *L, *Dd, *arefd, *jar_d, *v_d;
  int* live;
  float *scale, *grad, *dx, *t1, *t2, *xm, *x, *jar_fr, *diagv, *work, *xt,
      *asm_, *qv, *cdof, *D_fr, *aref_fr, *fl_fr;
  float *D_lim, *aref_lim, *side, *jar_lim, *v_lim;
  int* lim;
  int nlive;
};

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// out = M v, M column-major (j*nv + i); lanes over i, sequential over j
__device__ void mat_vec(const EnvBase& s, const float* M, const float* v, float* out) {
  for (int i = s.lane; i < s.nv; i += 32) {
    float acc = M[i] * v[0];
    for (int j = 1; j < s.nv; ++j) acc = acc + M[j * s.nv + i] * v[j];
    out[i] = acc;
  }
  __syncwarp();
}

// Jacobi-equilibrated Cholesky with a ridge; A may alias Lo (lower
// triangle, column-major, written in place). scale gets 1/sqrt(diag).
__device__ void chol_factor(const EnvBase& s, const float* A, float* Lo, float* scale) {
  const int nv = s.nv;
  for (int j = s.lane; j < nv; j += 32) scale[j] = rsqrtf(fmaxf(A[j * nv + j], kEps));
  __syncwarp();
  for (int j = 0; j < nv; ++j) {
    const float sj = scale[j];
    float djj = A[j * nv + j] * (sj * sj) + kRidge;
    for (int k = 0; k < j; ++k) djj = djj - Lo[k * nv + j] * Lo[k * nv + j];
    const float d = sqrtf(fmaxf(djj, kRidge));
    for (int i = j + 1 + s.lane; i < nv; i += 32) {
      float v = A[j * nv + i] * (scale[i] * sj);
      for (int k = 0; k < j; ++k) v = v - Lo[k * nv + i] * Lo[k * nv + j];
      Lo[j * nv + i] = v / d;
    }
    __syncwarp();
    if (s.lane == 0) Lo[j * nv + j] = djj / d;
    __syncwarp();
  }
}

// x = A^-1 g from chol_factor's (Lo, scale); work holds nv floats
__device__ void chol_solve(const EnvBase& s, const float* Lo, const float* scale,
                           const float* g, float* x, float* work) {
  const int nv = s.nv;
  for (int i = s.lane; i < nv; i += 32) work[i] = g[i] * scale[i];
  __syncwarp();
  for (int j = 0; j < nv; ++j) {
    const float yj = work[j] / Lo[j * nv + j];
    __syncwarp();
    for (int i = j + 1 + s.lane; i < nv; i += 32) work[i] = work[i] - Lo[j * nv + i] * yj;
    if (s.lane == 0) work[j] = yj;
    __syncwarp();
  }
  for (int k = nv - 1; k >= 0; --k) {
    float acc = 0.f;
    for (int i = k + 1; i < nv; ++i) acc = acc + Lo[k * nv + i] * x[i];
    const float xk = (work[k] - acc) / Lo[k * nv + k];
    __syncwarp();
    if (s.lane == 0) x[k] = xk;
    __syncwarp();
  }
  for (int i = s.lane; i < nv; i += 32) x[i] = x[i] * scale[i];
  __syncwarp();
}

// ordered list of the rows r < n with pred(r), by warp ballots
template <class Pred>
__device__ int compact(const EnvBase& s, int n, const int* src, int* dst, Pred pred) {
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int idx = base + s.lane;
    const int row = idx < n ? (src ? src[idx] : idx) : 0;
    const bool take = idx < n && pred(row);
    const unsigned mask = __ballot_sync(FULL, take);
    if (take) dst[count + __popc(mask & ((1u << s.lane) - 1u))] = row;
    count += __popc(mask);
  }
  __syncwarp();
  return count;
}

// J[row] . y, summed over the dofs in order
__device__ __forceinline__ float row_dot(const EnvBase& s, int row, const float* y) {
  const float* Jr = s.J + row * s.nv;
  float acc = 0.f;
  for (int i = 0; i < s.nv; ++i) acc = acc + Jr[i] * y[i];
  return acc;
}

// 0.5 (y - a_smooth)' M (y - a_smooth), y = base + t * dir
__device__ float smooth_cost(const EnvBase& s, const float* base, float t, const float* dir) {
  for (int i = s.lane; i < s.nv; i += 32)
    s.xm[i] = (base[i] + (dir ? t * dir[i] : 0.f)) - s.asm_[i];
  __syncwarp();
  mat_vec(s, s.M, s.xm, s.t2);
  float acc = 0.f;
  for (int i = s.lane; i < s.nv; i += 32) acc = acc + s.xm[i] * s.t2[i];
  return 0.5f * warp_sum(acc);
}

// ---------- the dof-friction and limit rows ----------

// this lane's share of their cost at jar + t * v (vf, vl == nullptr: at jar)
__device__ __forceinline__ float fr_lim_cost(const EnvBase& s, float t, const float* vf,
                                             const float* vl) {
  float c = 0.f;
  for (int i = s.lane; i < s.nv; i += 32) {
    const float j = s.jar_fr[i] + (vf ? t * vf[i] : 0.f);
    const float D = s.D_fr[i], fl = s.fl_fr[i];
    c = c + (fabsf(D * j) <= fl ? 0.5f * D * j * j
                                : fl * fabsf(j) - 0.5f * fl * fl / fmaxf(D, kEps));
  }
  for (int l = s.lane; l < s.nlim; l += 32) {
    const float j = s.jar_lim[l] + (vl ? t * vl[l] : 0.f);
    if (j < 0.f) c = c + 0.5f * s.D_lim[l] * j * j;
  }
  return c;
}

// this lane's share of their slope (sl, their forces along dx) and, with
// need_h, curvature (hl) at step al along dx
__device__ __forceinline__ void fr_lim_slope(const EnvBase& s, float al, bool need_h,
                                             float& sl, float& hl) {
  for (int i = s.lane; i < s.nv; i += 32) {
    const float v = s.dx[i];
    const float j = s.jar_fr[i] + al * v;
    const float D = s.D_fr[i], fl = s.fl_fr[i];
    const float fq = -D * j;
    sl = sl + v * fminf(fmaxf(fq, -fl), fl);
    if (need_h && fabsf(fq) <= fl && D > 0.f) hl = hl + D * v * v;
  }
  for (int l = s.lane; l < s.nlim; l += 32) {
    const float v = s.v_lim[l];
    const float j = s.jar_lim[l] + al * v;
    if (j < 0.f) {
      const float D = s.D_lim[l];
      sl = sl + v * (-D * j);
      if (need_h && D > 0.f) hl = hl + D * v * v;
    }
  }
}

// their Hessian diagonal into diagv (friction rows in the quadratic zone,
// active limits)
__device__ __forceinline__ void fr_lim_diag(const EnvBase& s) {
  for (int i = s.lane; i < s.nv; i += 32) {
    const float fq = -s.D_fr[i] * s.jar_fr[i];
    const bool q = fabsf(fq) <= s.fl_fr[i] && s.D_fr[i] > 0.f;
    s.diagv[i] = q ? s.D_fr[i] : 0.f;
  }
  __syncwarp();
  for (int l = s.lane; l < s.nlim; l += 32)
    if (s.jar_lim[l] < 0.f && s.D_lim[l] > 0.f) s.diagv[s.lim[l]] = s.diagv[s.lim[l]] + s.D_lim[l];
}

// dof-friction force of dof i at the current jar (clipped at its loss)
__device__ __forceinline__ float fr_force(const EnvBase& s, int i) {
  const float fq = -s.D_fr[i] * s.jar_fr[i];
  const float fl = s.fl_fr[i];
  return fminf(fmaxf(fq, -fl), fl);
}

// limit force of limit row l at the current jar
__device__ __forceinline__ float lim_force(const EnvBase& s, int l) {
  const float j = s.jar_lim[l];
  return j < 0.f ? -s.D_lim[l] * j : 0.f;
}

// out[dof] += the limit rows' forces (distinct dofs: no race)
__device__ __forceinline__ void lim_scatter(const EnvBase& s, float* out) {
  for (int l = s.lane; l < s.nlim; l += 32)
    out[s.lim[l]] = out[s.lim[l]] + s.side[l] * lim_force(s, l);
  __syncwarp();
}

// ---------- the Newton step ----------

// the Newton direction dx = -L^-1 grad from the Hessian in L (factored in
// place)
__device__ void newton_direction(const EnvBase& s) {
  chol_factor(s, s.L, s.L, s.scale);
  chol_solve(s, s.L, s.scale, s.grad, s.dx, s.work);
  for (int i = s.lane; i < s.nv; i += 32) s.dx[i] = -s.dx[i];
  __syncwarp();
}

// q1 = dx' M (x - a_smooth) (t1 holds M (x - a_smooth)), q2 = dx' M dx
__device__ void smooth_quadratic(const EnvBase& s, float& q1, float& q2) {
  mat_vec(s, s.M, s.dx, s.t2);
  float q1p = 0.f, q2p = 0.f;
  for (int i = s.lane; i < s.nv; i += 32) {
    q1p = q1p + s.dx[i] * s.t1[i];
    q2p = q2p + s.dx[i] * s.t2[i];
  }
  q1 = warp_sum(q1p);
  q2 = warp_sum(q2p);
}

// the step along dx: 12 doubling probes, then ls_iterations safeguarded
// Newton/bisection steps on the slope dphi(al, need_h, &curvature)
template <class Dphi>
__device__ float line_search(Dphi dphi, int ls_iterations) {
  float hi = 1.f;
  for (int pr = 0; pr < 12; ++pr) {
    const float g = dphi(hi, false, nullptr);
    if (g < 0.f) hi = hi * 2.f;
  }
  float lo = 0.f;
  float al = fminf(hi, 1.f);
  for (int pr = 0; pr < ls_iterations; ++pr) {
    float h;
    const float g = dphi(al, true, &h);
    if (g < 0.f) lo = al; else hi = al;
    const float an = al - g / fmaxf(h, kEps);
    al = (an > lo && an < hi) ? an : 0.5f * (lo + hi);
  }
  return fmaxf(al, 0.f);
}

// x += step dx and the residuals of the friction, limit and live contact
// rows with it (the caller syncs the warp)
__device__ __forceinline__ void advance(const EnvBase& s, float step) {
  for (int i = s.lane; i < s.nv; i += 32) {
    s.x[i] = s.x[i] + step * s.dx[i];
    s.jar_fr[i] = s.jar_fr[i] + step * s.dx[i];
  }
  for (int l = s.lane; l < s.nlim; l += 32) s.jar_lim[l] = s.jar_lim[l] + step * s.v_lim[l];
  for (int n = s.lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    s.jar_d[row] = s.jar_d[row] + step * s.v_d[row];
  }
}

// ---------- loads and stores ----------

// the mass matrix, cdof, qvel, and the friction and limit rows, which
// start at row off of the non-contact inputs (after the equality rows)
__device__ void load_common(const EnvBase& s, const float* Mc, const float* cdof,
                            const float* qvel, const float* Dnc, const float* arefnc,
                            const float* flnc, const float* side, const int* lim,
                            int off, int E, int e) {
  const int nv = s.nv;
  for (int r = s.lane; r < nv * nv; r += 32) s.M[r] = IN(Mc, r);
  for (int r = s.lane; r < 6 * nv; r += 32) s.cdof[r] = IN(cdof, r);
  for (int i = s.lane; i < nv; i += 32) {
    s.qv[i] = IN(qvel, i);
    s.D_fr[i] = IN(Dnc, off + i);
    s.aref_fr[i] = IN(arefnc, off + i);
    s.fl_fr[i] = IN(flnc, off + i);
  }
  for (int l = s.lane; l < s.nlim; l += 32) {
    s.D_lim[l] = IN(Dnc, off + nv + l);
    s.aref_lim[l] = IN(arefnc, off + nv + l);
    s.side[l] = IN(side, l);
    s.lim[l] = lim[l];
  }
}

// the unconstrained acceleration: M a_smooth = qfrc_smooth, into asm_
__device__ void smooth_acceleration(const EnvBase& s, const float* qfs, int E, int e) {
  for (int i = s.lane; i < s.nv; i += 32) s.t1[i] = IN(qfs, i);
  __syncwarp();
  chol_factor(s, s.M, s.L, s.scale);
  chol_solve(s, s.L, s.scale, s.t1, s.asm_, s.work);
}

// qacc, a_smooth, and the friction and limit forces at row off of fnc
__device__ void store_common(const EnvBase& s, float* x, float* asm_, float* fnc, int off,
                             int E, int e) {
  for (int i = s.lane; i < s.nv; i += 32) {
    IN(fnc, off + i) = fr_force(s, i);
    IN(x, i) = s.x[i];
    IN(asm_, i) = s.asm_[i];
  }
  for (int l = s.lane; l < s.nlim; l += 32) IN(fnc, off + s.nv + l) = lim_force(s, l);
}

// qacc_int: with do_int, Mh^-1 (M qacc) (the implicit velocity update),
// else qacc
__device__ void store_qacc_int(const EnvBase& s, const float* Mh, float* qint, int do_int,
                               int E, int e) {
  if (do_int) {
    mat_vec(s, s.M, s.x, s.xt);
    for (int r = s.lane; r < s.nv * s.nv; r += 32) s.L[r] = IN(Mh, r);
    __syncwarp();
    chol_factor(s, s.L, s.L, s.scale);
    chol_solve(s, s.L, s.scale, s.xt, s.t1, s.work);
    for (int i = s.lane; i < s.nv; i += 32) IN(qint, i) = s.t1[i];
  } else {
    for (int i = s.lane; i < s.nv; i += 32) IN(qint, i) = s.x[i];
  }
}

}  // namespace
