// newton_common.cuh: what every Newton solve kernel shares (the env-last
// input macro IN, the Cholesky's constants, the warp butterfly sum), and
// the one-warp-per-env routines of newton_solve_dense.cu: the env's
// shared-memory layout, the mass-matrix products, the Jacobi-equilibrated
// Cholesky and its solves, the row compaction and the line search. The
// block-wide routines of newton_solve.cu and newton_solve_elliptic.cu are
// in newton_block.cuh.
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

// an env's shared-memory layout: the dense rows (J [row][dof], D, aref,
// residual jar, search direction v) with the list of live ones, the mass
// matrix M, the Hessian / factor L and the dof vectors
struct EnvBase {
  int lane, nv;
  float *J, *M, *L, *Dd, *arefd, *jar_d, *v_d;
  int* live;
  float *scale, *grad, *dx, *t1, *t2, *xm, *x, *work, *xt, *asm_;
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

}  // namespace
