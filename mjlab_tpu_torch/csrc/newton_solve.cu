// newton_solve: contact-Jacobian assembly + Newton constraint solve +
// implicit velocity update, one warp per env (pyramidal cone).
//
// Replaces the TPU kernel newton_assemble_solve with cone=0
// (mjlab_tpu/phys/solver_pallas2.py:623, kernel _make_kernel at :46,
// pallas_call at :674). The parts that do not depend on the cone (the
// Cholesky, the line search, the friction and limit rows) are in
// newton_common.cuh, shared with the elliptic kernel.
//
// What bounds it on an H100: operations, and the latency between them.
// Each Newton iteration builds the Hessian M + J^T diag(D) J (nv^2/2 *
// active-row multiply-adds), factors it (nv^3/6), and runs 12 +
// ls_iterations line-search probes over all rows; inputs and outputs are
// ~28 KB per env, read and written once. Every step depends on the one
// before, so a thread-per-env kernel (one warp per SM at 4096 envs) waits
// on memory latency almost all the time.
//
// Design: one warp per env, one env per block. The env's dense rows
// (J, [row][dof]), mass matrix, Hessian / Cholesky factor, row data and
// vectors live in shared memory (36.5 KB for the G1: six envs per SM), so
// the inner loops read shared memory, and the 32 lanes split each loop:
// rows in the row loops, dofs in the matrix-vector products, the rows of a
// column in the Hessian and the factor. Sums that feed a branch (costs,
// line-search slopes) are warp butterfly reductions, which leave every lane
// the same bits, so the warp takes every branch together. Matrix-vector
// products, the Hessian entries, the row products and the triangular
// solves keep the sequential order of the plain version
// (phys/solver_kernels.py); only the scalar sums over all rows are summed
// in another order.
//
// The TPU kernel's arithmetic is kept: the initial point is the cheaper of
// warmstart and a_smooth, the Cholesky is Jacobi-equilibrated with a 1e-6
// ridge, the line search takes 12 doubling probes then ls_iterations
// safeguarded Newton/bisection steps, a step is accepted only when the
// cost drops (ok), and the solve stops when gnorm2 < (tolerance*nv)^2 or
// not ok. On the TPU a 128-env tile iterates until all its envs are done
// and a done env takes step 0 (solver_pallas2.py:568); here the warp of an
// env leaves its loop when its env is done, which leaves the same x. Two
// exact zeros are skipped: contact rows whose activity flag is 0 (their J
// row, D and aref are 0) and, in the Hessian, rows with D * q = 0. The
// limit rows go through the lim_dofs table, which covers the contiguous
// and the scattered layouts alike (solver_pallas2.py:167-207).
#include "newton_common.cuh"

namespace {

struct SolveArgs {
  const float *Mc, *qfs, *ws, *qvel, *Mh, *Dnc, *arefnc, *flnc, *side;
  const float *cdof, *posk, *O1, *O2, *frame, *mu, *Dc, *bb, *kimp, *on;
  const float *W1, *W2;
  const int* lim;
  float *x, *fnc, *fcon, *qfrc, *asm_, *qint;
  int* iters;
  int nv, K, R, nlim, iterations, ls_iterations, do_int, E;
  float tolerance;
};

// floats of shared memory one env takes (the int lists count as floats)
__host__ __device__ inline int smem_floats(int nv, int RK, int nlim) {
  return RK * nv + 2 * nv * nv + 4 * RK + 2 * RK + 22 * nv + 6 * nlim;
}

// the env's shared-memory layout: the common part and the active rows
struct Env : EnvBase {
  int* act;
  int nact;
};

// row residuals at a point y: friction, limits, live contact rows
__device__ void jar_into(const Env& s, const float* y, float* jf, float* jl, float* jd) {
  for (int i = s.lane; i < s.nv; i += 32) jf[i] = y[i] - s.aref_fr[i];
  for (int l = s.lane; l < s.nlim; l += 32) jl[l] = s.side[l] * y[s.lim[l]] - s.aref_lim[l];
  for (int n = s.lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    jd[row] = row_dot(s, row, y) - s.arefd[row];
  }
  __syncwarp();
}

// cost of the rows at jar + t * v (v == nullptr: at jar)
__device__ float cost_rows(const Env& s, float t, const float* vf, const float* vl,
                           const float* vd) {
  float c = fr_lim_cost(s, t, vf, vl);
  for (int n = s.lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    const float j = s.jar_d[row] + (vd ? t * vd[row] : 0.f);
    if (j < 0.f) c = c + 0.5f * s.Dd[row] * j * j;
  }
  return warp_sum(c);
}

// out = f_fr + J^T f_d + limit scatter, forces at the current jar
__device__ void jt_forces(const Env& s, float* out) {
  for (int i = s.lane; i < s.nv; i += 32) {
    float acc = 0.f;
    for (int n = 0; n < s.nlive; ++n) {
      const int row = s.live[n];
      const float j = s.jar_d[row];
      const float fd = j < 0.f ? -s.Dd[row] * j : 0.f;
      acc = acc + s.J[row * s.nv + i] * fd;
    }
    out[i] = fr_force(s, i) + acc;
  }
  __syncwarp();
  lim_scatter(s, out);
}

__global__ void newton_solve_kernel(SolveArgs a) {
  const int E = a.E;
  const int e = blockIdx.x;
  const int nv = a.nv, K = a.K, R = a.R, nlim = a.nlim;
  const int RK = R * K;
  extern __shared__ float sm[];

  Env s;
  s.lane = threadIdx.x;
  s.nv = nv;
  s.nlim = nlim;
  float* p = sm;
  auto take = [&](int n) { float* q = p; p += n; return q; };
  s.J = take(RK * nv);
  s.M = take(nv * nv);
  s.L = take(nv * nv);
  s.Dd = take(RK);
  s.arefd = take(RK);
  s.jar_d = take(RK);
  s.v_d = take(RK);
  s.live = reinterpret_cast<int*>(take(RK));
  s.act = reinterpret_cast<int*>(take(RK));
  s.scale = take(nv); s.grad = take(nv); s.dx = take(nv); s.t1 = take(nv);
  s.t2 = take(nv); s.xm = take(nv); s.x = take(nv); s.jar_fr = take(nv);
  s.diagv = take(nv); s.work = take(nv); s.xt = take(nv); s.asm_ = take(nv);
  s.qv = take(nv); s.cdof = take(6 * nv); s.D_fr = take(nv);
  s.aref_fr = take(nv); s.fl_fr = take(nv);
  s.D_lim = take(nlim); s.aref_lim = take(nlim); s.side = take(nlim);
  s.jar_lim = take(nlim); s.v_lim = take(nlim);
  s.lim = reinterpret_cast<int*>(take(nlim));
  const int lane = s.lane;

  // ---------- the env's inputs into shared memory ----------
  load_common(s, a.Mc, a.cdof, a.qvel, a.Dnc, a.arefnc, a.flnc, a.side, a.lim, 0, E, e);
  __syncwarp();

  // ---------- phase A: dense contact rows (r-major), D and aref ----------
  s.nlive = compact(s, RK, nullptr, s.live, [&](int row) { return IN(a.on, row) != 0.f; });
  for (int n = lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    const int r = row / K, k = row - r * K;
    const int jdir = r >> 1;
    const float sgn = (r & 1) ? -1.f : 1.f;
    const float onv = IN(a.on, row);
    float pp[3], r1[3], r2[3], fr[9];
    for (int c = 0; c < 3; ++c) {
      pp[c] = IN(a.posk, c * K + k);
      r1[c] = pp[c] - IN(a.O1, c * K + k);
      r2[c] = pp[c] - IN(a.O2, c * K + k);
    }
    for (int c = 0; c < 9; ++c) fr[c] = IN(a.frame, c * K + k);
    const float muj = IN(a.mu, jdir * K + k);
    float vel = 0.f;
    float* Jr = s.J + row * nv;
    for (int i = 0; i < nv; ++i) {
      const float w1 = IN(a.W1, i * K + k), w2 = IN(a.W2, i * K + k);
      const float* cd = s.cdof + 6 * i;
      float jd[3];
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        const float j2 = cd[3 + c] + cd[c1] * r2[c2] - cd[c2] * r2[c1];
        const float j1 = cd[3 + c] + cd[c1] * r1[c2] - cd[c2] * r1[c1];
        jd[c] = j2 * w2 - j1 * w1;
      }
      const float f0 = fr[0] * jd[0] + fr[1] * jd[1] + fr[2] * jd[2];
      const float ft = fr[3 * (1 + jdir)] * jd[0] + fr[3 * (1 + jdir) + 1] * jd[1] +
                       fr[3 * (1 + jdir) + 2] * jd[2];
      const float jv = onv * (f0 + sgn * (muj * ft));
      Jr[i] = jv;
      vel = vel + jv * s.qv[i];
    }
    s.Dd[row] = onv * IN(a.Dc, k);
    s.arefd[row] = onv * (-IN(a.bb, k) * vel - IN(a.kimp, k));
  }
  __syncwarp();

  // ---------- unconstrained acceleration: M a_smooth = qfrc_smooth ----------
  smooth_acceleration(s, a.qfs, E, e);

  // ---------- initial point: the cheaper of warmstart and a_smooth ----------
  for (int i = lane; i < nv; i += 32) s.xt[i] = IN(a.ws, i);
  __syncwarp();
  jar_into(s, s.xt, s.jar_fr, s.jar_lim, s.jar_d);
  const float c_ws = smooth_cost(s, s.xt, 0.f, nullptr) + cost_rows(s, 0.f, nullptr, nullptr, nullptr);
  jar_into(s, s.asm_, s.jar_fr, s.jar_lim, s.jar_d);
  const float c_sm = smooth_cost(s, s.asm_, 0.f, nullptr) + cost_rows(s, 0.f, nullptr, nullptr, nullptr);
  const bool take_ws = c_ws < c_sm;
  for (int i = lane; i < nv; i += 32) s.x[i] = take_ws ? s.xt[i] : s.asm_[i];
  __syncwarp();
  if (take_ws) jar_into(s, s.x, s.jar_fr, s.jar_lim, s.jar_d);
  float cost_x = take_ws ? c_ws : c_sm;

  const float tol2 = (a.tolerance * nv) * (a.tolerance * nv);
  int it = 0;
  bool done = false;
  for (; it < a.iterations && !done; ++it) {
    // gradient: M (x - a_smooth) - J^T f
    for (int i = lane; i < nv; i += 32) s.xm[i] = s.x[i] - s.asm_[i];
    __syncwarp();
    mat_vec(s, s.M, s.xm, s.t1);
    jt_forces(s, s.work);
    float gp = 0.f;
    for (int i = lane; i < nv; i += 32) {
      const float g = s.t1[i] - s.work[i];
      s.grad[i] = g;
      gp = gp + g * g;
    }
    const float gnorm2 = warp_sum(gp);

    // Hessian H = M + diag(friction, limits) + J^T diag(D q) J (lower)
    fr_lim_diag(s);
    s.nact = compact(s, s.nlive, s.live, s.act,
                     [&](int row) { return s.jar_d[row] < 0.f && s.Dd[row] > 0.f; });
    for (int j = 0; j < nv; ++j)
      for (int i = j + lane; i < nv; i += 32) {
        float acc = 0.f;
        for (int n = 0; n < s.nact; ++n) {
          const float* Jr = s.J + s.act[n] * nv;
          acc = acc + Jr[i] * (Jr[j] * s.Dd[s.act[n]]);
        }
        const float h = s.M[j * nv + i] + (i == j ? s.diagv[i] : 0.f);
        s.L[j * nv + i] = h + acc;
      }
    __syncwarp();
    newton_direction(s);

    // search direction in row space
    for (int l = lane; l < nlim; l += 32) s.v_lim[l] = s.side[l] * s.dx[s.lim[l]];
    for (int n = lane; n < s.nlive; n += 32) s.v_d[s.live[n]] = row_dot(s, s.live[n], s.dx);
    __syncwarp();
    float q1, q2;
    smooth_quadratic(s, q1, q2);

    // slope (and curvature) of the cost along dx at step al
    auto dphi = [&](float al, bool need_h, float* d2out) {
      float sl = 0.f, hl = 0.f;
      fr_lim_slope(s, al, need_h, sl, hl);
      for (int n = lane; n < s.nlive; n += 32) {
        const int row = s.live[n];
        const float v = s.v_d[row];
        const float j = s.jar_d[row] + al * v;
        if (j < 0.f) {
          const float D = s.Dd[row];
          sl = sl + v * (-D * j);
          if (need_h && D > 0.f) hl = hl + D * v * v;
        }
      }
      const float ssum = warp_sum(sl);
      if (need_h) *d2out = q2 + warp_sum(hl);
      return q1 + al * q2 - ssum;
    };
    const float step = line_search(dphi, a.ls_iterations);

    // accept when the cost drops (ok), else stop
    const float cost_new =
        smooth_cost(s, s.x, step, s.dx) + cost_rows(s, step, s.dx, s.v_lim, s.v_d);
    const bool ok = isfinite(cost_new) && cost_new < cost_x;
    if (ok) {
      advance(s, step);
      __syncwarp();
      cost_x = cost_new;
    }
    done = gnorm2 < tol2 || !ok;
  }
  if (lane == 0) IN(a.iters, 0) = it;

  // ---------- outputs ----------
  store_common(s, a.x, a.asm_, a.fnc, 0, E, e);
  for (int row = lane; row < RK; row += 32) IN(a.fcon, row) = 0.f;
  __syncwarp();
  for (int n = lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    const float j = s.jar_d[row];
    IN(a.fcon, row) = j < 0.f ? -s.Dd[row] * j : 0.f;
  }
  jt_forces(s, s.work);
  for (int i = lane; i < nv; i += 32) IN(a.qfrc, i) = s.work[i];
  store_qacc_int(s, a.Mh, a.qint, a.do_int, E, e);
}

}  // namespace

extern "C" const char* mjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int newton_solve_launch(
    const float* Mc, const float* qfs, const float* ws, const float* qvel,
    const float* Mh, const float* Dnc, const float* arefnc, const float* flnc,
    const float* side, const float* cdof, const float* posk, const float* O1,
    const float* O2, const float* frame, const float* mu, const float* Dc,
    const float* bb, const float* kimp, const float* on, const float* W1,
    const float* W2, const int* lim, float* x, float* fnc, float* fcon,
    float* qfrc, float* asm_, float* qint, int* iters, int nv, int K, int R,
    int nlim, int iterations, int ls_iterations, float tolerance, int do_int,
    int E, cudaStream_t stream) {
  SolveArgs a;
  a.Mc = Mc; a.qfs = qfs; a.ws = ws; a.qvel = qvel; a.Mh = Mh; a.Dnc = Dnc;
  a.arefnc = arefnc; a.flnc = flnc; a.side = side; a.cdof = cdof;
  a.posk = posk; a.O1 = O1; a.O2 = O2; a.frame = frame; a.mu = mu; a.Dc = Dc;
  a.bb = bb; a.kimp = kimp; a.on = on; a.W1 = W1; a.W2 = W2; a.lim = lim;
  a.x = x; a.fnc = fnc; a.fcon = fcon; a.qfrc = qfrc; a.asm_ = asm_;
  a.qint = qint; a.iters = iters;
  a.nv = nv; a.K = K; a.R = R; a.nlim = nlim;
  a.iterations = iterations; a.ls_iterations = ls_iterations;
  a.do_int = do_int; a.E = E; a.tolerance = tolerance;
  const size_t smem = sizeof(float) * (size_t)smem_floats(nv, R * K, nlim);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        newton_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  newton_solve_kernel<<<E, 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
