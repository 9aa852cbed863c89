// newton_solve_dense: Newton constraint solve over a dense, materialised
// constraint Jacobian, one warp per env.
//
// Replaces the TPU kernel newton_solve_pallas / newton_solve_pallas_envlast
// (mjlab_tpu/phys/solver_pallas.py: kernel _make_kernel at :40, launcher
// _newton_call at :230, pallas_call at :255), the constraint solve of
// Simulation.forward(). Unlike newton_solve.cu, which rebuilds the contact
// rows from per-slot tensors and keeps the friction and limit rows
// implicit, every row here is dense: Jt (nv, nefc, E) arrives whole, with a
// class per row (equality, dof friction, one-sided).
//
// What bounds it on an H100: operations and the latency between them, as
// for newton_solve.cu. Each Newton iteration builds the Hessian M + J^T
// diag(D q) J (nv^2/2 multiply-adds per active row), factors it (nv^3/6),
// and runs 12 + ls_iterations line-search probes over the live rows. The
// bytes (Jt, 28.6 KB per env at the G1's shapes, read once) come second.
//
// Design: one warp per env, one env per block. The live rows of the env's
// J ([row][dof]), the mass matrix, the Hessian / Cholesky factor and the
// row and dof vectors live in shared memory (46.3 KB per env at nv 35,
// nefc 204: four envs per SM). The one-warp routines are in
// newton_common.cuh: the equilibrated Cholesky with its 1e-6 ridge, the
// triangular solves, the mass-matrix products, the line search, the warp
// butterfly sums (every sum that feeds a branch leaves every lane the same
// bits, so the warp branches together).
//
// Load pattern: in the env-last Jt one env's entries lie E floats apart,
// so each 4-byte load of a warp that loads one env touches a 32-byte sector
// of its own (8x the bytes it uses); the neighbouring envs' blocks read the
// other 7 floats of each sector at about the same time, which L2 may
// serve. Only live rows are loaded: a row with D = 0 (an inactive limit or
// contact row) adds exactly nothing to the cost, the forces or the
// Hessian, so it is skipped everywhere and its force written as 0. Rows
// with D q = 0 are skipped in the Hessian.
//
// The TPU kernel's arithmetic is kept: the initial point is the cheaper of
// warmstart and a_smooth, a step is accepted only when the cost drops, and
// an env is done when gnorm2 < (tolerance nv)^2 or a step is rejected. The
// TPU's 128-env tile iterates until all its envs are done, with step 0 for
// a done env (which is then rejected); here the warp leaves its loop when
// its env is done, which leaves the same x.
#include "newton_common.cuh"

namespace {

enum RowClass { kEquality = 0, kFriction = 1, kOneSided = 2 };

struct DenseArgs {
  const float *Jt, *D, *aref, *fl, *M, *asm_, *ws;
  const int* cls;
  float *x, *force;
  int* iters;
  int nv, nefc, iterations, ls_iterations, E;
  float tolerance;
};

// floats of shared memory one env takes (the int lists count as floats)
__host__ __device__ inline int dense_smem_floats(int nv, int nefc) {
  return nefc * nv + 2 * nv * nv + 8 * nefc + 10 * nv;
}

struct Env : EnvBase {
  float* fl;
  int *cls, *act;
  int nact;
};

// the row's force at residual j (solver_pallas.py row_forces)
__device__ __forceinline__ float row_force(int c, float D, float fl, float j) {
  const float fq = -D * j;
  if (c == kEquality) return fq;
  if (c == kFriction) return fminf(fmaxf(fq, -fl), fl);
  if (c == kOneSided) return j < 0.f ? fq : 0.f;
  return 0.f;
}

// whether the row is in its quadratic zone (and D > 0) at residual j
__device__ __forceinline__ bool row_quad(int c, float D, float fl, float j) {
  if (!(D > 0.f)) return false;
  if (c == kEquality) return true;
  if (c == kFriction) return fabsf(-D * j) <= fl;
  if (c == kOneSided) return j < 0.f;
  return false;
}

// the row's cost at residual j (solver_pallas.py cost_rows)
__device__ __forceinline__ float row_cost(int c, float D, float fl, float j) {
  const float quad = 0.5f * D * j * j;
  if (c == kEquality) return quad;
  if (c == kFriction)
    return fabsf(D * j) <= fl ? quad : fl * fabsf(j) - 0.5f * fl * fl / fmaxf(D, kEps);
  if (c == kOneSided) return j < 0.f ? quad : 0.f;
  return 0.f;
}

// residuals J y - aref of the live rows
__device__ void jar_into(const Env& s, const float* y) {
  for (int n = s.lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    s.jar_d[row] = row_dot(s, row, y) - s.arefd[row];
  }
  __syncwarp();
}

// cost of the live rows at jar + t * v (vd == nullptr: at jar)
__device__ float cost_rows(const Env& s, float t, const float* vd) {
  float c = 0.f;
  for (int n = s.lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    const float j = s.jar_d[row] + (vd ? t * vd[row] : 0.f);
    c = c + row_cost(s.cls[row], s.Dd[row], s.fl[row], j);
  }
  return warp_sum(c);
}

// out = J^T f at the current residuals, summed over the live rows in order
__device__ void jt_forces(const Env& s, float* out) {
  for (int i = s.lane; i < s.nv; i += 32) {
    float acc = 0.f;
    for (int n = 0; n < s.nlive; ++n) {
      const int row = s.live[n];
      const float f = row_force(s.cls[row], s.Dd[row], s.fl[row], s.jar_d[row]);
      acc = acc + s.J[row * s.nv + i] * f;
    }
    out[i] = acc;
  }
  __syncwarp();
}

__global__ void newton_solve_dense_kernel(DenseArgs a) {
  const int E = a.E;
  const int e = blockIdx.x;
  const int nv = a.nv, nefc = a.nefc;
  extern __shared__ float sm[];

  Env s = {};
  s.lane = threadIdx.x;
  s.nv = nv;
  float* p = sm;
  auto take = [&](int n) { float* q = p; p += n; return q; };
  s.J = take(nefc * nv);
  s.M = take(nv * nv);
  s.L = take(nv * nv);
  s.Dd = take(nefc);
  s.arefd = take(nefc);
  s.fl = take(nefc);
  s.jar_d = take(nefc);
  s.v_d = take(nefc);
  s.cls = reinterpret_cast<int*>(take(nefc));
  s.live = reinterpret_cast<int*>(take(nefc));
  s.act = reinterpret_cast<int*>(take(nefc));
  s.scale = take(nv); s.grad = take(nv); s.dx = take(nv); s.t1 = take(nv);
  s.t2 = take(nv); s.xm = take(nv); s.x = take(nv); s.work = take(nv);
  s.xt = take(nv); s.asm_ = take(nv);
  const int lane = s.lane;

  // ---------- the env's rows, mass matrix and vectors ----------
  for (int r = lane; r < nefc; r += 32) {
    s.Dd[r] = IN(a.D, r);
    s.arefd[r] = IN(a.aref, r);
    s.fl[r] = IN(a.fl, r);
    s.cls[r] = a.cls[r];
  }
  __syncwarp();
  s.nlive = compact(s, nefc, nullptr, s.live, [&](int row) {
    return s.Dd[row] != 0.f && s.cls[row] <= kOneSided;
  });
  for (int n = 0; n < s.nlive; ++n) {
    const int row = s.live[n];
    for (int i = lane; i < nv; i += 32) s.J[row * nv + i] = IN(a.Jt, i * nefc + row);
  }
  // M (nv, nv, E) row-major into the column-major s.M
  for (int r = lane; r < nv * nv; r += 32) {
    const int i = r / nv, j = r - i * nv;
    s.M[j * nv + i] = IN(a.M, r);
  }
  for (int i = lane; i < nv; i += 32) {
    s.asm_[i] = IN(a.asm_, i);
    s.xt[i] = IN(a.ws, i);
  }
  __syncwarp();

  // ---------- initial point: the cheaper of warmstart and a_smooth ----------
  jar_into(s, s.xt);
  const float c_ws = smooth_cost(s, s.xt, 0.f, nullptr) + cost_rows(s, 0.f, nullptr);
  jar_into(s, s.asm_);
  const float c_sm = smooth_cost(s, s.asm_, 0.f, nullptr) + cost_rows(s, 0.f, nullptr);
  const bool take_ws = c_ws < c_sm;
  for (int i = lane; i < nv; i += 32) s.x[i] = take_ws ? s.xt[i] : s.asm_[i];
  __syncwarp();
  if (take_ws) jar_into(s, s.x);
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

    // Hessian H = M + J^T diag(D q) J (lower triangle, column-major)
    s.nact = compact(s, s.nlive, s.live, s.act, [&](int row) {
      return row_quad(s.cls[row], s.Dd[row], s.fl[row], s.jar_d[row]);
    });
    for (int j = 0; j < nv; ++j)
      for (int i = j + lane; i < nv; i += 32) {
        float acc = 0.f;
        for (int n = 0; n < s.nact; ++n) {
          const float* Jr = s.J + s.act[n] * nv;
          acc = acc + (Jr[j] * s.Dd[s.act[n]]) * Jr[i];
        }
        s.L[j * nv + i] = acc + s.M[j * nv + i];
      }
    __syncwarp();
    newton_direction(s);

    // search direction in row space
    for (int n = lane; n < s.nlive; n += 32) s.v_d[s.live[n]] = row_dot(s, s.live[n], s.dx);
    __syncwarp();
    float q1, q2;
    smooth_quadratic(s, q1, q2);

    // slope (and curvature) of the cost along dx at step al
    auto dphi = [&](float al, bool need_h, float* d2out) {
      float sl = 0.f, hl = 0.f;
      for (int n = lane; n < s.nlive; n += 32) {
        const int row = s.live[n];
        const int c = s.cls[row];
        const float v = s.v_d[row], D = s.Dd[row], fl = s.fl[row];
        const float j = s.jar_d[row] + al * v;
        sl = sl + v * row_force(c, D, fl, j);
        if (need_h && row_quad(c, D, fl, j)) hl = hl + D * v * v;
      }
      const float ssum = warp_sum(sl);
      if (need_h) *d2out = q2 + warp_sum(hl);
      return q1 + al * q2 - ssum;
    };
    const float step = line_search(dphi, a.ls_iterations);

    // accept when the cost drops (ok), else stop
    const float cost_new = smooth_cost(s, s.x, step, s.dx) + cost_rows(s, step, s.v_d);
    const bool ok = isfinite(cost_new) && cost_new < cost_x;
    if (ok) {
      for (int i = lane; i < nv; i += 32) s.x[i] = s.x[i] + step * s.dx[i];
      for (int n = lane; n < s.nlive; n += 32) {
        const int row = s.live[n];
        s.jar_d[row] = s.jar_d[row] + step * s.v_d[row];
      }
      __syncwarp();
      cost_x = cost_new;
    }
    done = gnorm2 < tol2 || !ok;
  }
  if (lane == 0) IN(a.iters, 0) = it;

  // ---------- outputs: qacc and every row's force ----------
  for (int i = lane; i < nv; i += 32) IN(a.x, i) = s.x[i];
  for (int r = lane; r < nefc; r += 32) IN(a.force, r) = 0.f;
  __syncwarp();
  for (int n = lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    IN(a.force, row) = row_force(s.cls[row], s.Dd[row], s.fl[row], s.jar_d[row]);
  }
}

}  // namespace

extern "C" const char* mjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

extern "C" int newton_solve_dense_smem_bytes(int nv, int nefc) {
  return static_cast<int>(sizeof(float)) * dense_smem_floats(nv, nefc);
}

extern "C" int newton_solve_dense_launch(
    const float* Jt, const float* D, const float* aref, const float* fl,
    const float* M, const float* asm_, const float* ws, const int* cls, float* x,
    float* force, int* iters, int nv, int nefc, int iterations, int ls_iterations,
    float tolerance, int E, cudaStream_t stream) {
  DenseArgs a;
  a.Jt = Jt; a.D = D; a.aref = aref; a.fl = fl; a.M = M; a.asm_ = asm_; a.ws = ws;
  a.cls = cls; a.x = x; a.force = force; a.iters = iters;
  a.nv = nv; a.nefc = nefc; a.iterations = iterations;
  a.ls_iterations = ls_iterations; a.E = E; a.tolerance = tolerance;
  const size_t smem = sizeof(float) * (size_t)dense_smem_floats(nv, nefc);
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        newton_solve_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  newton_solve_dense_kernel<<<E, 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
