// newton_solve_elliptic: contact-Jacobian assembly + Newton constraint
// solve + implicit velocity update under the elliptic friction cone, with
// joint-equality rows, one warp per env.
//
// Replaces the TPU kernel newton_assemble_solve with cone=1
// (mjlab_tpu/phys/solver_pallas2.py:623, kernel _make_kernel at :46 with
// its elliptic branches 92-106, 216-260, 433-485 and 521-546, pallas_call
// at :674). Its pyramidal sibling is csrc/newton_solve.cu (cone=0), whose
// structure this kernel shares; the parts that do not depend on the cone
// (the Cholesky, the line search, the friction and limit rows) are in
// newton_common.cuh. They are separate sources so that each cone's build
// is only its own code.
//
// What bounds it on an H100: operations, and the latency between them.
// Each Newton iteration builds the Hessian M + sum_k J_k^T B_k J_k with a
// dense (R, R) cone block B_k per contact, factors it (nv^3/6), and runs
// 12 + ls_iterations line-search probes, each evaluating every contact's
// 3-zone cone state; inputs and outputs are tens of KB per env, read and
// written once. Every step depends on the one before.
//
// Design: one warp per env, one env per block, as the pyramidal kernel.
// The env's dense rows (J, [row][dof]: contacts r-major, then the equality
// rows), mass matrix, Hessian / Cholesky factor, cone blocks, row data and
// vectors live in shared memory (newton_solve_elliptic_smem_bytes: 39.6 KB
// for the YAM lift-cube model, five envs per SM). The 32 lanes split each
// loop: contacts in the cone loops, rows in the row loops, dofs in the
// matrix-vector products, the rows of a column in the Hessian and the
// factor. Sums that feed a branch (costs, line-search slopes) are warp
// butterfly reductions, which leave every lane the same bits, so the warp
// takes every branch together. Matrix-vector products, the Hessian
// entries, the row products and the triangular solves keep the sequential
// order of the plain version (phys/solver_kernels.py); only the scalar
// sums over all rows are summed in another order.
//
// The cone (lm/solver.py _ell_*): a contact's rows are the frame
// components [n, t1, t2, torsion, roll1, roll2][:R]; its cost is the
// 3-zone cone cost of x = sqrt(D) * jar (bottom: quadratic, middle: the
// cone's quadratic less its normal part, top: zero), with the whitened
// cone coefficient mu / sqrt(impratio). A contact's Hessian block is
// built once per Newton iteration into shared memory and applied one
// column of H at a time (a column of B J, then the column of J^T (B J)),
// which needs one extra row vector instead of a second copy of J. The
// equality rows are bilateral quadratics.
//
// The TPU kernel's arithmetic is kept, as in the pyramidal kernel: the
// initial point is the cheaper of warmstart and a_smooth, the Cholesky is
// Jacobi-equilibrated with a 1e-6 ridge, the line search takes 12
// doubling probes then ls_iterations safeguarded Newton/bisection steps,
// a step is accepted only when the cost drops (ok), and the solve stops
// when gnorm2 < (tolerance*nv)^2 or not ok; the warp of an env leaves its
// loop when its env is done. Exact zeros are skipped: contact rows whose
// activity flag is 0 (their J row, D and aref are 0), contacts with no
// active row, and cone blocks in the top zone.
#include "newton_common.cuh"

namespace {

constexpr int kMaxR = 6;  // contact rows: [n, t1, t2, torsion, roll1, roll2]

struct SolveArgs {
  const float *Mc, *qfs, *ws, *qvel, *Mh, *Dnc, *arefnc, *flnc, *side, *Jeq;
  const float *cdof, *posk, *O1, *O2, *frame, *Dfri, *mut, *Dc, *bb, *kimp, *on;
  const float *W1, *W2;
  const int* lim;
  float *x, *fnc, *fcon, *qfrc, *asm_, *qint;
  int* iters;
  int nv, K, R, neq, nlim, iterations, ls_iterations, do_int, E;
  float tolerance;
};

// floats of shared memory one env takes (the int lists count as floats)
__host__ __device__ inline int smem_floats(int nv, int K, int R, int neq, int nlim) {
  const int RK = R * K, ND = RK + neq;
  return ND * nv + 2 * nv * nv + 4 * ND + RK + 22 * nv + 6 * nlim  // as pyramidal
         + K * R * R + 2 * ND + 4 * K;  // cone blocks, a B J column, forces, mut, lists
}

// the env's shared-memory layout: the common part, the equality rows
// (after the contact rows) and the cone
struct Env : EnvBase {
  int K, R, RK, neq;
  // cone blocks (K, R, R), a column of B J, row forces, the whitened cone
  // coefficient, live contacts, contacts with a block, block flags
  float *B, *bj, *fd, *mut;
  int *con, *hcon, *hflag;
  int ncon, nhcon;
};

// row residuals at a point y: friction, limits, live contact rows, equality
__device__ void jar_into(const Env& s, const float* y, float* jf, float* jl, float* jd) {
  for (int i = s.lane; i < s.nv; i += 32) jf[i] = y[i] - s.aref_fr[i];
  for (int l = s.lane; l < s.nlim; l += 32) jl[l] = s.side[l] * y[s.lim[l]] - s.aref_lim[l];
  for (int n = s.lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    jd[row] = row_dot(s, row, y) - s.arefd[row];
  }
  for (int q = s.lane; q < s.neq; q += 32) {
    const int row = s.RK + q;
    jd[row] = row_dot(s, row, y) - s.arefd[row];
  }
  __syncwarp();
}

// ---------- the elliptic cone of one contact (lm/solver.py _ell_*) ----------

struct Cone {
  float sD[kMaxR], x[kMaxR];
  float xn, tt, T, w, mut, c1;
  bool bottom, mid;
};

// the 3-zone state of contact k at jar + t * v (v == nullptr: at jar)
__device__ Cone cone_at(const Env& s, int k, float t, const float* v) {
  Cone c;
  for (int r = 0; r < s.R; ++r) {
    const int row = r * s.K + k;
    const float j = s.jar_d[row] + (v ? t * v[row] : 0.f);
    c.sD[r] = sqrtf(s.Dd[row]);
    c.x[r] = j * c.sD[r];
  }
  c.xn = c.x[0];
  float tt = c.x[1] * c.x[1];
  for (int r = 2; r < s.R; ++r) tt = tt + c.x[r] * c.x[r];
  c.tt = tt;
  c.T = sqrtf(fmaxf(tt, kEps * kEps));
  c.mut = s.mut[k];
  c.w = c.mut * c.xn + c.T;
  c.c1 = 1.f + c.mut * c.mut;
  const bool mu_pos = c.mut > 1e-9f;
  c.bottom = mu_pos ? c.w <= 0.f : c.xn < 0.f;
  const bool top = !c.bottom && (mu_pos ? c.xn >= c.mut * c.T : c.xn >= 0.f);
  c.mid = !c.bottom && !top;
  return c;
}

// force of row r (residual j, row D) of a contact in state c: -grad s
__device__ __forceinline__ float cone_force(const Cone& c, int r, float D, float j) {
  if (c.bottom) return -D * j;
  if (!c.mid) return 0.f;
  if (r == 0) return c.sD[0] * (c.mut * c.w / c.c1 - c.xn);
  return -c.sD[r] * c.x[r] * (1.f - c.w / (c.c1 * c.T));
}

__device__ __forceinline__ float cone_cost(const Cone& c) {
  const float norm2 = c.xn * c.xn + c.tt;
  if (c.bottom) return 0.5f * norm2;
  return c.mid ? 0.5f * (norm2 - c.w * c.w / c.c1) : 0.f;
}

// v' (hess s) v for the row-space direction v of contact k
__device__ float cone_curv(const Env& s, const Cone& c, int k, const float* v) {
  float vt[kMaxR];
  for (int r = 0; r < s.R; ++r) vt[r] = v[r * s.K + k] * c.sD[r];
  float vtt2 = vt[1] * vt[1];
  float tv = (c.x[1] / c.T) * vt[1];
  for (int r = 2; r < s.R; ++r) {
    vtt2 = vtt2 + vt[r] * vt[r];
    tv = tv + (c.x[r] / c.T) * vt[r];
  }
  const float quad = vt[0] * vt[0] + vtt2;
  const float gw = c.mut * vt[0] + tv;
  const float mid = quad - (gw * gw + (c.w / c.T) * (vtt2 - tv * tv)) / c.c1;
  if (c.bottom) return quad;
  return c.mid ? fmaxf(mid, 0.f) : 0.f;
}

// the (R, R) Hessian block of contact k's cone cost into B (row-major);
// returns whether it is nonzero (bottom or middle zone)
__device__ bool cone_block(const Env& s, const Cone& c, int k, float* B) {
  const int R = s.R;
  const float wT = c.w / c.T;
  for (int r = 0; r < R; ++r) {
    const float tr = r >= 1 ? c.x[r] / c.T : 0.f;
    const float gr = r >= 1 ? tr : c.mut;
    for (int q = 0; q < R; ++q) {
      const float tq = q >= 1 ? c.x[q] / c.T : 0.f;
      const float gq = q >= 1 ? tq : c.mut;
      const float delta = r == q ? 1.f : 0.f;
      const float pt = (r == q && r >= 1) ? 1.f : 0.f;
      float bm = delta - (gr * gq + wT * (pt - tr * tq)) / c.c1;
      bm = c.sD[r] * bm * c.sD[q];
      float v = 0.f;
      if (c.bottom) v = r == q ? s.Dd[r * s.K + k] : 0.f;
      else if (c.mid) v = bm;
      B[r * R + q] = v;
    }
  }
  return c.bottom || c.mid;
}

// ---------- costs, forces and the Hessian ----------

// cost of the rows at jar + t * v (v == nullptr: at jar)
__device__ float cost_rows(const Env& s, float t, const float* vf, const float* vl,
                           const float* vd) {
  float c = fr_lim_cost(s, t, vf, vl);
  for (int n = s.lane; n < s.ncon; n += 32) c = c + cone_cost(cone_at(s, s.con[n], t, vd));
  for (int q = s.lane; q < s.neq; q += 32) {
    const int row = s.RK + q;
    const float j = s.jar_d[row] + (vd ? t * vd[row] : 0.f);
    c = c + 0.5f * s.Dd[row] * j * j;
  }
  return warp_sum(c);
}

// the contact rows' forces at the current jar into s.fd
__device__ void cone_forces(const Env& s) {
  for (int n = s.lane; n < s.ncon; n += 32) {
    const int k = s.con[n];
    const Cone c = cone_at(s, k, 0.f, nullptr);
    for (int r = 0; r < s.R; ++r) {
      const int row = r * s.K + k;
      s.fd[row] = cone_force(c, r, s.Dd[row], s.jar_d[row]);
    }
  }
  __syncwarp();
}

// out = f_fr + J^T f_d + limit scatter, forces at the current jar (s.fd
// gets the contact rows' forces)
__device__ void jt_forces(const Env& s, float* out) {
  cone_forces(s);
  for (int i = s.lane; i < s.nv; i += 32) {
    float acc = 0.f;
    for (int n = 0; n < s.nlive; ++n) {
      const int row = s.live[n];
      acc = acc + s.J[row * s.nv + i] * s.fd[row];
    }
    for (int q = 0; q < s.neq; ++q) {
      const int row = s.RK + q;
      acc = acc + s.J[row * s.nv + i] * (-s.Dd[row] * s.jar_d[row]);
    }
    out[i] = fr_force(s, i) + acc;
  }
  __syncwarp();
  lim_scatter(s, out);
}

// equality rows' part of H entry (i, j)
__device__ __forceinline__ float eq_hess(const Env& s, int i, int j) {
  float acc = 0.f;
  for (int q = 0; q < s.neq; ++q) {
    const float* Jr = s.J + (s.RK + q) * s.nv;
    const float D = s.Dd[s.RK + q];
    if (D > 0.f) acc = acc + Jr[i] * (Jr[j] * D);
  }
  return acc;
}

// H = M + diag(friction, limits) + sum_k J_k^T B_k J_k + J_eq^T D J_eq
// (lower triangle)
__device__ void hessian(Env& s) {
  const int nv = s.nv;
  const int R = s.R, K = s.K;
  for (int n = s.lane; n < s.ncon; n += 32) {
    const int k = s.con[n];
    s.hflag[k] = cone_block(s, cone_at(s, k, 0.f, nullptr), k, s.B + k * R * R);
  }
  __syncwarp();
  s.nhcon = compact(s, s.ncon, s.con, s.hcon, [&](int k) { return s.hflag[k] != 0; });
  for (int j = 0; j < nv; ++j) {
    // column j of B J over the contacts with a block
    for (int idx = s.lane; idx < s.nhcon * R; idx += 32) {
      const int k = s.hcon[idx / R], r = idx % R;
      const float* B = s.B + k * R * R + r * R;
      float acc = 0.f;
      for (int q = 0; q < R; ++q) acc = acc + B[q] * s.J[(q * K + k) * nv + j];
      s.bj[r * K + k] = acc;
    }
    __syncwarp();
    for (int i = j + s.lane; i < nv; i += 32) {
      float acc = 0.f;
      for (int n = 0; n < s.nhcon; ++n) {
        const int k = s.hcon[n];
        for (int r = 0; r < R; ++r) acc = acc + s.J[(r * K + k) * nv + i] * s.bj[r * K + k];
      }
      acc = acc + eq_hess(s, i, j);
      const float h = s.M[j * nv + i] + (i == j ? s.diagv[i] : 0.f);
      s.L[j * nv + i] = h + acc;
    }
    __syncwarp();
  }
}

__global__ void newton_solve_elliptic_kernel(SolveArgs a) {
  const int E = a.E;
  const int e = blockIdx.x;
  const int nv = a.nv, K = a.K, R = a.R, neq = a.neq, nlim = a.nlim;
  const int RK = R * K, ND = RK + neq;
  extern __shared__ float sm[];

  Env s;
  s.lane = threadIdx.x;
  s.nv = nv;
  s.K = K;
  s.R = R;
  s.RK = RK;
  s.neq = neq;
  s.nlim = nlim;
  float* p = sm;
  auto take = [&](int n) { float* q = p; p += n; return q; };
  s.J = take(ND * nv);
  s.M = take(nv * nv);
  s.L = take(nv * nv);
  s.Dd = take(ND);
  s.arefd = take(ND);
  s.jar_d = take(ND);
  s.v_d = take(ND);
  s.live = reinterpret_cast<int*>(take(RK));
  s.scale = take(nv); s.grad = take(nv); s.dx = take(nv); s.t1 = take(nv);
  s.t2 = take(nv); s.xm = take(nv); s.x = take(nv); s.jar_fr = take(nv);
  s.diagv = take(nv); s.work = take(nv); s.xt = take(nv); s.asm_ = take(nv);
  s.qv = take(nv); s.cdof = take(6 * nv); s.D_fr = take(nv);
  s.aref_fr = take(nv); s.fl_fr = take(nv);
  s.D_lim = take(nlim); s.aref_lim = take(nlim); s.side = take(nlim);
  s.jar_lim = take(nlim); s.v_lim = take(nlim);
  s.lim = reinterpret_cast<int*>(take(nlim));
  s.B = take(K * R * R);
  s.bj = take(ND);
  s.fd = take(ND);
  s.mut = take(K);
  s.con = reinterpret_cast<int*>(take(K));
  s.hcon = reinterpret_cast<int*>(take(K));
  s.hflag = reinterpret_cast<int*>(take(K));
  const int lane = s.lane;

  // ---------- the env's inputs into shared memory ----------
  load_common(s, a.Mc, a.cdof, a.qvel, a.Dnc, a.arefnc, a.flnc, a.side, a.lim, neq, E, e);
  for (int r = lane; r < neq * nv; r += 32) s.J[RK * nv + r] = IN(a.Jeq, r);
  for (int q = lane; q < neq; q += 32) {
    s.Dd[RK + q] = IN(a.Dnc, q);
    s.arefd[RK + q] = IN(a.arefnc, q);
    s.v_d[RK + q] = 0.f;
  }
  // rows past a contact's dimension stay exact zeros
  for (int r = lane; r < RK * nv; r += 32) s.J[r] = 0.f;
  for (int r = lane; r < RK; r += 32) {
    s.Dd[r] = 0.f; s.arefd[r] = 0.f; s.jar_d[r] = 0.f; s.v_d[r] = 0.f;
  }
  for (int k = lane; k < K; k += 32) s.mut[k] = IN(a.mut, k);
  __syncwarp();

  // ---------- phase A: dense contact rows (r-major), D and aref ----------
  s.nlive = compact(s, RK, nullptr, s.live, [&](int row) { return IN(a.on, row) != 0.f; });
  s.ncon = compact(s, K, nullptr, s.con, [&](int k) { return IN(a.on, k) != 0.f; });
  for (int n = lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    const int r = row / K, k = row - r * K;
    const float onv = IN(a.on, row);
    float pp[3], r1[3], r2[3], fr[9];
    for (int c = 0; c < 3; ++c) {
      pp[c] = IN(a.posk, c * K + k);
      r1[c] = pp[c] - IN(a.O1, c * K + k);
      r2[c] = pp[c] - IN(a.O2, c * K + k);
    }
    for (int c = 0; c < 9; ++c) fr[c] = IN(a.frame, c * K + k);
    // frame row r of the point Jacobian (r < 3) or row r - 3 of the
    // angular one
    const int f = r < 3 ? r : r - 3;
    float vel = 0.f;
    float* Jr = s.J + row * nv;
    for (int i = 0; i < nv; ++i) {
      const float w1 = IN(a.W1, i * K + k), w2 = IN(a.W2, i * K + k);
      const float* cd = s.cdof + 6 * i;
      float jd[3];
      if (r >= 3) {
        for (int c = 0; c < 3; ++c) jd[c] = cd[c] * (w2 - w1);
      } else {
        for (int c = 0; c < 3; ++c) {
          const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
          const float j2 = cd[3 + c] + cd[c1] * r2[c2] - cd[c2] * r2[c1];
          const float j1 = cd[3 + c] + cd[c1] * r1[c2] - cd[c2] * r1[c1];
          jd[c] = j2 * w2 - j1 * w1;
        }
      }
      const float jv = onv * (fr[3 * f] * jd[0] + fr[3 * f + 1] * jd[1] + fr[3 * f + 2] * jd[2]);
      Jr[i] = jv;
      vel = vel + jv * s.qv[i];
    }
    // normal row: the slot's D and impedance term; friction row r: its D
    s.Dd[row] = onv * (r == 0 ? IN(a.Dc, k) : IN(a.Dfri, (r - 1) * K + k));
    s.arefd[row] = onv * (-IN(a.bb, k) * vel - (r == 0 ? IN(a.kimp, k) : 0.f));
  }
  __syncwarp();

  // ---------- unconstrained acceleration: M a_smooth = qfrc_smooth ----------
  smooth_acceleration(s, a.qfs, E, e);

  // ---------- initial point: the cheaper of warmstart and a_smooth ----------
  for (int i = lane; i < nv; i += 32) s.xt[i] = IN(a.ws, i);
  __syncwarp();
  jar_into(s, s.xt, s.jar_fr, s.jar_lim, s.jar_d);
  const float c_ws = smooth_cost(s, s.xt, 0.f, nullptr) +
                     cost_rows(s, 0.f, nullptr, nullptr, nullptr);
  jar_into(s, s.asm_, s.jar_fr, s.jar_lim, s.jar_d);
  const float c_sm = smooth_cost(s, s.asm_, 0.f, nullptr) +
                     cost_rows(s, 0.f, nullptr, nullptr, nullptr);
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

    // Hessian and the Newton direction
    fr_lim_diag(s);
    hessian(s);
    newton_direction(s);

    // search direction in row space
    for (int l = lane; l < nlim; l += 32) s.v_lim[l] = s.side[l] * s.dx[s.lim[l]];
    for (int n = lane; n < s.nlive; n += 32) s.v_d[s.live[n]] = row_dot(s, s.live[n], s.dx);
    for (int q = lane; q < neq; q += 32) s.v_d[RK + q] = row_dot(s, RK + q, s.dx);
    __syncwarp();
    float q1, q2;
    smooth_quadratic(s, q1, q2);

    // slope (and curvature) of the cost along dx at step al
    auto dphi = [&](float al, bool need_h, float* d2out) {
      float sl = 0.f, hl = 0.f;
      fr_lim_slope(s, al, need_h, sl, hl);
      for (int n = lane; n < s.ncon; n += 32) {
        const int k = s.con[n];
        const Cone c = cone_at(s, k, al, s.v_d);
        for (int r = 0; r < R; ++r) {
          const int row = r * K + k;
          const float v = s.v_d[row];
          sl = sl + v * cone_force(c, r, s.Dd[row], s.jar_d[row] + al * v);
        }
        if (need_h) hl = hl + cone_curv(s, c, k, s.v_d);
      }
      for (int q = lane; q < neq; q += 32) {
        const int row = RK + q;
        const float v = s.v_d[row];
        const float D = s.Dd[row];
        sl = sl + v * (-D * (s.jar_d[row] + al * v));
        if (need_h && D > 0.f) hl = hl + D * v * v;
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
      for (int q = lane; q < neq; q += 32)
        s.jar_d[RK + q] = s.jar_d[RK + q] + step * s.v_d[RK + q];
      __syncwarp();
      cost_x = cost_new;
    }
    done = gnorm2 < tol2 || !ok;
  }
  if (lane == 0) IN(a.iters, 0) = it;

  // ---------- outputs ----------
  // non-contact forces in the canonical order [equality, friction, limits]
  for (int q = lane; q < neq; q += 32) IN(a.fnc, q) = -s.Dd[RK + q] * s.jar_d[RK + q];
  store_common(s, a.x, a.asm_, a.fnc, neq, E, e);
  for (int row = lane; row < RK; row += 32) IN(a.fcon, row) = 0.f;
  jt_forces(s, s.work);  // (fills s.fd at the final jar)
  for (int n = lane; n < s.nlive; n += 32) {
    const int row = s.live[n];
    IN(a.fcon, row) = s.fd[row];
  }
  for (int i = lane; i < nv; i += 32) IN(a.qfrc, i) = s.work[i];
  store_qacc_int(s, a.Mh, a.qint, a.do_int, E, e);
}

}  // namespace

extern "C" const char* mjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// bytes of shared memory a block (one env) of the kernel takes
extern "C" int newton_solve_elliptic_smem_bytes(int nv, int K, int R, int neq, int nlim) {
  return static_cast<int>(sizeof(float)) * smem_floats(nv, K, R, neq, nlim);
}

extern "C" int newton_solve_elliptic_launch(
    const float* Mc, const float* qfs, const float* ws, const float* qvel,
    const float* Mh, const float* Dnc, const float* arefnc, const float* flnc,
    const float* side, const float* Jeq, const float* cdof, const float* posk,
    const float* O1, const float* O2, const float* frame, const float* Dfri,
    const float* mut, const float* Dc, const float* bb, const float* kimp,
    const float* on, const float* W1, const float* W2, const int* lim, float* x,
    float* fnc, float* fcon, float* qfrc, float* asm_, float* qint, int* iters,
    int nv, int K, int R, int neq, int nlim, int iterations, int ls_iterations,
    float tolerance, int do_int, int E, cudaStream_t stream) {
  SolveArgs a;
  a.Mc = Mc; a.qfs = qfs; a.ws = ws; a.qvel = qvel; a.Mh = Mh; a.Dnc = Dnc;
  a.arefnc = arefnc; a.flnc = flnc; a.side = side; a.Jeq = Jeq; a.cdof = cdof;
  a.posk = posk; a.O1 = O1; a.O2 = O2; a.frame = frame; a.Dfri = Dfri;
  a.mut = mut; a.Dc = Dc; a.bb = bb; a.kimp = kimp; a.on = on; a.W1 = W1;
  a.W2 = W2; a.lim = lim;
  a.x = x; a.fnc = fnc; a.fcon = fcon; a.qfrc = qfrc; a.asm_ = asm_;
  a.qint = qint; a.iters = iters;
  a.nv = nv; a.K = K; a.R = R; a.neq = neq; a.nlim = nlim;
  a.iterations = iterations; a.ls_iterations = ls_iterations;
  a.do_int = do_int; a.E = E; a.tolerance = tolerance;
  const size_t smem = static_cast<size_t>(newton_solve_elliptic_smem_bytes(nv, K, R, neq, nlim));
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        newton_solve_elliptic_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  newton_solve_elliptic_kernel<<<E, 32, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}
