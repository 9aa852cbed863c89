// newton_block.cuh: the Newton constraint solve of the port's three solve
// kernels, one env per block of kThreads threads: newton_solve.cu (the
// fused contact-Jacobian assembly, pyramidal cone), newton_solve_elliptic.cu
// (the same, elliptic cone) and newton_solve_dense.cu (the solve over a
// dense, materialised Jacobian). This header holds all of it but the rows:
// the shared-memory layout, the loads, the dof-friction and limit rows,
// the register-tiled Hessian and Cholesky, the triangular solves, the line
// search and the outputs, in one routine (solve_env) templated on a row
// policy (the dense rows: their assembly or loads, forces, costs, slopes
// and Hessian terms), which each .cu file supplies. A policy with
// kImplicitRows (kernels 4 and 5) has the dof-friction and limit rows
// carried implicitly, solves a_smooth from qfrc_smooth and writes
// qfrc_constraint, a_smooth and qacc_int; the dense policy (kernel 6) has
// every row dense, takes a_smooth as an input and writes its own outputs.
//
// Who does what. The four warps split the matrix work: phase A (one
// (slot, dof) pair per thread), the row products, the gradient, the
// Hessian (a 3x3 tile of its lower triangle per thread, kept in registers)
// and the Cholesky (right-looking by panels of three columns on those
// register tiles: warp 0 factors a panel, the tiles right of it take its
// update, two barriers per panel). Warp 0 alone runs the scalar sequence
// that decides each step:
// the costs, q1 and q2, the gradient norm, and the line search, with the
// lane-strided sums and butterflies of a one-warp-per-env solve, so every
// lane holds the same bits and the arithmetic of each decision is that of
// the one-warp kernel (its per-lane order, its reduction tree); it hands
// the step to the block through shared memory. The f32 solve's acceptance
// test and its 20-probe line search flip on rounding, so the kernel keeps
// the one-warp kernel's order wherever a sum feeds them.
//
// IN(p, r) reads row r of an env-last (rows, E) input for env e; the
// callers name the env count E and the env e.
#pragma once

#include <cuda_runtime.h>

#include "newton_phases.cuh"

#define FULL 0xffffffffu
#define IN(p, r) (p)[(size_t)(r) * E + e]

namespace {

constexpr float kEps = 1e-12f;
constexpr float kRidge = 1e-6f;
constexpr int kThreads = 128;            // threads per env (one env per block)
constexpr int kTile = 3;                 // a thread's Hessian / factor entries: a kTile^2 tile
constexpr int kMaxNv = 45;               // one tile per thread: 15 * 16 / 2 tiles <= kThreads
constexpr int kDoubling = 12;            // doubling probes of the line search
constexpr int kShapeMismatch = 1001;     // launcher error: not the kernel's launch shape

// a warp butterfly sum: every lane gets the same bits
__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  return v;
}

// dof vectors, nv floats each
enum DofVec {
  kX, kAsm, kGrad, kDx, kT1, kT2, kXm, kScale, kPivot, kYb, kQv, kDfr, kArefFr, kFlFr, kJarFr,
  kNumDofVecs
};
// limit-row vectors, nlim floats each
enum LimVec { kDlim, kArefLim, kSide, kJarLim, kVlim, kNumLimVecs };
// dense-row vectors, ND floats each: the contact rows r-major (row r of
// slot k at r * K + k), then the equality rows
enum RowVec { kDd, kArefD, kJarD, kVd, kFd, kNumRowVecs };
// what warp 0 hands the block: the step, whether it was taken, whether the
// solve is done, the initial point's choice
enum Bcast { kStep, kOk, kDone, kTakeWs, kNumBcast };

// floats of shared memory one env takes (int lists count as floats): J
// (ND rows), M, L (which holds cdof during the loads), the row, dof and
// limit vectors with their int tables, the live slots, warp 0's four
// results and four counts; the elliptic cone adds the whitened cone
// coefficients, the zone flags and two (R, nv) buffers of B_k J_k
__host__ __device__ inline int env_floats(int nv, int K, int R, int neq, int nlim,
                                          bool elliptic) {
  const int ND = R * K + neq;
  const int nL = nv * nv > 6 * nv ? nv * nv : 6 * nv;
  int n = ND * nv + nv * nv + nL + kNumRowVecs * ND + ND + kNumDofVecs * nv + nv +
          kNumLimVecs * nlim + nlim + K + kNumBcast + 4;
  if (elliptic) n += 2 * K + 2 * R * nv;
  return n;
}

struct SolveArgs {
  const float *Mc, *qfs, *ws, *qvel, *Mh, *Dnc, *arefnc, *flnc, *side, *Jeq;
  const float *cdof, *posk, *O1, *O2, *frame, *mu, *mut, *Dc, *bb, *kimp, *on;
  const float *W1, *W2;
  const int* lim;
  float *x, *fnc, *fcon, *qfrc, *asm_, *qint;
  int* iters;
  int nv, K, R, neq, nlim, iterations, ls_iterations, do_int, E;
  float tolerance;
  // the dense solve (newton_solve_dense.cu): Jt (nv, nefc, E), the rows'
  // D, aref and frictionloss (nefc, E), their classes (nefc), a_smooth
  // (nv, E) in, every row's force (nefc, E) out; at most ncap live rows
  const float *Jt, *Dr, *arefr, *flr, *asm_in;
  const int* cls;
  float* fr;
  int nefc, ncap;
};

// one env's block: sizes, counts and the shared-memory layout
struct Blk {
  int tid, lane, nv, K, R, RK, neq, ND, nlim;
  int ncon, nrows;  // live slots; live rows (contact rows, then the equality rows)
  float *J, *M, *L, *row, *dof, *lim, *bc, *tail;
  int *live, *doflim, *limdof, *con, *cnt;
  __device__ float* dv(int v) const { return dof + v * nv; }
  __device__ float* rv(int v) const { return row + v * ND; }
  __device__ float* lv(int v) const { return lim + v * nlim; }
};

__device__ __forceinline__ void blk_init(Blk& s, float* sm, const SolveArgs& a) {
  s.tid = threadIdx.x;
  s.lane = threadIdx.x & 31;
  s.nv = a.nv; s.K = a.K; s.R = a.R; s.RK = a.R * a.K; s.neq = a.neq;
  s.ND = s.RK + a.neq; s.nlim = a.nlim;
  const int nv = a.nv;
  float* p = sm;
  auto take = [&](int n) { float* q = p; p += n; return q; };
  s.J = take(s.ND * nv);
  s.M = take(nv * nv);
  s.L = take(nv * nv > 6 * nv ? nv * nv : 6 * nv);
  s.row = take(kNumRowVecs * s.ND);
  s.live = reinterpret_cast<int*>(take(s.ND));
  s.dof = take(kNumDofVecs * nv);
  s.doflim = reinterpret_cast<int*>(take(nv));
  s.lim = take(kNumLimVecs * s.nlim);
  s.limdof = reinterpret_cast<int*>(take(s.nlim));
  s.con = reinterpret_cast<int*>(take(s.K));
  s.bc = take(kNumBcast);
  s.cnt = reinterpret_cast<int*>(take(4));
  s.tail = p;  // the cone's own part
}

// ---------- loads ----------

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// every input the env reads more than once, into shared memory with
// cp.async, all in flight together: M, cdof (into L), the activity flags
// (into the row vector kVd, until the search direction needs it),
// qvel, qfrc_smooth (kT1), the warmstart (kXm), the dof-friction, limit
// and equality rows; then every limit's dof and each dof's limit row, and
// the zero contact-row forces of dead rows. Ends with a barrier.
__device__ __forceinline__ void load_common(Blk& s, const SolveArgs& a, int E, int e) {
  const int nv = s.nv, tid = s.tid, off = s.neq;
  for (int r = tid; r < nv * nv; r += kThreads) cp_async4(s.M + r, &IN(a.Mc, r));
  for (int r = tid; r < 6 * nv; r += kThreads) cp_async4(s.L + r, &IN(a.cdof, r));
  for (int r = tid; r < s.RK; r += kThreads) cp_async4(s.rv(kVd) + r, &IN(a.on, r));
  for (int r = tid; r < s.neq * nv; r += kThreads) cp_async4(s.J + s.RK * nv + r, &IN(a.Jeq, r));
  for (int i = tid; i < nv; i += kThreads) {
    cp_async4(s.dv(kQv) + i, &IN(a.qvel, i));
    cp_async4(s.dv(kT1) + i, &IN(a.qfs, i));
    cp_async4(s.dv(kXm) + i, &IN(a.ws, i));
    cp_async4(s.dv(kDfr) + i, &IN(a.Dnc, off + i));
    cp_async4(s.dv(kArefFr) + i, &IN(a.arefnc, off + i));
    cp_async4(s.dv(kFlFr) + i, &IN(a.flnc, off + i));
    s.doflim[i] = -1;
  }
  for (int l = tid; l < s.nlim; l += kThreads) {
    cp_async4(s.lv(kDlim) + l, &IN(a.Dnc, off + nv + l));
    cp_async4(s.lv(kArefLim) + l, &IN(a.arefnc, off + nv + l));
    cp_async4(s.lv(kSide) + l, &IN(a.side, l));
    cp_async4(s.limdof + l, a.lim + l);
  }
  for (int q = tid; q < s.neq; q += kThreads) {
    cp_async4(s.rv(kDd) + s.RK + q, &IN(a.Dnc, q));
    cp_async4(s.rv(kArefD) + s.RK + q, &IN(a.arefnc, q));
  }
  for (int r = tid; r < s.RK; r += kThreads) s.rv(kFd)[r] = 0.f;
  cp_async_wait();
  __syncthreads();
  for (int l = tid; l < s.nlim; l += kThreads) s.doflim[s.limdof[l]] = l;
}

// ordered list of the indices r < n with pred(r), by warp 0's ballots;
// returns the count (warp 0 only)
template <class Pred>
__device__ __forceinline__ int warp_compact(const Blk& s, int n, int* dst, Pred pred) {
  int count = 0;
  for (int base = 0; base < n; base += 32) {
    const int idx = base + s.lane;
    const bool take = idx < n && pred(idx);
    const unsigned mask = __ballot_sync(FULL, take);
    if (take) dst[count + __popc(mask & ((1u << s.lane) - 1u))] = idx;
    count += __popc(mask);
  }
  return count;
}

// the live slots (slot_live(k)) and the live rows (row_live(row), r-major,
// then the equality rows), in order, by warp 0. Ends with a barrier.
template <class Cone>
__device__ __forceinline__ void live_rows(Blk& s, const Cone& cone) {
  if (s.tid < 32) {
    const int ncon = warp_compact(s, s.K, s.con, [&](int k) { return cone.slot_live(s, k); });
    const int nc = warp_compact(s, s.RK, s.live, [&](int r) { return cone.row_live(s, r); });
    for (int q = s.lane; q < s.neq; q += 32) s.live[nc + q] = s.RK + q;
    if (s.lane == 0) {
      s.cnt[0] = ncon;
      s.cnt[1] = nc + s.neq;
    }
  }
  __syncthreads();
  s.ncon = s.cnt[0];
  s.nrows = s.cnt[1];
}

// ---------- products ----------

// row `row` of J times y, over the dofs in order
__device__ __forceinline__ float row_dot_b(const Blk& s, int row, const float* y) {
  const float* Jr = s.J + row * s.nv;
  float acc = 0.f;
#pragma unroll 4
  for (int i = 0; i < s.nv; ++i) acc = acc + Jr[i] * y[i];
  return acc;
}

// (M y)_i, M column-major
__device__ __forceinline__ float mv_row(const Blk& s, const float* y, int i) {
  float acc = s.M[i] * y[0];
#pragma unroll 4
  for (int j = 1; j < s.nv; ++j) acc = acc + s.M[j * s.nv + i] * y[j];
  return acc;
}

// ---------- the dof-friction and limit rows ----------

__device__ __forceinline__ float fr_force(const Blk& s, int i) {
  const float fq = -s.dv(kDfr)[i] * s.dv(kJarFr)[i];
  const float fl = s.dv(kFlFr)[i];
  return fminf(fmaxf(fq, -fl), fl);
}

__device__ __forceinline__ float lim_force(const Blk& s, int l) {
  const float j = s.lv(kJarLim)[l];
  return j < 0.f ? -s.lv(kDlim)[l] * j : 0.f;
}

// dof i's force from its friction row, the dense rows (jt) and its limit
// row, if any
__device__ __forceinline__ float fr_lim_force(const Blk& s, int i, float jt) {
  float f = fr_force(s, i) + jt;
  const int l = s.doflim[i];
  if (l >= 0) f = f + s.lv(kSide)[l] * lim_force(s, l);
  return f;
}

// the Hessian's diagonal term of dof i: its friction row in the quadratic
// zone, its limit row when active
__device__ __forceinline__ float fr_lim_diag(const Blk& s, int i) {
  const float D = s.dv(kDfr)[i];
  const float fq = -D * s.dv(kJarFr)[i];
  float d = (fabsf(fq) <= s.dv(kFlFr)[i] && D > 0.f) ? D : 0.f;
  const int l = s.doflim[i];
  if (l >= 0 && s.lv(kJarLim)[l] < 0.f && s.lv(kDlim)[l] > 0.f) d = d + s.lv(kDlim)[l];
  return d;
}

// ---------- warp 0: costs, slopes, the line search ----------
// Each lane takes the friction rows, the limit rows and the cone's items
// with stride 32, in that order; a warp butterfly gives every lane the sum.

// this lane's share of the friction and limit rows' cost at jar + t v
// (with_v) or at jar
__device__ __forceinline__ float fr_lim_cost(const Blk& s, float t, bool with_v) {
  float c = 0.f;
  for (int i = s.lane; i < s.nv; i += 32) {
    const float j = s.dv(kJarFr)[i] + (with_v ? t * s.dv(kDx)[i] : 0.f);
    const float D = s.dv(kDfr)[i], fl = s.dv(kFlFr)[i];
    c = c + (fabsf(D * j) <= fl ? 0.5f * D * j * j
                                : fl * fabsf(j) - 0.5f * fl * fl / fmaxf(D, kEps));
  }
  for (int l = s.lane; l < s.nlim; l += 32) {
    const float j = s.lv(kJarLim)[l] + (with_v ? t * s.lv(kVlim)[l] : 0.f);
    if (j < 0.f) c = c + 0.5f * s.lv(kDlim)[l] * j * j;
  }
  return c;
}

// this lane's share of their slope (sl, their forces along dx) and, with
// need_h, curvature (hl) at step al
__device__ __forceinline__ void fr_lim_slope(const Blk& s, float al, bool need_h, float& sl,
                                             float& hl) {
  for (int i = s.lane; i < s.nv; i += 32) {
    const float v = s.dv(kDx)[i];
    const float j = s.dv(kJarFr)[i] + al * v;
    const float D = s.dv(kDfr)[i], fl = s.dv(kFlFr)[i];
    const float fq = -D * j;
    sl = sl + v * fminf(fmaxf(fq, -fl), fl);
    if (need_h && fabsf(fq) <= fl && D > 0.f) hl = hl + D * v * v;
  }
  for (int l = s.lane; l < s.nlim; l += 32) {
    const float v = s.lv(kVlim)[l];
    const float j = s.lv(kJarLim)[l] + al * v;
    if (j < 0.f) {
      const float D = s.lv(kDlim)[l];
      sl = sl + v * (-D * j);
      if (need_h && D > 0.f) hl = hl + D * v * v;
    }
  }
}

// the rows' cost at jar + t v (with_v) or at jar
template <class Cone>
__device__ __forceinline__ float cost_rows(const Blk& s, const Cone& cone, float t, bool with_v) {
  if constexpr (Cone::kImplicitRows)
    return warp_sum(fr_lim_cost(s, t, with_v) + cone.cost_lane(s, t, with_v));
  else
    return warp_sum(cone.cost_lane(s, t, with_v));
}

// 0.5 (y - a_smooth)' M (y - a_smooth), y = base + t dir (dir == nullptr:
// base); the difference goes through kT2
__device__ __forceinline__ float smooth_cost_w(const Blk& s, const float* base, float t,
                                               const float* dir) {
  float* xm = s.dv(kT2);
  for (int i = s.lane; i < s.nv; i += 32)
    xm[i] = (base[i] + (dir ? t * dir[i] : 0.f)) - s.dv(kAsm)[i];
  __syncwarp();
  float acc = 0.f;
  for (int i = s.lane; i < s.nv; i += 32) acc = acc + xm[i] * mv_row(s, xm, i);
  __syncwarp();
  return 0.5f * warp_sum(acc);
}

// the slope q1 + al q2 - (the rows' forces along dx) at step al, and with
// need_h the curvature into h
template <class Cone>
__device__ __forceinline__ float dphi(const Blk& s, const Cone& cone, float q1, float q2,
                                      float al, bool need_h, float& h) {
  float sl = 0.f, hl = 0.f;
  if constexpr (Cone::kImplicitRows) fr_lim_slope(s, al, need_h, sl, hl);
  cone.slope_lane(s, al, need_h, sl, hl);
  const float ssum = warp_sum(sl);
  if (need_h) h = q2 + warp_sum(hl);
  return q1 + al * q2 - ssum;
}

// the step along dx (warp 0). The 12 doubling probes of the serial search
// (hi = 1; 12 times: if the slope at hi is negative, hi doubles) are
// evaluated in one pass: each lane sums its items' slopes at 1, 2, ...,
// 2^11 into 12 accumulators, 12 butterflies reduce them, and the doubling
// is replayed on the results. This gives the serial loop's hi: hi is
// always a power of two 2^k with k <= the probe's number, so each probe
// reads the slope at 2^k, and that slope is the same sum (each lane's
// items in the same order, the same butterfly, the same q1 + al q2 - sum)
// as the serial probe's; hi stops at the first 2^k whose slope is not
// negative (0 and NaN included), since every later probe sees that same
// slope. Then ls_iterations safeguarded Newton/bisection steps, each
// depending on the one before.
template <class Cone>
__device__ __forceinline__ float line_search_w(const Blk& s, const Cone& cone, float q1, float q2,
                                               int ls_iterations) {
  float g[kDoubling];
#pragma unroll
  for (int k = 0; k < kDoubling; ++k) {
    float sl = 0.f, hl = 0.f;
    const float al = static_cast<float>(1 << k);
    if constexpr (Cone::kImplicitRows) fr_lim_slope(s, al, false, sl, hl);
    cone.slope_lane(s, al, false, sl, hl);
    g[k] = sl;
  }
  float hi = 1.f;
  bool up = true;
#pragma unroll
  for (int k = 0; k < kDoubling; ++k) {
    up = up && (q1 + static_cast<float>(1 << k) * q2 - warp_sum(g[k])) < 0.f;
    if (up) hi = hi * 2.f;
  }
  PHASE_MARK(kPhDoubling);
  float lo = 0.f;
  float al = fminf(hi, 1.f);
  for (int pr = 0; pr < ls_iterations; ++pr) {
    float h;
    const float gs = dphi(s, cone, q1, q2, al, true, h);
    if (gs < 0.f) lo = al; else hi = al;
    const float an = al - gs / fmaxf(h, kEps);
    al = (an > lo && an < hi) ? an : 0.5f * (lo + hi);
  }
  PHASE_MARK(kPhBisect);
  return fmaxf(al, 0.f);
}

// ---------- the Hessian and the Cholesky on register tiles ----------

// the kTile x kTile tile of a lower triangle this thread holds: tile tid of
// the lower block triangle, rows i0 + a, columns j0 + b. A row of J feeds
// the tile with 2 kTile loads for kTile^2 multiply-adds; entries above the
// diagonal or past nv are carried and dropped (their loads clamped to dof
// nv - 1).
struct Tile {
  float v[kTile][kTile];
  int i0, j0;
  bool on;
};

// (r, c), c <= r, of entry e of a lower triangle packed row by row
__device__ __forceinline__ void tri_rc(int e, int& r, int& c) {
  const float f = 8.f * static_cast<float>(e) + 1.f;
  int rr = static_cast<int>((f * rsqrtf(f) - 1.f) * 0.5f);
  if ((rr + 1) * (rr + 2) / 2 <= e) ++rr;
  if (rr * (rr + 1) / 2 > e) --rr;
  r = rr;
  c = e - rr * (rr + 1) / 2;
}

__device__ __forceinline__ void tile_init(const Blk& s, Tile& h) {
  const int nb = (s.nv + kTile - 1) / kTile;
  h.on = s.tid < nb * (nb + 1) / 2;
  int bi = 0, bj = 0;
  if (h.on) tri_rc(s.tid, bi, bj);
  h.i0 = bi * kTile;
  h.j0 = bj * kTile;
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) h.v[a][b] = 0.f;
}

// entry (a, b) is in the lower triangle
__device__ __forceinline__ bool tile_has(const Blk& s, const Tile& h, int a, int b) {
  return h.on && h.i0 + a < s.nv && h.j0 + b <= h.i0 + a;
}

// entries (i, j) += x[i] * (y[j] * D)
__device__ __forceinline__ void tile_add(const Blk& s, Tile& h, const float* x, const float* y,
                                         float D) {
  float xi[kTile], yj[kTile];
#pragma unroll
  for (int a = 0; a < kTile; ++a) {
    xi[a] = x[min(h.i0 + a, s.nv - 1)];
    yj[a] = y[min(h.j0 + a, s.nv - 1)] * D;
  }
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) h.v[a][b] = h.v[a][b] + xi[a] * yj[b];
}

// H = (M + the friction and limit diagonal) + the tile's sums; M + the
// tile's sums for a policy without implicit rows
template <class Cone>
__device__ __forceinline__ void tile_hessian(const Blk& s, Tile& h) {
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b) {
      if (!tile_has(s, h, a, b)) continue;
      const int i = h.i0 + a, j = h.j0 + b;
      if constexpr (Cone::kImplicitRows)
        h.v[a][b] = (s.M[j * s.nv + i] + (i == j ? fr_lim_diag(s, i) : 0.f)) + h.v[a][b];
      else
        h.v[a][b] = s.M[j * s.nv + i] + h.v[a][b];
    }
}

// the tile of the symmetric A (column-major; its lower triangle)
__device__ __forceinline__ void tile_load(const Blk& s, Tile& h, const float* A) {
  tile_init(s, h);
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int b = 0; b < kTile; ++b)
      if (tile_has(s, h, a, b)) h.v[a][b] = A[(h.j0 + b) * s.nv + h.i0 + a];
}

// Jacobi-equilibrated Cholesky with a ridge of the matrix A whose tiles
// the threads hold, right-looking by panels of kTile columns: Lo
// (column-major) gets the factor of S = diag(scale) A diag(scale) + ridge I
// below the diagonal and piv its diagonal, scale = 1/sqrt(diag A), pivots
// floored at the ridge; yb gets the forward solve L^-1 (scale b). Panel J
// (columns kTile J ..): the tiles of block column J publish their entries,
// every earlier panel's update applied, into Lo; warp 0 factors the panel
// column by column (the pivot, the column below it, the panel's later
// columns and the forward solve updated, with warp barriers); then every
// tile right of the panel applies the panel's columns in order. Two block
// barriers per panel. Each entry's arithmetic is the sequential
// left-looking factor's, in the same order (v - L(i, c) L(k, c) for
// ascending c, then / the pivot), and the forward solve's is the
// column-oriented one's.
__device__ __forceinline__ void block_chol(Blk& s, Tile& h, const float* b, float* Lo,
                                           float* scale, float* yb, float* piv) {
  const int nv = s.nv;
#pragma unroll
  for (int a = 0; a < kTile; ++a)
    if (tile_has(s, h, a, a) && h.i0 == h.j0)
      scale[h.i0 + a] = rsqrtf(fmaxf(h.v[a][a], kEps));
  __syncthreads();
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int c = 0; c < kTile; ++c) {
      if (!tile_has(s, h, a, c)) continue;
      const int i = h.i0 + a, k = h.j0 + c;
      float v = h.v[a][c] * (scale[i] * scale[k]);
      if (i == k) v = v + kRidge;
      h.v[a][c] = v;
    }
  for (int i = s.tid; i < nv; i += kThreads) yb[i] = b[i] * scale[i];
  // the entries this thread holds, bit a * kTile + c
  unsigned held = 0;
#pragma unroll
  for (int a = 0; a < kTile; ++a)
#pragma unroll
    for (int c = 0; c < kTile; ++c)
      if (tile_has(s, h, a, c)) held |= 1u << (a * kTile + c);
  for (int c0 = 0; c0 < nv; c0 += kTile) {
    const int c1 = min(c0 + kTile, nv);
    // the panel's tiles publish their entries
    if (held && h.j0 == c0) {
#pragma unroll
      for (int a = 0; a < kTile; ++a)
#pragma unroll
        for (int c = 0; c < kTile; ++c)
          if ((held >> (a * kTile + c)) & 1u) Lo[(h.j0 + c) * nv + h.i0 + a] = h.v[a][c];
    }
    __syncthreads();
    // warp 0 factors the panel
    if (s.tid < 32) {
      for (int c = c0; c < c1; ++c) {
        const float djn = Lo[c * nv + c];
        const float dn = sqrtf(fmaxf(djn, kRidge));
        const float ljj = djn / dn;
        const float y = yb[c] / ljj;
        float* Lc = Lo + c * nv;
        for (int i = c + 1 + s.lane; i < nv; i += 32) Lc[i] = Lc[i] / dn;
        __syncwarp();
        for (int i = c + 1 + s.lane; i < nv; i += 32) {
          const float l = Lc[i];
          for (int k = c + 1; k < c1 && k <= i; ++k) Lo[k * nv + i] = Lo[k * nv + i] - l * Lc[k];
          yb[i] = yb[i] - y * l;
        }
        if (s.lane == 0) {
          piv[c] = ljj;
          yb[c] = y;
        }
        __syncwarp();
      }
    }
    __syncthreads();
    // the tiles right of the panel apply its columns, in order
    if (held && h.j0 >= c1) {
      for (int c = c0; c < c1; ++c) {
        const float* Lc = Lo + c * nv;
        float li[kTile], lk[kTile];
#pragma unroll
        for (int a = 0; a < kTile; ++a) {
          li[a] = Lc[min(h.i0 + a, nv - 1)];
          lk[a] = Lc[min(h.j0 + a, nv - 1)];
        }
#pragma unroll
        for (int a = 0; a < kTile; ++a)
#pragma unroll
          for (int k = 0; k < kTile; ++k) h.v[a][k] = h.v[a][k] - li[a] * lk[k];
      }
    }
  }
}

// x = sign * diag(scale) L^-T yb, the back substitution in the one-warp
// kernel's order (each x_k from the ascending sum over i > k), by lane 0
// of warp 0; then warp 0 scales it. No barrier inside.
__device__ __forceinline__ void warp_back_solve(const Blk& s, const float* Lo, const float* piv,
                                                const float* scale, const float* yb, float* x,
                                                float sign) {
  const int nv = s.nv;
  if (s.lane == 0) {
    for (int k = nv - 1; k >= 0; --k) {
      float acc = 0.f;
#pragma unroll 4
      for (int i = k + 1; i < nv; ++i) acc = acc + Lo[k * nv + i] * x[i];
      x[k] = (yb[k] - acc) / piv[k];
    }
  }
  __syncwarp();
  for (int i = s.lane; i < nv; i += 32) x[i] = (x[i] * scale[i]) * sign;
}

// x = sign A^-1 b for the A whose tiles the threads hold: block_chol into
// L, warp 0's back substitution; ends with a barrier (x visible to the
// block). b must be visible to the block.
__device__ __forceinline__ void block_solve(Blk& s, Tile& h, const float* b, float* x,
                                            float sign) {
  block_chol(s, h, b, s.L, s.dv(kScale), s.dv(kYb), s.dv(kPivot));
  if (s.tid < 32) warp_back_solve(s, s.L, s.dv(kPivot), s.dv(kScale), s.dv(kYb), x, sign);
  __syncthreads();
}

// ---------- residuals and forces ----------

// the rows' residuals at y: friction, limits, live rows (no barrier)
template <class Cone>
__device__ __forceinline__ void jar_at(const Blk& s, const float* y) {
  if constexpr (Cone::kImplicitRows) {
    for (int i = s.tid; i < s.nv; i += kThreads) s.dv(kJarFr)[i] = y[i] - s.dv(kArefFr)[i];
    for (int l = s.tid; l < s.nlim; l += kThreads)
      s.lv(kJarLim)[l] = s.lv(kSide)[l] * y[s.limdof[l]] - s.lv(kArefLim)[l];
  }
  for (int t = s.tid; t < s.nrows; t += kThreads) {
    const int row = s.live[t];
    s.rv(kJarD)[row] = row_dot_b(s, row, y) - s.rv(kArefD)[row];
  }
}

// (J^T f)_i over the live rows in order, f in kFd
__device__ __forceinline__ float jt_force(const Blk& s, int i) {
  float acc = 0.f;
#pragma unroll 4
  for (int t = 0; t < s.nrows; ++t) {
    const int row = s.live[t];
    acc = acc + s.J[row * s.nv + i] * s.rv(kFd)[row];
  }
  return acc;
}

// the outputs of a policy with kImplicitRows, its row forces in kFd (and
// visible to the block): qacc, a_smooth, every row's force,
// qfrc_constraint and qacc_int (with do_int Mh^-1 (M qacc), the implicit
// velocity update, else qacc)
template <class Cone>
__device__ __forceinline__ void step_outputs(Blk& s, const SolveArgs& a, int E, int e) {
  const int nv = s.nv, tid = s.tid;
  const float* asm_ = s.dv(kAsm);
  for (int i = tid; i < nv; i += kThreads) {
    IN(a.x, i) = s.dv(kX)[i];
    IN(a.asm_, i) = asm_[i];
    IN(a.fnc, s.neq + i) = fr_force(s, i);
    IN(a.qfrc, i) = fr_lim_force(s, i, jt_force(s, i));
    if (a.do_int) s.dv(kT1)[i] = mv_row(s, s.dv(kX), i);
  }
  for (int l = tid; l < s.nlim; l += kThreads) IN(a.fnc, s.neq + nv + l) = lim_force(s, l);
  for (int q = tid; q < s.neq; q += kThreads)
    IN(a.fnc, q) = -s.rv(kDd)[s.RK + q] * s.rv(kJarD)[s.RK + q];
  for (int r = tid; r < s.RK; r += kThreads) IN(a.fcon, r) = s.rv(kFd)[r];
  if (a.do_int) {
    for (int r = tid; r < nv * nv; r += kThreads) cp_async4(s.L + r, &IN(a.Mh, r));
    cp_async_wait();
    __syncthreads();
    Tile h;
    tile_load(s, h, s.L);
    block_solve(s, h, s.dv(kT1), s.dv(kT2), 1.f);
    for (int i = tid; i < nv; i += kThreads) IN(a.qint, i) = s.dv(kT2)[i];
  } else {
    for (int i = tid; i < nv; i += kThreads) IN(a.qint, i) = s.dv(kX)[i];
  }
}

// ---------- the solve of one env ----------

// One env's solve, the block's whole work. Cone supplies: kImplicitRows;
// load(s, a, E, e) (its own inputs: with kImplicitRows issued before
// load_common's wait; without, every input: the live rows with their J,
// D and aref, M, a_smooth and the warmstart, ending with a barrier), slot_live(s, k), row_live(s, row) and
// assemble(s, a, E, e) (with kImplicitRows: J of the live slots' rows and
// their D and aref, ending with a barrier), cost_lane and slope_lane (this
// lane's share over its items), forces(s) (kFd of the live rows at the
// current residuals, no barrier), hessian(s, h) (the rows' terms into the
// thread's tile); without kImplicitRows also layout(s, sm, a) (the shared
// memory) and store(s, a, E, e) (the outputs but x and the iterations).
template <class Cone>
__device__ __forceinline__ void solve_env(float* sm, const SolveArgs& a, Cone& cone) {
  constexpr bool kImp = Cone::kImplicitRows;
  const int E = a.E, e = blockIdx.x;
  Blk s;
  if constexpr (kImp) blk_init(s, sm, a);
  else cone.layout(s, sm, a);
  PHASE_BEGIN();
  const int nv = s.nv, tid = s.tid;
  const bool w0 = tid < 32;

  // ---------- the env's inputs, the live rows, phase A ----------
  cone.load(s, a, E, e);
  if constexpr (kImp) {
    load_common(s, a, E, e);
    live_rows(s, cone);
    cone.assemble(s, a, E, e);
  }
  PHASE_MARK(kPhLoad);

  // ---------- unconstrained acceleration: M a_smooth = qfrc_smooth ----------
  if constexpr (kImp) {
    Tile h;
    tile_load(s, h, s.M);
    block_solve(s, h, s.dv(kT1), s.dv(kAsm), 1.f);
  }
  PHASE_MARK(kPhSmooth);

  // ---------- initial point: the cheaper of warmstart (kXm) and a_smooth ----------
  float* ws = s.dv(kXm);
  float* asm_ = s.dv(kAsm);
  jar_at<Cone>(s, ws);
  __syncthreads();
  float c_ws = 0.f;
  if (w0) c_ws = smooth_cost_w(s, ws, 0.f, nullptr) + cost_rows(s, cone, 0.f, false);
  __syncthreads();
  jar_at<Cone>(s, asm_);
  __syncthreads();
  if (w0) {
    const float c_sm = smooth_cost_w(s, asm_, 0.f, nullptr) + cost_rows(s, cone, 0.f, false);
    if (s.lane == 0) {
      s.bc[kTakeWs] = c_ws < c_sm ? 1.f : 0.f;
      s.bc[kStep] = c_ws < c_sm ? c_ws : c_sm;  // the initial cost, for warp 0
    }
  }
  __syncthreads();
  const bool take_ws = s.bc[kTakeWs] != 0.f;
  float cost_x = s.bc[kStep];
  for (int i = tid; i < nv; i += kThreads) s.dv(kX)[i] = take_ws ? ws[i] : asm_[i];
  if (take_ws) jar_at<Cone>(s, ws);
  __syncthreads();
  PHASE_MARK(kPhInit);

  const float tol2 = (a.tolerance * nv) * (a.tolerance * nv);
  int it = 0;
  bool done = false;
  for (; it < a.iterations && !done; ++it) {
    // gradient: M (x - a_smooth) - J^T f
    for (int i = tid; i < nv; i += kThreads) s.dv(kXm)[i] = s.dv(kX)[i] - asm_[i];
    cone.forces(s);
    __syncthreads();
    for (int i = tid; i < nv; i += kThreads) {
      const float t1 = mv_row(s, s.dv(kXm), i);
      s.dv(kT1)[i] = t1;
      if constexpr (kImp) s.dv(kGrad)[i] = t1 - fr_lim_force(s, i, jt_force(s, i));
      else s.dv(kGrad)[i] = t1 - jt_force(s, i);
    }
    PHASE_MARK(kPhGrad);

    // Hessian H = M + diag(friction, limits) + the rows' terms (lower), in
    // the threads' tiles
    Tile h;
    tile_init(s, h);
    cone.hessian(s, h);
    tile_hessian<Cone>(s, h);
    PHASE_MARK(kPhHess);

    // the Newton direction dx = -H^-1 grad
    __syncthreads();  // grad written
    block_solve(s, h, s.dv(kGrad), s.dv(kDx), -1.f);
    PHASE_MARK(kPhFactor);

    // the direction in row space
    const float* dx = s.dv(kDx);
    for (int l = tid; l < s.nlim; l += kThreads) s.lv(kVlim)[l] = s.lv(kSide)[l] * dx[s.limdof[l]];
    for (int t = tid; t < s.nrows; t += kThreads) {
      const int row = s.live[t];
      s.rv(kVd)[row] = row_dot_b(s, row, dx);
    }
    __syncthreads();
    PHASE_MARK(kPhDir);

    // warp 0: gnorm2, q1 = dx' M (x - a_smooth), q2 = dx' M dx, the line
    // search, the accepting cost
    if (w0) {
      float gp = 0.f, q1p = 0.f, q2p = 0.f;
      for (int i = s.lane; i < nv; i += 32) {
        const float g = s.dv(kGrad)[i];
        gp = gp + g * g;
        q1p = q1p + dx[i] * s.dv(kT1)[i];
        q2p = q2p + dx[i] * mv_row(s, dx, i);
      }
      const float gnorm2 = warp_sum(gp);
      const float q1 = warp_sum(q1p), q2 = warp_sum(q2p);
      const float step = line_search_w(s, cone, q1, q2, a.ls_iterations);
      const float cost_new =
          smooth_cost_w(s, s.dv(kX), step, dx) + cost_rows(s, cone, step, true);
      const bool ok = isfinite(cost_new) && cost_new < cost_x;
      if (ok) cost_x = cost_new;
      if (s.lane == 0) {
        s.bc[kStep] = step;
        s.bc[kOk] = ok ? 1.f : 0.f;
        s.bc[kDone] = (gnorm2 < tol2 || !ok) ? 1.f : 0.f;
      }
    }
    __syncthreads();
    const float step = s.bc[kStep];
    if (s.bc[kOk] != 0.f) {
      for (int i = tid; i < nv; i += kThreads) {
        s.dv(kX)[i] = s.dv(kX)[i] + step * dx[i];
        if constexpr (kImp) s.dv(kJarFr)[i] = s.dv(kJarFr)[i] + step * dx[i];
      }
      for (int l = tid; l < s.nlim; l += kThreads)
        s.lv(kJarLim)[l] = s.lv(kJarLim)[l] + step * s.lv(kVlim)[l];
      for (int t = tid; t < s.nrows; t += kThreads) {
        const int row = s.live[t];
        s.rv(kJarD)[row] = s.rv(kJarD)[row] + step * s.rv(kVd)[row];
      }
    }
    done = s.bc[kDone] != 0.f;
    __syncthreads();
    PHASE_MARK(kPhAccept);
  }
  PHASE_ITERS(it);
  if (tid == 0) IN(a.iters, 0) = it;

  // ---------- outputs ----------
  cone.forces(s);
  __syncthreads();
  if constexpr (kImp) {
    step_outputs<Cone>(s, a, E, e);
  } else {
    for (int i = tid; i < nv; i += kThreads) IN(a.x, i) = s.dv(kX)[i];
    cone.store(s, a, E, e);
  }
  PHASE_MARK(kPhOut);
}

}  // namespace

extern "C" const char* mjt_error_string(int code) {
  if (code == kShapeMismatch)
    return "the launch shape does not match the kernel's (phys/solver_kernels.py "
           "newton_launch_shape or phys/solver_dense_kernels.py dense_launch_shape "
           "against the layout of csrc/newton_block.cuh)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
