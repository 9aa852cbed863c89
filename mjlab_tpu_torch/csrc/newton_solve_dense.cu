// newton_solve_dense: Newton constraint solve over a dense, materialised
// constraint Jacobian, one env per block of 128 threads.
//
// Replaces the TPU kernel newton_solve_pallas / newton_solve_pallas_envlast
// (mjlab_tpu/phys/solver_pallas.py: kernel _make_kernel at :40, launcher
// _newton_call at :230, pallas_call at :255), the constraint solve of
// Simulation.forward(). Unlike newton_solve.cu, which rebuilds the contact
// rows from per-slot tensors and keeps the friction and limit rows
// implicit, every row here is dense: Jt (nv, nefc, E) arrives whole, with a
// class per row (equality, dof friction, one-sided). Everything but the
// rows is newton_block.cuh's solve_env, shared with kernels 4 and 5; this
// file is the dense rows' policy (DenseRows): their loads, forces, costs,
// slopes and Hessian terms. The implicit dof-friction and limit blocks of
// solve_env are empty here: in the dense contract those rows are dense.
//
// What bounds it on an H100: the latency of one env's dependent steps and
// the instructions they issue. Each Newton iteration builds the Hessian
// M + J^T diag(D q) J (nv^2/2 multiply-adds per row in the quadratic
// zone), factors it (nv^3/6) and runs 12 + ls_iterations line-search
// probes over the live rows; the bytes (Jt's live rows, ~20 KB per env on
// the G1, read once) and the operations are far below the card's rates.
// What the design does (newton_block.cuh): 128 threads per env, the
// Hessian and the Cholesky on register tiles, the 12 doubling probes in
// one batched pass, the inputs in bursts of cp.async copies, warp 0 for
// the scalar decisions with the one-warp kernel's sums. Shared memory
// holds only the live rows (D != 0, a class): the layout is sized by ncap,
// the batch's largest live count, which the wrapper reads from the device
// (one read from device to host per call); an env's rows beyond ncap
// cannot occur, and would turn its qacc to NaN rather than drop a row.
//
// Load pattern: in the env-last Jt one env's entries lie E floats apart,
// so each 4-byte load touches a 32-byte sector of its own; the
// neighbouring envs' blocks read the other 7 floats of each sector at
// about the same time, which L2 (and L1, for blocks on one SM) serves.
//
// The TPU kernel's arithmetic is kept: the initial point is the cheaper of
// warmstart and a_smooth, the Hessian is exact, the factor is the
// Jacobi-equilibrated Cholesky with a 1e-6 ridge, the line search is 12
// doubling probes then safeguarded Newton/bisection steps, a step is
// accepted only when the cost drops, and an env is done when
// gnorm2 < (tolerance nv)^2 or a step is rejected. The TPU's 128-env tile
// iterates until all its envs are done, with step 0 for a done env (which
// is then rejected); here the block leaves its loop when its env is done,
// which leaves the same x.
#include "newton_block.cuh"

namespace {

constexpr int kMinBlocks = 6;  // envs per SM the registers are budgeted for

enum RowClass { kEquality = 0, kFriction = 1, kOneSided = 2 };

// floats of shared memory one env takes (int lists count as floats): J of
// ncap live rows (the region first holds every row's D and class), M, the
// factor L, the row vectors with the live list, the dof vectors up to kYb,
// warp 0's results and counts, each live row's frictionloss and class, and
// the list of live rows of Jt (nefc)
__host__ __device__ inline int dense_env_floats(int nv, int nefc, int ncap) {
  const int nJ = ncap * nv > 2 * nefc ? ncap * nv : 2 * nefc;
  return nJ + 2 * nv * nv + (kNumRowVecs + 1) * ncap + (kYb + 1) * nv + kNumBcast + 4 +
         2 * ncap + nefc;
}

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

// The dense rows. Live row n (n < s.nrows, in the order of Jt) is row
// src[n] of Jt; its J, D, aref, residual, direction and force sit at index
// n (s.live is the identity).
struct DenseRows {
  static constexpr bool kImplicitRows = false;
  float* fl;  // (ncap) each live row's frictionloss
  int* cls;   // (ncap) its class
  int* src;   // (nefc) its row of Jt

  __device__ __forceinline__ void layout(Blk& s, float* sm, const SolveArgs& a) {
    s.tid = threadIdx.x;
    s.lane = threadIdx.x & 31;
    s.nv = a.nv;
    s.K = s.R = s.RK = s.neq = s.nlim = 0;
    s.ND = a.ncap;
    const int nv = a.nv;
    float* p = sm;
    auto take = [&](int n) { float* q = p; p += n; return q; };
    s.J = take(s.ND * nv > 2 * a.nefc ? s.ND * nv : 2 * a.nefc);
    s.M = take(nv * nv);
    s.L = take(nv * nv);
    s.row = take(kNumRowVecs * s.ND);
    s.live = reinterpret_cast<int*>(take(s.ND));
    s.dof = take((kYb + 1) * nv);
    s.bc = take(kNumBcast);
    s.cnt = reinterpret_cast<int*>(take(4));
    fl = take(s.ND);
    cls = reinterpret_cast<int*>(take(s.ND));
    src = reinterpret_cast<int*>(take(a.nefc));
    s.doflim = s.limdof = s.con = nullptr;
    s.lim = nullptr;
    s.tail = p;
  }

  // every input: each row's D and class, M (row-major, symmetric) into the
  // column-major s.M, a_smooth and the warmstart (kXm); then, by warp 0's
  // ballots, the live rows (D != 0 and a class) in order, and their J, D,
  // aref, frictionloss and class. Ends with a barrier.
  __device__ __forceinline__ void load(Blk& s, const SolveArgs& a, int E, int e) {
    const int nv = s.nv, tid = s.tid, nefc = a.nefc;
    float* allD = s.J;
    int* allC = reinterpret_cast<int*>(s.J + nefc);
    for (int r = tid; r < nefc; r += kThreads) {
      cp_async4(allD + r, &IN(a.Dr, r));
      cp_async4(allC + r, a.cls + r);
    }
    for (int r = tid; r < nv * nv; r += kThreads) {
      const int i = r / nv, j = r - i * nv;
      cp_async4(s.M + j * nv + i, &IN(a.Mc, r));
    }
    for (int i = tid; i < nv; i += kThreads) {
      cp_async4(s.dv(kAsm) + i, &IN(a.asm_in, i));
      cp_async4(s.dv(kXm) + i, &IN(a.ws, i));
    }
    cp_async_wait();
    __syncthreads();
    if (tid < 32) {
      const int n = warp_compact(s, nefc, src, [&](int r) {
        return allD[r] != 0.f && allC[r] <= kOneSided;
      });
      if (s.lane == 0) s.cnt[0] = n;
    }
    __syncthreads();
    s.nrows = min(s.cnt[0], s.ND);
    for (int n = tid; n < s.nrows; n += kThreads) {
      const int r = src[n];
      s.rv(kDd)[n] = allD[r];
      cls[n] = allC[r];
      s.live[n] = n;
    }
    __syncthreads();  // every row's D and class read before J overwrites them
    for (int t = tid; t < s.nrows * nv; t += kThreads) {
      const int n = t / nv, i = t - n * nv;
      cp_async4(s.J + t, &IN(a.Jt, i * nefc + src[n]));
    }
    for (int n = tid; n < s.nrows; n += kThreads) {
      cp_async4(s.rv(kArefD) + n, &IN(a.arefr, src[n]));
      cp_async4(fl + n, &IN(a.flr, src[n]));
    }
    cp_async_wait();
    __syncthreads();
  }

  // this lane's share of the live rows' cost at jar + t v (with_v) or at jar
  __device__ __forceinline__ float cost_lane(const Blk& s, float t, bool with_v) const {
    float c = 0.f;
    for (int n = s.lane; n < s.nrows; n += 32) {
      const float j = s.rv(kJarD)[n] + (with_v ? t * s.rv(kVd)[n] : 0.f);
      c = c + row_cost(cls[n], s.rv(kDd)[n], fl[n], j);
    }
    return c;
  }

  // this lane's share of their slope and curvature at step al
  __device__ __forceinline__ void slope_lane(const Blk& s, float al, bool need_h, float& sl,
                                             float& hl) const {
    for (int n = s.lane; n < s.nrows; n += 32) {
      const int c = cls[n];
      const float v = s.rv(kVd)[n], D = s.rv(kDd)[n], f = fl[n];
      const float j = s.rv(kJarD)[n] + al * v;
      sl = sl + v * row_force(c, D, f, j);
      if (need_h && row_quad(c, D, f, j)) hl = hl + D * v * v;
    }
  }

  __device__ __forceinline__ void forces(const Blk& s) const {
    for (int n = s.tid; n < s.nrows; n += kThreads)
      s.rv(kFd)[n] = row_force(cls[n], s.rv(kDd)[n], fl[n], s.rv(kJarD)[n]);
  }

  // J^T diag(D q) J over the rows in the quadratic zone into the tile, in
  // one pass over the rows
  __device__ __forceinline__ void hessian(Blk& s, Tile& h) const {
    for (int n = 0; n < s.nrows; ++n) {
      const float D = s.rv(kDd)[n];
      if (h.on && row_quad(cls[n], D, fl[n], s.rv(kJarD)[n])) {
        const float* Jr = s.J + n * s.nv;
        tile_add(s, h, Jr, Jr, D);
      }
    }
  }

  // every row's force: 0, then the live rows' (kFd, visible to the block)
  __device__ __forceinline__ void store(Blk& s, const SolveArgs& a, int E, int e) const {
    for (int r = s.tid; r < a.nefc; r += kThreads) IN(a.fr, r) = 0.f;
    __syncthreads();
    for (int n = s.tid; n < s.nrows; n += kThreads) IN(a.fr, src[n]) = s.rv(kFd)[n];
    if (s.cnt[0] > s.ND)
      for (int i = s.tid; i < s.nv; i += kThreads) IN(a.x, i) = __int_as_float(0x7fc00000);
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks) newton_solve_dense_kernel(SolveArgs a) {
  extern __shared__ float sm[];
  DenseRows rows;
  solve_env(sm, a, rows);
}

}  // namespace

// launch shape: kThreads threads and one env per block, smem_bytes of
// shared memory per env for at most ncap live rows
// (phys/solver_dense_kernels.py dense_launch_shape); a shape that is not
// this kernel's returns kShapeMismatch, nothing launched
extern "C" int newton_solve_dense_launch(
    const float* Jt, const float* D, const float* aref, const float* fl, const float* M,
    const float* asm_, const float* ws, const int* cls, float* x, float* force, int* iters,
    int nv, int nefc, int ncap, int iterations, int ls_iterations, float tolerance, int E,
    int threads, int envs_per_block, int smem_bytes, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * dense_env_floats(nv, nefc, ncap);
  if (threads != kThreads || envs_per_block != 1 || smem_bytes != smem || nv > kMaxNv ||
      ncap > nefc)
    return kShapeMismatch;
  SolveArgs a = {};
  a.Jt = Jt; a.Dr = D; a.arefr = aref; a.flr = fl; a.Mc = M; a.asm_in = asm_; a.ws = ws;
  a.cls = cls; a.x = x; a.fr = force; a.iters = iters;
  a.nv = nv; a.nefc = nefc; a.ncap = ncap; a.iterations = iterations;
  a.ls_iterations = ls_iterations; a.tolerance = tolerance; a.E = E;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        newton_solve_dense_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (E <= 0) return 0;
  newton_solve_dense_kernel<<<E, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// envs (blocks) of the kernel one SM holds at smem_bytes per env
extern "C" int newton_solve_dense_blocks_per_sm(int smem_bytes) {
  int n = 0;
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(newton_solve_dense_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_bytes);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, newton_solve_dense_kernel, kThreads, smem_bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
