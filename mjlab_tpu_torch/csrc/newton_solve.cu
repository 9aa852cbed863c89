// newton_solve: contact-Jacobian assembly + Newton constraint solve +
// implicit velocity update, one env per block of 128 threads (pyramidal
// cone), with joint-equality rows.
//
// Replaces the TPU kernel newton_assemble_solve with cone=0
// (mjlab_tpu/phys/solver_pallas2.py:623, kernel _make_kernel at :46,
// pallas_call at :674). Everything but the cone is newton_block.cuh's
// solve_env, shared with the elliptic kernel (newton_solve_elliptic.cu);
// this file is the pyramidal cone's policy: the rows' assembly and their
// one-sided quadratics.
//
// What bounds it on an H100: the latency of one env's dependent steps and
// the instructions they issue. Per Newton iteration the env builds the
// Hessian M + J^T diag(D) J (nv^2/2 multiply-adds per active row), factors
// it (nv^3/6), solves, and runs 12 + ls_iterations line-search probes,
// each a sum over all rows; the bytes (~28 KB per env, read and written
// once) and the operations are far below the card's rates. What the
// design does (newton_block.cuh): 128 threads per env; the Hessian and the
// Cholesky are register tiles (each thread holds a 3x3 tile of the lower
// triangle, fed by one pass over the active rows, factored right-looking
// by panels of three columns, two barriers per panel, with the forward
// solve carried along); the
// 12 doubling probes are one batched pass; the env's inputs arrive in one
// burst of cp.async copies; warp 0 runs the scalar decisions (costs, the
// line search) with the one-warp kernel's sums. Shared memory holds the
// env (J, M, L, the row and dof vectors: 35.9 KB for the G1), six envs per
// SM at <= 80 registers (__launch_bounds__), 768 threads per SM against 192
// for one warp per env.
//
// The rows: a live slot's R rows [+t1, -t1, +t2, -t2][:R] (R <= 4, the two
// tangent directions of the frame, as the TPU kernel builds them:
// solver_pallas2.py:110-121) are one-sided quadratics; equality rows
// (bilateral quadratics) follow the contact rows. Rows of dead slots are
// skipped (their J row, D and aref are 0), and in the Hessian rows with
// D q = 0. The TPU kernel's arithmetic is kept: the initial point is the
// cheaper of warmstart and a_smooth, the Cholesky is Jacobi-equilibrated
// with a 1e-6 ridge, a step is accepted only when the cost drops (ok), the
// solve stops when gnorm2 < (tolerance*nv)^2 or not ok, and each env's
// block leaves its loop when its env is done, which leaves the x the TPU's
// 128-env tile leaves (there a done env takes step 0).
#include "newton_block.cuh"

namespace {

constexpr int kMinBlocks = 6;  // envs per SM the registers are budgeted for

struct PyrCone {
  static constexpr bool kImplicitRows = true;  // dof friction and limits

  __device__ __forceinline__ void load(Blk&, const SolveArgs&, int, int) const {}

  __device__ __forceinline__ bool slot_live(const Blk& s, int k) const {
    for (int r = 0; r < s.R; ++r)
      if (s.rv(kVd)[r * s.K + k] != 0.f) return true;
    return false;
  }

  __device__ __forceinline__ bool row_live(const Blk& s, int row) const {
    return s.rv(kVd)[row] != 0.f;
  }

  // phase A: J of the live slots' rows, one (slot, dof) pair per thread,
  // then each live row's D and aref
  __device__ __forceinline__ void assemble(Blk& s, const SolveArgs& a, int E, int e) const {
    const int nv = s.nv, K = s.K, R = s.R;
    const float* on = s.rv(kVd);
    for (int t = s.tid; t < s.ncon * nv; t += kThreads) {
      const int n = t / nv, i = t - n * nv, k = s.con[n];
      float r1[3], r2[3], fr[9];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const float pp = IN(a.posk, c * K + k);
        r1[c] = pp - IN(a.O1, c * K + k);
        r2[c] = pp - IN(a.O2, c * K + k);
      }
#pragma unroll
      for (int c = 0; c < 9; ++c) fr[c] = IN(a.frame, c * K + k);
      const float w1 = IN(a.W1, i * K + k), w2 = IN(a.W2, i * K + k);
      const float* cd = s.L + 6 * i;  // cdof, staged in L
      float jd[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        const float j2 = cd[3 + c] + cd[c1] * r2[c2] - cd[c2] * r2[c1];
        const float j1 = cd[3 + c] + cd[c1] * r1[c2] - cd[c2] * r1[c1];
        jd[c] = j2 * w2 - j1 * w1;
      }
      const float f0 = fr[0] * jd[0] + fr[1] * jd[1] + fr[2] * jd[2];
      const float ft0 = fr[3] * jd[0] + fr[4] * jd[1] + fr[5] * jd[2];
      const float ft1 = fr[6] * jd[0] + fr[7] * jd[1] + fr[8] * jd[2];
      for (int r = 0; r < R; ++r) {
        const int jdir = r >> 1;
        const float sgn = (r & 1) ? -1.f : 1.f;
        const float ft = jdir == 0 ? ft0 : ft1;
        const float muj = IN(a.mu, jdir * K + k);
        const int row = r * K + k;
        s.J[row * nv + i] = on[row] * (f0 + sgn * (muj * ft));
      }
    }
    __syncthreads();
    for (int t = s.tid; t < s.nrows - s.neq; t += kThreads) {
      const int row = s.live[t];
      const int k = row % K;
      const float onv = on[row];
      const float vel = row_dot_b(s, row, s.dv(kQv));
      s.rv(kDd)[row] = onv * IN(a.Dc, k);
      s.rv(kArefD)[row] = onv * (-IN(a.bb, k) * vel - IN(a.kimp, k));
    }
    __syncthreads();
  }

  // this lane's share of the live rows' cost at jar + t v (with_v) or at
  // jar: contact rows one-sided, equality rows bilateral
  __device__ __forceinline__ float cost_lane(const Blk& s, float t, bool with_v) const {
    float c = 0.f;
    for (int n = s.lane; n < s.nrows; n += 32) {
      const int row = s.live[n];
      const float j = s.rv(kJarD)[row] + (with_v ? t * s.rv(kVd)[row] : 0.f);
      if (row >= s.RK || j < 0.f) c = c + 0.5f * s.rv(kDd)[row] * j * j;
    }
    return c;
  }

  // this lane's share of their slope and curvature at step al
  __device__ __forceinline__ void slope_lane(const Blk& s, float al, bool need_h, float& sl,
                                             float& hl) const {
    for (int n = s.lane; n < s.nrows; n += 32) {
      const int row = s.live[n];
      const float v = s.rv(kVd)[row];
      const float j = s.rv(kJarD)[row] + al * v;
      if (row >= s.RK || j < 0.f) {
        const float D = s.rv(kDd)[row];
        sl = sl + v * (-D * j);
        if (need_h && D > 0.f) hl = hl + D * v * v;
      }
    }
  }

  __device__ __forceinline__ void forces(const Blk& s) const {
    for (int t = s.tid; t < s.nrows; t += kThreads) {
      const int row = s.live[t];
      const float j = s.rv(kJarD)[row];
      s.rv(kFd)[row] = (row >= s.RK || j < 0.f) ? -s.rv(kDd)[row] * j : 0.f;
    }
  }

  // J^T diag(D q) J over the rows in the quadratic zone into the tile, in
  // one pass over the rows
  __device__ __forceinline__ void hessian(Blk& s, Tile& h) const {
    for (int t = 0; t < s.nrows; ++t) {
      const int row = s.live[t];
      const float D = s.rv(kDd)[row];
      if (h.on && D > 0.f && (row >= s.RK || s.rv(kJarD)[row] < 0.f)) {
        const float* Jr = s.J + row * s.nv;
        tile_add(s, h, Jr, Jr, D);
      }
    }
  }
};

__global__ void __launch_bounds__(kThreads, kMinBlocks) newton_solve_kernel(SolveArgs a) {
  extern __shared__ float sm[];
  PyrCone cone;
  solve_env(sm, a, cone);
}

}  // namespace

// launch shape: kThreads threads and one env per block, smem_bytes of
// shared memory per env (phys/solver_kernels.py newton_launch_shape); a
// shape that is not this kernel's returns kShapeMismatch, nothing launched
extern "C" int newton_solve_launch(
    const float* Mc, const float* qfs, const float* ws, const float* qvel,
    const float* Mh, const float* Dnc, const float* arefnc, const float* flnc,
    const float* side, const float* Jeq, const float* cdof, const float* posk,
    const float* O1, const float* O2, const float* frame, const float* mu,
    const float* mut, const float* Dc, const float* bb, const float* kimp,
    const float* on, const float* W1, const float* W2, const int* lim, float* x,
    float* fnc, float* fcon, float* qfrc, float* asm_, float* qint, int* iters,
    int nv, int K, int R, int neq, int nlim, int iterations, int ls_iterations,
    float tolerance, int do_int, int E, int threads, int envs_per_block,
    int smem_bytes, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * env_floats(nv, K, R, neq, nlim, false);
  if (threads != kThreads || envs_per_block != 1 || smem_bytes != smem || R > 4 || nv > kMaxNv)
    return kShapeMismatch;
  SolveArgs a;
  a.Mc = Mc; a.qfs = qfs; a.ws = ws; a.qvel = qvel; a.Mh = Mh; a.Dnc = Dnc;
  a.arefnc = arefnc; a.flnc = flnc; a.side = side; a.Jeq = Jeq; a.cdof = cdof;
  a.posk = posk; a.O1 = O1; a.O2 = O2; a.frame = frame; a.mu = mu; a.mut = mut;
  a.Dc = Dc; a.bb = bb; a.kimp = kimp; a.on = on; a.W1 = W1; a.W2 = W2; a.lim = lim;
  a.x = x; a.fnc = fnc; a.fcon = fcon; a.qfrc = qfrc; a.asm_ = asm_;
  a.qint = qint; a.iters = iters;
  a.nv = nv; a.K = K; a.R = R; a.neq = neq; a.nlim = nlim;
  a.iterations = iterations; a.ls_iterations = ls_iterations;
  a.do_int = do_int; a.E = E; a.tolerance = tolerance;
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        newton_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  newton_solve_kernel<<<E, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// envs (blocks) of the kernel one SM holds at smem_bytes per env
extern "C" int newton_solve_blocks_per_sm(int R, int smem_bytes) {
  (void)R;
  int n = 0;
  if (smem_bytes > 48 * 1024)
    cudaFuncSetAttribute(newton_solve_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                         smem_bytes);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, newton_solve_kernel, kThreads, smem_bytes);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}
