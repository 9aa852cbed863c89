// newton_solve_elliptic: contact-Jacobian assembly + Newton constraint
// solve + implicit velocity update under the elliptic friction cone, with
// joint-equality rows, one env per block of 128 threads.
//
// Replaces the TPU kernel newton_assemble_solve with cone=1
// (mjlab_tpu/phys/solver_pallas2.py:623, kernel _make_kernel at :46 with
// its elliptic branches 92-106, 216-260, 433-485 and 521-546, pallas_call
// at :674). Everything but the cone is newton_block.cuh's solve_env,
// shared with the pyramidal kernel (newton_solve.cu); this file is the
// elliptic cone's policy. They are separate sources so that each cone's
// build is only its own code.
//
// What bounds it on an H100: the latency of one env's dependent steps, as
// for the pyramidal kernel. Per Newton iteration the Hessian adds a dense
// (R, R) cone block per contact, and every line-search probe evaluates
// each live contact's 3-zone cone state. What the design does, beyond the
// shared routine (128 threads per env, register-tiled Hessian and
// Cholesky, batched doubling probes, one burst of loads, warp 0 for the
// scalar decisions): the kernel is a template on R (3 to 6 rows per
// contact), so a contact's cone state lives in registers; the Hessian is
// built contact by contact: for each contact with a block, the threads
// form G_k = B_k J_k (R x nv) in a small double buffer, then every thread
// adds sum_r J_k[r, i] G_k[r, j] to the tile it holds in registers, one
// barrier per contact, with no per-slot block array. 30.5 KB of shared
// memory per env for the YAM lift-cube model, five envs (640 threads) per
// SM at <= 96 registers. At that cap the shared panel Cholesky
// (newton_block.cuh block_chol) spills a few bytes in some templates (R 6,
// the YAM's: 4 bytes; R 4: 12). On the card that measured faster than a
// column-by-column factor without spills (one barrier per column) and
// than four envs per SM at 128 registers (PERF.md).
//
// The cone (lm/solver.py _ell_*): a contact's rows are the frame
// components [n, t1, t2, torsion, roll1, roll2][:R]; its cost is the
// 3-zone cone cost of x = sqrt(D) * jar (bottom: quadratic, middle: the
// cone's quadratic less its normal part, top: zero), with the whitened
// cone coefficient mu / sqrt(impratio). The equality rows are bilateral
// quadratics. Exact zeros are skipped: dead slots (their rows' J, D and
// aref are 0), and cone blocks in the top zone. The TPU kernel's
// arithmetic is kept, as in the pyramidal kernel.
#include "newton_block.cuh"

namespace {

constexpr int kMinBlocks = 5;  // envs per SM the registers are budgeted for

template <int R>
struct Cone {
  float sD[R], x[R];
  float xn, tt, T, w, mut, c1;
  bool bottom, mid;
};

template <int R>
struct EllCone {
  static constexpr bool kImplicitRows = true;  // dof friction and limits
  float* mut;  // (K) whitened cone coefficient
  int* hflag;  // (K) the contact has a cone block (bottom or middle zone)
  float* G;    // two (R, nv) buffers of B_k J_k

  __device__ __forceinline__ void load(Blk& s, const SolveArgs& a, int E, int e) {
    mut = s.tail;
    hflag = reinterpret_cast<int*>(s.tail + s.K);
    G = s.tail + 2 * s.K;
    for (int k = s.tid; k < s.K; k += kThreads) cp_async4(mut + k, &IN(a.mut, k));
  }

  __device__ __forceinline__ bool slot_live(const Blk& s, int k) const { return s.rv(kVd)[k] != 0.f; }

  // every row of a live contact (rows past its dimension are exact zeros)
  __device__ __forceinline__ bool row_live(const Blk& s, int row) const {
    return s.rv(kVd)[row % s.K] != 0.f;
  }

  // phase A: J of the live contacts' rows, one (contact, dof) pair per
  // thread (frame row r of the point Jacobian for r < 3, row r - 3 of the
  // angular one), then each row's D and aref
  __device__ __forceinline__ void assemble(Blk& s, const SolveArgs& a, int E, int e) const {
    const int nv = s.nv, K = s.K;
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
      float jp[3], ja[3];
#pragma unroll
      for (int c = 0; c < 3; ++c) {
        const int c1 = (c + 1) % 3, c2 = (c + 2) % 3;
        const float j2 = cd[3 + c] + cd[c1] * r2[c2] - cd[c2] * r2[c1];
        const float j1 = cd[3 + c] + cd[c1] * r1[c2] - cd[c2] * r1[c1];
        jp[c] = j2 * w2 - j1 * w1;
        ja[c] = cd[c] * (w2 - w1);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int f = r < 3 ? r : r - 3;
        const float* jd = r < 3 ? jp : ja;
        const int row = r * K + k;
        s.J[row * nv + i] =
            on[row] * (fr[3 * f] * jd[0] + fr[3 * f + 1] * jd[1] + fr[3 * f + 2] * jd[2]);
      }
    }
    __syncthreads();
    for (int t = s.tid; t < s.nrows - s.neq; t += kThreads) {
      const int row = s.live[t];
      const int r = row / K, k = row - r * K;
      const float onv = on[row];
      const float vel = row_dot_b(s, row, s.dv(kQv));
      // normal row: the slot's D and impedance term; friction row r: its D
      s.rv(kDd)[row] = onv * (r == 0 ? IN(a.Dc, k) : IN(a.mu, (r - 1) * K + k));
      s.rv(kArefD)[row] = onv * (-IN(a.bb, k) * vel - (r == 0 ? IN(a.kimp, k) : 0.f));
    }
    __syncthreads();
  }

  // the 3-zone state of contact k at jar + t v (with_v) or at jar
  __device__ __forceinline__ Cone<R> cone_at(const Blk& s, int k, float t, bool with_v) const {
    Cone<R> c;
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const int row = r * s.K + k;
      const float j = s.rv(kJarD)[row] + (with_v ? t * s.rv(kVd)[row] : 0.f);
      c.sD[r] = sqrtf(s.rv(kDd)[row]);
      c.x[r] = j * c.sD[r];
    }
    c.xn = c.x[0];
    float tt = c.x[1] * c.x[1];
#pragma unroll
    for (int r = 2; r < R; ++r) tt = tt + c.x[r] * c.x[r];
    c.tt = tt;
    c.T = sqrtf(fmaxf(tt, kEps * kEps));
    c.mut = mut[k];
    c.w = c.mut * c.xn + c.T;
    c.c1 = 1.f + c.mut * c.mut;
    const bool mu_pos = c.mut > 1e-9f;
    c.bottom = mu_pos ? c.w <= 0.f : c.xn < 0.f;
    const bool top = !c.bottom && (mu_pos ? c.xn >= c.mut * c.T : c.xn >= 0.f);
    c.mid = !c.bottom && !top;
    return c;
  }

  // force of row r (residual j, row D) of a contact in state c: -grad s
  static __device__ __forceinline__ float cone_force(const Cone<R>& c, int r, float D, float j) {
    if (c.bottom) return -D * j;
    if (!c.mid) return 0.f;
    if (r == 0) return c.sD[0] * (c.mut * c.w / c.c1 - c.xn);
    return -c.sD[r] * c.x[r] * (1.f - c.w / (c.c1 * c.T));
  }

  // this lane's share of the contacts' and the equality rows' cost at
  // jar + t v (with_v) or at jar
  __device__ __forceinline__ float cost_lane(const Blk& s, float t, bool with_v) const {
    float c = 0.f;
    for (int n = s.lane; n < s.ncon; n += 32) {
      const Cone<R> z = cone_at(s, s.con[n], t, with_v);
      const float norm2 = z.xn * z.xn + z.tt;
      c = c + (z.bottom ? 0.5f * norm2 : (z.mid ? 0.5f * (norm2 - z.w * z.w / z.c1) : 0.f));
    }
    for (int q = s.lane; q < s.neq; q += 32) {
      const int row = s.RK + q;
      const float j = s.rv(kJarD)[row] + (with_v ? t * s.rv(kVd)[row] : 0.f);
      c = c + 0.5f * s.rv(kDd)[row] * j * j;
    }
    return c;
  }

  // this lane's share of their slope and curvature at step al
  __device__ __forceinline__ void slope_lane(const Blk& s, float al, bool need_h, float& sl,
                                             float& hl) const {
    for (int n = s.lane; n < s.ncon; n += 32) {
      const int k = s.con[n];
      const Cone<R> c = cone_at(s, k, al, true);
      float vt[R];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const int row = r * s.K + k;
        const float v = s.rv(kVd)[row];
        sl = sl + v * cone_force(c, r, s.rv(kDd)[row], s.rv(kJarD)[row] + al * v);
        vt[r] = v * c.sD[r];
      }
      if (need_h) {  // v' (hess s) v
        float vtt2 = vt[1] * vt[1];
        float tv = (c.x[1] / c.T) * vt[1];
#pragma unroll
        for (int r = 2; r < R; ++r) {
          vtt2 = vtt2 + vt[r] * vt[r];
          tv = tv + (c.x[r] / c.T) * vt[r];
        }
        const float quad = vt[0] * vt[0] + vtt2;
        const float gw = c.mut * vt[0] + tv;
        const float mid = quad - (gw * gw + (c.w / c.T) * (vtt2 - tv * tv)) / c.c1;
        hl = hl + (c.bottom ? quad : (c.mid ? fmaxf(mid, 0.f) : 0.f));
      }
    }
    for (int q = s.lane; q < s.neq; q += 32) {
      const int row = s.RK + q;
      const float v = s.rv(kVd)[row];
      const float D = s.rv(kDd)[row];
      sl = sl + v * (-D * (s.rv(kJarD)[row] + al * v));
      if (need_h && D > 0.f) hl = hl + D * v * v;
    }
  }

  // the rows' forces at the current residuals, and each contact's zone
  __device__ __forceinline__ void forces(const Blk& s) const {
    for (int t = s.tid; t < s.ncon + s.neq; t += kThreads) {
      if (t < s.ncon) {
        const int k = s.con[t];
        const Cone<R> c = cone_at(s, k, 0.f, false);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const int row = r * s.K + k;
          s.rv(kFd)[row] = cone_force(c, r, s.rv(kDd)[row], s.rv(kJarD)[row]);
        }
        hflag[k] = c.bottom || c.mid;
      } else {
        const int row = s.RK + t - s.ncon;
        s.rv(kFd)[row] = -s.rv(kDd)[row] * s.rv(kJarD)[row];
      }
    }
  }

  // sum_k J_k^T B_k J_k + J_eq^T D J_eq into the tile: per contact with a
  // block, G_k = B_k J_k into one of two buffers (one (row, dof) entry per
  // thread, B_k's row from the cone state), a barrier, then every thread
  // adds J_k^T G_k to its tile; the equality rows' sum is added last, as a
  // sum of its own
  __device__ __forceinline__ void hessian(Blk& s, Tile& h) const {
    const int nv = s.nv, K = s.K;
    int gpar = 0;
    for (int n = 0; n < s.ncon; ++n) {
      const int k = s.con[n];
      if (!hflag[k]) continue;
      float* Gk = G + gpar * R * nv;
      gpar ^= 1;
      for (int t = s.tid; t < R * nv; t += kThreads) {
        const int r = t / nv, i = t - r * nv;
        const Cone<R> c = cone_at(s, k, 0.f, false);
        float xr = 0.f, sDr = 0.f;
#pragma unroll
        for (int rr = 0; rr < R; ++rr)
          if (rr == r) { xr = c.x[rr]; sDr = c.sD[rr]; }
        const float wT = c.w / c.T;
        const float tr = r >= 1 ? xr / c.T : 0.f;
        const float gr = r >= 1 ? tr : c.mut;
        const float Drow = s.rv(kDd)[r * K + k];
        float acc = 0.f;
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float tq = q >= 1 ? c.x[q] / c.T : 0.f;
          const float gq = q >= 1 ? tq : c.mut;
          const float delta = r == q ? 1.f : 0.f;
          const float pt = (r == q && r >= 1) ? 1.f : 0.f;
          float bm = delta - (gr * gq + wT * (pt - tr * tq)) / c.c1;
          bm = sDr * bm * c.sD[q];
          const float B = c.bottom ? (r == q ? Drow : 0.f) : (c.mid ? bm : 0.f);
          acc = acc + B * s.J[(q * K + k) * nv + i];
        }
        Gk[r * nv + i] = acc;
      }
      __syncthreads();
      if (h.on) {
#pragma unroll
        for (int r = 0; r < R; ++r) tile_add(s, h, s.J + (r * K + k) * nv, Gk + r * nv, 1.f);
      }
    }
#pragma unroll
    for (int a = 0; a < kTile; ++a)
#pragma unroll
      for (int b = 0; b < kTile; ++b) {
        const int i = min(h.i0 + a, nv - 1), j = min(h.j0 + b, nv - 1);
        float eq = 0.f;
        for (int q = 0; q < s.neq; ++q) {
          const float* Jr = s.J + (s.RK + q) * nv;
          const float D = s.rv(kDd)[s.RK + q];
          if (D > 0.f) eq = eq + Jr[i] * (Jr[j] * D);
        }
        h.v[a][b] = h.v[a][b] + eq;
      }
  }
};

template <int R>
__global__ void __launch_bounds__(kThreads, kMinBlocks) newton_solve_elliptic_kernel(SolveArgs a) {
  extern __shared__ float sm[];
  EllCone<R> cone;
  solve_env(sm, a, cone);
}

template <int R>
int launch(const SolveArgs& a, int smem, cudaStream_t stream) {
  if (smem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        newton_solve_elliptic_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  newton_solve_elliptic_kernel<R><<<a.E, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int R>
int blocks_per_sm(int smem) {
  int n = 0;
  if (smem > 48 * 1024)
    cudaFuncSetAttribute(newton_solve_elliptic_kernel<R>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  const cudaError_t err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &n, newton_solve_elliptic_kernel<R>, kThreads, smem);
  return err == cudaSuccess ? n : -static_cast<int>(err);
}

}  // namespace

// launch shape: kThreads threads and one env per block, smem_bytes of
// shared memory per env (phys/solver_kernels.py newton_launch_shape); a
// shape that is not this kernel's returns kShapeMismatch, nothing launched
extern "C" int newton_solve_elliptic_launch(
    const float* Mc, const float* qfs, const float* ws, const float* qvel,
    const float* Mh, const float* Dnc, const float* arefnc, const float* flnc,
    const float* side, const float* Jeq, const float* cdof, const float* posk,
    const float* O1, const float* O2, const float* frame, const float* Dfri,
    const float* mut, const float* Dc, const float* bb, const float* kimp,
    const float* on, const float* W1, const float* W2, const int* lim, float* x,
    float* fnc, float* fcon, float* qfrc, float* asm_, float* qint, int* iters,
    int nv, int K, int R, int neq, int nlim, int iterations, int ls_iterations,
    float tolerance, int do_int, int E, int threads, int envs_per_block,
    int smem_bytes, cudaStream_t stream) {
  const int smem = static_cast<int>(sizeof(float)) * env_floats(nv, K, R, neq, nlim, true);
  if (threads != kThreads || envs_per_block != 1 || smem_bytes != smem || nv > kMaxNv)
    return kShapeMismatch;
  SolveArgs a;
  a.Mc = Mc; a.qfs = qfs; a.ws = ws; a.qvel = qvel; a.Mh = Mh; a.Dnc = Dnc;
  a.arefnc = arefnc; a.flnc = flnc; a.side = side; a.Jeq = Jeq; a.cdof = cdof;
  a.posk = posk; a.O1 = O1; a.O2 = O2; a.frame = frame; a.mu = Dfri; a.mut = mut;
  a.Dc = Dc; a.bb = bb; a.kimp = kimp; a.on = on; a.W1 = W1; a.W2 = W2; a.lim = lim;
  a.x = x; a.fnc = fnc; a.fcon = fcon; a.qfrc = qfrc; a.asm_ = asm_;
  a.qint = qint; a.iters = iters;
  a.nv = nv; a.K = K; a.R = R; a.neq = neq; a.nlim = nlim;
  a.iterations = iterations; a.ls_iterations = ls_iterations;
  a.do_int = do_int; a.E = E; a.tolerance = tolerance;
  switch (R) {
    case 3: return launch<3>(a, smem, stream);
    case 4: return launch<4>(a, smem, stream);
    case 5: return launch<5>(a, smem, stream);
    case 6: return launch<6>(a, smem, stream);
    default: return kShapeMismatch;
  }
}

// envs (blocks) of the kernel one SM holds at smem_bytes per env
extern "C" int newton_solve_elliptic_blocks_per_sm(int R, int smem_bytes) {
  switch (R) {
    case 3: return blocks_per_sm<3>(smem_bytes);
    case 4: return blocks_per_sm<4>(smem_bytes);
    case 5: return blocks_per_sm<5>(smem_bytes);
    case 6: return blocks_per_sm<6>(smem_bytes);
    default: return -1;
  }
}
