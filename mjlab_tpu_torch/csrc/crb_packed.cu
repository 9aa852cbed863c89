// crb_packed: the composite-rigid-body mass matrix, written straight into
// the dense column-major qM (nv*nv, E) the solve consumes and, for an
// implicit integrator, into Mh = qM + the implicit diagonal; many threads
// per env.
//
// Replaces the TPU kernel crb_packed (mjlab_tpu/phys/smooth_pallas.py:321,
// pallas_call at :352), fused with what the step does with its packed
// ancestor pairs: qm_dense_cm (smooth_pallas.py:364) and the implicit
// diagonal add (mjlab_tpu/phys/hybrid.py:536-545). The pairs no longer go
// through device memory.
//
// What bounds it on an H100: bytes, mostly the dense writes. Per env it
// reads cdof (6 nv), cinert (9 nbody) and the implicit diagonal (nv), and
// writes nv^2 floats of qM and as many of Mh: on the G1 at 4096 envs
// ~8.2 MB in and 2 x 20.1 MB out, ~0.014 ms at 3.35 TB/s, for ~11 flops
// per ancestor pair. What the design does about it: every output float is
// written once, by 16 env lanes at 64 contiguous bytes of a plane, zeros
// included (the outputs come from torch.empty), with streaming stores
// (__stcs: the solve reads them once, later; plain stores took 0.044 ms on
// the G1, streaming ones 0.030 on an H100, PERF.md); each mirrored pair is
// computed once and written to both entries. What holds it back now: the
// stores, ~2/3 of the time, and the subtree levels (~7 us on the G1's 12).
//
// Design (csrc/smooth_tree.cuh): a block of SMOOTH_ENVS envs with
// SMOOTH_WORKERS workers each; the composite inertias (10 floats per body:
// A in SYM6 order, h = m c, m), cdof and f (6 per dof) live in shared
// memory. The formulas and their float32 order are those of
// phys/lm/stages.py crb_lm:
//   0. cdof and each body's own inertia (A, h = c m, m) to shared memory,
//      one row per worker, the loops unrolled so that a worker's loads are
//      in flight together;
//   1. subtree sums, deepest level first, each parent summing its own
//      children in descending index, one (parent, component) per worker:
//      bitwise the serial pass `for b = nbody-1..1: comp[parent(b)] +=
//      comp[b]` (the world body's sum is unused and skipped);
//   2. f_j = I_c(body(j)) cdof_j, per dof;
//   3. the lower triangle, per entry (i, j): cdof_j . f_i where dof j is
//      on the chain of dof i's body (M[j, i] of crb_lm, j <= i), else 0;
//      the armature on the diagonal, then the implicit diagonal for Mh:
//      (dot + armature) + mh_diag, the eager code's order.
// Model constants (body_mass, dof_armature) are read through smooth_tree's
// mc accessor.
#include "smooth_common.cuh"
#include "smooth_tree.cuh"

namespace {

constexpr int kComp = 10;  // a composite inertia: A (SYM6), h = m c, m

// (i, j), j <= i, of entry k of a lower triangle packed row by row
__device__ __forceinline__ void lower_rc(int k, int& i, int& j) {
  int r = static_cast<int>((sqrtf(8.f * static_cast<float>(k) + 1.f) - 1.f) * 0.5f);
  if ((r + 1) * (r + 2) / 2 <= k) ++r;
  if (r * (r + 1) / 2 > k) --r;
  i = r;
  j = k - r * (r + 1) / 2;
}

__global__ void __launch_bounds__(SMOOTH_THREADS)
crb_packed_kernel(SmoothTables t, SmoothTree tr, const float* __restrict__ cdof,
                  const float* __restrict__ cinA, const float* __restrict__ cinc,
                  const float* __restrict__ mh_diag, float* qM, float* Mh, int E) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x % SMOOTH_ENVS;
  const int w = threadIdx.x / SMOOTH_ENVS;
  const int e = blockIdx.x * SMOOTH_ENVS + lane;
  const bool live = e < E;  // the ragged edge: work masked, barriers kept
  const int nb = t.nbody, nv = t.nv;
  float* scomp = sm;                                // (nb, kComp)
  float* scdof = scomp + kComp * nb * SMOOTH_ENVS;  // (nv, 6)
  float* sf = scdof + 6 * nv * SMOOTH_ENVS;         // (nv, 6)
  auto comp = [&](int b, int k) -> float& { return scomp[(kComp * b + k) * SMOOTH_ENVS + lane]; };

  // ---- 0. cdof and the bodies' own inertias (unrolled: a worker's
  // loads in flight together, not one latency each) ----
  if (live) {
#pragma unroll 8
    for (int r = w; r < 6 * nv; r += SMOOTH_WORKERS)
      scdof[r * SMOOTH_ENVS + lane] = __ldg(cdof + r * E + e);
#pragma unroll 8
    for (int r = w; r < 6 * nb; r += SMOOTH_WORKERS)
      comp(r / 6, r % 6) = __ldg(cinA + r * E + e);
#pragma unroll 8
    for (int r = w; r < 3 * nb; r += SMOOTH_WORKERS)
      comp(r / 3, 6 + r % 3) = __ldg(cinc + r * E + e) * mc(t.body_mass, r / 3);
    for (int b = w; b < nb; b += SMOOTH_WORKERS) comp(b, 9) = mc(t.body_mass, b);
  }
  __syncthreads();

  // ---- 1. subtree sums, deepest level first (the world's skipped) ----
  for (int L = tr.nlevel - 1; L > 1; --L) {
    const int a = mi(tr.level_adr, L - 1), n = mi(tr.level_adr, L) - a;
    if (live)
      for (int i = w; i < n * kComp; i += SMOOTH_WORKERS) {
        const int p = mi(tr.level_body, a + i / kComp), k = i % kComp;
        const int c0 = mi(tr.child_adr, p), c1 = mi(tr.child_adr, p + 1);
        if (c0 == c1) continue;
        float acc = comp(p, k);
        for (int c = c0; c < c1; ++c) acc = acc + comp(mi(tr.child_body, c), k);
        comp(p, k) = acc;
      }
    __syncthreads();
  }

  // ---- 2. f_j = I_c(body(j)) cdof_j ----
  if (live)
    for (int j = w; j < nv; j += SMOOTH_WORKERS) {
      const int b = mi(t.dof_body, j);
      float A[6];
      for (int k = 0; k < 6; ++k) A[k] = comp(b, k);
      sst6(sf, j, lane,
           spatial_mul(A, v3(comp(b, 6), comp(b, 7), comp(b, 8)), comp(b, 9),
                       sld6(scdof, j, lane)));
    }
  __syncthreads();
  if (!live) return;  // no barrier below

  // ---- 3. the dense entries, each mirrored pair once ----
#pragma unroll 4
  for (int k = w; k < nv * (nv + 1) / 2; k += SMOOTH_WORKERS) {
    int i, j;
    lower_rc(k, i, j);
    float v = 0.f;
    if (mi(t.anc_mask, mi(t.dof_body, i) * nv + j)) {
      v = dot6(sld6(scdof, j, lane), sld6(sf, i, lane));
      if (i == j) v = v + mc(t.dof_armature, i);
    }
    const size_t ij = static_cast<size_t>(i * nv + j) * E + e;
    const size_t ji = static_cast<size_t>(j * nv + i) * E + e;
    __stcs(qM + ij, v);
    if (i != j) __stcs(qM + ji, v);
    if (Mh) {
      __stcs(Mh + ij, i == j ? v + __ldg(mh_diag + i * E + e) : v);
      if (i != j) __stcs(Mh + ji, v);
    }
  }
}

// shared floats per env: the composite inertias (kComp per body), cdof
// and f (6 per dof each)
__host__ __device__ int crb_smem_floats(int nbody, int nv) { return kComp * nbody + 12 * nv; }

}  // namespace

// Mh and mh_diag may be null (no implicit integrator): only qM is written
extern "C" int crb_packed_launch(const SmoothTables* t, const SmoothTree* tr, const float* cdof,
                                 const float* cinA, const float* cinc, const float* mh_diag,
                                 float* qM, float* Mh, int E, cudaStream_t stream) {
  return smooth_launch(crb_packed_kernel, crb_smem_floats(t->nbody, t->nv), E, stream, *t,
                       *tr, cdof, cinA, cinc, mh_diag, qM, Mh, E);
}

// shared memory of one block (SMOOTH_ENVS envs), bytes
extern "C" int crb_packed_smem_bytes(int nbody, int nv) {
  return static_cast<int>(sizeof(float)) * crb_smem_floats(nbody, nv) * SMOOTH_ENVS;
}
