// crb_packed: composite-rigid-body mass matrix as packed ancestor-pair
// values, one thread per env.
//
// Replaces the TPU kernel crb_packed (mjlab_tpu/phys/smooth_pallas.py:321,
// pallas_call at :352).
//
// What bounds it on an H100: memory. Per env it reads cdof (nv*6), cinA
// (nbody*6) and cinc (nbody*3) and writes one float per ancestor pair
// (341 on the G1), with ~20 flops per output.
//
// Design: the thread accumulates the subtree (composite) inertias in tree
// order into env-last scratch, forms f_j = I_c(body(j)) cdof_j into
// scratch, then writes M[i, j] = cdof_i . f_j for the pairs of
// SmoothTables.pair_i/pair_j (the order of smooth_kernels._crb_pairs),
// with the armature on the diagonal (phys/lm/stages.py crb_lm).
#include "smooth_common.cuh"

__global__ void crb_packed_kernel(SmoothTables t, const float* __restrict__ cdof,
                                  const float* __restrict__ cinA,
                                  const float* __restrict__ cinc, float* out,
                                  float* compA, float* comph, float* compm,
                                  float* f, int E) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  for (int b = 0; b < t.nbody; ++b) {
    float mb = t.body_mass[b];
    for (int k = 0; k < 6; ++k) compA[(6 * b + k) * E + e] = cinA[(6 * b + k) * E + e];
    st3(comph, b, E, e, scale(ld3(cinc, b, E, e), mb));
    compm[b * E + e] = mb;
  }
  for (int b = t.nbody - 1; b > 0; --b) {
    int pid = t.body_parentid[b];
    for (int k = 0; k < 6; ++k)
      compA[(6 * pid + k) * E + e] = compA[(6 * pid + k) * E + e] + compA[(6 * b + k) * E + e];
    st3(comph, pid, E, e, add(ld3(comph, pid, E, e), ld3(comph, b, E, e)));
    compm[pid * E + e] = compm[pid * E + e] + compm[b * E + e];
  }
  for (int j = 0; j < t.nv; ++j) {
    int b = t.dof_body[j];
    float A[6];
    for (int k = 0; k < 6; ++k) A[k] = compA[(6 * b + k) * E + e];
    S6 s = ld6(cdof, j, E, e);
    st6(f, j, E, e, spatial_mul(A, ld3(comph, b, E, e), compm[b * E + e], s));
  }
  for (int p = 0; p < t.npair; ++p) {
    int i = t.pair_i[p], j = t.pair_j[p];
    float v = dot6(ld6(cdof, i, E, e), ld6(f, j, E, e));
    if (i == j) v = v + t.dof_armature[i];
    out[p * E + e] = v;
  }
}

extern "C" int crb_packed_launch(const SmoothTables* t, const float* cdof,
                                 const float* cinA, const float* cinc,
                                 float* out, float* compA, float* comph,
                                 float* compm, float* f, int E,
                                 cudaStream_t stream) {
  const int threads = 32;
  int blocks = (E + threads - 1) / threads;
  crb_packed_kernel<<<blocks, threads, 0, stream>>>(*t, cdof, cinA, cinc, out,
                                                    compA, comph, compm, f, E);
  return static_cast<int>(cudaGetLastError());
}
