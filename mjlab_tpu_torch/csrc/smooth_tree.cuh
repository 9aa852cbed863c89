// The tree schedule and launch shape of the many-threads-per-env smooth
// kernels (kin_com.cu, vel_smooth.cu).
//
// A block holds SMOOTH_ENVS envs and SMOOTH_WORKERS workers per env:
// thread t is env lane t % SMOOTH_ENVS and worker t / SMOOTH_ENVS, so the
// 16 lanes of a worker touch 16 neighbouring env-last addresses (two
// 32-byte sectors) and a warp holds two workers of the same 16 envs. 16
// workers cover the widest tree level of the G1 (4 bodies) in two warps
// and its 32 bodies, 35 dofs and 34 collision geoms in two or three
// rounds; at 4096 envs the grid is one wave of 256 blocks. (8 envs x 32
// workers measured the same on the G1 and up to 8 % slower on the YAM;
// PERF.md, PR 5.)
// Each env's intermediates live in dynamic shared memory as rows of
// SMOOTH_ENVS floats (row * SMOOTH_ENVS + lane: ld3/st3/ld6/st6 with
// E = SMOOTH_ENVS, e = lane), so the lanes of a warp hit distinct banks.
//
// The serial tree recursions become level-synchronous passes:
// - root to leaves, one barrier per level: the bodies of a level are
//   independent, each reads its parent's finished rows;
// - leaves to root (subtree sums), one barrier per level: each parent sums
//   its own children in descending body index. A child's subtree is
//   finished one level earlier, so every parent adds the same values in
//   the same order as the serial pass `for b = nbody-1..1: x[parent(b)] +=
//   x[b]`, and the sums are bitwise the serial ones, without atomics.
//
// SmoothTree's layout is mirrored by the ctypes structure _SmoothTree in
// mjlab_tpu_torch/phys/smooth_kernels.py, which builds the tables once per
// Model (smooth_kernels.tree_schedule).
#pragma once

#include "smooth_common.cuh"

#define SMOOTH_ENVS 16
#define SMOOTH_WORKERS 16
#define SMOOTH_THREADS (SMOOTH_ENVS * SMOOTH_WORKERS)

struct SmoothTree {
  int nlevel;               // tree levels, the world body's level 0 included
  const int* level_adr;     // (nlevel + 1,) start of each level in level_body
  const int* level_body;    // (nbody,) bodies by level, ascending within one
  const int* child_adr;     // (nbody + 1,) start of each body's children
  const int* child_body;    // children of each body, descending index
  const int* dof_jnt;       // (nv,) the joint that owns each dof
  const int* dof_act_adr;   // (nv + 1,) start of each dof's actuators
  const int* dof_act;       // actuators of each dof (its owner), ascending
  const int* dof_sub_adr;   // (nv + 1,) start of each dof's subtree bodies
  const int* dof_sub_body;  // bodies b >= 1 whose chain holds the dof, ascending
  const int* cg_body;       // (ncg,) the body that owns each collision geom
};

// Model constants are read through these accessors; a field that may be
// carried per env through mcv/mcv3 below.
__device__ __forceinline__ float mc(const float* p, int i) { return __ldg(p + i); }
__device__ __forceinline__ V3 mc3(const float* p, int i) {
  return {__ldg(p + 3 * i), __ldg(p + 3 * i + 1), __ldg(p + 3 * i + 2)};
}
__device__ __forceinline__ Q4 mc4(const float* p, int i) {
  return {__ldg(p + 4 * i), __ldg(p + 4 * i + 1), __ldg(p + 4 * i + 2), __ldg(p + 4 * i + 3)};
}
__device__ __forceinline__ int mi(const int* p, int i) { return __ldg(p + i); }

// A field that may be carried per env (smooth_common.cuh EnvField): env
// e's value of row i when f.p is set, the table's c otherwise. The reads
// of an env are strided by the field's size (a sector per lane): the
// fields are a few hundred bytes per env, read once per launch.
__device__ __forceinline__ float mcv(const float* c, EnvField f, int i, int e) {
  return f.p ? __ldg(f.p + (size_t)e * f.stride + i * f.width) : __ldg(c + i);
}
// x clamped to [lo, hi], a NaN x kept (torch.clamp's and jnp.clip's rule;
// fminf/fmaxf alone would return a bound, hiding a NaN from the NaN guard)
__device__ __forceinline__ float clamp_nan(float x, float lo, float hi) {
  return x != x ? x : fminf(fmaxf(x, lo), hi);
}

// element k of row i of such a field whose rows hold n floats in the table
__device__ __forceinline__ float mcvk(const float* c, EnvField f, int i, int k, int n,
                                      int e) {
  return f.p ? __ldg(f.p + (size_t)e * f.stride + i * f.width + k) : __ldg(c + i * n + k);
}
__device__ __forceinline__ V3 mcv3(const float* c, EnvField f, int i, int e) {
  if (!f.p) return mc3(c, i);
  const float* r = f.p + (size_t)e * f.stride + i * f.width;
  return {__ldg(r), __ldg(r + 1), __ldg(r + 2)};
}

// shared-memory rows of an env (row * SMOOTH_ENVS + lane)
__device__ __forceinline__ V3 sld3(const float* p, int row, int lane) {
  return ld3(p, row, SMOOTH_ENVS, lane);
}
__device__ __forceinline__ void sst3(float* p, int row, int lane, V3 v) {
  st3(p, row, SMOOTH_ENVS, lane, v);
}
__device__ __forceinline__ Q4 sld4(const float* p, int row, int lane) {
  return {p[(4 * row) * SMOOTH_ENVS + lane], p[(4 * row + 1) * SMOOTH_ENVS + lane],
          p[(4 * row + 2) * SMOOTH_ENVS + lane], p[(4 * row + 3) * SMOOTH_ENVS + lane]};
}
__device__ __forceinline__ void sst4(float* p, int row, int lane, Q4 q) {
  p[(4 * row) * SMOOTH_ENVS + lane] = q.w;
  p[(4 * row + 1) * SMOOTH_ENVS + lane] = q.x;
  p[(4 * row + 2) * SMOOTH_ENVS + lane] = q.y;
  p[(4 * row + 3) * SMOOTH_ENVS + lane] = q.z;
}
__device__ __forceinline__ S6 sld6(const float* p, int row, int lane) {
  return ld6(p, row, SMOOTH_ENVS, lane);
}
__device__ __forceinline__ void sst6(float* p, int row, int lane, const S6& s) {
  st6(p, row, SMOOTH_ENVS, lane, s);
}

// Launch a smooth kernel over E envs with `floats_per_env` floats of
// shared memory per env: opts in above 48 KB once, refuses more than a
// block may hold. Returns a cudaError_t as an int. with_env: the tables
// with this launch's per-env fields (a copy, passed by value).
__host__ inline SmoothTables with_env(const SmoothTables* t, const EnvFields* env) {
  SmoothTables out = *t;
  out.env = *env;
  return out;
}

template <typename Kernel, typename... Args>
int smooth_launch(Kernel kernel, int floats_per_env, int E, cudaStream_t stream,
                  Args... args) {
  const size_t smem = sizeof(float) * (size_t)floats_per_env * SMOOTH_ENVS;
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  if (E <= 0) return 0;
  const int blocks = (E + SMOOTH_ENVS - 1) / SMOOTH_ENVS;
  kernel<<<blocks, SMOOTH_THREADS, smem, stream>>>(args...);
  return static_cast<int>(cudaGetLastError());
}
