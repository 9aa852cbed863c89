// Shared model tables and plane math for the smooth-stage kernels
// (kin_com.cu, crb_packed.cu, vel_smooth.cu).
//
// The model's tree and constants are uploaded once as two flat device
// arrays (one int32, one float32); SmoothTables holds pointers into them.
// Its layout is mirrored field for field by the ctypes structure in
// mjlab_tpu_torch/phys/smooth_kernels.py (_SmoothTables).
//
// Every per-env array is env-last: element (row, e) at row * E + e, so the
// threads of a warp (neighbouring envs) touch neighbouring addresses.
//
// The model fields a domain randomisation event writes may be carried per
// env (phys/model.py PER_ENV_SMOOTH_FIELDS). Such a field is read from the
// Model's own (E, ...) tensor, env-first, where the event writes it in
// place: EnvField p points at it (null: the field is shared and read from
// the tables), env e's values start at p + e * stride and row i's at
// + i * width. The wrappers fill EnvFields at every launch
// (smooth_kernels.env_fields), so a captured graph reads the tensor a
// write between replays changed; the tables hold NaN for such a field.
#pragma once

#include <cuda_runtime.h>

#define MJT_MAX_BODY 128

struct EnvField {
  const float* p;
  int stride;  // floats per env
  int width;   // floats per row
};

struct EnvFields {
  EnvField qpos0;         // (E, nq)
  EnvField body_ipos;     // (E, nbody, 3)
  EnvField body_mass;     // (E, nbody)
  EnvField body_inertia;  // (E, nbody, 3)
  EnvField geom_pos;      // (E, ngeom, 3)
  EnvField dof_armature;  // (E, nv)
  EnvField dof_damping;   // (E, nv)
  EnvField jnt_stiffness; // (E, njnt)
  EnvField act_gainprm;   // (E, nu, 10): the first three of a row read
  EnvField act_biasprm;   // (E, nu, 10)
  EnvField act_forcerange; // (E, nu, 2): randomize_effort_limits writes it
};

struct SmoothTables {
  int nq, nv, nu, nbody, njnt, ncg, npair;
  int gravity_on, implicit, implicitfast;
  float timestep;
  float gravity[3];
  // int tables
  const int* body_parentid;
  const int* body_rootid;
  const int* body_jntadr;
  const int* body_jntnum;
  const int* body_dofadr;
  const int* body_dofnum;
  const int* jnt_type;
  const int* jnt_qposadr;
  const int* jnt_dofadr;
  const int* jnt_bodyid;
  const int* cg_geom;       // (ncg,) collision geom ids
  const int* geom_bodyid;
  const int* dof_body;      // (nv,)
  const int* pair_i;        // (npair,) CRB ancestor pairs, i <= j
  const int* pair_j;
  const int* anc_mask;      // (nbody, nv) 1 if dof on the chain to body
  const int* act_jnt;       // (nu,) transmission joint
  const int* act_gaintype;
  const int* act_biastype;
  const int* act_ctrllimited;
  const int* act_forcelimited;
  const int* body_mocapid;  // (nbody,) mocap id, -1 for other bodies
  // float tables
  const float* qpos0;
  const float* body_pos;      // (nbody, 3)
  const float* body_quat;     // (nbody, 4)
  const float* jnt_pos;       // (njnt, 3)
  const float* jnt_axis;      // (njnt, 3)
  const float* body_ipos;
  const float* body_iquat;
  const float* body_mass;
  const float* body_inertia;  // (nbody, 3)
  const float* geom_pos;      // (ngeom, 3)
  const float* geom_quat;     // (ngeom, 4)
  const float* dof_armature;
  const float* dof_damping;
  const float* jnt_stiffness;
  const float* qpos_spring;
  const float* act_gear;       // (nu,) gear[0]
  const float* act_ctrlrange;  // (nu, 2)
  const float* act_gainprm;    // (nu, 3)
  const float* act_biasprm;    // (nu, 3)
  const float* act_forcerange; // (nu, 2)
  EnvFields env;               // the per-env fields, set per launch
};

enum { JNT_FREE = 0, JNT_BALL = 1, JNT_SLIDE = 2, JNT_HINGE = 3 };

// SYM6 order of the symmetric 3x3 inertia block: 00 01 02 11 12 22
__device__ __forceinline__ int sym6(int i, int j) {
  if (i > j) { int t = i; i = j; j = t; }
  return i == 0 ? j : (i == 1 ? 2 + j : 5);
}

struct V3 { float x, y, z; };
struct Q4 { float w, x, y, z; };

__device__ __forceinline__ V3 v3(float a, float b, float c) { return {a, b, c}; }
__device__ __forceinline__ V3 add(V3 a, V3 b) { return {a.x + b.x, a.y + b.y, a.z + b.z}; }
__device__ __forceinline__ V3 sub(V3 a, V3 b) { return {a.x - b.x, a.y - b.y, a.z - b.z}; }
__device__ __forceinline__ V3 scale(V3 a, float s) { return {a.x * s, a.y * s, a.z * s}; }
__device__ __forceinline__ float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
__device__ __forceinline__ V3 cross(V3 a, V3 b) {
  return {a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x};
}

__device__ __forceinline__ Q4 qmul(Q4 u, Q4 v) {
  return {u.w * v.w - u.x * v.x - u.y * v.y - u.z * v.z,
          u.w * v.x + u.x * v.w + u.y * v.z - u.z * v.y,
          u.w * v.y - u.x * v.z + u.y * v.w + u.z * v.x,
          u.w * v.z + u.x * v.y - u.y * v.x + u.z * v.w};
}

__device__ __forceinline__ Q4 qnormalize(Q4 q) {
  const float eps = 1e-15f;
  float n2 = q.w * q.w + q.x * q.x + q.y * q.y + q.z * q.z;
  float n = sqrtf(fmaxf(n2, eps * eps));
  if (n < eps) return {1.f, 0.f, 0.f, 0.f};
  return {q.w / n, q.x / n, q.y / n, q.z / n};
}

// v + 2w(u x v) + 2u x (u x v)
__device__ __forceinline__ V3 qrot(V3 v, Q4 q) {
  V3 u = {q.x, q.y, q.z};
  V3 uv = cross(u, v);
  V3 uuv = cross(u, uv);
  return {v.x + 2.f * (q.w * uv.x + uuv.x), v.y + 2.f * (q.w * uv.y + uuv.y),
          v.z + 2.f * (q.w * uv.z + uuv.z)};
}

// row-major rotation matrix of a quaternion
__device__ __forceinline__ void qmat(Q4 q, float* r) {
  float xx = q.x * q.x, yy = q.y * q.y, zz = q.z * q.z;
  float xy = q.x * q.y, xz = q.x * q.z, yz = q.y * q.z;
  float wx = q.w * q.x, wy = q.w * q.y, wz = q.w * q.z;
  r[0] = 1.f - 2.f * (yy + zz); r[1] = 2.f * (xy - wz); r[2] = 2.f * (xz + wy);
  r[3] = 2.f * (xy + wz); r[4] = 1.f - 2.f * (xx + zz); r[5] = 2.f * (yz - wx);
  r[6] = 2.f * (xz - wy); r[7] = 2.f * (yz + wx); r[8] = 1.f - 2.f * (xx + yy);
}

__device__ __forceinline__ void matmul3(const float* a, const float* b, float* c) {
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j] + a[3 * i + 2] * b[6 + j];
}

__device__ __forceinline__ V3 ld3(const float* p, int row, int E, int e) {
  return {p[(3 * row) * E + e], p[(3 * row + 1) * E + e], p[(3 * row + 2) * E + e]};
}
__device__ __forceinline__ void st3(float* p, int row, int E, int e, V3 v) {
  p[(3 * row) * E + e] = v.x;
  p[(3 * row + 1) * E + e] = v.y;
  p[(3 * row + 2) * E + e] = v.z;
}

// spatial (6-vectors [angular, linear]) in env-last rows of 6
struct S6 { float v[6]; };

__device__ __forceinline__ S6 ld6(const float* p, int row, int E, int e) {
  S6 s;
  for (int c = 0; c < 6; ++c) s.v[c] = p[(6 * row + c) * E + e];
  return s;
}
__device__ __forceinline__ void st6(float* p, int row, int E, int e, const S6& s) {
  for (int c = 0; c < 6; ++c) p[(6 * row + c) * E + e] = s.v[c];
}

__device__ __forceinline__ S6 motion_cross(const S6& v, const S6& m) {
  V3 va = {v.v[0], v.v[1], v.v[2]}, vl = {v.v[3], v.v[4], v.v[5]};
  V3 ma = {m.v[0], m.v[1], m.v[2]}, ml = {m.v[3], m.v[4], m.v[5]};
  V3 ang = cross(va, ma);
  V3 lin = add(cross(vl, ma), cross(va, ml));
  return {{ang.x, ang.y, ang.z, lin.x, lin.y, lin.z}};
}

__device__ __forceinline__ S6 force_cross(const S6& v, const S6& f) {
  V3 va = {v.v[0], v.v[1], v.v[2]}, vl = {v.v[3], v.v[4], v.v[5]};
  V3 fa = {f.v[0], f.v[1], f.v[2]}, fl = {f.v[3], f.v[4], f.v[5]};
  V3 ang = add(cross(va, fa), cross(vl, fl));
  V3 lin = cross(va, fl);
  return {{ang.x, ang.y, ang.z, lin.x, lin.y, lin.z}};
}

__device__ __forceinline__ float dot6(const S6& a, const S6& b) {
  float s = a.v[0] * b.v[0];
  for (int c = 1; c < 6; ++c) s = s + a.v[c] * b.v[c];
  return s;
}

// inertia block (A sym-6, h = m c, m) applied to a motion s
__device__ __forceinline__ S6 spatial_mul(const float* A, V3 h, float m, const S6& s) {
  V3 w = {s.v[0], s.v[1], s.v[2]}, v = {s.v[3], s.v[4], s.v[5]};
  V3 ang = {A[0] * w.x + A[1] * w.y + A[2] * w.z,
            A[1] * w.x + A[3] * w.y + A[4] * w.z,
            A[2] * w.x + A[4] * w.y + A[5] * w.z};
  ang = add(ang, cross(h, v));
  V3 lin = sub(scale(v, m), cross(h, w));
  return {{ang.x, ang.y, ang.z, lin.x, lin.y, lin.z}};
}

extern "C" const char* mjt_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
