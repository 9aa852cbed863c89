// vel_smooth: velocity-dependent smooth stages, many threads per env:
// com_vel, rne (bias forces), passive, joint actuation and xfrc_applied
// projection -> qfrc_smooth, actuator force and velocity, and the
// integrator's implicit diagonal (h*damping - h*dfdv*gear^2).
//
// Replaces the TPU kernel vel_smooth (mjlab_tpu/phys/smooth_pallas.py:389,
// pallas_call at :487).
//
// What bounds it on an H100: memory. Per env it reads q, qvel, ctrl,
// cdof, cinert (A, c), subtree com, xipos, xfrc_applied and qfrc_applied
// (~1.3k floats on the G1) for a few thousand flops. What held the
// one-thread-per-env design back was latency: 128 one-warp blocks at
// E = 4096, every intermediate through a global scratch.
//
// Design (csrc/smooth_tree.cuh): a block of SMOOTH_ENVS envs with
// SMOOTH_WORKERS workers each; qvel and cdof, the body velocities and
// accelerations, the body forces and the xfrc spatial forces stay in
// shared memory (7 floats per dof, 12 per body). The formulas are those of
// phys/lm/stages.py (com_vel_lm, rne_lm, passive_lm, actuation_lm,
// xfrc_lm, actuator_vel_deriv_lm):
//   0. qvel and cdof to shared memory, all workers at once (one global
//      latency instead of one per tree level);
//   1. com_vel and the rne acceleration, level by level from the root:
//      each body's cdof_dot is made and added to its acceleration in dof
//      order, as the serial pass adds the stored ones;
//   2. body forces (I a + v x* I v) and xfrc spatial forces, per body;
//   3. rne's backward sum, deepest level first, each parent summing its
//      own children in descending index (the serial order, bitwise);
//   4. per dof: bias, passive (damping, then the joint spring), its
//      actuators in ascending order (force, velocity, implicit diagonal),
//      the xfrc projection over the bodies below it in ascending order,
//      and qfrc_smooth = passive - bias + actuator + applied + xfrc (the
//      order of smooth_pallas.py:456-463).
// What holds it back now (PERF.md, PR 5): the launch with its first loads,
// and the two tree passes' dependent chains; the bytes would take a
// quarter of the time.
#include "smooth_common.cuh"
#include "smooth_tree.cuh"

// velocity-space difference of the quaternion q(qq..qq+3) and
// qpos_spring(qq..), component k (quat_sub)
__device__ __forceinline__ float spring_quat_dif(const SmoothTables& t, const float* q, int qq,
                                                 int k, int E, int e) {
  auto Q = [&](int i) { return __ldg(q + i * E + e); };
  const Q4 qa4 = {Q(qq), Q(qq + 1), Q(qq + 2), Q(qq + 3)};
  const Q4 qb4 = {mc(t.qpos_spring, qq), -mc(t.qpos_spring, qq + 1),
                  -mc(t.qpos_spring, qq + 2), -mc(t.qpos_spring, qq + 3)};
  Q4 qd = qmul(qb4, qa4);
  if (qd.w < 0.f) qd = {-qd.w, -qd.x, -qd.y, -qd.z};
  const float sin_half = sqrtf(fmaxf(qd.x * qd.x + qd.y * qd.y + qd.z * qd.z, 0.f));
  const float angle = 2.f * atan2f(sin_half, qd.w);
  if (sin_half < 1e-12f) return 0.f;
  const float comp = k == 0 ? qd.x : (k == 1 ? qd.y : qd.z);
  return comp / sin_half * angle;
}

__global__ void __launch_bounds__(SMOOTH_THREADS)
vel_smooth_kernel(SmoothTables t, SmoothTree tr, const float* __restrict__ q,
                  const float* __restrict__ qvel, const float* __restrict__ ctrl,
                  const float* __restrict__ cdof, const float* __restrict__ cinA,
                  const float* __restrict__ cinc, const float* __restrict__ subcom,
                  const float* __restrict__ xipos, const float* __restrict__ xfrc,
                  const float* __restrict__ qfa, float* qfs, float* afrc, float* avel,
                  float* diag, int E) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x % SMOOTH_ENVS;
  const int w = threadIdx.x / SMOOTH_ENVS;
  const int e = blockIdx.x * SMOOTH_ENVS + lane;
  const bool live = e < E;  // the ragged edge: work masked, barriers kept
  const int nb = t.nbody;
  // (nb, 6) body velocities, then the xfrc spatial forces
  float* svel = sm;
  // (nb, 6) body accelerations, then the body forces
  float* sacc = svel + 6 * nb * SMOOTH_ENVS;
  float* scdof = sacc + 6 * nb * SMOOTH_ENVS;       // (nv, 6)
  float* sqvel = scdof + 6 * t.nv * SMOOTH_ENVS;    // (nv,)
  auto V = [&](int i) { return sqvel[i * SMOOTH_ENVS + lane]; };
  auto Q = [&](int i) { return __ldg(q + i * E + e); };
  auto CDOF = [&](int i) { return sld6(scdof, i, lane); };
  const S6 z6 = {{0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};

  // ---- 0. qvel and cdof to shared memory ----
  if (live)
    for (int r = w; r < 7 * t.nv; r += SMOOTH_WORKERS) {
      const float* src = r < 6 * t.nv ? cdof + r * E : qvel + (r - 6 * t.nv) * E;
      scdof[r * SMOOTH_ENVS + lane] = __ldg(src + e);
    }

  // ---- 1. com_vel and the rne acceleration, root to leaves ----
  if (live && w == 0) {
    S6 a0 = z6;
    if (t.gravity_on) {
      a0.v[3] = 0.f - t.gravity[0];
      a0.v[4] = 0.f - t.gravity[1];
      a0.v[5] = 0.f - t.gravity[2];
    }
    sst6(svel, 0, lane, z6);
    sst6(sacc, 0, lane, a0);
  }
  __syncthreads();
  for (int L = 1; L < tr.nlevel; ++L) {
    const int la = mi(tr.level_adr, L), n = mi(tr.level_adr, L + 1) - la;
    if (live)
      for (int i = w; i < n; i += SMOOTH_WORKERS) {
        const int b = mi(tr.level_body, la + i);
        const int pid = mi(t.body_parentid, b);
        S6 v = sld6(svel, pid, lane);
        S6 a = sld6(sacc, pid, lane);
        auto add_dof = [&](S6 x, int d) {  // x + cdof_d qvel_d
          const S6 c = CDOF(d);
          const float qd = V(d);
          for (int k = 0; k < 6; ++k) x.v[k] = x.v[k] + c.v[k] * qd;
          return x;
        };
        auto acc_dot = [&](const S6& cd, int d) {  // a + cdof_dot_d qvel_d
          const float qd = V(d);
          for (int k = 0; k < 6; ++k) a.v[k] = a.v[k] + cd.v[k] * qd;
        };
        const int jadr = mi(t.body_jntadr, b), jnum = mi(t.body_jntnum, b);
        for (int k = 0; k < jnum; ++k) {
          const int j = jadr + k;
          const int jt = mi(t.jnt_type, j);
          const int va = mi(t.jnt_dofadr, j);
          if (jt == JNT_FREE) {
            for (int d = 0; d < 3; ++d) v = add_dof(v, va + d);
            for (int d = 0; d < 3; ++d) acc_dot(z6, va + d);  // cdof_dot 0
            for (int d = 3; d < 6; ++d) acc_dot(motion_cross(v, CDOF(va + d)), va + d);
            for (int d = 3; d < 6; ++d) v = add_dof(v, va + d);
          } else if (jt == JNT_BALL) {
            for (int d = 0; d < 3; ++d) acc_dot(motion_cross(v, CDOF(va + d)), va + d);
            for (int d = 0; d < 3; ++d) v = add_dof(v, va + d);
          } else {
            acc_dot(motion_cross(v, CDOF(va)), va);
            v = add_dof(v, va);
          }
        }
        sst6(svel, b, lane, v);
        sst6(sacc, b, lane, a);
      }
    __syncthreads();
  }

  // ---- 2. body forces and xfrc spatial forces, per body ----
  if (live)
    for (int b = w; b < nb; b += SMOOTH_WORKERS) {
      float A[6];
      for (int k = 0; k < 6; ++k) A[k] = __ldg(cinA + (6 * b + k) * E + e);
      const float mb = mc(t.body_mass, b);
      const V3 h = scale(ld3(cinc, b, E, e), mb);
      const S6 cv = sld6(svel, b, lane);
      const S6 Iv = spatial_mul(A, h, mb, cv);
      S6 Ia = spatial_mul(A, h, mb, sld6(sacc, b, lane));
      const S6 fc = force_cross(cv, Iv);
      for (int k = 0; k < 6; ++k) Ia.v[k] = Ia.v[k] + fc.v[k];
      sst6(sacc, b, lane, Ia);
      if (b == 0) continue;
      const V3 fo = ld3(xfrc, 2 * b, E, e), to = ld3(xfrc, 2 * b + 1, E, e);
      const V3 off = sub(ld3(xipos, b, E, e), ld3(subcom, mi(t.body_rootid, b), E, e));
      const V3 ang = add(to, cross(off, fo));
      sst6(svel, b, lane, {{ang.x, ang.y, ang.z, fo.x, fo.y, fo.z}});
    }
  __syncthreads();

  // ---- 3. rne's backward sum, deepest level first (the world's is unused) ----
  for (int L = tr.nlevel - 1; L > 1; --L) {
    const int la = mi(tr.level_adr, L - 1), n = mi(tr.level_adr, L) - la;
    if (live)
      for (int i = w; i < n; i += SMOOTH_WORKERS) {
        const int p = mi(tr.level_body, la + i);
        const int c0 = mi(tr.child_adr, p), c1 = mi(tr.child_adr, p + 1);
        if (c0 == c1) continue;
        S6 f = sld6(sacc, p, lane);
        for (int k = c0; k < c1; ++k) {
          const S6 c = sld6(sacc, mi(tr.child_body, k), lane);
          for (int r = 0; r < 6; ++r) f.v[r] = f.v[r] + c.v[r];
        }
        sst6(sacc, p, lane, f);
      }
    __syncthreads();
  }
  if (!live) return;  // no barrier below

  // ---- 4. per dof: bias, passive, actuation, xfrc, qfrc_smooth ----
  for (int i = w; i < t.nv; i += SMOOTH_WORKERS) {
    const S6 cd = CDOF(i);
    const float vi = V(i);
    const float bias = dot6(cd, sld6(sacc, mi(t.dof_body, i), lane));

    // passive: damping, then the joint's spring
    const float damping = mc(t.dof_damping, i);
    float passive = -damping * vi;
    const int j = mi(tr.dof_jnt, i);
    const float ks = mc(t.jnt_stiffness, j);
    if (ks != 0.f) {
      const int jt = mi(t.jnt_type, j);
      const int qa = mi(t.jnt_qposadr, j), k = i - mi(t.jnt_dofadr, j);
      float dif;
      if (jt == JNT_HINGE || jt == JNT_SLIDE)
        dif = Q(qa) - mc(t.qpos_spring, qa);
      else if (jt == JNT_FREE && k < 3)
        dif = Q(qa + k) - mc(t.qpos_spring, qa + k);
      else if (jt == JNT_FREE)
        dif = spring_quat_dif(t, q, qa + 3, k - 3, E, e);
      else
        dif = spring_quat_dif(t, q, qa, k, E, e);
      passive = passive - ks * dif;
    }

    // actuation (joint transmission, no activation) and the implicit diagonal
    float act = 0.f;
    float dg = t.implicit ? t.timestep * damping : 0.f;
    for (int s = mi(tr.dof_act_adr, i); s < mi(tr.dof_act_adr, i + 1); ++s) {
      const int u = mi(tr.dof_act, s);
      const int ju = mi(t.act_jnt, u);
      const float gear = mc(t.act_gear, u);
      const float length = Q(mi(t.jnt_qposadr, ju)) * gear;
      const float vel = vi * gear;
      float c = __ldg(ctrl + u * E + e);
      if (mi(t.act_ctrllimited, u))
        c = fminf(fmaxf(c, mc(t.act_ctrlrange, 2 * u)), mc(t.act_ctrlrange, 2 * u + 1));
      const V3 gp = mc3(t.act_gainprm, u);
      const V3 bp = mc3(t.act_biasprm, u);
      const bool gain_affine = mi(t.act_gaintype, u) == 1;
      const bool bias_affine = mi(t.act_biastype, u) == 1;
      const float gain = gain_affine ? gp.x + gp.y * length + gp.z * vel : gp.x;
      const float bs = bias_affine ? bp.x + bp.y * length + bp.z * vel : 0.f;
      float force = gain * c + bs;
      const float lo = mc(t.act_forcerange, 2 * u), hi = mc(t.act_forcerange, 2 * u + 1);
      const bool limited = mi(t.act_forcelimited, u);
      if (limited) force = fminf(fmaxf(force, lo), hi);
      afrc[u * E + e] = force;
      avel[u * E + e] = vel;
      act = act + force * gear;
      // implicitfast: dF/dv of the affine gain/bias, zero when saturated
      if (t.implicitfast && (bias_affine || gain_affine)) {
        float dfdv = bias_affine ? bp.z : 0.f;
        if (gain_affine) dfdv = dfdv + gp.z * c;
        if (limited && (force <= lo || force >= hi)) dfdv = 0.f;
        dg = dg - t.timestep * dfdv * gear * gear;
      }
    }

    // xfrc_applied projection over the bodies whose chain holds the dof
    float qfx = 0.f;
    for (int s = mi(tr.dof_sub_adr, i); s < mi(tr.dof_sub_adr, i + 1); ++s)
      qfx = qfx + dot6(cd, sld6(svel, mi(tr.dof_sub_body, s), lane));

    qfs[i * E + e] = passive - bias + act + __ldg(qfa + i * E + e) + qfx;
    diag[i * E + e] = dg;
  }
}

// shared floats per env: body velocities / xfrc forces and body
// accelerations / forces, 6 each per body; cdof and qvel, 7 per dof
static int vel_smooth_smem_floats(const SmoothTables* t) {
  return 12 * t->nbody + 7 * t->nv;
}

extern "C" int vel_smooth_launch(const SmoothTables* t, const SmoothTree* tr, const float* q,
                                 const float* qvel, const float* ctrl, const float* cdof,
                                 const float* cinA, const float* cinc, const float* subcom,
                                 const float* xipos, const float* xfrc, const float* qfa,
                                 float* qfs, float* afrc, float* avel, float* diag, int E,
                                 cudaStream_t stream) {
  return smooth_launch(vel_smooth_kernel, vel_smooth_smem_floats(t), E, stream, *t, *tr, q,
                       qvel, ctrl, cdof, cinA, cinc, subcom, xipos, xfrc, qfa, qfs, afrc,
                       avel, diag, E);
}
