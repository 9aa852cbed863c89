// vel_smooth: velocity-dependent smooth stages, one thread per env:
// com_vel, rne (bias forces), passive, joint actuation and xfrc_applied
// projection -> qfrc_smooth, actuator force and velocity, and the
// integrator's implicit diagonal (h*damping - h*dfdv*gear^2).
//
// Replaces the TPU kernel vel_smooth (mjlab_tpu/phys/smooth_pallas.py:389,
// pallas_call at :487).
//
// What bounds it on an H100: memory. Per env it reads q, qvel, ctrl,
// cdof, cinert (A, c), subtree com, xipos, xfrc_applied and qfrc_applied
// (~1.3k floats on the G1) for a few thousand flops.
//
// Design: the tree recursions of phys/lm/stages.py (com_vel_lm, rne_lm,
// passive_lm, actuation_lm, xfrc_lm, actuator_vel_deriv_lm) in the same
// order, table-driven from SmoothTables. Body velocities, cdof_dot, body
// accelerations and body forces go to env-last scratch; qfrc_smooth is
// summed as passive - bias + actuator + applied + xfrc (the order of
// smooth_pallas.py:456-463).
#include "smooth_common.cuh"

__global__ void vel_smooth_kernel(
    SmoothTables t, const float* __restrict__ q, const float* __restrict__ qvel,
    const float* __restrict__ ctrl, const float* __restrict__ cdof,
    const float* __restrict__ cinA, const float* __restrict__ cinc,
    const float* __restrict__ subcom, const float* __restrict__ xipos,
    const float* __restrict__ xfrc, const float* __restrict__ qfa,
    float* qfs, float* afrc, float* avel, float* diag,
    float* cvel, float* cdot, float* cacc, float* cfrc, float* bias,
    float* qact, float* qfx, int E) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  auto V = [&](int i) { return qvel[i * E + e]; };
  auto Q = [&](int i) { return q[i * E + e]; };
  const S6 z6 = {{0.f, 0.f, 0.f, 0.f, 0.f, 0.f}};

  // ---- com_vel: body velocities and cdof_dot ----
  st6(cvel, 0, E, e, z6);
  for (int i = 0; i < t.nv; ++i) st6(cdot, i, E, e, z6);
  auto add_dof = [&](S6 v, int i) {
    S6 c = ld6(cdof, i, E, e);
    float qi = V(i);
    for (int k = 0; k < 6; ++k) v.v[k] = v.v[k] + c.v[k] * qi;
    return v;
  };
  for (int b = 1; b < t.nbody; ++b) {
    S6 v = ld6(cvel, t.body_parentid[b], E, e);
    int jadr = t.body_jntadr[b], jnum = t.body_jntnum[b];
    for (int k = 0; k < jnum; ++k) {
      int j = jadr + k;
      int jt = t.jnt_type[j];
      int va = t.jnt_dofadr[j];
      if (jt == JNT_FREE) {
        for (int i = 0; i < 3; ++i) v = add_dof(v, va + i);
        for (int i = 3; i < 6; ++i) st6(cdot, va + i, E, e, motion_cross(v, ld6(cdof, va + i, E, e)));
        for (int i = 3; i < 6; ++i) v = add_dof(v, va + i);
      } else if (jt == JNT_BALL) {
        for (int i = 0; i < 3; ++i) st6(cdot, va + i, E, e, motion_cross(v, ld6(cdof, va + i, E, e)));
        for (int i = 0; i < 3; ++i) v = add_dof(v, va + i);
      } else {
        st6(cdot, va, E, e, motion_cross(v, ld6(cdof, va, E, e)));
        v = add_dof(v, va);
      }
    }
    st6(cvel, b, E, e, v);
  }

  // ---- rne: body accelerations, body forces, qfrc_bias ----
  S6 a0 = z6;
  if (t.gravity_on) {
    a0.v[3] = 0.f - t.gravity[0];
    a0.v[4] = 0.f - t.gravity[1];
    a0.v[5] = 0.f - t.gravity[2];
  }
  st6(cacc, 0, E, e, a0);
  for (int b = 1; b < t.nbody; ++b) {
    S6 a = ld6(cacc, t.body_parentid[b], E, e);
    int adr = t.body_dofadr[b], num = t.body_dofnum[b];
    for (int i = 0; i < num; ++i) {
      S6 cd = ld6(cdot, adr + i, E, e);
      float qi = V(adr + i);
      for (int k = 0; k < 6; ++k) a.v[k] = a.v[k] + cd.v[k] * qi;
    }
    st6(cacc, b, E, e, a);
  }
  for (int b = 0; b < t.nbody; ++b) {
    float A[6];
    for (int k = 0; k < 6; ++k) A[k] = cinA[(6 * b + k) * E + e];
    float mb = t.body_mass[b];
    V3 h = scale(ld3(cinc, b, E, e), mb);
    S6 cv = ld6(cvel, b, E, e);
    S6 Iv = spatial_mul(A, h, mb, cv);
    S6 Ia = spatial_mul(A, h, mb, ld6(cacc, b, E, e));
    S6 fc = force_cross(cv, Iv);
    for (int k = 0; k < 6; ++k) Ia.v[k] = Ia.v[k] + fc.v[k];
    st6(cfrc, b, E, e, Ia);
  }
  for (int b = t.nbody - 1; b > 0; --b) {
    int pid = t.body_parentid[b];
    S6 p = ld6(cfrc, pid, E, e), c = ld6(cfrc, b, E, e);
    for (int k = 0; k < 6; ++k) p.v[k] = p.v[k] + c.v[k];
    st6(cfrc, pid, E, e, p);
  }
  for (int i = 0; i < t.nv; ++i) bias[i * E + e] = 0.f;
  for (int b = 1; b < t.nbody; ++b) {
    int adr = t.body_dofadr[b], num = t.body_dofnum[b];
    S6 fb = ld6(cfrc, b, E, e);
    for (int i = 0; i < num; ++i) bias[(adr + i) * E + e] = dot6(ld6(cdof, adr + i, E, e), fb);
  }

  // ---- passive: damping and joint springs (into qfs) ----
  for (int i = 0; i < t.nv; ++i) qfs[i * E + e] = -t.dof_damping[i] * V(i);
  for (int j = 0; j < t.njnt; ++j) {
    float ks = t.jnt_stiffness[j];
    if (ks == 0.f) continue;
    int jt = t.jnt_type[j];
    int qa = t.jnt_qposadr[j], va = t.jnt_dofadr[j];
    if (jt == JNT_HINGE || jt == JNT_SLIDE) {
      qfs[va * E + e] = qfs[va * E + e] - ks * (Q(qa) - t.qpos_spring[qa]);
      continue;
    }
    int qq = qa, vv = va;
    if (jt == JNT_FREE) {
      for (int i = 0; i < 3; ++i)
        qfs[(va + i) * E + e] = qfs[(va + i) * E + e] - ks * (Q(qa + i) - t.qpos_spring[qa + i]);
      qq = qa + 3;
      vv = va + 3;
    }
    // quat_sub(q, qpos_spring): velocity-space difference
    Q4 qa4 = {Q(qq), Q(qq + 1), Q(qq + 2), Q(qq + 3)};
    Q4 qb4 = {t.qpos_spring[qq], -t.qpos_spring[qq + 1], -t.qpos_spring[qq + 2],
              -t.qpos_spring[qq + 3]};
    Q4 qd = qmul(qb4, qa4);
    if (qd.w < 0.f) qd = {-qd.w, -qd.x, -qd.y, -qd.z};
    float sin_half = sqrtf(fmaxf(qd.x * qd.x + qd.y * qd.y + qd.z * qd.z, 0.f));
    float angle = 2.f * atan2f(sin_half, qd.w);
    bool small = sin_half < 1e-12f;
    float safe = small ? 1.f : sin_half;
    float dif[3] = {small ? 0.f : qd.x / safe * angle, small ? 0.f : qd.y / safe * angle,
                    small ? 0.f : qd.z / safe * angle};
    for (int i = 0; i < 3; ++i) qfs[(vv + i) * E + e] = qfs[(vv + i) * E + e] - ks * dif[i];
  }

  // ---- actuation (joint transmission, no activation) ----
  for (int i = 0; i < t.nv; ++i) qact[i * E + e] = 0.f;
  for (int i = 0; i < t.nv; ++i) diag[i * E + e] = t.implicit ? t.timestep * t.dof_damping[i] : 0.f;
  for (int u = 0; u < t.nu; ++u) {
    int j = t.act_jnt[u];
    int qa = t.jnt_qposadr[j], va = t.jnt_dofadr[j];
    float gear = t.act_gear[u];
    float length = Q(qa) * gear;
    float vel = V(va) * gear;
    float c = ctrl[u * E + e];
    if (t.act_ctrllimited[u]) c = fminf(fmaxf(c, t.act_ctrlrange[2 * u]), t.act_ctrlrange[2 * u + 1]);
    const float* gp = t.act_gainprm + 3 * u;
    const float* bp = t.act_biasprm + 3 * u;
    float gain = t.act_gaintype[u] == 1 ? gp[0] + gp[1] * length + gp[2] * vel : gp[0];
    float bs = t.act_biastype[u] == 1 ? bp[0] + bp[1] * length + bp[2] * vel : 0.f;
    float force = gain * c + bs;
    float lo = t.act_forcerange[2 * u], hi = t.act_forcerange[2 * u + 1];
    if (t.act_forcelimited[u]) force = fminf(fmaxf(force, lo), hi);
    afrc[u * E + e] = force;
    avel[u * E + e] = vel;
    qact[va * E + e] = qact[va * E + e] + force * gear;
    // implicitfast: dF/dv of the affine gain/bias, zero when saturated
    bool has = t.act_biastype[u] == 1 || t.act_gaintype[u] == 1;
    if (t.implicitfast && has) {
      float dfdv = t.act_biastype[u] == 1 ? bp[2] : 0.f;
      if (t.act_gaintype[u] == 1) dfdv = dfdv + gp[2] * c;
      if (t.act_forcelimited[u] && (force <= lo || force >= hi)) dfdv = 0.f;
      diag[va * E + e] = diag[va * E + e] - t.timestep * dfdv * gear * gear;
    }
  }

  // ---- xfrc_applied projection ----
  for (int i = 0; i < t.nv; ++i) qfx[i * E + e] = 0.f;
  for (int b = 1; b < t.nbody; ++b) {
    V3 fo = ld3(xfrc, 2 * b, E, e), to = ld3(xfrc, 2 * b + 1, E, e);
    V3 off = sub(ld3(xipos, b, E, e), ld3(subcom, t.body_rootid[b], E, e));
    V3 ang = add(to, cross(off, fo));
    S6 s = {{ang.x, ang.y, ang.z, fo.x, fo.y, fo.z}};
    for (int i = 0; i < t.nv; ++i)
      if (t.anc_mask[b * t.nv + i]) qfx[i * E + e] = qfx[i * E + e] + dot6(ld6(cdof, i, E, e), s);
  }

  for (int i = 0; i < t.nv; ++i)
    qfs[i * E + e] = qfs[i * E + e] - bias[i * E + e] + qact[i * E + e] +
                     qfa[i * E + e] + qfx[i * E + e];
}

extern "C" int vel_smooth_launch(const SmoothTables* t, const float* q,
                                 const float* qvel, const float* ctrl,
                                 const float* cdof, const float* cinA,
                                 const float* cinc, const float* subcom,
                                 const float* xipos, const float* xfrc,
                                 const float* qfa, float* qfs, float* afrc,
                                 float* avel, float* diag, float* scratch,
                                 int E, cudaStream_t stream) {
  // scratch layout (rows of E): cvel nbody*6, cdot nv*6, cacc nbody*6,
  // cfrc nbody*6, bias nv, qact nv, qfx nv
  float* cvel = scratch;
  float* cdot = cvel + (size_t)t->nbody * 6 * E;
  float* cacc = cdot + (size_t)t->nv * 6 * E;
  float* cfrc = cacc + (size_t)t->nbody * 6 * E;
  float* bias = cfrc + (size_t)t->nbody * 6 * E;
  float* qact = bias + (size_t)t->nv * E;
  float* qfx = qact + (size_t)t->nv * E;
  const int threads = 32;
  int blocks = (E + threads - 1) / threads;
  vel_smooth_kernel<<<blocks, threads, 0, stream>>>(
      *t, q, qvel, ctrl, cdof, cinA, cinc, subcom, xipos, xfrc, qfa, qfs,
      afrc, avel, diag, cvel, cdot, cacc, cfrc, bias, qact, qfx, E);
  return static_cast<int>(cudaGetLastError());
}
