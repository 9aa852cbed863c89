// kin_com: kinematics + com quantities, one thread per env.
//
// Replaces the TPU kernel kin_com (mjlab_tpu/phys/smooth_pallas.py:237,
// pallas_call at :294), which traced the model's constants into
// straight-line code over (8, 128) env tiles.
//
// What bounds it on an H100: memory. Per env it reads nq floats and writes
// the frames of the collision geoms, subtree coms, cdof, cinert (A, c),
// xipos, xpos and xquat (about 1.3k floats at the G1's sizes) for a few
// thousand flops, well under the card's ~20 flops per byte of HBM.
//
// Design: table-driven instead of traced. The tree and constants come
// from SmoothTables (uploaded once); the thread walks the bodies in tree
// order with the formulas of phys/lm/stages.py (kinematics_lm, com_pos_lm),
// in the same order of operations. Every per-env array is env-last
// (row * E + e), so each load and store of a warp is coalesced; body
// frames are written to the outputs as they are made and read back from
// there by the children, and joint anchors/axes go to env-last scratch,
// which keeps the thread's registers free of per-body arrays. One thread
// per env leaves the card under-occupied at E = 4096 (128 blocks of one
// warp); splitting the tree walk across threads is later work.
#include "smooth_common.cuh"

__global__ void kin_com_kernel(SmoothTables t, const float* __restrict__ q,
                               float* gxpos, float* gxmat, float* subcom,
                               float* cdof, float* cinA, float* cinc,
                               float* xipos, float* xpos, float* xquat,
                               float* xanchor, float* xaxis, int E) {
  int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= E) return;
  auto Q = [&](int i) { return q[i * E + e]; };

  // ---- kinematics: body frames in tree order ----
  st3(xpos, 0, E, e, v3(0.f, 0.f, 0.f));
  xquat[0 * E + e] = 1.f;
  xquat[1 * E + e] = 0.f;
  xquat[2 * E + e] = 0.f;
  xquat[3 * E + e] = 0.f;
  for (int b = 1; b < t.nbody; ++b) {
    int pid = t.body_parentid[b];
    int jadr = t.body_jntadr[b];
    int jnum = t.body_jntnum[b];
    V3 pos;
    Q4 quat;
    if (jnum == 1 && t.jnt_type[jadr] == JNT_FREE) {
      int qa = t.jnt_qposadr[jadr];
      pos = v3(Q(qa), Q(qa + 1), Q(qa + 2));
      quat = qnormalize({Q(qa + 3), Q(qa + 4), Q(qa + 5), Q(qa + 6)});
      st3(xanchor, jadr, E, e, pos);
      st3(xaxis, jadr, E, e, tab3(t.jnt_axis, jadr));
    } else {
      V3 ppos = ld3(xpos, pid, E, e);
      Q4 pquat = {xquat[(4 * pid) * E + e], xquat[(4 * pid + 1) * E + e],
                  xquat[(4 * pid + 2) * E + e], xquat[(4 * pid + 3) * E + e]};
      pos = add(ppos, qrot(tab3(t.body_pos, b), pquat));
      quat = qmul(pquat, tab4(t.body_quat, b));
      for (int k = 0; k < jnum; ++k) {
        int j = jadr + k;
        int jt = t.jnt_type[j];
        int qa = t.jnt_qposadr[j];
        V3 jpos = tab3(t.jnt_pos, j);
        V3 anchor = add(pos, qrot(jpos, quat));
        if (jt == JNT_SLIDE) {
          V3 axis_w = qrot(tab3(t.jnt_axis, j), quat);
          pos = add(pos, scale(axis_w, Q(qa) - t.qpos0[qa]));
        } else if (jt == JNT_HINGE) {
          float angle = Q(qa) - t.qpos0[qa];
          float half = 0.5f * angle;
          float s = sinf(half), c = cosf(half);
          V3 ax = tab3(t.jnt_axis, j);
          quat = qmul(quat, {c, ax.x * s, ax.y * s, ax.z * s});
          pos = sub(anchor, qrot(jpos, quat));
        } else {  // ball
          Q4 ql = qnormalize({Q(qa), Q(qa + 1), Q(qa + 2), Q(qa + 3)});
          quat = qmul(quat, ql);
          pos = sub(anchor, qrot(jpos, quat));
        }
        st3(xanchor, j, E, e, anchor);
        st3(xaxis, j, E, e, qrot(tab3(t.jnt_axis, j), quat));
      }
      quat = qnormalize(quat);
    }
    st3(xpos, b, E, e, pos);
    xquat[(4 * b) * E + e] = quat.w;
    xquat[(4 * b + 1) * E + e] = quat.x;
    xquat[(4 * b + 2) * E + e] = quat.y;
    xquat[(4 * b + 3) * E + e] = quat.z;
  }

  auto ldq = [&](int b) -> Q4 {
    return {xquat[(4 * b) * E + e], xquat[(4 * b + 1) * E + e],
            xquat[(4 * b + 2) * E + e], xquat[(4 * b + 3) * E + e]};
  };

  // ---- xipos, subtree com (moments accumulated in subcom) ----
  float smass[MJT_MAX_BODY];
  for (int b = 0; b < t.nbody; ++b) {
    V3 xi = add(ld3(xpos, b, E, e), qrot(tab3(t.body_ipos, b), ldq(b)));
    st3(xipos, b, E, e, xi);
    float mb = t.body_mass[b];
    st3(subcom, b, E, e, scale(xi, mb));
    smass[b] = mb;
  }
  for (int b = t.nbody - 1; b > 0; --b) {
    int pid = t.body_parentid[b];
    st3(subcom, pid, E, e, add(ld3(subcom, pid, E, e), ld3(subcom, b, E, e)));
    smass[pid] = smass[pid] + smass[b];
  }
  for (int b = 0; b < t.nbody; ++b)
    st3(subcom, b, E, e, scale(ld3(subcom, b, E, e), 1.f / fmaxf(smass[b], 1e-12f)));

  // ---- cinert: A = R diag(I) R^T - m [c]x^2 (sym-6), c = xipos - com ----
  for (int b = 0; b < t.nbody; ++b) {
    float xm[9], im[9], R[9];
    qmat(ldq(b), xm);
    qmat(tab4(t.body_iquat, b), im);
    matmul3(xm, im, R);
    V3 I = tab3(t.body_inertia, b);
    float Iw[6];
    int s = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = i; j < 3; ++j)
        Iw[s++] = R[3 * i] * I.x * R[3 * j] + R[3 * i + 1] * I.y * R[3 * j + 1] +
                  R[3 * i + 2] * I.z * R[3 * j + 2];
    V3 c = sub(ld3(xipos, b, E, e), ld3(subcom, t.body_rootid[b], E, e));
    float mb = t.body_mass[b];
    float c2 = c.x * c.x + c.y * c.y + c.z * c.z;
    float cc[6] = {c.x * c.x - c2, c.x * c.y, c.x * c.z,
                   c.y * c.y - c2, c.y * c.z, c.z * c.z - c2};
    for (int k = 0; k < 6; ++k) cinA[(6 * b + k) * E + e] = Iw[k] - mb * cc[k];
    st3(cinc, b, E, e, c);
  }

  // ---- cdof ----
  for (int j = 0; j < t.njnt; ++j) {
    int jt = t.jnt_type[j];
    int b = t.jnt_bodyid[j];
    int va = t.jnt_dofadr[j];
    V3 O = ld3(subcom, t.body_rootid[b], E, e);
    float* cd = cdof;
    auto put = [&](int dof, V3 ang, V3 lin) {
      cd[(6 * dof + 0) * E + e] = ang.x;
      cd[(6 * dof + 1) * E + e] = ang.y;
      cd[(6 * dof + 2) * E + e] = ang.z;
      cd[(6 * dof + 3) * E + e] = lin.x;
      cd[(6 * dof + 4) * E + e] = lin.y;
      cd[(6 * dof + 5) * E + e] = lin.z;
    };
    if (jt == JNT_FREE || jt == JNT_BALL) {
      float R[9];
      qmat(ldq(b), R);
      int base = va;
      V3 offset;
      if (jt == JNT_FREE) {
        V3 zero = v3(0.f, 0.f, 0.f);
        put(va + 0, zero, v3(1.f, 0.f, 0.f));
        put(va + 1, zero, v3(0.f, 1.f, 0.f));
        put(va + 2, zero, v3(0.f, 0.f, 1.f));
        offset = sub(O, ld3(xpos, b, E, e));
        base = va + 3;
      } else {
        offset = sub(O, ld3(xanchor, j, E, e));
      }
      for (int i = 0; i < 3; ++i) {
        V3 ax = v3(R[i], R[3 + i], R[6 + i]);
        put(base + i, ax, cross(ax, offset));
      }
    } else if (jt == JNT_SLIDE) {
      put(va, v3(0.f, 0.f, 0.f), ld3(xaxis, j, E, e));
    } else {
      V3 ax = ld3(xaxis, j, E, e);
      put(va, ax, cross(ax, sub(O, ld3(xanchor, j, E, e))));
    }
  }

  // ---- collision geom frames ----
  for (int o = 0; o < t.ncg; ++o) {
    int g = t.cg_geom[o];
    int b = t.geom_bodyid[g];
    Q4 bq = ldq(b);
    st3(gxpos, o, E, e, add(ld3(xpos, b, E, e), qrot(tab3(t.geom_pos, g), bq)));
    float xm[9], gm[9], r[9];
    qmat(bq, xm);
    qmat(tab4(t.geom_quat, g), gm);
    matmul3(xm, gm, r);
    for (int k = 0; k < 9; ++k) gxmat[(9 * o + k) * E + e] = r[k];
  }
}

extern "C" int kin_com_launch(const SmoothTables* t, const float* q,
                              float* gxpos, float* gxmat, float* subcom,
                              float* cdof, float* cinA, float* cinc,
                              float* xipos, float* xpos, float* xquat,
                              float* xanchor, float* xaxis, int E,
                              cudaStream_t stream) {
  const int threads = 32;
  int blocks = (E + threads - 1) / threads;
  kin_com_kernel<<<blocks, threads, 0, stream>>>(
      *t, q, gxpos, gxmat, subcom, cdof, cinA, cinc, xipos, xpos, xquat,
      xanchor, xaxis, E);
  return static_cast<int>(cudaGetLastError());
}
