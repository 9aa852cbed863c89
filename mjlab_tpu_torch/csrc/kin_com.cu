// kin_com: kinematics + com quantities, many threads per env.
//
// Replaces the TPU kernel kin_com (mjlab_tpu/phys/smooth_pallas.py:237,
// pallas_call at :294), which traced the model's constants into
// straight-line code over (8, 128) env tiles. A mocap body takes its frame
// from the per-env mocap inputs (nmocap, 3, E) and (nmocap, 4, E), as the
// TPU kernel's mocap planes (smooth_pallas.py:237-260). qpos0, body_ipos,
// body_mass, body_inertia and geom_pos may be carried per env (the TPU
// kernels' DR planes, smooth_pallas.py:95-162): they are read through mcv
// (smooth_tree.cuh).
//
// What bounds it on an H100: memory. Per env it reads nq floats and writes
// the frames of the collision geoms, subtree coms, cdof, cinert (A, c),
// xipos, xpos and xquat (about 1.3k floats at the G1's sizes) for a few
// thousand flops, well under the card's ~20 flops per byte of HBM. What
// held the one-thread-per-env design back was latency: 128 one-warp
// blocks at E = 4096, each thread walking the whole tree through global
// memory.
//
// Design (csrc/smooth_tree.cuh): a block of SMOOTH_ENVS envs with
// SMOOTH_WORKERS workers each; every per-env intermediate (qpos, body
// frames, joint anchors and axes, xipos, subtree moments and masses) stays
// in shared memory. The formulas are those of phys/lm/stages.py
// (kinematics_lm, com_pos_lm), in the same order within each body:
//   0. qpos to shared memory, all workers at once (one global latency
//      instead of one per tree level), and each joint's own rotation (a
//      hinge's half-angle quaternion, a ball's or free joint's normalised
//      quaternion) or slide, which depend on qpos alone: the tree levels
//      keep only what depends on the parent's frame;
//   1. body frames, level by level from the root (the bodies of a level in
//      parallel), the mocap branch last;
//   2. xipos and the mass moments, per body;
//   3. subtree sums, deepest level first, each parent summing its own
//      children in descending index (the serial order, bitwise);
//   4. subtree com, per body;
//   5. cinert per body, cdof per joint, collision-geom frames per geom.
// Every output is written once, env-last and coalesced. What holds it back
// now (PERF.md, PR 5): the root-to-leaves pass, a dependent chain of
// ~1-2 us per tree level with two warps of the block's eight busy, and the
// launch with its first loads; the bytes would take a fifth of the time.
#include "smooth_common.cuh"
#include "smooth_tree.cuh"

// joint j's own motion from qpos (phys/lm/stages.py kinematics_lm): a
// hinge's quaternion (cos, axis sin) of half its angle, a ball's or free
// joint's normalised quaternion, a slide's displacement (in w)
__device__ __forceinline__ Q4 joint_motion(const SmoothTables& t, int j, const float* q,
                                           int E, int e) {
  auto Q = [&](int i) { return __ldg(q + i * E + e); };
  const int jt = mi(t.jnt_type, j), qa = mi(t.jnt_qposadr, j);
  if (jt == JNT_HINGE) {
    const float angle = Q(qa) - mcv(t.qpos0, t.env.qpos0, qa, e);
    const float half = 0.5f * angle;
    const float s = sinf(half), c = cosf(half);
    const V3 ax = mc3(t.jnt_axis, j);
    return {c, ax.x * s, ax.y * s, ax.z * s};
  }
  if (jt == JNT_SLIDE) return {Q(qa) - mcv(t.qpos0, t.env.qpos0, qa, e), 0.f, 0.f, 0.f};
  const int o = jt == JNT_FREE ? qa + 3 : qa;
  return qnormalize({Q(o), Q(o + 1), Q(o + 2), Q(o + 3)});
}

// body b's frame from its parent's (shared memory) and its joints' motions;
// writes the frame to shared memory and the outputs, the joints' anchors
// and axes to shared memory
__device__ __forceinline__ void body_frame(const SmoothTables& t, int b, const float* sq,
                                           const float* sjm, const float* mocap_pos,
                                           const float* mocap_quat, float* sxpos,
                                           float* sxquat, float* sanchor, float* saxis,
                                           float* xpos, float* xquat, int E, int e,
                                           int lane) {
  auto Q = [&](int i) { return sq[i * SMOOTH_ENVS + lane]; };
  const int jadr = mi(t.body_jntadr, b);
  const int jnum = mi(t.body_jntnum, b);
  V3 pos;
  Q4 quat;
  if (jnum == 1 && mi(t.jnt_type, jadr) == JNT_FREE) {
    const int qa = mi(t.jnt_qposadr, jadr);
    pos = v3(Q(qa), Q(qa + 1), Q(qa + 2));
    quat = sld4(sjm, jadr, lane);
    sst3(sanchor, jadr, lane, pos);
    sst3(saxis, jadr, lane, mc3(t.jnt_axis, jadr));
  } else {
    const int pid = mi(t.body_parentid, b);
    const V3 ppos = sld3(sxpos, pid, lane);
    const Q4 pquat = sld4(sxquat, pid, lane);
    pos = add(ppos, qrot(mc3(t.body_pos, b), pquat));
    quat = qmul(pquat, mc4(t.body_quat, b));
    for (int k = 0; k < jnum; ++k) {
      const int j = jadr + k;
      const int jt = mi(t.jnt_type, j);
      const V3 jpos = mc3(t.jnt_pos, j);
      const V3 anchor = add(pos, qrot(jpos, quat));
      const Q4 jm = sld4(sjm, j, lane);
      if (jt == JNT_SLIDE) {
        const V3 axis_w = qrot(mc3(t.jnt_axis, j), quat);
        pos = add(pos, scale(axis_w, jm.w));
      } else {  // hinge, ball
        quat = qmul(quat, jm);
        pos = sub(anchor, qrot(jpos, quat));
      }
      sst3(sanchor, j, lane, anchor);
      sst3(saxis, j, lane, qrot(mc3(t.jnt_axis, j), quat));
    }
    quat = qnormalize(quat);
  }
  const int mid = mi(t.body_mocapid, b);
  if (mid >= 0) {
    pos = ld3(mocap_pos, mid, E, e);
    quat = qnormalize({mocap_quat[(4 * mid) * E + e], mocap_quat[(4 * mid + 1) * E + e],
                       mocap_quat[(4 * mid + 2) * E + e], mocap_quat[(4 * mid + 3) * E + e]});
  }
  sst3(sxpos, b, lane, pos);
  sst4(sxquat, b, lane, quat);
  st3(xpos, b, E, e, pos);
  xquat[(4 * b) * E + e] = quat.w;
  xquat[(4 * b + 1) * E + e] = quat.x;
  xquat[(4 * b + 2) * E + e] = quat.y;
  xquat[(4 * b + 3) * E + e] = quat.z;
}

__global__ void __launch_bounds__(SMOOTH_THREADS)
kin_com_kernel(SmoothTables t, SmoothTree tr, const float* __restrict__ q,
               const float* __restrict__ mocap_pos, const float* __restrict__ mocap_quat,
               float* gxpos, float* gxmat, float* subcom, float* cdof, float* cinA,
               float* cinc, float* xipos, float* xpos, float* xquat, int E) {
  extern __shared__ float sm[];
  const int lane = threadIdx.x % SMOOTH_ENVS;
  const int w = threadIdx.x / SMOOTH_ENVS;
  const int e = blockIdx.x * SMOOTH_ENVS + lane;
  const bool live = e < E;  // the ragged edge: work masked, barriers kept
  const int nb = t.nbody, nj = t.njnt;
  float* sxpos = sm;                          // (nb, 3)
  float* sxquat = sxpos + 3 * nb * SMOOTH_ENVS;   // (nb, 4)
  float* sanchor = sxquat + 4 * nb * SMOOTH_ENVS; // (nj, 3)
  float* saxis = sanchor + 3 * nj * SMOOTH_ENVS;  // (nj, 3)
  float* sxipos = saxis + 3 * nj * SMOOTH_ENVS;   // (nb, 3)
  float* scom = sxipos + 3 * nb * SMOOTH_ENVS;    // (nb, 3) moments, then com
  float* smass = scom + 3 * nb * SMOOTH_ENVS;     // (nb,) subtree masses
  float* sq = smass + nb * SMOOTH_ENVS;           // (nq,) qpos
  float* sjm = sq + t.nq * SMOOTH_ENVS;           // (nj, 4) joint motions

  // ---- 0. qpos and the joints' motions to shared memory ----
  if (live) {
    for (int r = w; r < t.nq; r += SMOOTH_WORKERS) sq[r * SMOOTH_ENVS + lane] = __ldg(q + r * E + e);
    for (int j = w; j < nj; j += SMOOTH_WORKERS) sst4(sjm, j, lane, joint_motion(t, j, q, E, e));
  }

  // ---- 1. body frames, root to leaves ----
  if (live && w == 0) {
    const V3 zero = v3(0.f, 0.f, 0.f);
    const Q4 unit = {1.f, 0.f, 0.f, 0.f};
    sst3(sxpos, 0, lane, zero);
    sst4(sxquat, 0, lane, unit);
    st3(xpos, 0, E, e, zero);
    xquat[0 * E + e] = 1.f;
    xquat[1 * E + e] = 0.f;
    xquat[2 * E + e] = 0.f;
    xquat[3 * E + e] = 0.f;
  }
  __syncthreads();
  for (int L = 1; L < tr.nlevel; ++L) {
    const int a = mi(tr.level_adr, L), n = mi(tr.level_adr, L + 1) - a;
    if (live)
      for (int i = w; i < n; i += SMOOTH_WORKERS)
        body_frame(t, mi(tr.level_body, a + i), sq, sjm, mocap_pos, mocap_quat, sxpos,
                   sxquat, sanchor, saxis, xpos, xquat, E, e, lane);
    __syncthreads();
  }

  // ---- 2. xipos and the mass moments ----
  if (live)
    for (int b = w; b < nb; b += SMOOTH_WORKERS) {
      const V3 xi = add(sld3(sxpos, b, lane), qrot(mcv3(t.body_ipos, t.env.body_ipos, b, e), sld4(sxquat, b, lane)));
      st3(xipos, b, E, e, xi);
      sst3(sxipos, b, lane, xi);
      const float mb = mcv(t.body_mass, t.env.body_mass, b, e);
      sst3(scom, b, lane, scale(xi, mb));
      smass[b * SMOOTH_ENVS + lane] = mb;
    }
  __syncthreads();

  // ---- 3. subtree sums, deepest level first ----
  for (int L = tr.nlevel - 1; L > 0; --L) {
    const int a = mi(tr.level_adr, L - 1), n = mi(tr.level_adr, L) - a;
    if (live)
      for (int i = w; i < n; i += SMOOTH_WORKERS) {
        const int p = mi(tr.level_body, a + i);
        const int c0 = mi(tr.child_adr, p), c1 = mi(tr.child_adr, p + 1);
        if (c0 == c1) continue;
        V3 acc = sld3(scom, p, lane);
        float ms = smass[p * SMOOTH_ENVS + lane];
        for (int k = c0; k < c1; ++k) {
          const int c = mi(tr.child_body, k);
          acc = add(acc, sld3(scom, c, lane));
          ms = ms + smass[c * SMOOTH_ENVS + lane];
        }
        sst3(scom, p, lane, acc);
        smass[p * SMOOTH_ENVS + lane] = ms;
      }
    __syncthreads();
  }

  // ---- 4. subtree com ----
  if (live)
    for (int b = w; b < nb; b += SMOOTH_WORKERS) {
      const V3 com =
          scale(sld3(scom, b, lane), 1.f / fmaxf(smass[b * SMOOTH_ENVS + lane], 1e-12f));
      st3(subcom, b, E, e, com);
      sst3(scom, b, lane, com);
    }
  __syncthreads();
  if (!live) return;  // no barrier below

  // ---- 5a. cinert: A = R diag(I) R^T - m [c]x^2 (sym-6), c = xipos - com ----
  for (int b = w; b < nb; b += SMOOTH_WORKERS) {
    float xm[9], im[9], R[9];
    qmat(sld4(sxquat, b, lane), xm);
    qmat(mc4(t.body_iquat, b), im);
    matmul3(xm, im, R);
    const V3 I = mcv3(t.body_inertia, t.env.body_inertia, b, e);
    float Iw[6];
    int s = 0;
    for (int i = 0; i < 3; ++i)
      for (int j = i; j < 3; ++j)
        Iw[s++] = R[3 * i] * I.x * R[3 * j] + R[3 * i + 1] * I.y * R[3 * j + 1] +
                  R[3 * i + 2] * I.z * R[3 * j + 2];
    const V3 c = sub(sld3(sxipos, b, lane), sld3(scom, mi(t.body_rootid, b), lane));
    const float mb = mcv(t.body_mass, t.env.body_mass, b, e);
    const float c2 = c.x * c.x + c.y * c.y + c.z * c.z;
    const float cc[6] = {c.x * c.x - c2, c.x * c.y, c.x * c.z,
                         c.y * c.y - c2, c.y * c.z, c.z * c.z - c2};
    for (int k = 0; k < 6; ++k) cinA[(6 * b + k) * E + e] = Iw[k] - mb * cc[k];
    st3(cinc, b, E, e, c);
  }

  // ---- 5b. cdof, per joint ----
  auto put = [&](int dof, V3 ang, V3 lin) {
    cdof[(6 * dof + 0) * E + e] = ang.x;
    cdof[(6 * dof + 1) * E + e] = ang.y;
    cdof[(6 * dof + 2) * E + e] = ang.z;
    cdof[(6 * dof + 3) * E + e] = lin.x;
    cdof[(6 * dof + 4) * E + e] = lin.y;
    cdof[(6 * dof + 5) * E + e] = lin.z;
  };
  for (int j = w; j < nj; j += SMOOTH_WORKERS) {
    const int jt = mi(t.jnt_type, j);
    const int b = mi(t.jnt_bodyid, j);
    const int va = mi(t.jnt_dofadr, j);
    const V3 O = sld3(scom, mi(t.body_rootid, b), lane);
    if (jt == JNT_FREE || jt == JNT_BALL) {
      float R[9];
      qmat(sld4(sxquat, b, lane), R);
      int base = va;
      V3 offset;
      if (jt == JNT_FREE) {
        const V3 zero = v3(0.f, 0.f, 0.f);
        put(va + 0, zero, v3(1.f, 0.f, 0.f));
        put(va + 1, zero, v3(0.f, 1.f, 0.f));
        put(va + 2, zero, v3(0.f, 0.f, 1.f));
        offset = sub(O, sld3(sxpos, b, lane));
        base = va + 3;
      } else {
        offset = sub(O, sld3(sanchor, j, lane));
      }
      for (int i = 0; i < 3; ++i) {
        const V3 ax = v3(R[i], R[3 + i], R[6 + i]);
        put(base + i, ax, cross(ax, offset));
      }
    } else if (jt == JNT_SLIDE) {
      put(va, v3(0.f, 0.f, 0.f), sld3(saxis, j, lane));
    } else {
      const V3 ax = sld3(saxis, j, lane);
      put(va, ax, cross(ax, sub(O, sld3(sanchor, j, lane))));
    }
  }

  // ---- 5c. collision geom frames, per geom ----
  for (int o = w; o < t.ncg; o += SMOOTH_WORKERS) {
    const int g = mi(t.cg_geom, o);
    const int b = mi(tr.cg_body, o);
    const Q4 bq = sld4(sxquat, b, lane);
    st3(gxpos, o, E, e, add(sld3(sxpos, b, lane), qrot(mcv3(t.geom_pos, t.env.geom_pos, g, e), bq)));
    float xm[9], gm[9], r[9];
    qmat(bq, xm);
    qmat(mc4(t.geom_quat, g), gm);
    matmul3(xm, gm, r);
    for (int k = 0; k < 9; ++k) gxmat[(9 * o + k) * E + e] = r[k];
  }
}

// shared floats per env: frames (7 nbody), anchors and axes (6 njnt),
// xipos, subtree moments and masses (7 nbody), qpos (nq), joint motions
// (4 njnt)
static int kin_com_smem_floats(const SmoothTables* t) {
  return 14 * t->nbody + 10 * t->njnt + t->nq;
}

extern "C" int kin_com_launch(const SmoothTables* t, const SmoothTree* tr,
                              const EnvFields* env, const float* q,
                              const float* mocap_pos, const float* mocap_quat,
                              float* gxpos, float* gxmat, float* subcom,
                              float* cdof, float* cinA, float* cinc,
                              float* xipos, float* xpos, float* xquat, int E,
                              cudaStream_t stream) {
  return smooth_launch(kin_com_kernel, kin_com_smem_floats(t), E, stream, with_env(t, env), *tr, q,
                       mocap_pos, mocap_quat, gxpos, gxmat, subcom, cdof, cinA, cinc,
                       xipos, xpos, xquat, E);
}
