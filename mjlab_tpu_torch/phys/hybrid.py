"""The env-last physics step, the full forward pass and the per-control-
step kinematic refresh.

PyTorch counterpart of mjlab_tpu/phys/hybrid.py: its kernel path
(``_step_envlast``, ``refresh_envlast``) and its full-writeback
``forward_hybrid`` and ``step_hybrid(lean=False)`` (here step_full). One
lean step:

    kin_com (kernel)            qpos, mocap -> geom frames, com, cdof, cinert
    collision_lm, constraint    narrowphase + top-K + row data (eager torch)
    vel_smooth (kernel)         qfrc_smooth, actuator force, Mh diagonal
    crb_dense (kernel)          dense mass matrix (nv*nv, E), + Mh diagonal
    newton_assemble_solve       contact rows + Newton solve + implicit update
    integrate_envlast           positions/velocities, divergence reset

Data stays env-first; the step moves qpos/qvel/ctrl to env-last planes on
the way in and writes back only what the env step consumes (the lean
writeback): contact activity, the compacted K-slot record and the solver
outputs.

The full forward pass (mj_forward over the whole Data surface, for reset
and startup, viewers and parity tests) runs the env-first batched stages
(phys/kinematics.py, smooth.py, forward.py), the same contact stack with
the dense contact rows assembled (make_constraint_lm with assemble_j), and
the dense-Jacobian Newton solve (newton_solve_dense, csrc/
newton_solve_dense.cu), then writes back every efc row, the packed contact
table and connormal.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from mjlab_tpu_torch.phys import forward as fwd
from mjlab_tpu_torch.phys import smooth
from mjlab_tpu_torch.phys.data import Contact, Data
from mjlab_tpu_torch.phys.kinematics import com_pos, kinematics
from mjlab_tpu_torch.phys.lm.base import Params, quat_to_mat
from mjlab_tpu_torch.phys.lm.collision import collision_lm, slot_params
from mjlab_tpu_torch.phys.lm.constraint import make_constraint_lm
from mjlab_tpu_torch.phys.model import (
    CONE_PYRAMIDAL, EFC_CONTACT, EFC_EQUALITY, EFC_FRICTION_DOF,
    EFC_LIMIT_JOINT, EFC_LIMIT_TENDON, JNT_BALL, JNT_FREE, Model, cached,
    device_array, limit_rows_static, per_env_smooth,
)
from mjlab_tpu_torch.phys.smooth_kernels import (
    collision_geoms, crb_dense, implicit_flags, integrate_envlast, kin_com,
    vel_smooth,
)
from mjlab_tpu_torch.phys.solver_dense_kernels import newton_solve_dense
from mjlab_tpu_torch.phys.solver_kernels import newton_assemble_solve


def has_implicit(m: Model) -> bool:
    """Whether the integrator solves an implicit velocity update."""
    return implicit_flags(m)[0]


def _ef(x: torch.Tensor) -> torch.Tensor:
    """(rows..., E) -> (E, rows...)."""
    return torch.movedim(x, -1, 0)


def contact_stack(m: Model, P: Params, qT, vT, gxpos, gxmat, subcom):
    """Narrowphase, top-K compaction and constraint rows (eager torch)."""
    E = qT.shape[-1]
    gx = gxpos.new_zeros(m.ngeom, 3, E)
    gm = gxmat.new_zeros(m.ngeom, 9, E)
    cg = device_array(m, "collision_geoms", lambda: collision_geoms(m), torch.long)
    gx[cg] = gxpos
    gm[cg] = gxmat
    k = collision_lm(m, P, gx, gm, {"subtree_com": subcom})
    q = tuple(qT[i] for i in range(m.nq))
    qvel = tuple(vT[i] for i in range(m.nv))
    return make_constraint_lm(m, P, k, q, qvel, qT.dtype)


def mocap_planes(m: Model, d: Data):
    """The env-last mocap frames (nmocap, 3, E), (nmocap, 4, E) kin_com
    takes, or (None, None) for a model without mocap bodies."""
    if not m.nmocap:
        return None, None
    return (d.mocap_pos.permute(1, 2, 0).contiguous(),
            d.mocap_quat.permute(1, 2, 0).contiguous())


def solve_args(m: Model, k: dict, qM_cm, qfsT, wsT, vT, cdofT, Mh_cm):
    """(args, kwargs) of newton_assemble_solve from the kernel-mode
    constraint tensors: every input contiguous, env-last, in the kernel's
    layouts (component- and dof-major, contact rows r-major). The
    elliptic cone passes the friction-row D values where the pyramidal
    one passes the friction coefficients, and the whitened cone
    coefficient."""
    E = vT.shape[-1]
    nv, K, R, neq = m.nv, m.ncon_max, m.rows_per_con, m.neq_jnt
    NC = neq + nv + m.nlimit
    cone = int(m.opt.cone)

    def cm(x):  # (K, w, E) -> component-major (w*K, E)
        return x.permute(1, 0, 2).reshape(-1, E).contiguous()

    c = lambda x: x.contiguous()  # noqa: E731
    dummy = vT.new_zeros(1, E)
    do_int = Mh_cm is not None
    args = (
        c(qM_cm), c(qfsT), c(wsT), c(vT), c(Mh_cm) if do_int else dummy,
        c(k["efc_D"][:NC]), c(k["efc_aref"][:NC]), c(k["efc_fl"][:NC]),
        c(k["efc_lim_side"]),
        c(k["efc_Jeq"].reshape(neq * nv, E)) if neq else dummy,
        c(cdofT), cm(k["con_pos_k"]), c(k["con_O1"].reshape(3 * K, E)),
        c(k["con_O2"].reshape(3 * K, E)), cm(k["con_frame_k"]),
        cm(k["con_Dfri"]) if cone else cm(k["con_mu_dirs"]),
        c(k["con_mut"]) if cone else dummy,
        c(k["con_Dc"]), c(k["con_bb"]), c(k["con_kimp"]),
        c(k["con_on"].to(vT.dtype)),
        c(k["con_W1"].reshape(nv * K, E)), c(k["con_W2"].reshape(nv * K, E)),
    )
    kw = dict(
        nv=nv, K=K, R=R, ndirs=R - 1 if cone else R // 2, neq=neq,
        nlim=m.nlimit, cone=cone,
        lim_dofs=tuple(int(a) for a in m.jnt_dofadr[m.limit_jntid]),
        iterations=m.opt.iterations,
        ls_iterations=max(m.opt.ls_iterations, 8),
        tolerance=float(m.opt.tolerance),
        do_int=do_int,
    )
    return args, kw


def _solve_core(m: Model, k: dict, qM_cm, qfsT, wsT, vT, cdofT, Mh_cm,
                iters=None) -> dict:
    """Launch the fused assembly+solve; returns qacc, efc_force (k-major
    contacts), qfrc_constraint, qacc_smooth and, when Mh_cm is given,
    qacc_int."""
    E = vT.shape[-1]
    K, R = m.ncon_max, m.rows_per_con
    args, kw = solve_args(m, k, qM_cm, qfsT, wsT, vT, cdofT, Mh_cm)
    x, fnc, fcon_rm, qfrc, a_smooth, qacc_int = newton_assemble_solve(
        *args, **kw, iters=iters
    )
    fcon = fcon_rm.reshape(R, K, E).permute(1, 0, 2).reshape(R * K, E)
    out = dict(
        qacc=x, efc_force=torch.cat([fnc, fcon], dim=0),
        qfrc_constraint=qfrc, qacc_smooth=a_smooth,
    )
    if kw["do_int"]:
        out["qacc_int"] = qacc_int
    return out


def _writeback_lean(m: Model, d: Data, k: dict, P: Params) -> Data:
    """Contact activity per slot and the compacted K-slot record."""
    S, K = m.pairs.ncon, m.ncon_max
    if not S:
        return d
    dtype = d.qpos.dtype
    _, _, _, inclm = slot_params(m, P, dtype)
    upd = dict(condist=_ef(k["con_dist"]), con_found=_ef(k["con_dist"] < inclm))
    if K:
        cpk = torch.cat(
            [
                k["con_dist_k"][:, None],
                k["con_margin_k"][:, None],
                k["con_pos_k"],
                k["con_mu_k"],
                k["con_solref_k"],
                k["con_solimp_k"],
                k["con_frame_k"],
                k["con_dim_k"][:, None],
            ],
            dim=1,
        )  # (K, 27, E)
        upd.update(
            con_sel=_ef(k["con_sel"]).to(torch.int32),
            con_sel_active=_ef(k["con_sel_active"]),
            con_packed_c=_ef(cpk),
        )
    return d.replace(**upd)


def decode_contact_forces(m: Model, d: Data, efc_force: torch.Tensor):
    """World contact force and torque per compacted slot (mj_contactForce):
    (E, K, 3) each, zero on inactive slots. Elliptic rows are the
    contact-frame components [fn, t1, t2, torsion, roll1, roll2][:R];
    pyramidal rows are edge forces."""
    K, R = m.ncon_max, m.rows_per_con
    E = efc_force.shape[0]
    base = m.neq_jnt + m.nv + m.nlimit + m.nlimit_ten
    rows = efc_force[:, base:base + R * K].reshape(E, K, R)
    cpk = d.con_packed_c
    mu = cpk[..., 5:10]
    frame = cpk[..., 17:26].reshape(E, K, 3, 3)
    dim_k = cpk[..., 26]
    active = d.con_sel_active[..., None]

    if int(m.opt.cone) != CONE_PYRAMIDAL:
        def world(first):
            fc = torch.stack([
                rows[..., i] if i < R else torch.zeros_like(dim_k)
                for i in range(first, first + 3)
            ], dim=-1)
            return torch.where(
                active, torch.einsum("ekf,ekfx->ekx", fc, frame), 0.0
            )

        force = world(0)
        return force, world(3) if R > 3 else torch.zeros_like(force)

    def comp(i, dim_req):
        # friction component i (1-based) <- rows 2(i-1), 2(i-1)+1
        if R < 2 * i:
            return torch.zeros_like(dim_k)
        c = torch.where(dim_k >= dim_req, mu[..., i - 1], 0.0)
        return c * (rows[..., 2 * (i - 1)] - rows[..., 2 * (i - 1) + 1])

    fc = torch.stack([rows.sum(-1), comp(1, 3), comp(2, 3)], dim=-1)
    force = torch.where(active, torch.einsum("ekf,ekfx->ekx", fc, frame), 0.0)
    if R > 4:
        tc = torch.stack([comp(3, 4), comp(4, 6), comp(5, 6)], dim=-1)
        torque = torch.where(
            active, torch.einsum("ekf,ekfx->ekx", tc, frame), 0.0
        )
    else:
        torque = torch.zeros_like(force)
    return force, torque


def forward_solve(m: Model, d: Data, iters: torch.Tensor | None = None,
                  mark: Callable[[str], None] | None = None):
    """Every stage of a step before integration, env-last.

    Returns (qT, vT, sol): qpos/qvel as (nq, E)/(nv, E) planes and a dict
    with the solver outputs (qacc, efc_force, qfrc_constraint,
    qacc_smooth, qacc_int), actuator_force/actuator_velocity (nu, E) and
    the contact stack's dict as "k". ``iters`` receives each env's Newton
    iteration count; ``mark`` is called after each phase with its name."""
    mark = mark or (lambda name: None)
    E = d.qpos.shape[0]
    nv = m.nv
    P = Params(m, E)
    qT = d.qpos.T.contiguous()
    vT = d.qvel.T.contiguous()
    ctrlT = d.ctrl.T.contiguous()

    kin = kin_com(m, qT, *mocap_planes(m, d))
    gxpos, gxmat, subcom, cdof, cinA, cinc, xipos, _, _ = kin
    mark("kin_com")
    k = contact_stack(m, P, qT, vT, gxpos, gxmat, subcom)
    mark("contact")
    xfrcT = d.xfrc_applied.permute(1, 2, 0).contiguous()
    qfaT = d.qfrc_applied.T.contiguous()
    qfs, afrc, avel, mh_diag = vel_smooth(
        m, qT, vT, ctrlT, cdof, cinA, cinc, (subcom, xipos, xfrcT, qfaT)
    )
    mark("vel_smooth")
    qM_cm, Mh_cm = crb_dense(m, cdof, cinA, cinc, mh_diag if has_implicit(m) else None)
    mark("crb")
    sol = _solve_core(
        m, k, qM_cm, qfs, d.qacc_warmstart.T, vT, cdof.reshape(nv * 6, E),
        Mh_cm, iters=iters,
    )
    mark("solve")
    sol.setdefault("qacc_int", sol["qacc"])
    sol.update(actuator_force=afrc, actuator_velocity=avel, k=k, kin=kin)
    return qT, vT, sol


def step_envlast(m: Model, d: Data,
                 mark: Callable[[str], None] | None = None,
                 frames: bool = False) -> Data:
    """One physics step of every env (mj_step semantics, lean writeback).

    ``frames`` also writes what refresh_envlast writes, for the state the
    step started from, from the step's own kin_com (what mj_step leaves in
    mjData, and what the JAX package's batched step writes per substep on
    the CPU: frames and velocities one substep behind qpos).
    ``mark(name)``, if given, is called after each phase with the phase's
    name (kin_com, contact, vel_smooth, crb, solve, integrate); a profiler
    records events there."""
    mark = mark or (lambda name: None)
    nu = m.nu
    qT, vT, sol = forward_solve(m, d, mark=mark)
    if frames:
        d = d.replace(**_frame_fields(m, d, sol["kin"], vT))
    qacc = sol["qacc"]
    qT_new, vT_new, bad = integrate_envlast(m, qT, vT, sol["qacc_int"])
    afrc, avel = sol["actuator_force"], sol["actuator_velocity"]

    d = _writeback_lean(m, d, sol["k"], Params(m, qT.shape[-1]))
    efc_force = sol["efc_force"].T
    found = d.con_found.to(torch.int32).sum(-1)
    d = d.replace(
        qpos=qT_new.T,
        qvel=vT_new.T,
        qacc=qacc.T,
        qacc_warmstart=torch.where(bad[:, None], 0.0, qacc.T),
        qacc_smooth=sol["qacc_smooth"].T,
        qfrc_constraint=sol["qfrc_constraint"].T,
        efc_force=efc_force,
        actuator_force=afrc.T if nu else d.actuator_force,
        actuator_velocity=avel.T if nu else d.actuator_velocity,
        time=d.time + m.opt.timestep,
        ncheck_reset=d.ncheck_reset + bad.to(torch.int32),
        ncon_overflow=d.ncon_overflow
        + torch.clamp(found - m.ncon_max, min=0).to(torch.int32),
    )
    if m.ncon_max and m.pairs.ncon:
        cf, ct = decode_contact_forces(m, d, efc_force)
        d = d.replace(con_force_c=cf, con_torque_c=ct)
    mark("integrate")
    return d


# ---------------------------------------------------------------------------
# the full forward pass (mj_forward over the whole Data surface)
# ---------------------------------------------------------------------------


def _contact_full(m: Model, P: Params, d: Data) -> dict:
    """Narrowphase, top-K compaction and the constraint rows with the
    dense contact Jacobian, from the env-first frames of the batched
    position stages."""
    E = d.qpos.shape[0]
    env_last = lambda x: torch.movedim(x, 0, -1).contiguous()  # noqa: E731
    k = collision_lm(
        m, P, env_last(d.geom_xpos), env_last(d.geom_xmat.reshape(E, m.ngeom, 9)),
        {"subtree_com": env_last(d.subtree_com), "cdof": env_last(d.cdof)},
    )
    qT, vT = d.qpos.T, d.qvel.T
    return make_constraint_lm(
        m, P, k, tuple(qT[i] for i in range(m.nq)),
        tuple(vT[i] for i in range(m.nv)), qT.dtype, assemble_j=True,
    )


def _writeback_full(m: Model, d: Data, k: dict, P: Params) -> Data:
    """The lean writeback plus every efc row, the packed (E, ncon, 26)
    contact table and connormal."""
    d = _writeback_lean(m, d, k, P)
    upd = dict(
        efc_D=_ef(k["efc_D"]), efc_aref=_ef(k["efc_aref"]),
        efc_frictionloss=_ef(k["efc_fl"]), efc_pos=_ef(k["efc_pos"]),
        efc_margin=_ef(k["efc_margin"]), efc_active=_ef(k["efc_active"]),
        efc_Jeq=_ef(k["efc_Jeq"]), efc_lim_side=_ef(k["efc_lim_side"]),
        efc_Jc=_ef(k["efc_Jc"]),
    )
    S = m.pairs.ncon
    if S:
        E = d.qpos.shape[0]
        f5, sr, si, inclm = slot_params(m, P, d.qpos.dtype)
        b3 = lambda x, w: torch.broadcast_to(x, (S, w, E))  # noqa: E731
        packed_t = torch.cat(
            [k["con_dist"][:, None], b3(inclm[:, None, :], 1), k["con_pos"],
             b3(f5, 5), b3(sr, 2), b3(si, 5), k["con_frame"]],
            dim=1,
        )  # (S, 26, E)
        upd.update(contact=Contact(packed=_ef(packed_t)),
                   connormal=_ef(k["con_frame"][:, 0:3]))
    return d.replace(**upd)


def _row_masks(m: Model) -> tuple[tuple[bool, ...], ...]:
    """(one-sided, dof friction, equality) row-class flags of the rows."""
    t = m.efc_type
    os_ = (t == EFC_LIMIT_JOINT) | (t == EFC_LIMIT_TENDON) | (t == EFC_CONTACT)
    return tuple(tuple(bool(b) for b in x)
                 for x in (os_, t == EFC_FRICTION_DOF, t == EFC_EQUALITY))


def dense_jacobian(m: Model, k: dict) -> torch.Tensor:
    """The whole constraint Jacobian Jt (nv, nefc, E), rows
    [equality][dof friction][limits][contacts k-major]: the equality rows,
    the identity, the limit rows' signed one-hot entries and efc_Jc."""
    nv, neq = m.nv, m.neq_jnt
    nlimit = m.nlimit + m.nlimit_ten
    Jc = k["efc_Jc"]
    E = Jc.shape[-1]
    Jt = Jc.new_zeros(nv, m.nefc, E)
    if neq:
        Jt[:, :neq] = k["efc_Jeq"].permute(1, 0, 2)
    diag = device_array(m, "dof_range", lambda: np.arange(nv), torch.long)
    Jt[diag, neq + diag] = 1.0
    if nlimit:
        Pl = device_array(m, "limit_rows_static", lambda: limit_rows_static(m), Jt.dtype)
        Jt[:, neq + nv:neq + nv + nlimit] = (
            k["efc_lim_side"][None] * Pl.T[:, :, None])
    if Jc.shape[0]:
        Jt[:, neq + nv + nlimit:] = Jc.permute(1, 0, 2)
    return Jt


def solve_dense_inputs(m: Model, k: dict, d: Data):
    """(args, kwargs) of newton_solve_dense for the rows in k and the
    env-first Data d (qM, qacc_smooth, qacc_warmstart)."""
    os_mask, fr_mask, eq_mask = _row_masks(m)
    args = (
        dense_jacobian(m, k), k["efc_D"].contiguous(), k["efc_aref"].contiguous(),
        k["efc_fl"].contiguous(), d.qM.permute(1, 2, 0).contiguous(),
        d.qacc_smooth.T.contiguous(), d.qacc_warmstart.T.contiguous(),
    )
    kw = dict(
        nv=m.nv, nefc=m.nefc, os_mask=os_mask, fr_mask=fr_mask,
        eq_mask=eq_mask, iterations=m.opt.iterations,
        ls_iterations=max(m.opt.ls_iterations, 8),
        tolerance=float(m.opt.tolerance),
    )
    return args, kw


def forward_stages(m: Model, d: Data,
                   mark: Callable[[str], None] | None = None):
    """Every stage of the full forward pass before the constraint solve:
    (Data with the position, velocity and actuation fields and
    qfrc_smooth/qacc_smooth, the constraint rows k, Params). ``mark`` as in
    forward_hybrid (position, contact, velocity)."""
    mark = mark or (lambda name: None)
    P = Params(m, d.qpos.shape[0])
    d = kinematics(m, d)
    d = com_pos(m, d)
    d = smooth.crb(m, d, factor=True)
    mark("position")
    k = _contact_full(m, P, d)
    mark("contact")
    d = smooth.transmission(m, d)
    d = smooth.com_vel(m, d)
    d = smooth.rne(m, d)
    d = smooth.passive(m, d)
    d = smooth.fwd_actuation(m, d)
    d = fwd.fwd_acceleration(m, d)
    mark("velocity")
    return d, k, P


def forward_hybrid(m: Model, d: Data, iters: torch.Tensor | None = None,
                   mark: Callable[[str], None] | None = None) -> Data:
    """mj_forward of every env with the full writeback (pyramidal cone).

    ``iters`` receives each env's Newton iteration count; ``mark(name)``
    is called after each phase (position, contact, velocity, solve,
    writeback). The elliptic cone's dense solve (the JAX package's
    solve_lm) is not ported yet."""
    if int(m.opt.cone) != CONE_PYRAMIDAL:
        raise NotImplementedError(
            "forward() under the elliptic cone is not ported yet"
        )
    if per_env_smooth(m):
        raise NotImplementedError(
            f"forward() with per-env model fields {list(per_env_smooth(m))} "
            "is not ported yet (the step and the refresh carry them)"
        )
    mark = mark or (lambda name: None)
    d, k, P = forward_stages(m, d, mark)
    args, kw = solve_dense_inputs(m, k, d)
    x, force = newton_solve_dense(*args, **kw, iters=iters)
    qfrc = torch.einsum("vre,re->ve", args[0], force)
    mark("solve")
    d = _writeback_full(m, d, k, P)
    qacc, efc_force = x.T, force.T
    d = d.replace(qacc=qacc, qacc_warmstart=qacc, qfrc_constraint=qfrc.T,
                  efc_force=efc_force)
    if m.ncon_max and m.pairs.ncon:
        cf, ct = decode_contact_forces(m, d, efc_force)
        d = d.replace(con_force_c=cf, con_torque_c=ct)
    mark("writeback")
    return d


def step_full(m: Model, d: Data) -> Data:
    """mj_step of every env with the full writeback (the JAX package's
    step_hybrid(lean=False)): the full forward pass, then the batched
    integrator, which leave the whole Data surface fresh."""
    return fwd.integrate(m, forward_hybrid(m, d))


# ---------------------------------------------------------------------------
# per-control-step kinematic refresh
# ---------------------------------------------------------------------------


def _quat_mat_planes(q):
    """(n, 4, E) quats -> (n, 9, E) row-major rotation matrices."""
    return torch.stack(quat_to_mat(q.unbind(1)), dim=1)


def _child_frames(R, pos, local_mat, local_pos):
    """World frames of rigidly attached children: parent rotations R
    (n, 9, E) and positions pos (n, 3, E), constant local rotations
    (n, 3, 3) and offsets (n, 3), or per env (n, 3, E) -> positions
    (n, 3, E), rotations (n, 9, E)."""
    n, _, E = R.shape
    Rm = R.reshape(n, 3, 3, E)
    mat = torch.einsum("nike,nkj->nije", Rm, local_mat).reshape(n, 9, E)
    if local_pos.dim() == 3:
        return pos + torch.einsum("nike,nke->nie", Rm, local_pos), mat
    return pos + torch.einsum("nike,nk->nie", Rm, local_pos), mat


def _local_rotations(m: Model, quat: str) -> torch.Tensor:
    """Rotation matrices (n, 3, 3) of a model quaternion field."""
    q = getattr(m, quat)[..., None]
    return _quat_mat_planes(q)[..., 0].reshape(-1, 3, 3)


def _cvel_structure(m: Model):
    """Static accumulation structure of mj_comVel: A (nbody, nv) sums the
    ancestor-dof contributions into body cvel; B (nv, nv) sums the ones
    accumulated BEFORE each dof (the velocity cdof_dot crosses with)."""
    nb, nv = m.nbody, m.nv
    A = np.zeros((nb, nv))
    B = np.zeros((nv, nv))
    body_dofs: list[list[int]] = [[] for _ in range(nb)]
    for b in range(1, nb):
        seen = list(body_dofs[int(m.body_parentid[b])])
        for kk in range(int(m.body_jntnum[b])):
            j = int(m.body_jntadr[b] + kk)
            jt = int(m.jnt_type[j])
            va = int(m.jnt_dofadr[j])
            if jt == JNT_FREE:
                seen = seen + [va, va + 1, va + 2]
                for i in range(3, 6):
                    B[va + i, seen] = 1.0
                seen = seen + [va + 3, va + 4, va + 5]
            elif jt == JNT_BALL:
                for i in range(3):
                    B[va + i, seen] = 1.0
                seen = seen + [va, va + 1, va + 2]
            else:
                B[va, seen] = 1.0
                seen = seen + [va]
        body_dofs[b] = seen
        A[b, seen] = 1.0
    return A, B


def refresh_envlast(m: Model, d: Data) -> Data:
    """Full-surface kinematic refresh of every env: xpos/xquat/xmat/xipos/
    ximat, geom and site frames, subtree_com, cinert, cdof, cvel, cdof_dot.
    xanchor/xaxis are not refreshed (no consumer outside the step)."""
    qT = d.qpos.T.contiguous()
    kin = kin_com(m, qT, *mocap_planes(m, d))
    return d.replace(**_frame_fields(m, d, kin, d.qvel.T))


def _frame_fields(m: Model, d: Data, kin: tuple, vT: torch.Tensor) -> dict:
    """The refreshed Data fields from kin_com's outputs ``kin`` and the
    velocities vT (nv, E)."""
    E = d.qpos.shape[0]
    nb, ng, ns = m.nbody, m.ngeom, m.nsite
    dt, dev = d.qpos.dtype, d.qpos.device
    _, _, subcom, cdof, cinA, cinc, xipos, xpos, xquat = kin

    xmat = _quat_mat_planes(xquat)
    P = Params(m, E)
    rot = cached(m, "refresh_rotations", lambda: {
        n: _local_rotations(m, f"{n}_{'iquat' if n == 'body' else 'quat'}")
        for n in ("body", "geom", "site")
    })
    ximat = torch.einsum(
        "nike,nkj->nije", xmat.reshape(nb, 3, 3, E), rot["body"]
    ).reshape(nb, 9, E)
    gb = device_array(m, "geom_bodyid", lambda: m.geom_bodyid, torch.long)
    # geom offsets per env (n, 3, E) when the model carries them so, read
    # on every call: a domain randomisation write is seen
    geom_pos = P("geom_pos") if "geom_pos" in P.batched else m.geom_pos
    gxpos, gxmat = _child_frames(xmat[gb], xpos[gb], rot["geom"], geom_pos)
    upd = {}
    if ns:
        sb = device_array(m, "site_bodyid", lambda: m.site_bodyid, torch.long)
        sxpos, sxmat = _child_frames(xmat[sb], xpos[sb], rot["site"], m.site_pos)
        upd.update(
            site_xpos=_ef(sxpos), site_xmat=_ef(sxmat).reshape(E, ns, 3, 3)
        )

    A, B = cached(m, ("cvel_structure", dt), lambda: tuple(
        torch.as_tensor(x, dtype=dt, device=dev) for x in _cvel_structure(m)
    ))
    cd_v = cdof * vT[:, None, :]
    cvel = torch.einsum("bj,jce->bce", A, cd_v)
    vb = torch.einsum("ij,jce->ice", B, cd_v)
    cross = lambda a, b: torch.linalg.cross(a, b, dim=1)  # noqa: E731
    cdof_dot = torch.cat(
        [
            cross(vb[:, :3], cdof[:, :3]),
            cross(vb[:, 3:], cdof[:, :3]) + cross(vb[:, :3], cdof[:, 3:]),
        ],
        dim=1,
    )

    # cinert 6x6: [[A, m skew(c)], [-m skew(c), m I]]
    mass = P("body_mass")  # (nb, 1), or per env (nb, E)
    c0, c1, c2 = cinc[:, 0], cinc[:, 1], cinc[:, 2]
    h0, h1, h2 = mass * c0, mass * c1, mass * c2
    z = torch.zeros_like(h0)
    mm = mass + z
    a00, a01, a02, a11, a12, a22 = (cinA[:, i] for i in range(6))
    cin36 = torch.stack(
        [a00, a01, a02, z, -h2, h1,
         a01, a11, a12, h2, z, -h0,
         a02, a12, a22, -h1, h0, z,
         z, h2, -h1, mm, z, z,
         -h2, z, h0, z, mm, z,
         h1, -h0, z, z, z, mm],
        dim=1,
    )  # (nb, 36, E)

    upd.update(
        xpos=_ef(xpos), xquat=_ef(xquat), xmat=_ef(xmat).reshape(E, nb, 3, 3),
        xipos=_ef(xipos), ximat=_ef(ximat).reshape(E, nb, 3, 3),
        geom_xpos=_ef(gxpos), geom_xmat=_ef(gxmat).reshape(E, ng, 3, 3),
        subtree_com=_ef(subcom), cinert=_ef(cin36).reshape(E, nb, 6, 6),
        cdof=_ef(cdof), cvel=_ef(cvel), cdof_dot=_ef(cdof_dot),
    )
    return upd
