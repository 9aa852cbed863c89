"""Acceleration stage and integrators over every env, env-first.

PyTorch counterpart of mjlab_tpu/phys/forward.py's ``fwd_acceleration``,
``integrate``, ``integrator_mh`` and their helpers (mj_forward / mj_step
semantics for Euler and implicitfast) under jax.vmap. No activation
states (Simulation refuses them).
"""

from __future__ import annotations

import torch

from mjlab_tpu_torch.phys import linalg, math, smooth
from mjlab_tpu_torch.phys.data import Data
from mjlab_tpu_torch.phys.model import (
    DSBL_EULERDAMP, INT_EULER, INT_IMPLICITFAST, JNT_BALL, JNT_FREE, Model,
    device_array,
)

# a diverged env (non-finite or |.| > MAXVAL) resets (mj_checkPos/Vel/Acc)
MAXVAL = 1e10


def fwd_acceleration(m: Model, d: Data) -> Data:
    """qfrc_smooth and the unconstrained acceleration qacc_smooth."""
    qfrc_smooth = (
        d.qfrc_passive - d.qfrc_bias + d.qfrc_actuator + d.qfrc_applied
        + smooth.xfrc_accumulate(m, d)
    )
    return d.replace(qfrc_smooth=qfrc_smooth,
                     qacc_smooth=smooth.solve_m(d, qfrc_smooth))


def _actuator_vel_deriv(m: Model, d: Data) -> torch.Tensor:
    """d(actuator force)/d(actuator velocity) per actuator, zero where the
    force is saturated (mjd_smooth_vel)."""
    if m.nu == 0:
        return d.qpos.new_zeros(d.qpos.shape[0], 0)
    gp, bp = m.actuator_gainprm, m.actuator_biasprm
    dfdv = torch.where(
        device_array(m, "bias_affine", lambda: m.actuator_biastype == 1),
        bp[:, 2], 0.0,
    ).expand_as(d.actuator_force)
    inp, _ = smooth.actuation_input(m, d)
    dfdv = dfdv + torch.where(
        device_array(m, "gain_affine", lambda: m.actuator_gaintype == 1),
        gp[:, 2] * inp, 0.0,
    )
    fr = m.actuator_forcerange  # (nu, 2), or (E, nu, 2) per env
    saturated = device_array(
        m, "actuator_forcelimited", lambda: m.actuator_forcelimited.astype(bool)
    ) & ((d.actuator_force <= fr[..., 0]) | (d.actuator_force >= fr[..., 1]))
    return torch.where(saturated, 0.0, dfdv)


def _integrate_pos(m: Model, qpos: torch.Tensor, qvel: torch.Tensor, dt) -> torch.Tensor:
    out = qpos.clone()
    for j in range(m.njnt):
        jtype = int(m.jnt_type[j])
        qadr = int(m.jnt_qposadr[j])
        vadr = int(m.jnt_dofadr[j])
        if jtype == JNT_FREE:
            out[:, qadr:qadr + 3] = qpos[:, qadr:qadr + 3] + dt * qvel[:, vadr:vadr + 3]
            out[:, qadr + 3:qadr + 7] = math.quat_integrate(
                qpos[:, qadr + 3:qadr + 7], qvel[:, vadr + 3:vadr + 6], dt)
        elif jtype == JNT_BALL:
            out[:, qadr:qadr + 4] = math.quat_integrate(
                qpos[:, qadr:qadr + 4], qvel[:, vadr:vadr + 3], dt)
        else:  # hinge / slide
            out[:, qadr] = qpos[:, qadr] + dt * qvel[:, vadr]
    return out


def _euler_mh(m: Model, d: Data) -> torch.Tensor:
    """Implicit-damping Euler system matrix M + h B."""
    return d.qM + m.opt.timestep * torch.diag(m.dof_damping)


def _implicitfast_mh(m: Model, d: Data) -> torch.Tensor:
    """M - h dF/dv with dF/dv = -diag(damping) + moment^T G moment."""
    h = m.opt.timestep
    Mh = d.qM + h * torch.diag(m.dof_damping)
    if m.nu:
        dfdv = _actuator_vel_deriv(m, d)
        mom = d.actuator_moment
        Mh = Mh - h * (mom.transpose(-1, -2) * dfdv[:, None, :]) @ mom
    return Mh


def integrator_mh(m: Model, d: Data) -> torch.Tensor | None:
    """System matrix of the integrator's implicit velocity update, or None
    for plain Euler with damping disabled."""
    if m.opt.integrator == INT_IMPLICITFAST:
        return _implicitfast_mh(m, d)
    if m.opt.integrator == INT_EULER and not m.opt.disableflags & DSBL_EULERDAMP:
        return _euler_mh(m, d)
    return None


def integrate(m: Model, d: Data, qacc_int: torch.Tensor | None = None) -> Data:
    """Post-solve integration and the diverged-state reset. qacc_int is
    the implicit velocity update when the caller already solved it; None
    solves (Mh) qacc_int = M qacc here."""
    h = m.opt.timestep
    if qacc_int is None:
        if m.opt.integrator not in (INT_EULER, INT_IMPLICITFAST):
            raise NotImplementedError(f"integrator {m.opt.integrator}")
        Mh = integrator_mh(m, d)
        if Mh is None:
            qacc_int = d.qacc
        else:
            Li = linalg.tri_inv(linalg.chol_factor(Mh))
            Ma = torch.einsum("eij,ej->ei", d.qM, d.qacc)
            qacc_int = linalg.chol_solve_inv(Li, Ma, Mh)
    qvel = d.qvel + h * qacc_int
    qpos = _integrate_pos(m, d.qpos, qvel, h)

    def bad_rows(x):
        return ~torch.isfinite(x).all(-1) | (x.abs().amax(-1) > MAXVAL)

    bad = bad_rows(qpos) | bad_rows(qvel) | bad_rows(qacc_int)
    if m.na:
        bad = bad | ~torch.isfinite(d.act).all(-1)
    b = bad[:, None]
    n_found = d.con_found.to(torch.int32).sum(-1)
    return d.replace(
        qpos=torch.where(b, m.qpos0, qpos),
        qvel=torch.where(b, 0.0, qvel),
        act=torch.where(b, 0.0, d.act),
        qacc_warmstart=torch.where(b, 0.0, d.qacc_warmstart),
        time=d.time + h,
        ncheck_reset=d.ncheck_reset + bad.to(torch.int32),
        ncon_overflow=d.ncon_overflow
        + torch.clamp(n_found - m.ncon_max, min=0).to(torch.int32),
    )
