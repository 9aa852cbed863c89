"""Data dataclass: the dynamic state of every env, env-first batched.

PyTorch counterpart of mjlab_tpu/phys/data.py. Every field carries a
leading num_envs axis with the JAX Data's per-world shape after it, and the
same field names. Fields that hold a shared fresh value are broadcast views
(``Tensor.expand``) until a step or reset writes them, so an idle
(E, ncon, 26) contact table costs no memory.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from mjlab_tpu_torch.phys.model import Model, device_array


@dataclass
class Contact:
    """Contact slots, packed (E, ncon, 26): [dist, includemargin, pos(3),
    friction(5), solref(2), solimp(5), frame(9 row-major)]."""

    packed: torch.Tensor


@dataclass
class Data:
    # ----- inputs / state -----
    time: torch.Tensor  # (E,)
    ncheck_reset: torch.Tensor  # (E,) int32 diverged-state auto-resets
    qpos: torch.Tensor  # (E, nq)
    qvel: torch.Tensor  # (E, nv)
    ctrl: torch.Tensor  # (E, nu)
    act: torch.Tensor  # (E, na)
    act_dot: torch.Tensor
    qfrc_applied: torch.Tensor  # (E, nv)
    xfrc_applied: torch.Tensor  # (E, nbody, 6) [force(3), torque(3)]
    mocap_pos: torch.Tensor  # (E, nmocap, 3)
    mocap_quat: torch.Tensor  # (E, nmocap, 4)
    qacc_warmstart: torch.Tensor  # (E, nv)

    # ----- position stage -----
    xpos: torch.Tensor  # (E, nbody, 3)
    xquat: torch.Tensor  # (E, nbody, 4)
    xmat: torch.Tensor  # (E, nbody, 3, 3)
    xipos: torch.Tensor
    ximat: torch.Tensor
    xanchor: torch.Tensor  # (E, njnt, 3)
    xaxis: torch.Tensor
    geom_xpos: torch.Tensor  # (E, ngeom, 3)
    geom_xmat: torch.Tensor  # (E, ngeom, 3, 3)
    site_xpos: torch.Tensor
    site_xmat: torch.Tensor
    subtree_com: torch.Tensor  # (E, nbody, 3)
    cinert: torch.Tensor  # (E, nbody, 6, 6)
    cdof: torch.Tensor  # (E, nv, 6)
    qM: torch.Tensor  # (E, nv, nv)
    qLD: torch.Tensor
    qLDinv: torch.Tensor
    contact: Contact

    # ----- velocity stage -----
    cvel: torch.Tensor  # (E, nbody, 6)
    cdof_dot: torch.Tensor  # (E, nv, 6)
    qfrc_bias: torch.Tensor
    qfrc_passive: torch.Tensor

    ten_length: torch.Tensor
    ten_velocity: torch.Tensor

    # ----- actuation -----
    actuator_length: torch.Tensor
    actuator_velocity: torch.Tensor
    actuator_moment: torch.Tensor  # (E, nu, nv)
    actuator_force: torch.Tensor
    qfrc_actuator: torch.Tensor

    # ----- acceleration / constraints -----
    qfrc_smooth: torch.Tensor
    qacc_smooth: torch.Tensor
    efc_Jeq: torch.Tensor  # (E, neq, nv)
    efc_lim_side: torch.Tensor  # (E, nlimit + nlimit_ten)
    efc_Jc: torch.Tensor  # (E, ncon_max * rows_per_con, nv)
    efc_D: torch.Tensor  # (E, nefc)
    efc_aref: torch.Tensor
    efc_pos: torch.Tensor
    efc_margin: torch.Tensor
    efc_frictionloss: torch.Tensor
    efc_active: torch.Tensor  # bool
    efc_force: torch.Tensor
    qfrc_constraint: torch.Tensor
    qacc: torch.Tensor
    condist: torch.Tensor  # (E, ncon)
    con_found: torch.Tensor  # (E, ncon) bool
    connormal: torch.Tensor  # (E, ncon, 3)
    con_sel: torch.Tensor  # (E, ncon_max) int32 compacted slot ids
    con_packed_c: torch.Tensor  # (E, ncon_max, 27)
    con_sel_active: torch.Tensor  # (E, ncon_max) bool
    con_force_c: torch.Tensor  # (E, ncon_max, 3)
    con_torque_c: torch.Tensor
    ncon_overflow: torch.Tensor  # (E,) int32 cumulative top-K overflow

    def replace(self, **kw) -> "Data":
        return dataclasses.replace(self, **kw)


def tensor_fields() -> tuple[str, ...]:
    """Data field names, with the packed contact table as "contact"."""
    return tuple(f.name for f in dataclasses.fields(Data))


def mocap_bodies(m: Model) -> torch.Tensor:
    """Body id of each mocap body, in mocap id order (on the model's
    device)."""
    return device_array(
        m, "mocap_bodies",
        lambda: np.argsort(m.body_mocapid)[m.nbody - m.nmocap:], torch.long,
    )


def _fresh(m: Model) -> dict[str, torch.Tensor]:
    """Per-world fresh values (qpos0, identity frames, far contacts, mocap
    frames at their bodies' model frames as mj_resetData sets them)."""
    dt, dev = m.dtype, m.device
    ncon = m.pairs.ncon

    def z(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=dev)

    def tile(vals, n):
        return torch.tensor(vals, dtype=dt, device=dev).repeat(n, 1)

    eye = torch.eye(3, dtype=dt, device=dev)
    mocap_body = mocap_bodies(m)
    packed = torch.tensor(
        [1e10, 0.0, 0.0, 0.0, 0.0, 1.0, 1.0, 0.005, 1e-4, 1e-4, 0.02, 1.0,
         0.9, 0.95, 0.001, 0.5, 2.0] + np.eye(3).reshape(9).tolist(),
        dtype=dt, device=dev,
    )
    return dict(
        time=z(),
        ncheck_reset=z(dtype=torch.int32),
        qpos=m.qpos0.clone(),
        qvel=z(m.nv),
        ctrl=z(m.nu),
        act=z(m.na),
        act_dot=z(m.na),
        qfrc_applied=z(m.nv),
        xfrc_applied=z(m.nbody, 6),
        mocap_pos=m.body_pos[mocap_body].clone(),
        mocap_quat=m.body_quat[mocap_body].clone(),
        qacc_warmstart=z(m.nv),
        xpos=z(m.nbody, 3),
        xquat=tile([1.0, 0, 0, 0], m.nbody),
        xmat=eye.expand(m.nbody, 3, 3),
        xipos=z(m.nbody, 3),
        ximat=eye.expand(m.nbody, 3, 3),
        xanchor=z(m.njnt, 3),
        xaxis=z(m.njnt, 3),
        geom_xpos=z(m.ngeom, 3),
        geom_xmat=eye.expand(m.ngeom, 3, 3),
        site_xpos=z(m.nsite, 3),
        site_xmat=eye.expand(m.nsite, 3, 3),
        subtree_com=z(m.nbody, 3),
        cinert=z(m.nbody, 6, 6),
        cdof=z(m.nv, 6),
        qM=z(m.nv, m.nv),
        qLD=z(m.nv, m.nv),
        qLDinv=z(m.nv, m.nv),
        contact=packed.expand(ncon, 26),
        cvel=z(m.nbody, 6),
        cdof_dot=z(m.nv, 6),
        qfrc_bias=z(m.nv),
        qfrc_passive=z(m.nv),
        ten_length=z(m.ntendon),
        ten_velocity=z(m.ntendon),
        actuator_length=z(m.nu),
        actuator_velocity=z(m.nu),
        actuator_moment=z(m.nu, m.nv),
        actuator_force=z(m.nu),
        qfrc_actuator=z(m.nv),
        qfrc_smooth=z(m.nv),
        qacc_smooth=z(m.nv),
        efc_Jeq=z(m.neq_jnt, m.nv),
        efc_lim_side=z(m.nlimit + m.nlimit_ten),
        efc_Jc=z(m.ncon_max * m.rows_per_con, m.nv),
        efc_D=z(m.nefc),
        efc_aref=z(m.nefc),
        efc_pos=z(m.nefc),
        efc_margin=z(m.nefc),
        efc_frictionloss=z(m.nefc),
        efc_active=z(m.nefc, dtype=torch.bool),
        efc_force=z(m.nefc),
        qfrc_constraint=z(m.nv),
        qacc=z(m.nv),
        condist=torch.full((ncon,), 1e10, dtype=dt, device=dev),
        con_found=z(ncon, dtype=torch.bool),
        connormal=tile([0.0, 0, 1.0], ncon),
        con_sel=z(m.ncon_max, dtype=torch.int32),
        con_packed_c=z(m.ncon_max, 27),
        con_sel_active=z(m.ncon_max, dtype=torch.bool),
        con_force_c=z(m.ncon_max, 3),
        con_torque_c=z(m.ncon_max, 3),
        ncon_overflow=z(dtype=torch.int32),
    )


def make_data(m: Model, num_envs: int) -> Data:
    """Fresh Data for num_envs envs at qpos0 (each env's own when the
    model carries qpos0 per env), in the model's dtype and on its device
    (positions not yet propagated)."""
    fresh = _fresh(m)
    kw = {
        k: v if k == "qpos" and m.qpos0.dim() == 2 else
        v.expand((num_envs,) + tuple(v.shape)) for k, v in fresh.items()
    }
    kw["contact"] = Contact(packed=kw["contact"])
    return Data(**kw)


def reset_data(m: Model, d: Data, mask: torch.Tensor) -> Data:
    """Reset the envs where mask (E,) is true to make_data's fresh state."""
    fresh = _fresh(m)
    kw = {}
    for name in tensor_fields():
        old = d.contact.packed if name == "contact" else getattr(d, name)
        new = fresh[name]
        sel = mask.reshape((-1,) + (1,) * (old.ndim - 1))
        kw[name] = torch.where(sel, new, old)
    kw["contact"] = Contact(packed=kw["contact"])
    return Data(**kw)


def data_from_numpy(
    fields: dict[str, Any], device: str | torch.device = "cuda"
) -> Data:
    """Data from numpy arrays, one per field (env-first, batched); the
    contact table is given as "contact" (E, ncon, 26). Floating arrays keep
    their dtype, as do bool and integer ones."""
    kw = {}
    for name in tensor_fields():
        kw[name] = torch.as_tensor(np.asarray(fields[name]), device=device)
    kw["contact"] = Contact(packed=kw["contact"])
    return Data(**kw)
