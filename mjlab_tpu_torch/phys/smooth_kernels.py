"""The smooth-stage kernels, env-last: kinematics + com quantities, the CRB
mass matrix, and the velocity stages.

PyTorch counterpart of mjlab_tpu/phys/smooth_pallas.py. Each of the three
kernels has a CUDA implementation, table-driven, many threads per env on
the tree schedule of tree_schedule and csrc/smooth_tree.cuh
(csrc/kin_com.cu, csrc/crb_packed.cu, csrc/vel_smooth.cu), and a plain
PyTorch version built on phys/lm/stages.py, with the same inputs and
outputs. The wrapper runs the plain version for tensors on the CPU and
launches the kernel for CUDA tensors; ``<wrapper>.launches`` counts kernel
launches.

    kin_com     qpos -> collision-geom frames, subtree com, cdof, cinert
    crb_dense   cdof + cinert -> dense mass matrix qM and qM + the
                implicit diagonal (the TPU kernel crb_packed, fused with
                qm_dense_cm and the diagonal add)
    vel_smooth  qvel + ctrl -> qfrc_smooth, actuator force, Mh diagonal

crb_packed_plain keeps the TPU kernel's own contract (packed ancestor
pairs); collision_geoms, _crb_pairs, qm_dense_cm and integrate_envlast are
plain PyTorch here, as the JAX package computes them in XLA.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mjlab_tpu_torch import cuda_build
from mjlab_tpu_torch.phys.lm import stages
from mjlab_tpu_torch.phys.lm.base import Params, quat_integrate
from mjlab_tpu_torch.phys.model import (
    DSBL_EULERDAMP, DSBL_GRAVITY, INT_EULER, INT_IMPLICITFAST, JNT_BALL,
    JNT_FREE, SMOOTH_HOST_FIELDS, SMOOTH_VECTOR_FIELDS, Model, cached,
    device_array, per_env_smooth,
)

SYM6 = ((0, 0), (0, 1), (0, 2), (1, 1), (1, 2), (2, 2))
_JOINT_DOFS = {JNT_FREE: 6, JNT_BALL: 3}  # 1 for hinge and slide
_MAX_BODY = 128  # MJT_MAX_BODY in csrc/smooth_common.cuh
SMOOTH_ENVS = 16  # envs per block of the tree kernels (csrc/smooth_tree.cuh)


def collision_geoms(m: Model) -> tuple[int, ...]:
    """Static ids of geoms that take part in narrowphase pairs (computed
    once per Model)."""

    def make():
        pt = m.pairs
        if not pt.ncon:
            return ()
        return tuple(sorted({int(g) for g in pt.geom1} | {int(g) for g in pt.geom2}))

    return cached(m, "collision_geoms", make)


def _crb_pairs(m: Model) -> list[tuple[int, int]]:
    """Static ancestor-pair list [(i, j), ...] with i <= j (the nonzero
    upper-triangle structure of qM)."""
    _, _, U = stages.crb_static(m)
    return [
        (i, j) for i in range(m.nv) for j in range(i, m.nv)
        if U[i, j] or i == j
    ]


def implicit_flags(m: Model) -> tuple[bool, bool]:
    """(implicit, implicitfast): whether the integrator adds an implicit
    damping diagonal, and whether it adds actuator dF/dv terms too."""
    integ = int(m.opt.integrator)
    eulerdamp = not (int(m.opt.disableflags) & DSBL_EULERDAMP)
    implicitfast = integ == INT_IMPLICITFAST
    return implicitfast or (integ == INT_EULER and eulerdamp), implicitfast


def _csr(lists) -> tuple[np.ndarray, np.ndarray]:
    """Lists of ints -> (start offsets (n + 1,), the lists concatenated)."""
    adr = np.cumsum([0] + [len(x) for x in lists]).astype(np.int32)
    return adr, np.asarray([v for x in lists for v in x], np.int32)


def body_tree(parent) -> dict[str, np.ndarray]:
    """The body-tree part of tree_schedule from body_parentid (parent[b] <
    b, MuJoCo's body order): body_level, level_adr/level_body,
    child_adr/child_body."""
    parent = [int(p) for p in parent]
    nb = len(parent)
    level = [0] * nb
    for b in range(1, nb):
        level[b] = level[parent[b]] + 1
    level_adr, level_body = _csr(
        [[b for b in range(nb) if level[b] == L] for L in range(max(level) + 1)]
    )
    child_adr, child_body = _csr(
        [[c for c in range(nb - 1, 0, -1) if parent[c] == b] for b in range(nb)]
    )
    return dict(body_level=np.asarray(level, np.int32), level_adr=level_adr,
                level_body=level_body, child_adr=child_adr, child_body=child_body)


def tree_schedule(m: Model) -> dict[str, np.ndarray]:
    """The tree schedule of the many-threads-per-env kernels
    (csrc/smooth_tree.cuh), int32 tables:

    body_level (nbody,): depth in the tree, the world body at 0;
    level_adr (nlevel + 1,), level_body (nbody,): bodies grouped by level,
      ascending within a level;
    child_adr (nbody + 1,), child_body: each body's children, descending;
    dof_jnt (nv,): the joint that owns each dof;
    dof_act_adr (nv + 1,), dof_act: each dof's actuators (the first dof of
      an actuator's joint owns it), ascending;
    dof_sub_adr (nv + 1,), dof_sub_body: the bodies b >= 1 whose chain from
      the world holds the dof (stages.ancestor_dof_mask), ascending;
    cg_body (ncg,): the body that owns each collision geom.
    """
    dof_jnt = np.zeros(m.nv, np.int32)
    for j in range(m.njnt):
        adr = int(m.jnt_dofadr[j])
        dof_jnt[adr:adr + _JOINT_DOFS.get(int(m.jnt_type[j]), 1)] = j
    act_dof = [int(m.jnt_dofadr[int(m.actuator_trnid[u, 0])]) for u in range(m.nu)]
    anc = stages.ancestor_dof_mask(m)
    dof_act_adr, dof_act = _csr([[u for u in range(m.nu) if act_dof[u] == i]
                                 for i in range(m.nv)])
    dof_sub_adr, dof_sub_body = _csr([[b for b in range(1, m.nbody) if anc[b, i]]
                                      for i in range(m.nv)])
    geom_bodyid = np.asarray(m.geom_bodyid)
    return dict(
        body_tree(m.body_parentid), dof_jnt=dof_jnt, dof_act_adr=dof_act_adr,
        dof_act=dof_act, dof_sub_adr=dof_sub_adr, dof_sub_body=dof_sub_body,
        cg_body=np.asarray([int(geom_bodyid[g]) for g in collision_geoms(m)], np.int32),
    )


def _stack(planes, E, like):
    return torch.stack([
        torch.broadcast_to(torch.as_tensor(x, dtype=like.dtype,
                                           device=like.device), (E,))
        for x in planes
    ])


# ---------------------------------------------------------------------------
# device tables (the CUDA kernels' view of the model)
# ---------------------------------------------------------------------------


_INT_TABLES = (
    "body_parentid", "body_rootid", "body_jntadr", "body_jntnum",
    "body_dofadr", "body_dofnum", "jnt_type", "jnt_qposadr", "jnt_dofadr",
    "jnt_bodyid", "cg_geom", "geom_bodyid", "dof_body", "pair_i", "pair_j",
    "anc_mask", "act_jnt", "act_gaintype", "act_biastype",
    "act_ctrllimited", "act_forcelimited", "body_mocapid",
)
_FLOAT_TABLES = (
    "qpos0", "body_pos", "body_quat", "jnt_pos", "jnt_axis", "body_ipos",
    "body_iquat", "body_mass", "body_inertia", "geom_pos", "geom_quat",
    "dof_armature", "dof_damping", "jnt_stiffness", "qpos_spring",
    "act_gear", "act_ctrlrange", "act_gainprm", "act_biasprm",
    "act_forcerange",
)


class _EnvField(ctypes.Structure):
    """Mirror of struct EnvField (csrc/smooth_common.cuh)."""

    _fields_ = [("p", ctypes.c_void_p), ("stride", ctypes.c_int), ("width", ctypes.c_int)]


# EnvFields' members (csrc/smooth_common.cuh) and the Model fields they read
_ENV_FIELDS = (
    ("qpos0", "qpos0"), ("body_ipos", "body_ipos"), ("body_mass", "body_mass"),
    ("body_inertia", "body_inertia"), ("geom_pos", "geom_pos"),
    ("dof_armature", "dof_armature"), ("dof_damping", "dof_damping"),
    ("jnt_stiffness", "jnt_stiffness"), ("act_gainprm", "actuator_gainprm"),
    ("act_biasprm", "actuator_biasprm"), ("act_forcerange", "actuator_forcerange"),
)


class _EnvFields(ctypes.Structure):
    """Mirror of struct EnvFields (csrc/smooth_common.cuh)."""

    _fields_ = [(n, _EnvField) for n, _ in _ENV_FIELDS]


class _SmoothTables(ctypes.Structure):
    """Mirror of struct SmoothTables (csrc/smooth_common.cuh)."""

    _fields_ = (
        [(n, ctypes.c_int) for n in (
            "nq", "nv", "nu", "nbody", "njnt", "ncg", "npair",
            "gravity_on", "implicit", "implicitfast",
        )]
        + [("timestep", ctypes.c_float), ("gravity", ctypes.c_float * 3)]
        + [(n, ctypes.c_void_p) for n in _INT_TABLES + _FLOAT_TABLES]
        + [("env", _EnvFields)]
    )


_TREE_TABLES = (
    "level_adr", "level_body", "child_adr", "child_body", "dof_jnt",
    "dof_act_adr", "dof_act", "dof_sub_adr", "dof_sub_body", "cg_body",
)


class _SmoothTree(ctypes.Structure):
    """Mirror of struct SmoothTree (csrc/smooth_tree.cuh)."""

    _fields_ = [("nlevel", ctypes.c_int)] + [(n, ctypes.c_void_p) for n in _TREE_TABLES]


class DeviceTables:
    """The model's tree and constants on the card, uploaded once per
    Model: two flat tensors with pointers in a SmoothTables struct, and the
    tree schedule's tensor with pointers in a SmoothTree struct.

    A field the model carries per env (model.per_env_smooth) is not a
    constant: its table holds NaN (a read of it shows), and the kernels
    read the Model's (E, ...) tensor through env_fields, at every launch.
    Any other smooth field must have its shared shape: packed flat, an
    (E, ...) one would give every env env 0's rows."""

    def __init__(self, m: Model):
        if m.nbody > _MAX_BODY:
            raise NotImplementedError(f"nbody {m.nbody} > {_MAX_BODY}")
        planned = per_env_smooth(m)
        for name in SMOOTH_HOST_FIELDS:
            ndim = 1 if name in SMOOTH_VECTOR_FIELDS else 2
            if name not in planned and getattr(m, name).dim() != ndim:
                raise NotImplementedError(
                    f"the smooth kernels take {name} shared or as a per-env "
                    f"field of phys/model.py PER_ENV_SMOOTH_FIELDS, got shape "
                    f"{tuple(getattr(m, name).shape)}"
                )

        def hn(name):
            v = getattr(m, name).detach().cpu().numpy()
            return np.full(v.shape[1:], np.nan, v.dtype) if name in planned else v
        pairs = _crb_pairs(m)
        _, dof_body, _ = stages.crb_static(m)
        ints = dict(
            body_parentid=m.body_parentid, body_rootid=m.body_rootid,
            body_jntadr=m.body_jntadr, body_jntnum=m.body_jntnum,
            body_dofadr=m.body_dofadr, body_dofnum=m.body_dofnum,
            jnt_type=m.jnt_type, jnt_qposadr=m.jnt_qposadr,
            jnt_dofadr=m.jnt_dofadr, jnt_bodyid=m.jnt_bodyid,
            cg_geom=np.asarray(collision_geoms(m), np.int32),
            geom_bodyid=m.geom_bodyid, dof_body=dof_body,
            pair_i=np.asarray([p[0] for p in pairs], np.int32),
            pair_j=np.asarray([p[1] for p in pairs], np.int32),
            anc_mask=stages.ancestor_dof_mask(m).astype(np.int32),
            act_jnt=m.actuator_trnid[:, 0] if m.nu else np.zeros(0),
            act_gaintype=m.actuator_gaintype,
            act_biastype=m.actuator_biastype,
            act_ctrllimited=m.actuator_ctrllimited,
            act_forcelimited=m.actuator_forcelimited,
            body_mocapid=m.body_mocapid,
        )
        floats = dict(
            qpos0=hn("qpos0"), body_pos=hn("body_pos"),
            body_quat=hn("body_quat"), jnt_pos=hn("jnt_pos"),
            jnt_axis=hn("jnt_axis"), body_ipos=hn("body_ipos"),
            body_iquat=hn("body_iquat"), body_mass=hn("body_mass"),
            body_inertia=hn("body_inertia"), geom_pos=hn("geom_pos"),
            geom_quat=hn("geom_quat"), dof_armature=hn("dof_armature"),
            dof_damping=hn("dof_damping"),
            jnt_stiffness=hn("jnt_stiffness"),
            qpos_spring=hn("qpos_spring"),
            act_gear=hn("actuator_gear")[:, 0],
            act_ctrlrange=hn("actuator_ctrlrange"),
            act_gainprm=hn("actuator_gainprm")[:, :3],
            act_biasprm=hn("actuator_biasprm")[:, :3],
            act_forcerange=hn("actuator_forcerange"),
        )
        ibuf, ioff = self._pack(ints, _INT_TABLES, np.int32)
        fbuf, foff = self._pack(floats, _FLOAT_TABLES, np.float32)
        self.ints = torch.as_tensor(ibuf, device=m.device)
        self.floats = torch.as_tensor(fbuf, device=m.device)
        implicit, implicitfast = implicit_flags(m)
        s = _SmoothTables()
        s.nq, s.nv, s.nu, s.nbody, s.njnt = m.nq, m.nv, m.nu, m.nbody, m.njnt
        s.ncg, s.npair = len(collision_geoms(m)), len(pairs)
        s.gravity_on = int(not (m.opt.disableflags & DSBL_GRAVITY))
        s.implicit, s.implicitfast = int(implicit), int(implicitfast)
        s.timestep = float(m.opt.timestep)
        for i, g in enumerate(m.opt.gravity.tolist()):
            s.gravity[i] = g
        for name in _INT_TABLES:
            setattr(s, name, self.ints.data_ptr() + 4 * ioff[name])
        for name in _FLOAT_TABLES:
            setattr(s, name, self.floats.data_ptr() + 4 * foff[name])
        self.struct = s
        self.npair = len(pairs)
        sched = tree_schedule(m)
        tbuf, toff = self._pack(sched, _TREE_TABLES, np.int32)
        self.tree_ints = torch.as_tensor(tbuf, device=m.device)
        tr = _SmoothTree()
        tr.nlevel = len(sched["level_adr"]) - 1
        for name in _TREE_TABLES:
            setattr(tr, name, self.tree_ints.data_ptr() + 4 * toff[name])
        self.tree = tr

    @staticmethod
    def _pack(arrays, names, dtype):
        offsets, parts, at = {}, [], 0
        for n in names:
            a = np.ascontiguousarray(np.asarray(arrays[n]).reshape(-1), dtype)
            offsets[n] = at
            parts.append(a)
            at += max(a.size, 1)
            if a.size == 0:
                parts.append(np.zeros(1, dtype))
        return np.concatenate(parts), offsets


_P, _I = ctypes.c_void_p, ctypes.c_int
_TABLES = ctypes.POINTER(_SmoothTables)
_TREE = ctypes.POINTER(_SmoothTree)
_ENV = ctypes.POINTER(_EnvFields)


def env_fields(m: Model, E: int) -> _EnvFields:
    """The per-env fields of m for one launch over E envs (EnvFields,
    csrc/smooth_common.cuh): for each field of model.per_env_smooth(m) a
    pointer to the Model's own (E, ...) tensor, which a domain
    randomisation event writes in place, so the launch reads the values
    of that moment (and a CUDA graph, the tensor a write between replays
    changed); null for a shared field. Built at every launch: no pointer
    outlives the tensor it points at."""
    out = _EnvFields()
    planned = per_env_smooth(m)
    for member, name in _ENV_FIELDS:
        if name not in planned:
            continue
        v = getattr(m, name)
        _check_cuda(name, v, (E,) + tuple(v.shape[1:]))
        width = v.shape[2] if v.dim() == 3 else 1
        setattr(out, member, _EnvField(v.data_ptr(), v[0].numel(), width))
    return out


def device_tables(m: Model) -> DeviceTables:
    """The model's DeviceTables, built once per Model object."""
    return cached(m, "device_tables", lambda: DeviceTables(m))


def _check_cuda(name, x, shape):
    if x.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {x.device}")
    if x.dtype != torch.float32:
        raise ValueError(f"{name}: the CUDA kernel takes float32, got {x.dtype}")
    if tuple(x.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {shape}, got {tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def _empty(shape, like):
    return torch.empty(shape, dtype=torch.float32, device=like.device)


# ---------------------------------------------------------------------------
# kernel 1: kinematics + com quantities
# ---------------------------------------------------------------------------


def _mocap_planes(m: Model, qT, mcT, mcqT):
    """The mocap inputs of kin_com, checked: (nmocap, 3, E), (nmocap, 4, E)."""
    E = qT.shape[-1]
    if m.nmocap and (mcT is None or mcqT is None):
        raise ValueError(f"the model has {m.nmocap} mocap bodies: pass their frames")
    if not m.nmocap:
        return qT.new_zeros(0, 3, E), qT.new_zeros(0, 4, E)
    return mcT, mcqT


def kin_com_plain(m: Model, qT: torch.Tensor, mcT=None, mcqT=None):
    """Plain PyTorch kin_com (phys/lm/stages.py), same outputs."""
    E = qT.shape[-1]
    P = Params(m, E)
    cg = collision_geoms(m)
    q = tuple(qT[i] for i in range(m.nq))
    mcT, mcqT = _mocap_planes(m, qT, mcT, mcqT)
    k = stages.kinematics_lm(
        m, P, q,
        [tuple(mcT[i, c] for c in range(3)) for i in range(m.nmocap)],
        [tuple(mcqT[i, c] for c in range(4)) for i in range(m.nmocap)],
        geoms=cg, sites=(),
    )
    k = stages.com_pos_lm(m, P, k)
    nb, nv = m.nbody, m.nv
    if cg:
        gxpos = torch.stack([_stack(k["geom_xpos"][g], E, qT) for g in cg])
        gxmat = torch.stack([_stack(k["geom_xmat"][g], E, qT) for g in cg])
    else:
        gxpos = qT.new_zeros(1, 3, E)
        gxmat = qT.new_zeros(1, 9, E)
    per_body = lambda key: torch.stack(  # noqa: E731
        [_stack(k[key][b], E, qT) for b in range(nb)]
    )
    cinA = torch.stack([
        _stack([k["cinert"][b]["A"][ij] for ij in SYM6], E, qT)
        for b in range(nb)
    ])
    cinc = torch.stack([_stack(k["cinert"][b]["c"], E, qT) for b in range(nb)])
    cdof = torch.stack([_stack(k["cdof"][i], E, qT) for i in range(nv)])
    return (gxpos, gxmat, per_body("subtree_com"), cdof, cinA, cinc,
            per_body("xipos"), per_body("xpos"), per_body("xquat"))


def kin_com(m: Model, qT: torch.Tensor, mcT=None, mcqT=None):
    """qT (nq, E) and the mocap frames mcT (nmocap, 3, E), mcqT (nmocap, 4,
    E) (required when the model has mocap bodies) -> env-last gxpos (Gc,
    3, E), gxmat (Gc, 9, E) for the collision_geoms(m) subset (one zero row
    when there are none), subcom (nbody, 3, E), cdof (nv, 6, E), cinA
    (nbody, 6, E) in SYM6 order, cinc (nbody, 3, E), xipos, xpos (nbody,
    3, E), xquat (nbody, 4, E)."""
    if qT.device.type == "cpu":
        return kin_com_plain(m, qT, mcT, mcqT)
    E = qT.shape[-1]
    _check_cuda("qT", qT, (m.nq, E))
    mcT, mcqT = _mocap_planes(m, qT, mcT, mcqT)
    _check_cuda("mcT", mcT, (m.nmocap, 3, E))
    _check_cuda("mcqT", mcqT, (m.nmocap, 4, E))
    t = device_tables(m)
    nb, nv = m.nbody, m.nv
    G = max(len(collision_geoms(m)), 1)
    outs = [
        _empty((G, 3, E), qT), _empty((G, 9, E), qT),
        _empty((nb, 3, E), qT), _empty((nv, 6, E), qT),
        _empty((nb, 6, E), qT), _empty((nb, 3, E), qT),
        _empty((nb, 3, E), qT), _empty((nb, 3, E), qT),
        _empty((nb, 4, E), qT),
    ]
    if G > len(collision_geoms(m)):
        outs[0].zero_()
        outs[1].zero_()
    env = env_fields(m, E)
    launch = cuda_build.launcher(
        "kin_com", "kin_com_launch", (_TABLES, _TREE, _ENV) + (_P,) * 12 + (_I, _P)
    )
    rc = launch(
        ctypes.byref(t.struct), ctypes.byref(t.tree), ctypes.byref(env), cuda_build.ptr(qT),
        cuda_build.ptr(mcT), cuda_build.ptr(mcqT),
        *[cuda_build.ptr(o) for o in outs],
        ctypes.c_int(E), cuda_build.stream(),
    )
    cuda_build.check(cuda_build.library("kin_com"), rc, "kin_com")
    kin_com.launches += 1
    return tuple(outs)


kin_com.launches = 0


# ---------------------------------------------------------------------------
# kernel 2: CRB mass matrix (dense, with the implicit diagonal)
# ---------------------------------------------------------------------------


def _cinert_blocks(m: Model, P: Params, cinA, cinc):
    return [
        dict(
            A={ij: cinA[b, s] for s, ij in enumerate(SYM6)},
            c=tuple(cinc[b, c] for c in range(3)),
            m=P.plane("body_mass", b),
        )
        for b in range(m.nbody)
    ]


def crb_packed_plain(m: Model, cdof, cinA, cinc):
    """The TPU kernel crb_packed's contract in plain PyTorch
    (stages.crb_lm): -> qM_pairs (npairs, E), the ancestor-pair values of
    the CRB mass matrix in _crb_pairs(m) order, armature on the
    diagonal."""
    E = cdof.shape[-1]
    P = Params(m, E)
    k = {
        "cdof": [tuple(cdof[i, c] for c in range(6)) for i in range(m.nv)],
        "cinert": _cinert_blocks(m, P, cinA, cinc),
    }
    k = stages.crb_lm(m, P, k)
    return _stack([k["qM"][ij] for ij in _crb_pairs(m)], E, cdof)


def qm_dense_cm(m: Model, qM_pairs: torch.Tensor) -> torch.Tensor:
    """(npairs, E) packed pairs -> (nv*nv, E) dense symmetric (column-major
    == row-major), the layout newton_assemble_solve takes."""
    nv = m.nv
    E = qM_pairs.shape[-1]

    def scatter():
        rows, vals_idx = [], []
        for p, (i, j) in enumerate(_crb_pairs(m)):
            rows.append(i * nv + j)
            vals_idx.append(p)
            if i != j:
                rows.append(j * nv + i)
                vals_idx.append(p)
        return np.array([rows, vals_idx])

    rows, vals_idx = device_array(m, "qm_dense_scatter", scatter, torch.long)
    dense = qM_pairs.new_zeros(nv * nv, E)
    dense[rows] = qM_pairs[vals_idx]
    return dense


def _diag_rows(m: Model) -> torch.Tensor:
    """Rows of the diagonal in an (nv*nv, E) dense matrix."""
    return device_array(m, "diag_rows", lambda: np.arange(m.nv) * (m.nv + 1), torch.long)


def crb_dense_plain(m: Model, cdof, cinA, cinc, mh_diag=None):
    """Plain PyTorch crb_dense: the eager code the kernel fuses,
    qm_dense_cm of crb_packed_plain and the implicit diagonal added to a
    copy (mjlab_tpu/phys/hybrid.py:536-545)."""
    qM_cm = qm_dense_cm(m, crb_packed_plain(m, cdof, cinA, cinc))
    if mh_diag is None:
        return qM_cm, None
    Mh_cm = qM_cm.clone()
    Mh_cm[_diag_rows(m)] += mh_diag
    return qM_cm, Mh_cm


def crb_smem_bytes(m: Model) -> int:
    """Shared memory of one block of crb_dense's kernel (SMOOTH_ENVS envs):
    10 floats per body, 12 per dof per env (csrc/crb_packed.cu
    crb_smem_floats)."""
    return 4 * (10 * m.nbody + 12 * m.nv) * SMOOTH_ENVS


def crb_dense(m: Model, cdof, cinA, cinc, mh_diag=None):
    """cdof (nv, 6, E), cinA (nbody, 6, E), cinc (nbody, 3, E) and, for an
    implicit integrator, mh_diag (nv, E) -> (qM_cm (nv*nv, E), Mh_cm
    (nv*nv, E) or None): the CRB mass matrix, dense and column-major
    (symmetric, so row-major too), armature on the diagonal, and qM_cm plus
    mh_diag on the diagonal when mh_diag is given. On the card one launch
    of csrc/crb_packed.cu writes both."""
    if cdof.device.type == "cpu":
        return crb_dense_plain(m, cdof, cinA, cinc, mh_diag)
    E = cdof.shape[-1]
    nb, nv = m.nbody, m.nv
    _check_cuda("cdof", cdof, (nv, 6, E))
    _check_cuda("cinA", cinA, (nb, 6, E))
    _check_cuda("cinc", cinc, (nb, 3, E))
    if mh_diag is not None:
        _check_cuda("mh_diag", mh_diag, (nv, E))
    t = device_tables(m)
    qM_cm = _empty((nv * nv, E), cdof)
    Mh_cm = None if mh_diag is None else _empty((nv * nv, E), cdof)
    env = env_fields(m, E)
    launch = cuda_build.launcher(
        "crb_packed", "crb_packed_launch", (_TABLES, _TREE, _ENV) + (_P,) * 6 + (_I, _P)
    )
    opt = lambda x: None if x is None else cuda_build.ptr(x)  # noqa: E731
    rc = launch(
        ctypes.byref(t.struct), ctypes.byref(t.tree), ctypes.byref(env), cuda_build.ptr(cdof),
        cuda_build.ptr(cinA), cuda_build.ptr(cinc), opt(mh_diag),
        cuda_build.ptr(qM_cm), opt(Mh_cm), ctypes.c_int(E), cuda_build.stream(),
    )
    cuda_build.check(cuda_build.library("crb_packed"), rc, "crb_dense")
    crb_dense.launches += 1
    return qM_cm, Mh_cm


crb_dense.launches = 0


# ---------------------------------------------------------------------------
# kernel 3: velocity stages -> qfrc_smooth, actuator force, Mh diagonal
# ---------------------------------------------------------------------------


def vel_smooth_plain(m: Model, qT, vT, ctrlT, cdof, cinA, cinc, xq):
    """Plain PyTorch vel_smooth (stages.com_vel_lm ... xfrc_lm)."""
    subcom, xipos, xfrcT, qfaT = xq
    E = vT.shape[-1]
    nb, nv, nu = m.nbody, m.nv, m.nu
    P = Params(m, E)
    grav3 = tuple(float(g) for g in m.opt.gravity.tolist())
    h = float(m.opt.timestep)
    implicit, implicitfast = implicit_flags(m)

    q = tuple(qT[i] for i in range(m.nq))
    qvel = tuple(vT[i] for i in range(nv))
    ctrl = tuple(ctrlT[u] for u in range(nu))
    zero = torch.zeros_like(qvel[0])
    k = {
        "cdof": [tuple(cdof[i, c] for c in range(6)) for i in range(nv)],
        "cinert": _cinert_blocks(m, P, cinA, cinc),
        "subtree_com": [tuple(subcom[b, c] for c in range(3)) for b in range(nb)],
        "xipos": [tuple(xipos[b, c] for c in range(3)) for b in range(nb)],
    }
    k = stages.com_vel_lm(m, P, k, qvel)
    k = stages.rne_lm(m, P, k, qvel, grav3)
    k = stages.passive_lm(m, P, k, q, qvel)
    k = stages.actuation_lm(m, P, k, q, qvel, ctrl)
    xfrc = [tuple(xfrcT[b, c] for c in range(6)) for b in range(nb)]
    qfx = stages.xfrc_lm(m, P, k, xfrc)
    qfs = [
        k["qfrc_passive"][i] - k["qfrc_bias"][i] + k["qfrc_actuator"][i]
        + qfaT[i] + qfx[i]
        for i in range(nv)
    ]
    if not implicit:
        diag = [zero] * nv
    else:
        diag = [zero + h * P.plane("dof_damping", i) for i in range(nv)]
        if implicitfast and nu:
            dfdv = stages.actuator_vel_deriv_lm(
                m, P, ctrl, k["actuator_force"]
            )
            for u in range(nu):
                if dfdv[u] is None:
                    continue
                vadr = int(m.jnt_dofadr[int(m.actuator_trnid[u, 0])])
                gear = P.plane("actuator_gear", u, 0)
                diag[vadr] = diag[vadr] - h * dfdv[u] * gear * gear
    afrc = _stack(k["actuator_force"], E, vT) if nu else vT.new_zeros(0, E)
    avel = _stack(k["actuator_velocity"], E, vT) if nu else vT.new_zeros(0, E)
    return _stack(qfs, E, vT), afrc, avel, _stack(diag, E, vT)


def vel_smooth(m: Model, qT, vT, ctrlT, cdof, cinA, cinc, xq):
    """xq = (subcom (nb,3,E), xipos (nb,3,E), xfrcT (nb,6,E), qfaT (nv,E)).

    Returns (qfrc_smooth (nv, E), actuator_force (nu, E),
    actuator_velocity (nu, E), mh_diag (nv, E)); mh_diag holds the
    integrator's implicit diagonal additions (h*damping, minus
    h*dfdv*gear^2 under implicitfast), zero for an explicit update."""
    if vT.device.type == "cpu":
        return vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    subcom, xipos, xfrcT, qfaT = xq
    E = vT.shape[-1]
    nb, nv, nu = m.nbody, m.nv, m.nu
    for name, x, shape in (
        ("qT", qT, (m.nq, E)), ("vT", vT, (nv, E)), ("ctrlT", ctrlT, (nu, E)),
        ("cdof", cdof, (nv, 6, E)), ("cinA", cinA, (nb, 6, E)),
        ("cinc", cinc, (nb, 3, E)), ("subcom", subcom, (nb, 3, E)),
        ("xipos", xipos, (nb, 3, E)), ("xfrcT", xfrcT, (nb, 6, E)),
        ("qfaT", qfaT, (nv, E)),
    ):
        _check_cuda(name, x, shape)
    t = device_tables(m)
    qfs = _empty((nv, E), vT)
    afrc = _empty((nu, E), vT)
    avel = _empty((nu, E), vT)
    diag = _empty((nv, E), vT)
    env = env_fields(m, E)
    launch = cuda_build.launcher(
        "vel_smooth", "vel_smooth_launch", (_TABLES, _TREE, _ENV) + (_P,) * 14 + (_I, _P)
    )
    rc = launch(
        ctypes.byref(t.struct), ctypes.byref(t.tree), ctypes.byref(env),
        *[cuda_build.ptr(x) for x in (
            qT, vT, ctrlT, cdof, cinA, cinc, subcom, xipos, xfrcT, qfaT,
            qfs, afrc, avel, diag,
        )],
        ctypes.c_int(E), cuda_build.stream(),
    )
    cuda_build.check(cuda_build.library("vel_smooth"), rc, "vel_smooth")
    vel_smooth.launches += 1
    return qfs, afrc, avel, diag


vel_smooth.launches = 0


# ---------------------------------------------------------------------------
# env-last integration (plain PyTorch)
# ---------------------------------------------------------------------------


def _joint_index(m: Model):
    """Index tables of integrate_envlast: qpos/qvel addresses of the
    coordinates that integrate linearly (hinge, slide, free-joint position)
    and of the quaternions (free-joint and ball rotations), (n, 4) / (n, 3)."""
    lin_q, lin_v, quat_q, quat_v = [], [], [], []
    for j in range(m.njnt):
        jtype = int(m.jnt_type[j])
        qadr = int(m.jnt_qposadr[j])
        vadr = int(m.jnt_dofadr[j])
        if jtype == JNT_FREE:
            lin_q += [qadr, qadr + 1, qadr + 2]
            lin_v += [vadr, vadr + 1, vadr + 2]
            quat_q.append([qadr + 3 + i for i in range(4)])
            quat_v.append([vadr + 3 + i for i in range(3)])
        elif jtype == JNT_BALL:
            quat_q.append([qadr + i for i in range(4)])
            quat_v.append([vadr + i for i in range(3)])
        else:
            lin_q.append(qadr)
            lin_v.append(vadr)
    t = lambda x, shape: torch.as_tensor(  # noqa: E731
        np.asarray(x, np.int64).reshape(shape), device=m.device
    )
    return (t(lin_q, -1), t(lin_v, -1), t(quat_q, (-1, 4)),
            t(quat_v, (-1, 3)))


def integrate_envlast(m: Model, qT, vT, qacc_int):
    """Env-last mj_step integration tail without activation states.

    qT (nq, E), vT (nv, E), qacc_int (nv, E) -> (qposT', qvelT', bad (E,));
    a diverged env (non-finite or > 1e10) is re-seeded at (its own)
    qpos0, zero velocity (mj_checkPos/Vel/Acc). Every joint of a kind is integrated by
    the same few tensor operations."""
    h = m.opt.timestep
    vT_new = vT + h * qacc_int
    lin_q, lin_v, quat_q, quat_v = cached(m, "joint_index", lambda: _joint_index(m))
    qT_new = qT.clone()
    qT_new[lin_q] = qT[lin_q] + h * vT_new[lin_v]
    if len(quat_q):
        q4 = qT[quat_q]  # (n, 4, E)
        w3 = vT_new[quat_v]  # (n, 3, E)
        qq = quat_integrate(
            tuple(q4[:, i] for i in range(4)), tuple(w3[:, i] for i in range(3)), h
        )
        qT_new[quat_q] = torch.stack(qq, dim=1)

    MAXVAL = 1e10

    def bad_of(x):
        return torch.any(~torch.isfinite(x) | (torch.abs(x) > MAXVAL), dim=0)

    bad = bad_of(qT_new) | bad_of(vT_new) | bad_of(qacc_int)
    qT_new = torch.where(bad, Params(m, qT.shape[-1])("qpos0"), qT_new)
    vT_new = torch.where(bad, 0.0, vT_new)
    return qT_new, vT_new, bad
