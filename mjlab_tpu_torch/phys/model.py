"""Model dataclass and host-side conversion from mujoco.MjModel.

PyTorch counterpart of mjlab_tpu/phys/model.py. MuJoCo's MjSpec/MjModel
pipeline stays the model compiler; ``put_model`` converts the compiled
MjModel into a ``Model`` dataclass. Structural tables (tree topology, joint
types, constraint layout, the contact pair table) stay numpy arrays for
host-side indexing; physical parameters are torch tensors on the model's
device.

The contact pair table builder (``make_pair_table``) and the geom type
constants live here too (in the JAX package they sit in phys/collision.py,
which this port does not carry).

Only the conversion from an MjModel needs the ``mujoco`` package; a Model
saved with ``save_model`` loads without it (``load_model``), which is how a
machine without MuJoCo runs a compiled model.
"""

from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

# mujoco.mjtDisableBit values
DSBL_FRICTIONLOSS = 1 << 2
DSBL_LIMIT = 1 << 3
DSBL_CONTACT = 1 << 4
DSBL_GRAVITY = 1 << 7
DSBL_FILTERPARENT = 1 << 10
DSBL_EULERDAMP = 1 << 15

# joint types (mujoco.mjtJoint)
JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE = 0, 1, 2, 3

# integrators
INT_EULER, INT_RK4, INT_IMPLICIT, INT_IMPLICITFAST = 0, 1, 2, 3

# cones
CONE_PYRAMIDAL, CONE_ELLIPTIC = 0, 1

# actuator activation dynamics (mujoco.mjtDyn)
DYN_NONE, DYN_INTEGRATOR, DYN_FILTER, DYN_FILTEREXACT = 0, 1, 2, 3

# efc row types (the engine's layout, not mujoco's enum)
EFC_FRICTION_DOF = 0
EFC_LIMIT_JOINT = 1
EFC_CONTACT = 2
EFC_EQUALITY = 3
EFC_LIMIT_TENDON = 4

# transmission types (mujoco.mjtTrn)
TRN_JOINT, TRN_JOINTINPARENT, TRN_SLIDERCRANK, TRN_TENDON, TRN_SITE = 0, 1, 2, 3, 4

# geom types (mujoco.mjtGeom)
GEOM_PLANE = 0
GEOM_HFIELD = 1
GEOM_SPHERE = 2
GEOM_CAPSULE = 3
GEOM_ELLIPSOID = 4
GEOM_CYLINDER = 5
GEOM_BOX = 6
GEOM_MESH = 7

# model fields the smooth kernels read from their device tables
SMOOTH_HOST_FIELDS = (
    "qpos0", "body_pos", "body_quat", "jnt_pos", "jnt_axis",
    "body_ipos", "body_iquat", "geom_pos", "geom_quat",
    "body_mass", "body_inertia", "dof_armature", "dof_damping",
    "jnt_stiffness", "qpos_spring",
    "actuator_gear", "actuator_ctrlrange", "actuator_gainprm",
    "actuator_biasprm", "actuator_forcerange",
)

# the smooth fields of one value per row (the others hold a vector per row)
SMOOTH_VECTOR_FIELDS = frozenset({
    "qpos0", "qpos_spring", "body_mass", "dof_armature", "dof_damping",
    "jnt_stiffness",
})

# the smooth fields a model may carry per env (a leading num_envs axis):
# those a domain randomisation event writes. The kernels read such a field
# from its (E, ...) tensor in place of the device table's constant; the
# other smooth fields stay shared.
PER_ENV_SMOOTH_FIELDS = frozenset({
    "body_mass", "body_ipos", "body_inertia", "geom_pos", "dof_damping",
    "dof_armature", "jnt_stiffness", "qpos0", "actuator_gainprm",
    "actuator_biasprm", "actuator_forcerange",
})


def per_env_smooth(m: "Model") -> tuple[str, ...]:
    """The plan of the smooth kernels' per-env fields: the sorted names of
    PER_ENV_SMOOTH_FIELDS that m carries with a leading env axis, one axis
    more than the shared field (the JAX package's dr_smooth_plan)."""
    return tuple(sorted(
        n for n in PER_ENV_SMOOTH_FIELDS
        if getattr(m, n).dim() > (1 if n in SMOOTH_VECTOR_FIELDS else 2)
    ))

# contact slots emitted per (type1, type2) narrowphase; the table is the
# engine's full pair catalog (the narrowphase of this package implements a
# subset, see phys/lm/collision.py)
_PAIR_NCON = {
    (GEOM_PLANE, GEOM_SPHERE): 1,
    (GEOM_PLANE, GEOM_CAPSULE): 2,
    (GEOM_PLANE, GEOM_BOX): 4,
    (GEOM_PLANE, GEOM_MESH): 3,
    (GEOM_PLANE, GEOM_CYLINDER): 4,
    (GEOM_PLANE, GEOM_ELLIPSOID): 1,
    (GEOM_SPHERE, GEOM_CYLINDER): 1,
    (GEOM_SPHERE, GEOM_ELLIPSOID): 1,
    (GEOM_ELLIPSOID, GEOM_ELLIPSOID): 1,
    (GEOM_ELLIPSOID, GEOM_CYLINDER): 1,
    (GEOM_CYLINDER, GEOM_CYLINDER): 1,
    (GEOM_HFIELD, GEOM_SPHERE): 1,
    (GEOM_HFIELD, GEOM_CAPSULE): 2,
    (GEOM_HFIELD, GEOM_BOX): 4,
    (GEOM_SPHERE, GEOM_SPHERE): 1,
    (GEOM_SPHERE, GEOM_CAPSULE): 1,
    (GEOM_SPHERE, GEOM_BOX): 1,
    (GEOM_CAPSULE, GEOM_CAPSULE): 1,
    (GEOM_CAPSULE, GEOM_BOX): 2,
    (GEOM_BOX, GEOM_BOX): 4,
}


@dataclass
class Option:
    """Physics options (the supported subset of mjModel.opt)."""

    timestep: torch.Tensor  # ()
    gravity: torch.Tensor  # (3,)
    magnetic: torch.Tensor  # (3,)
    impratio: torch.Tensor  # ()

    integrator: int
    cone: int
    iterations: int
    ls_iterations: int
    tolerance: float
    ls_tolerance: float
    disableflags: int


OPTION_TENSOR_FIELDS = ("timestep", "gravity", "magnetic", "impratio")
OPTION_STATIC_FIELDS = (
    "integrator", "cone", "iterations", "ls_iterations", "tolerance",
    "ls_tolerance", "disableflags",
)


@dataclass
class PairTable:
    """Static candidate contact-pair table (host-side broadphase).

    Pairs are grouped by (type1, type2) narrowphase function; each pair
    owns a fixed number of contact slots. All fields are numpy."""

    geom1: np.ndarray  # (npair,) geom ids
    geom2: np.ndarray
    pair_condim: np.ndarray
    pair_ncon: np.ndarray  # contact slots per pair
    pair_conadr: np.ndarray  # first contact slot of each pair
    ex_mask: np.ndarray  # explicit <pair> overrides
    ex_friction5: np.ndarray
    ex_solref: np.ndarray
    ex_solimp: np.ndarray
    ex_margin: np.ndarray
    ex_gap: np.ndarray
    ncon: int  # total contact slots
    con_pairid: np.ndarray  # per contact slot
    con_geom1: np.ndarray
    con_geom2: np.ndarray
    con_dim: np.ndarray
    con_efcadr: np.ndarray


@dataclass
class Model:
    """Physics model of one world; every env shares it."""

    # ----- static structure (python ints, numpy arrays, name tuples) -----
    nq: int
    nv: int
    nu: int
    nbody: int
    njnt: int
    ngeom: int
    nsite: int
    nmocap: int

    body_parentid: np.ndarray
    body_rootid: np.ndarray
    body_jntadr: np.ndarray
    body_jntnum: np.ndarray
    body_dofadr: np.ndarray
    body_dofnum: np.ndarray
    body_mocapid: np.ndarray

    jnt_type: np.ndarray
    jnt_qposadr: np.ndarray
    jnt_dofadr: np.ndarray
    jnt_bodyid: np.ndarray
    jnt_limited: np.ndarray

    dof_bodyid: np.ndarray
    dof_jntid: np.ndarray

    geom_bodyid: np.ndarray
    geom_type: np.ndarray
    geom_condim: np.ndarray
    geom_priority: np.ndarray
    geom_dataid: np.ndarray

    nhfield: int
    hfield_nrow: int
    hfield_ncol: int

    nmesh: int
    mesh_hull_vert: np.ndarray
    mesh_hull_mask: np.ndarray

    site_bodyid: np.ndarray

    actuator_trntype: np.ndarray
    actuator_gaintype: np.ndarray
    actuator_biastype: np.ndarray
    actuator_trnid: np.ndarray  # (nu, 2)
    actuator_ctrllimited: np.ndarray
    actuator_forcelimited: np.ndarray
    na: int
    actuator_dyntype: np.ndarray
    actuator_actadr: np.ndarray
    actuator_actlimited: np.ndarray
    actuator_actearly: np.ndarray
    act_actuatorid: np.ndarray

    ntendon: int
    ten_J: np.ndarray
    ten_Lq: np.ndarray
    tendon_names: tuple

    # constraint layout: [equality][dof friction][jnt limits][ten limits][contacts]
    nefc: int
    nlimit: int
    nlimit_ten: int
    limit_tenid: np.ndarray
    ncon_max: int
    rows_per_con: int
    limit_jntid: np.ndarray
    efc_type: np.ndarray
    pairs: PairTable

    neq_jnt: int
    eq_j1_qadr: np.ndarray
    eq_j1_dofadr: np.ndarray
    eq_j2_qadr: np.ndarray
    eq_j2_dofadr: np.ndarray

    body_names: tuple
    joint_names: tuple
    geom_names: tuple
    site_names: tuple
    actuator_names: tuple

    # ----- physical parameters (torch tensors) -----
    qpos0: torch.Tensor
    qpos_spring: torch.Tensor
    body_pos: torch.Tensor
    body_quat: torch.Tensor
    body_ipos: torch.Tensor
    body_iquat: torch.Tensor
    body_mass: torch.Tensor
    body_inertia: torch.Tensor
    body_invweight0: torch.Tensor
    jnt_axis: torch.Tensor
    jnt_pos: torch.Tensor
    jnt_range: torch.Tensor
    jnt_solref: torch.Tensor
    jnt_solimp: torch.Tensor
    jnt_stiffness: torch.Tensor
    jnt_margin: torch.Tensor
    dof_armature: torch.Tensor
    dof_damping: torch.Tensor
    dof_frictionloss: torch.Tensor
    dof_invweight0: torch.Tensor
    dof_solref: torch.Tensor
    dof_solimp: torch.Tensor
    geom_pos: torch.Tensor
    geom_quat: torch.Tensor
    geom_size: torch.Tensor
    geom_friction: torch.Tensor
    geom_solref: torch.Tensor
    geom_solimp: torch.Tensor
    geom_solmix: torch.Tensor
    geom_margin: torch.Tensor
    geom_gap: torch.Tensor
    site_pos: torch.Tensor
    site_quat: torch.Tensor
    hfield_size: torch.Tensor
    hfield_data: torch.Tensor
    eq_polycoef: torch.Tensor
    eq_solref: torch.Tensor
    eq_solimp: torch.Tensor
    eq_q0_1: torch.Tensor
    eq_q0_2: torch.Tensor
    actuator_gainprm: torch.Tensor
    actuator_biasprm: torch.Tensor
    actuator_ctrlrange: torch.Tensor
    actuator_forcerange: torch.Tensor
    actuator_gear: torch.Tensor
    actuator_dynprm: torch.Tensor
    actuator_actrange: torch.Tensor
    tendon_range: torch.Tensor
    tendon_solref_lim: torch.Tensor
    tendon_solimp_lim: torch.Tensor
    tendon_margin: torch.Tensor
    tendon_stiffness: torch.Tensor
    tendon_damping: torch.Tensor
    tendon_lengthspring: torch.Tensor
    tendon_invweight0: torch.Tensor

    opt: Option

    @property
    def device(self) -> torch.device:
        return self.qpos0.device

    @property
    def dtype(self) -> torch.dtype:
        return self.qpos0.dtype


def cached(m: Model, key, make):
    """``make()``, computed once per Model object: tables derived from the
    model's structure and constants (device copies, host copies). A Model
    made by dataclasses.replace starts with an empty cache. Building them
    once keeps host-device copies, each a stream synchronisation, out of
    the step."""
    cache = m.__dict__.setdefault("_cache", {})
    if key not in cache:
        cache[key] = make()
    return cache[key]


def host_array(m: Model, name: str) -> np.ndarray:
    """The model tensor ``name`` as a numpy array, copied once."""
    return cached(
        m, ("host", name), lambda: getattr(m, name).detach().cpu().numpy()
    )


def device_array(m: Model, key, make, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(make())`` on the model's device, made once."""
    return cached(
        m, ("device", key, dtype),
        lambda: torch.as_tensor(make(), dtype=dtype, device=m.device),
    )


def tensor_fields() -> tuple[str, ...]:
    """Names of the Model fields that hold torch tensors."""
    return tuple(
        f.name for f in dataclasses.fields(Model)
        if f.type in ("torch.Tensor", torch.Tensor)
    )


def static_fields() -> tuple[str, ...]:
    """Names of the Model fields that hold host structure (not opt)."""
    tf = set(tensor_fields())
    return tuple(
        f.name for f in dataclasses.fields(Model)
        if f.name not in tf and f.name != "opt"
    )


def limit_rows_static(m: Model) -> np.ndarray:
    """Static ((nlimit + nlimit_ten), nv) limit-row Jacobian pattern:
    one-hot rows for joint limits, fixed-tendon coefficient rows for
    tendon limits. Signs are applied at run time via efc_lim_side."""
    P = np.zeros((m.nlimit + m.nlimit_ten, m.nv))
    if m.nlimit:
        P[np.arange(m.nlimit), m.jnt_dofadr[m.limit_jntid]] = 1.0
    if m.nlimit_ten:
        P[m.nlimit:] = m.ten_J[m.limit_tenid]
    return P


def make_pair_table(mj: "mujoco.MjModel") -> PairTable:
    """Enumerate candidate contact pairs with MuJoCo's filtering rules."""
    nbody = mj.nbody
    weld = mj.body_weldid
    weld_parent = np.array(
        [weld[mj.body_parentid[mj.body_weldid[b]]] for b in range(nbody)]
    )
    excludes = set()
    for e in range(mj.nexclude):
        sig = int(mj.exclude_signature[e])
        excludes.add((sig >> 16, sig & 0xFFFF))
        excludes.add((sig & 0xFFFF, sig >> 16))

    filterparent = not (mj.opt.disableflags & DSBL_FILTERPARENT)

    # explicit <pair> elements come first: they bypass contype/conaffinity
    # filtering, dedupe the dynamic pair and carry their own parameters
    g1s, g2s = [], []
    explicit_rows = []
    explicit_set = set()
    skipped = set()
    for p in range(mj.npair):
        i, j = int(mj.pair_geom1[p]), int(mj.pair_geom2[p])
        t1, t2 = int(mj.geom_type[i]), int(mj.geom_type[j])
        gi, gj = (i, j) if t1 <= t2 else (j, i)
        key = (min(t1, t2), max(t1, t2))
        if key not in _PAIR_NCON:
            skipped.add(key)
            continue
        if np.any(mj.pair_solreffriction[p] != 0.0):
            warnings.warn(
                "<pair solreffriction> is not supported; using solref for "
                "friction rows"
            )
        g1s.append(gi)
        g2s.append(gj)
        explicit_set.add((min(i, j), max(i, j)))
        explicit_rows.append(
            dict(
                condim=int(mj.pair_dim[p]),
                friction5=np.asarray(mj.pair_friction[p], np.float64).copy(),
                solref=np.asarray(mj.pair_solref[p], np.float64).copy(),
                solimp=np.asarray(mj.pair_solimp[p], np.float64).copy(),
                margin=float(mj.pair_margin[p]),
                gap=float(mj.pair_gap[p]),
            )
        )

    n_explicit = len(g1s)
    for i in range(mj.ngeom):
        for j in range(i + 1, mj.ngeom):
            if (min(i, j), max(i, j)) in explicit_set:
                continue
            b1, b2 = int(mj.geom_bodyid[i]), int(mj.geom_bodyid[j])
            w1, w2 = int(weld[b1]), int(weld[b2])
            if w1 == w2:
                continue
            if filterparent and w1 != 0 and w2 != 0 and (
                w1 == weld_parent[b2] or w2 == weld_parent[b1]
            ):
                continue
            if (b1, b2) in excludes:
                continue
            if not (
                (mj.geom_contype[i] & mj.geom_conaffinity[j])
                or (mj.geom_contype[j] & mj.geom_conaffinity[i])
            ):
                continue
            t1, t2 = int(mj.geom_type[i]), int(mj.geom_type[j])
            gi, gj = (i, j) if t1 <= t2 else (j, i)
            key = (min(t1, t2), max(t1, t2))
            if key not in _PAIR_NCON:
                skipped.add(key)
                continue
            g1s.append(gi)
            g2s.append(gj)
    if skipped:
        warnings.warn(
            f"unsupported collision type pairs skipped: {sorted(skipped)}"
        )

    # sort pairs by type pair so each narrowphase group owns a contiguous
    # contact-slot range
    ex_data = explicit_rows + [None] * (len(g1s) - n_explicit)
    order = sorted(
        range(len(g1s)),
        key=lambda p: (int(mj.geom_type[g1s[p]]), int(mj.geom_type[g2s[p]])),
    )
    g1s = [g1s[p] for p in order]
    g2s = [g2s[p] for p in order]
    ex_data = [ex_data[p] for p in order]

    geom1 = np.array(g1s, np.int32)
    geom2 = np.array(g2s, np.int32)
    npair = len(g1s)

    # condim: priority rule, else max; explicit pairs use their own dim
    p1 = mj.geom_priority[geom1] if npair else np.zeros(0)
    p2 = mj.geom_priority[geom2] if npair else np.zeros(0)
    c1 = mj.geom_condim[geom1] if npair else np.zeros(0, np.int32)
    c2 = mj.geom_condim[geom2] if npair else np.zeros(0, np.int32)
    pair_condim = np.where(
        p1 > p2, c1, np.where(p2 > p1, c2, np.maximum(c1, c2))
    ).astype(np.int32)

    ex_mask = np.array([e is not None for e in ex_data], bool)
    ex_friction5 = np.zeros((npair, 5))
    ex_solref = np.zeros((npair, 2))
    ex_solimp = np.zeros((npair, 5))
    ex_margin = np.zeros(npair)
    ex_gap = np.zeros(npair)
    for idx, e in enumerate(ex_data):
        if e is None:
            continue
        pair_condim[idx] = e["condim"]
        ex_friction5[idx] = e["friction5"]
        ex_solref[idx] = e["solref"]
        ex_solimp[idx] = e["solimp"]
        ex_margin[idx] = e["margin"]
        ex_gap[idx] = e["gap"]

    if npair:
        pair_ncon = np.array(
            [
                _PAIR_NCON[(int(mj.geom_type[a]), int(mj.geom_type[b]))]
                for a, b in zip(geom1, geom2)
            ],
            np.int32,
        )
        pair_conadr = np.concatenate(
            [[0], np.cumsum(pair_ncon)[:-1]]
        ).astype(np.int32)
        con_pairid = np.repeat(np.arange(npair, dtype=np.int32), pair_ncon)
    else:
        pair_ncon = pair_conadr = con_pairid = np.zeros(0, np.int32)
    ncon = int(pair_ncon.sum())

    return PairTable(
        geom1=geom1,
        geom2=geom2,
        pair_condim=pair_condim,
        pair_ncon=pair_ncon,
        pair_conadr=pair_conadr,
        ex_mask=ex_mask,
        ex_friction5=ex_friction5,
        ex_solref=ex_solref,
        ex_solimp=ex_solimp,
        ex_margin=ex_margin,
        ex_gap=ex_gap,
        ncon=ncon,
        con_pairid=con_pairid,
        con_geom1=geom1[con_pairid],
        con_geom2=geom2[con_pairid],
        con_dim=pair_condim[con_pairid],
        con_efcadr=np.zeros(ncon, np.int32),
    )


def _names(mj: "mujoco.MjModel", objtype, n) -> tuple:
    import mujoco

    return tuple(
        mujoco.mj_id2name(mj, objtype, i) or f"_{i}" for i in range(n)
    )


def _check_supported(mj: "mujoco.MjModel") -> None:
    import mujoco

    if mj.ntendon:
        WRAP_JOINT = int(mujoco.mjtWrap.mjWRAP_JOINT)
        if set(mj.wrap_type.tolist()) - {WRAP_JOINT}:
            raise NotImplementedError(
                "spatial tendons (site/geom wraps) not yet supported"
            )
        if np.any(mj.tendon_frictionloss > 0):
            raise NotImplementedError("tendon frictionloss not yet supported")
        if hasattr(mj, "tendon_armature") and np.any(mj.tendon_armature > 0):
            raise NotImplementedError("tendon armature not yet supported")
    eq_types = set(mj.eq_type.tolist()) if mj.neq else set()
    if eq_types - {int(mujoco.mjtEq.mjEQ_JOINT)}:
        raise NotImplementedError(
            f"only joint equality constraints supported, got {eq_types}"
        )
    dyn_types = set(mj.actuator_dyntype.tolist()) if mj.nu else set()
    if dyn_types - {DYN_NONE, DYN_INTEGRATOR, DYN_FILTER, DYN_FILTEREXACT}:
        raise NotImplementedError(
            f"actuator dyntype {dyn_types} (muscle/user/plugin) not supported"
        )
    if mj.nu and np.any(mj.actuator_actnum > 1):
        raise NotImplementedError("actuators with actnum > 1 not supported")
    unsupported = set(mj.jnt_type.tolist()) - {
        JNT_FREE, JNT_BALL, JNT_SLIDE, JNT_HINGE
    }
    if unsupported:
        raise NotImplementedError(f"joint types {unsupported}")
    if mj.nhfield > 1:
        raise NotImplementedError(
            "at most one hfield (the terrain) is supported"
        )


def put_model(
    mj: "mujoco.MjModel",
    dtype: torch.dtype = torch.float32,
    nconmax: int | None = None,
    device: str | torch.device = "cuda",
) -> Model:
    """Convert a compiled mujoco.MjModel into a Model on ``device``."""
    import mujoco

    _check_supported(mj)

    ntendon = int(mj.ntendon)
    act_actuatorid = np.zeros(int(mj.na), np.int32)
    for u in range(mj.nu):
        if mj.actuator_actnum[u] > 0:
            act_actuatorid[int(mj.actuator_actadr[u])] = u

    # fixed-tendon coefficient rows (static)
    ten_J = np.zeros((ntendon, mj.nv))
    ten_Lq = np.zeros((ntendon, mj.nq))
    for t in range(ntendon):
        adr, num = int(mj.tendon_adr[t]), int(mj.tendon_num[t])
        for w in range(adr, adr + num):
            j = int(mj.wrap_objid[w])
            coef = float(mj.wrap_prm[w])
            ten_J[t, int(mj.jnt_dofadr[j])] += coef
            ten_Lq[t, int(mj.jnt_qposadr[j])] += coef
    limit_tenid = (
        np.nonzero(mj.tendon_limited)[0].astype(np.int32)
        if ntendon
        else np.zeros(0, np.int32)
    )
    nlimit_ten = len(limit_tenid)

    # convex hull vertices per mesh (qhull graph verts when present)
    nmesh = int(mj.nmesh)
    if nmesh:
        hulls = []
        for i in range(nmesh):
            va, vn = int(mj.mesh_vertadr[i]), int(mj.mesh_vertnum[i])
            verts = np.asarray(mj.mesh_vert[va:va + vn], np.float64)
            ga = int(mj.mesh_graphadr[i])
            if ga >= 0:
                g = mj.mesh_graph
                numvert = int(g[ga])
                vgid = np.asarray(g[ga + 2 + numvert:ga + 2 + 2 * numvert])
                verts = verts[vgid]
            hulls.append(verts)
        vmax = max(len(h) for h in hulls)
        mesh_hull_vert = np.zeros((nmesh, vmax, 3))
        mesh_hull_mask = np.zeros((nmesh, vmax), bool)
        for i, h in enumerate(hulls):
            mesh_hull_vert[i, :len(h)] = h
            mesh_hull_vert[i, len(h):] = h[0]
            mesh_hull_mask[i, :len(h)] = True
    else:
        mesh_hull_vert = np.zeros((0, 1, 3))
        mesh_hull_mask = np.zeros((0, 1), bool)

    pairs = make_pair_table(mj)
    limit_jntid = np.nonzero(mj.jnt_limited)[0].astype(np.int32)
    nlimit = len(limit_jntid)
    if nconmax is None:
        nconmax = 64
    ncon_max = int(min(pairs.ncon, nconmax))
    maxdim = int(
        max(3, pairs.pair_condim.max() if len(pairs.pair_condim) else 3)
    )
    if int(mj.opt.cone) == CONE_PYRAMIDAL:
        rows_per_con = 2 * (maxdim - 1)
    else:
        rows_per_con = maxdim

    neq_jnt = int(mj.neq)
    if neq_jnt:
        eq_j1 = mj.eq_obj1id.astype(np.int32)
        eq_j2 = mj.eq_obj2id.astype(np.int32)
        single = eq_j2 < 0
        eq_j1_qadr = mj.jnt_qposadr[eq_j1].astype(np.int32)
        eq_j1_dofadr = mj.jnt_dofadr[eq_j1].astype(np.int32)
        eq_j2_qadr = np.where(
            single, -1, mj.jnt_qposadr[np.maximum(eq_j2, 0)]
        ).astype(np.int32)
        eq_j2_dofadr = np.where(
            single, -1, mj.jnt_dofadr[np.maximum(eq_j2, 0)]
        ).astype(np.int32)
        eq_polycoef = mj.eq_data[:, :5].astype(np.float64)
        eq_q0_1 = mj.qpos0[eq_j1_qadr]
        eq_q0_2 = np.where(single, 0.0, mj.qpos0[np.maximum(eq_j2_qadr, 0)])
        eq_solref_np = mj.eq_solref
        eq_solimp_np = mj.eq_solimp
    else:
        eq_j1_qadr = eq_j1_dofadr = np.zeros(0, np.int32)
        eq_j2_qadr = eq_j2_dofadr = np.zeros(0, np.int32)
        eq_polycoef = np.zeros((0, 5))
        eq_q0_1 = eq_q0_2 = np.zeros(0)
        eq_solref_np = np.zeros((0, 2))
        eq_solimp_np = np.zeros((0, 5))

    nefc = neq_jnt + mj.nv + nlimit + nlimit_ten + rows_per_con * ncon_max
    efc_type = np.concatenate([
        np.full(neq_jnt, EFC_EQUALITY, np.int32),
        np.full(mj.nv, EFC_FRICTION_DOF, np.int32),
        np.full(nlimit, EFC_LIMIT_JOINT, np.int32),
        np.full(nlimit_ten, EFC_LIMIT_TENDON, np.int32),
        np.full(rows_per_con * ncon_max, EFC_CONTACT, np.int32),
    ])

    i32 = lambda x: np.asarray(x).astype(np.int32)  # noqa: E731
    static = dict(
        nq=mj.nq, nv=mj.nv, nu=mj.nu, nbody=mj.nbody, njnt=mj.njnt,
        ngeom=mj.ngeom, nsite=mj.nsite, nmocap=mj.nmocap,
        body_parentid=i32(mj.body_parentid),
        body_rootid=i32(mj.body_rootid),
        body_jntadr=i32(mj.body_jntadr),
        body_jntnum=i32(mj.body_jntnum),
        body_dofadr=i32(mj.body_dofadr),
        body_dofnum=i32(mj.body_dofnum),
        body_mocapid=i32(mj.body_mocapid),
        jnt_type=i32(mj.jnt_type),
        jnt_qposadr=i32(mj.jnt_qposadr),
        jnt_dofadr=i32(mj.jnt_dofadr),
        jnt_bodyid=i32(mj.jnt_bodyid),
        jnt_limited=i32(mj.jnt_limited),
        dof_bodyid=i32(mj.dof_bodyid),
        dof_jntid=i32(mj.dof_jntid),
        geom_bodyid=i32(mj.geom_bodyid),
        geom_type=i32(mj.geom_type),
        geom_condim=i32(mj.geom_condim),
        geom_priority=i32(mj.geom_priority),
        geom_dataid=i32(mj.geom_dataid),
        nhfield=int(mj.nhfield),
        hfield_nrow=int(mj.hfield_nrow[0]) if mj.nhfield else 0,
        hfield_ncol=int(mj.hfield_ncol[0]) if mj.nhfield else 0,
        nmesh=nmesh,
        mesh_hull_vert=mesh_hull_vert,
        mesh_hull_mask=mesh_hull_mask,
        site_bodyid=i32(mj.site_bodyid),
        actuator_trntype=i32(mj.actuator_trntype),
        actuator_gaintype=i32(mj.actuator_gaintype),
        actuator_biastype=i32(mj.actuator_biastype),
        actuator_trnid=i32(mj.actuator_trnid).reshape(mj.nu, 2),
        actuator_ctrllimited=i32(mj.actuator_ctrllimited),
        actuator_forcelimited=i32(mj.actuator_forcelimited),
        na=int(mj.na),
        actuator_dyntype=i32(mj.actuator_dyntype),
        actuator_actadr=i32(mj.actuator_actadr),
        actuator_actlimited=i32(mj.actuator_actlimited),
        actuator_actearly=i32(mj.actuator_actearly),
        act_actuatorid=act_actuatorid,
        ntendon=ntendon,
        ten_J=ten_J,
        ten_Lq=ten_Lq,
        tendon_names=_names(mj, mujoco.mjtObj.mjOBJ_TENDON, ntendon),
        nefc=int(nefc),
        nlimit=nlimit,
        nlimit_ten=nlimit_ten,
        limit_tenid=limit_tenid,
        ncon_max=ncon_max,
        rows_per_con=rows_per_con,
        limit_jntid=limit_jntid,
        efc_type=efc_type,
        pairs=pairs,
        neq_jnt=neq_jnt,
        eq_j1_qadr=eq_j1_qadr,
        eq_j1_dofadr=eq_j1_dofadr,
        eq_j2_qadr=eq_j2_qadr,
        eq_j2_dofadr=eq_j2_dofadr,
        body_names=_names(mj, mujoco.mjtObj.mjOBJ_BODY, mj.nbody),
        joint_names=_names(mj, mujoco.mjtObj.mjOBJ_JOINT, mj.njnt),
        geom_names=_names(mj, mujoco.mjtObj.mjOBJ_GEOM, mj.ngeom),
        site_names=_names(mj, mujoco.mjtObj.mjOBJ_SITE, mj.nsite),
        actuator_names=_names(mj, mujoco.mjtObj.mjOBJ_ACTUATOR, mj.nu),
        opt_integrator=int(mj.opt.integrator),
        opt_cone=int(mj.opt.cone),
        opt_iterations=int(mj.opt.iterations),
        opt_ls_iterations=int(mj.opt.ls_iterations),
        opt_tolerance=float(mj.opt.tolerance),
        opt_ls_tolerance=float(mj.opt.ls_tolerance),
        opt_disableflags=int(mj.opt.disableflags),
    )
    fields = dict(
        qpos0=mj.qpos0,
        qpos_spring=mj.qpos_spring,
        body_pos=mj.body_pos,
        body_quat=mj.body_quat,
        body_ipos=mj.body_ipos,
        body_iquat=mj.body_iquat,
        body_mass=mj.body_mass,
        body_inertia=mj.body_inertia,
        body_invweight0=mj.body_invweight0,
        jnt_axis=mj.jnt_axis,
        jnt_pos=mj.jnt_pos,
        jnt_range=mj.jnt_range,
        jnt_solref=mj.jnt_solref,
        jnt_solimp=mj.jnt_solimp,
        jnt_stiffness=mj.jnt_stiffness,
        jnt_margin=mj.jnt_margin,
        dof_armature=mj.dof_armature,
        dof_damping=mj.dof_damping,
        dof_frictionloss=mj.dof_frictionloss,
        dof_invweight0=mj.dof_invweight0,
        dof_solref=mj.dof_solref,
        dof_solimp=mj.dof_solimp,
        geom_pos=mj.geom_pos,
        geom_quat=mj.geom_quat,
        geom_size=mj.geom_size,
        geom_friction=mj.geom_friction,
        geom_solref=mj.geom_solref,
        geom_solimp=mj.geom_solimp,
        geom_solmix=mj.geom_solmix,
        geom_margin=mj.geom_margin,
        geom_gap=mj.geom_gap,
        site_pos=mj.site_pos,
        site_quat=mj.site_quat,
        eq_polycoef=eq_polycoef,
        eq_solref=eq_solref_np,
        eq_solimp=eq_solimp_np,
        eq_q0_1=eq_q0_1,
        eq_q0_2=eq_q0_2,
        hfield_size=mj.hfield_size.reshape(-1, 4),
        hfield_data=(
            mj.hfield_data.reshape(mj.hfield_nrow[0], mj.hfield_ncol[0])
            if mj.nhfield
            else np.zeros((0, 0))
        ),
        actuator_gainprm=mj.actuator_gainprm,
        actuator_biasprm=mj.actuator_biasprm,
        actuator_ctrlrange=mj.actuator_ctrlrange,
        actuator_forcerange=mj.actuator_forcerange,
        actuator_gear=mj.actuator_gear,
        actuator_dynprm=mj.actuator_dynprm,
        actuator_actrange=mj.actuator_actrange,
        tendon_range=mj.tendon_range.reshape(ntendon, 2),
        tendon_solref_lim=mj.tendon_solref_lim.reshape(ntendon, 2),
        tendon_solimp_lim=mj.tendon_solimp_lim.reshape(ntendon, 5),
        tendon_margin=mj.tendon_margin.reshape(ntendon),
        tendon_stiffness=mj.tendon_stiffness.reshape(ntendon),
        tendon_damping=mj.tendon_damping.reshape(ntendon),
        tendon_lengthspring=mj.tendon_lengthspring.reshape(ntendon, 2),
        tendon_invweight0=mj.tendon_invweight0.reshape(ntendon),
        opt_timestep=mj.opt.timestep,
        opt_gravity=mj.opt.gravity,
        opt_magnetic=mj.opt.magnetic,
        opt_impratio=mj.opt.impratio,
    )
    return model_from_numpy(fields, static, dtype=dtype, device=device)


def model_from_numpy(
    fields: dict[str, Any],
    static: dict[str, Any],
    dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> Model:
    """Build a Model from numpy values.

    ``fields`` maps every tensor field of Model, plus ``opt_timestep``,
    ``opt_gravity``, ``opt_magnetic`` and ``opt_impratio``, to an array or
    scalar. ``static`` maps every structural field to its value, plus the
    static options as ``opt_<name>``; ``pairs`` may be a PairTable or a dict
    of its fields. ``model_to_numpy`` is the inverse."""
    device = resolve_device(device)

    def t(x):
        return torch.as_tensor(np.array(x, np.float64), dtype=dtype,
                               device=device)

    opt = Option(
        **{n: t(fields[f"opt_{n}"]) for n in OPTION_TENSOR_FIELDS},
        **{n: static[f"opt_{n}"] for n in OPTION_STATIC_FIELDS},
    )
    kw = {}
    for name in static_fields():
        v = static[name]
        if name == "pairs" and isinstance(v, dict):
            v = PairTable(**v)
        kw[name] = v
    for name in tensor_fields():
        kw[name] = t(fields[name])
    return Model(**kw, opt=opt)


def model_to_numpy(m: Model) -> tuple[dict[str, Any], dict[str, Any]]:
    """(fields, static) numpy view of a Model (model_from_numpy's input)."""
    fields = {n: getattr(m, n).cpu().numpy() for n in tensor_fields()}
    for n in OPTION_TENSOR_FIELDS:
        fields[f"opt_{n}"] = getattr(m.opt, n).cpu().numpy()
    static = {n: getattr(m, n) for n in static_fields()}
    static["pairs"] = dataclasses.asdict(m.pairs)
    for n in OPTION_STATIC_FIELDS:
        static[f"opt_{n}"] = getattr(m.opt, n)
    return fields, static


def save_model(path, m: Model, **extra: np.ndarray) -> None:
    """Write a Model (and named extra arrays) to a compressed .npz that
    ``load_model`` reads without MuJoCo and without pickling. Float values
    are stored at the model's dtype widened to float64."""
    fields, static = model_to_numpy(m)
    out = {f"f__{k}": np.asarray(v, np.float64) for k, v in fields.items()}
    for k, v in static.items():
        if k == "pairs":
            out.update({f"p__{pk}": np.asarray(pv) for pk, pv in v.items()})
        elif isinstance(v, tuple):
            out[f"t__{k}"] = np.asarray(v, dtype=np.str_)
        else:
            out[f"s__{k}"] = np.asarray(v)
    out.update({f"x__{k}": np.asarray(v) for k, v in extra.items()})
    np.savez_compressed(path, **out)


def load_model(
    path, dtype: torch.dtype = torch.float32,
    device: str | torch.device = "cuda",
) -> tuple[Model, dict[str, np.ndarray]]:
    """(Model, extra arrays) from a file written by ``save_model``."""

    def scalar(v):
        return v.item() if v.ndim == 0 else v

    fields, static, pairs, extra = {}, {}, {}, {}
    with np.load(path, allow_pickle=False) as z:
        for key in z.files:
            kind, name = key[:3], key[3:]
            v = z[key]
            if kind == "f__":
                fields[name] = v
            elif kind == "p__":
                pairs[name] = scalar(v)
            elif kind == "t__":
                static[name] = tuple(str(x) for x in v)
            elif kind == "s__":
                static[name] = scalar(v)
            else:
                extra[name] = v
    static["pairs"] = pairs
    return model_from_numpy(fields, static, dtype=dtype, device=device), extra


def resolve_device(device: str | torch.device) -> torch.device:
    """The device an entry point runs on; raise if CUDA is asked for and
    there is none (no silent move to the CPU)."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device 'cuda' requested but torch.cuda.is_available() is "
            "false; pass device='cpu' to run the plain PyTorch versions"
        )
    return device
