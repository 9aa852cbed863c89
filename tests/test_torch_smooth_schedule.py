"""The tree schedule of the many-threads-per-env smooth kernels
(smooth_kernels.tree_schedule, csrc/smooth_tree.cuh), on the CPU.

kin_com.cu, crb_packed.cu and vel_smooth.cu walk the body tree level by
level: root to leaves for the frames and velocities, leaves to root for
the subtree sums, where each parent sums its own children in descending
index. Here the tables are held against the model's tree on the G1, the
YAM and the toys, and a small Python model of the leaves-to-root pass is
held bitwise against the serial pass of the one-thread-per-env kernels
(``for b = nbody-1..1: x[parent(b)] += x[b]``) on random float32 data. A
Python model of the whole crb kernel (its composite inertias on that
schedule, f per dof, the lower triangle by its index map) is held against
the serial composite sums bitwise and against crb_dense_plain.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.phys import smooth_kernels as sk
from mjlab_tpu_torch.phys.lm import stages

import torch_toy_models as toys
from test_torch_newton_launch import _model

MODELS = ["g1", "yam", *toys.ALL]
CSRC = Path(sk.__file__).resolve().parent.parent / "csrc"


def serial_backward(parent, x):
    """The serial pass: x[parent(b)] += x[b] for b = nbody-1 .. 1 (f32)."""
    x = x.copy()
    for b in range(len(parent) - 1, 0, -1):
        x[parent[b]] = x[parent[b]] + x[b]
    return x


def scheduled_backward(sched, x, skip_world=False):
    """The kernels' pass: deepest level first, each parent of the level
    above sums its own children in the order of child_body (one
    barrier per level: a level's parents read only finished children)."""
    x = x.copy()
    adr, bodies = sched["level_adr"], sched["level_body"]
    cadr, kids = sched["child_adr"], sched["child_body"]
    last = 1 if skip_world else 0
    for L in range(len(adr) - 2, last, -1):
        finished = x.copy()  # what the level reads was written a level earlier
        for p in bodies[adr[L - 1]:adr[L]]:
            acc = finished[p]
            for c in kids[cadr[p]:cadr[p + 1]]:
                acc = acc + finished[c]
            x[p] = acc
    return x


@pytest.fixture(scope="module", params=MODELS)
def model(request):
    m = _model(request.param)
    return m, sk.tree_schedule(m)


def test_levels_put_every_parent_above_its_children(model):
    m, s = model
    parent = np.asarray(m.body_parentid)
    level = s["body_level"]
    assert level[0] == 0 and (level[1:] >= 1).all()
    assert (level[parent[1:]] == level[1:] - 1).all()
    adr, bodies = s["level_adr"], s["level_body"]
    assert adr[0] == 0 and adr[-1] == m.nbody == len(bodies)
    assert sorted(bodies.tolist()) == list(range(m.nbody))
    for L in range(len(adr) - 1):
        group = bodies[adr[L]:adr[L + 1]]
        assert len(group) and (level[group] == L).all()
        assert (np.diff(group) > 0).all()


def test_children_lists_match_body_parentid(model):
    m, s = model
    parent = np.asarray(m.body_parentid)
    for b in range(m.nbody):
        kids = s["child_body"][s["child_adr"][b]:s["child_adr"][b + 1]].tolist()
        assert kids == sorted((c for c in range(1, m.nbody) if parent[c] == b), reverse=True)


def test_owner_tables(model):
    m, s = model
    for j in range(m.njnt):
        adr = int(m.jnt_dofadr[j])
        n = {0: 6, 1: 3}.get(int(m.jnt_type[j]), 1)
        assert (s["dof_jnt"][adr:adr + n] == j).all()
    for i in range(m.nv):
        acts = s["dof_act"][s["dof_act_adr"][i]:s["dof_act_adr"][i + 1]].tolist()
        assert acts == [u for u in range(m.nu)
                        if int(m.jnt_dofadr[int(m.actuator_trnid[u, 0])]) == i]
    assert s["dof_act_adr"][-1] == m.nu
    anc = stages.ancestor_dof_mask(m)
    for i in range(m.nv):
        sub = s["dof_sub_body"][s["dof_sub_adr"][i]:s["dof_sub_adr"][i + 1]].tolist()
        assert sub == [b for b in range(1, m.nbody) if anc[b, i]]
    cg = sk.collision_geoms(m)
    assert s["cg_body"].tolist() == [int(m.geom_bodyid[g]) for g in cg]


@pytest.mark.parametrize("skip_world", [False, True])
def test_parent_owned_sum_is_the_serial_pass_bitwise(model, skip_world):
    """On random f32 data (6 columns, a spatial force), every body's sum
    is bitwise the serial pass's; vel_smooth skips the world's (unused)."""
    m, s = model
    parent = np.asarray(m.body_parentid)
    rng = np.random.default_rng(m.nbody)
    x = rng.standard_normal((m.nbody, 6)).astype(np.float32) * np.float32(1e3)
    want = serial_backward(parent, x)
    got = scheduled_backward(s, x, skip_world)
    start = 1 if skip_world else 0
    np.testing.assert_array_equal(got[start:], want[start:])


def test_parent_owned_sum_on_wide_random_trees():
    """Random trees with many children per parent: the descending order is
    the serial pass bitwise; the ascending order is not (so the test can
    tell the two apart)."""
    rng = np.random.default_rng(0)
    ascending_differs = False
    for _ in range(20):
        nb = 40
        parent = np.zeros(nb, np.int64)
        for b in range(2, nb):
            parent[b] = rng.integers(0, min(b, 4))
        s = sk.body_tree(parent)
        x = rng.standard_normal((nb, 3)).astype(np.float32)
        want = serial_backward(parent, x)
        np.testing.assert_array_equal(scheduled_backward(s, x), want)
        flipped = dict(s)
        flipped["child_body"] = np.concatenate([
            s["child_body"][s["child_adr"][b]:s["child_adr"][b + 1]][::-1] for b in range(nb)
        ])
        ascending_differs |= not np.array_equal(scheduled_backward(flipped, x), want)
    assert ascending_differs


def lower_rc(k):
    """csrc/crb_packed.cu lower_rc in float32: entry k of a lower triangle
    packed row by row -> (i, j), j <= i."""
    r = int((np.sqrt(np.float32(8 * k + 1)) - np.float32(1)) * np.float32(0.5))
    if (r + 1) * (r + 2) // 2 <= k:
        r += 1
    if r * (r + 1) // 2 > k:
        r -= 1
    return r, k - r * (r + 1) // 2


def test_lower_triangle_index_map_covers_each_entry_once():
    for nv in (1, 2, 14, 35, 45, 128):
        got = [lower_rc(k) for k in range(nv * (nv + 1) // 2)]
        assert got == [(i, j) for i in range(nv) for j in range(i + 1)]


def crb_model(m, sched, cdof, cinA, cinc, mh):
    """csrc/crb_packed.cu for one env in float32: cdof (nv, 6), cinA
    (nbody, 6), cinc (nbody, 3), mh (nv,) -> (the composite inertias
    (nbody, 10), qM (nv, nv), Mh (nv, nv))."""
    f32 = np.float32
    mass = np.asarray(m.body_mass, f32)
    comp = np.concatenate([cinA, cinc * mass[:, None], mass[:, None]], axis=1)
    comp = scheduled_backward(sched, comp, skip_world=True)
    _, dof_body, _ = stages.crb_static(m)
    f = np.zeros((m.nv, 6), f32)
    for j in range(m.nv):
        A, h, mb = comp[dof_body[j], :6], comp[dof_body[j], 6:9], comp[dof_body[j], 9]
        w, v = cdof[j, :3], cdof[j, 3:]
        ang = np.array([A[0] * w[0] + A[1] * w[1] + A[2] * w[2],
                        A[1] * w[0] + A[3] * w[1] + A[4] * w[2],
                        A[2] * w[0] + A[4] * w[1] + A[5] * w[2]], f32)
        f[j, :3] = ang + np.cross(h, v)
        f[j, 3:] = v * mb - np.cross(h, w)
    anc = stages.ancestor_dof_mask(m)
    arm = np.asarray(m.dof_armature, f32)
    qM = np.zeros((m.nv, m.nv), f32)
    Mh = np.zeros((m.nv, m.nv), f32)
    for k in range(m.nv * (m.nv + 1) // 2):
        i, j = lower_rc(k)
        v = f32(0)
        if anc[dof_body[i], j]:
            v = cdof[j, 0] * f[i, 0]
            for c in range(1, 6):
                v = v + cdof[j, c] * f[i, c]
            if i == j:
                v = v + arm[i]
        qM[i, j] = qM[j, i] = v
        Mh[i, j] = Mh[j, i] = v + mh[i] if i == j else v
    return comp, qM, Mh


def test_crb_kernel_model_matches_the_serial_crb(model):
    """The crb kernel's composite inertias (10 columns: A, h = m c, m) are
    the serial pass's bitwise; its dense qM and Mh match crb_dense_plain
    within 5e-6 (the plain version, as the TPU kernel's trace, sums the
    composite masses of the model constants in float64) with the same
    zeros."""
    m, s = model
    rng = np.random.default_rng(m.nv)
    E = 3
    f32 = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    cdof, cinA, cinc, mh = f32(m.nv, 6, E), f32(m.nbody, 6, E), f32(m.nbody, 3, E), f32(m.nv, E)
    t = torch.as_tensor
    qM_p, Mh_p = (x.numpy().reshape(m.nv, m.nv, E)
                  for x in sk.crb_dense_plain(m, t(cdof), t(cinA), t(cinc), t(mh)))
    parent = np.asarray(m.body_parentid)
    mass = np.asarray(m.body_mass, np.float32)
    for e in range(E):
        comp, qM, Mh = crb_model(m, s, cdof[..., e], cinA[..., e], cinc[..., e], mh[:, e])
        own = np.concatenate([cinA[..., e], cinc[..., e] * mass[:, None], mass[:, None]], 1)
        np.testing.assert_array_equal(comp[1:], serial_backward(parent, own)[1:])
        for got, ref in ((qM, qM_p[..., e]), (Mh, Mh_p[..., e])):
            assert np.abs(got - ref).max() <= 5e-6 * max(1.0, np.abs(ref).max())
            np.testing.assert_array_equal(got == 0, ref == 0)


def _struct_fields(header: str, name: str) -> list[str]:
    body = re.search(r"struct %s \{(.*?)\};" % name, header, re.S).group(1)
    body = re.sub(r"//[^\n]*", "", body)
    return [n for decl in body.split(";") if decl.strip()
            for n in re.findall(r"\*?\s*(\w+)(?:\[\d+\])?\s*(?:,|$)", decl.strip())]


@pytest.mark.parametrize("header, struct, mirror", [
    ("smooth_tree.cuh", "SmoothTree", sk._SmoothTree),
    ("smooth_common.cuh", "SmoothTables", sk._SmoothTables),
])
def test_ctypes_mirrors_match_the_headers(header, struct, mirror):
    fields = _struct_fields((CSRC / header).read_text(), struct)
    assert fields == [f[0] for f in mirror._fields_]
