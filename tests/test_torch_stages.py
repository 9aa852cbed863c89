"""The port's smooth-stage kernels (plain PyTorch versions) against JAX.

kin_com, crb_packed + qm_dense_cm and vel_smooth of
mjlab_tpu_torch.phys.smooth_kernels run their plain versions on CPU tensors
(phys/lm/stages.py). They are held against:

- at f64, the JAX package's lm/stages.py functions composed as the Pallas
  kernels compose them (smooth_pallas.py kin_com/crb_packed/vel_smooth
  bodies, model constants as host floats), within 1e-9;
- at f32, the vmapped stages (phys/kinematics.py, phys/smooth.py), with the
  tolerances of tests/test_smooth_pallas.py: 2e-6 on frames, com, cdof and
  cinert, 5e-6 on the mass matrix and the velocity-stage outputs (the same
  formulas in another association order: a few f32 ulps of the scale).

Scale of every relative error: max(1, |reference|max).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_tpu.phys.forward as fwd
from mjlab_tpu.phys import smooth
from mjlab_tpu.phys.data import make_data as jax_make_data
from mjlab_tpu.phys.kinematics import com_pos, kinematics
from mjlab_tpu.phys.lm import stages as jst
from mjlab_tpu.phys.smooth_pallas import SYM6, HostParams
from mjlab_tpu.sim.sim import model_in_axes
from mjlab_tpu_torch.phys import smooth_kernels as sk

from torch_port_common import (
    G1_NCONMAX, TOY_NCONMAX, g1_mj, model_pair, rel_err, state_np, tnp,
    toy_mj,
)

CASES = {
    "toy": (toy_mj, TOY_NCONMAX, False),
    "g1": (g1_mj, G1_NCONMAX, True),
}


def _inputs(mj, E, dtype, keyframe, seed=0):
    q, v, c = state_np(mj, E, seed=seed, dtype=dtype, keyframe=keyframe)
    rng = np.random.default_rng(seed + 1)
    xfrc = (0.1 * rng.standard_normal((E, mj.nbody, 6))).astype(dtype)
    qfa = (0.1 * rng.standard_normal((E, mj.nv))).astype(dtype)
    return q, v, c, xfrc, qfa


def _planes(x):
    """(E, n) numpy -> tuple of n (E,) jnp planes."""
    return tuple(jnp.asarray(x[:, i]) for i in range(x.shape[1]))


def _st(planes, E):
    return np.stack([np.broadcast_to(np.asarray(p, np.float64), (E,)) for p in planes])


def _jax_smooth_f64(jm, q, v, c, xfrc, qfa):
    """The Pallas kernels' arithmetic with JAX lm stages on (E,) planes:
    returns (kin_com outputs, qM pairs, vel_smooth outputs) as numpy."""
    E = q.shape[0]
    P = HostParams(jm, E)
    cg = sk.collision_geoms(jm)
    qp, vp, cp = _planes(q), _planes(v), _planes(c)
    k = jst.kinematics_lm(jm, P, qp, [], [], geoms=cg, sites=())
    k = jst.com_pos_lm(jm, P, k)
    kin = dict(
        gxpos=np.stack([_st(k["geom_xpos"][g], E) for g in cg]),
        gxmat=np.stack([_st(k["geom_xmat"][g], E) for g in cg]),
        subcom=np.stack([_st(x, E) for x in k["subtree_com"]]),
        cdof=np.stack([_st(x, E) for x in k["cdof"]]),
        cinA=np.stack([_st([ci["A"][ij] for ij in SYM6], E) for ci in k["cinert"]]),
        cinc=np.stack([_st(ci["c"], E) for ci in k["cinert"]]),
        xipos=np.stack([_st(x, E) for x in k["xipos"]]),
        xpos=np.stack([_st(x, E) for x in k["xpos"]]),
        xquat=np.stack([_st(x, E) for x in k["xquat"]]),
    )
    k = jst.crb_lm(jm, P, k)
    from mjlab_tpu.phys.smooth_pallas import _crb_pairs

    qM_pairs = np.stack([
        np.broadcast_to(np.asarray(k["qM"][ij], np.float64), (E,))
        for ij in _crb_pairs(jm)
    ])

    grav3 = tuple(float(g) for g in np.asarray(jm.opt.gravity))
    h = float(np.asarray(jm.opt.timestep))
    k = jst.com_vel_lm(jm, P, k, vp)
    k = jst.rne_lm(jm, P, k, vp, grav3)
    k = jst.passive_lm(jm, P, k, qp, vp)
    k = jst.actuation_lm(jm, P, k, qp, vp, cp)
    xf = [tuple(jnp.asarray(xfrc[:, b, i]) for i in range(6)) for b in range(jm.nbody)]
    qfx = jst.xfrc_lm(jm, P, k, xf)
    qfs = [
        k["qfrc_passive"][i] - k["qfrc_bias"][i] + k["qfrc_actuator"][i]
        + jnp.asarray(qfa[:, i]) + qfx[i]
        for i in range(jm.nv)
    ]
    zero = jnp.zeros((E,), q.dtype)
    diag = [zero + h * P.plane("dof_damping", i) for i in range(jm.nv)]
    dfdv = jst.actuator_vel_deriv_lm(jm, P, cp, k["actuator_force"])
    for u in range(jm.nu):
        if dfdv[u] is None:
            continue
        vadr = int(jm.jnt_dofadr[int(jm.actuator_trnid[u, 0])])
        gear = P.plane("actuator_gear", u, 0)
        diag[vadr] = diag[vadr] - h * dfdv[u] * gear * gear
    vel = dict(
        qfs=_st(qfs, E), afrc=_st(k["actuator_force"], E),
        avel=_st(k["actuator_velocity"], E), diag=_st(diag, E),
    )
    return kin, qM_pairs, vel


def _port_smooth(m, q, v, c, xfrc, qfa):
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))  # noqa: E731
    qT = t(q.T)
    outs = sk.kin_com(m, qT)
    names = ("gxpos", "gxmat", "subcom", "cdof", "cinA", "cinc", "xipos",
             "xpos", "xquat")
    kin = dict(zip(names, outs))
    qM_pairs = sk.crb_packed(m, kin["cdof"], kin["cinA"], kin["cinc"])
    xq = (kin["subcom"], kin["xipos"], t(np.moveaxis(xfrc, 0, -1)), t(qfa.T))
    qfs, afrc, avel, diag = sk.vel_smooth(
        m, qT, t(v.T), t(c.T), kin["cdof"], kin["cinA"], kin["cinc"], xq
    )
    vel = dict(qfs=qfs, afrc=afrc, avel=avel, diag=diag)
    return kin, qM_pairs, vel


@pytest.mark.parametrize("name", ["toy", "g1"])
def test_smooth_kernels_plain_match_jax_stages_f64(name):
    make, nconmax, keyframe = CASES[name]
    mj = make()
    E = 8
    with jax.enable_x64(True):
        jm, m = model_pair(mj, nconmax, np.float64)
        args = _inputs(mj, E, np.float64, keyframe)
        kin_r, qm_r, vel_r = _jax_smooth_f64(jm, *args)
    kin, qm, vel = _port_smooth(m, *args)
    for key, ref in kin_r.items():
        assert rel_err(ref, tnp(kin[key])) < 1e-9, key
    assert rel_err(qm_r, tnp(qm)) < 1e-9, "qM pairs"
    for key, ref in vel_r.items():
        assert rel_err(ref, tnp(vel[key])) < 1e-9, key


def _vmapped(jm, d, fns):
    axes = model_in_axes(jm, frozenset())
    for fn in fns:
        d = jax.jit(jax.vmap(fn, in_axes=(axes, 0)))(jm, d)
    return d


def _jax_state(jm, q, v, c, xfrc, qfa):
    E = q.shape[0]
    d0 = jax_make_data(jm, dtype=jnp.float32)
    dB = jax.tree_util.tree_map(lambda x: jnp.broadcast_to(x, (E,) + x.shape), d0)
    return dB.replace(
        qpos=jnp.asarray(q), qvel=jnp.asarray(v), ctrl=jnp.asarray(c),
        xfrc_applied=jnp.asarray(xfrc), qfrc_applied=jnp.asarray(qfa),
    )


@pytest.mark.parametrize("name", ["toy", "g1"])
def test_smooth_kernels_plain_match_vmapped_f32(name):
    make, nconmax, keyframe = CASES[name]
    mj = make()
    E = 16
    jm, m = model_pair(mj, nconmax, np.float32)
    args = _inputs(mj, E, np.float32, keyframe, seed=2)
    d = _jax_state(jm, *args)
    ref = _vmapped(
        jm, d,
        [kinematics, com_pos, smooth.crb, smooth.transmission,
         smooth.com_vel, smooth.rne, smooth.passive, smooth.fwd_actuation],
    )
    axes = model_in_axes(jm, frozenset())

    def accum(mm, dd):
        qfs = (dd.qfrc_passive - dd.qfrc_bias + dd.qfrc_actuator
               + dd.qfrc_applied + smooth.xfrc_accumulate(mm, dd))
        return dd.replace(qfrc_smooth=qfs)

    ref = jax.jit(jax.vmap(accum, in_axes=(axes, 0)))(jm, ref)
    Mh = jax.jit(jax.vmap(fwd.integrator_mh, in_axes=(axes, 0)))(jm, ref)

    kin, qm, vel = _port_smooth(m, *args)
    ev = lambda x: np.moveaxis(np.asarray(x), 0, -1)  # noqa: E731
    cg = sk.collision_geoms(m)
    assert rel_err(ev(ref.geom_xpos)[list(cg)], tnp(kin["gxpos"])) < 2e-6
    assert rel_err(
        ev(np.asarray(ref.geom_xmat).reshape(E, -1, 9))[list(cg)],
        tnp(kin["gxmat"]),
    ) < 2e-6
    for key, fld in (("subcom", "subtree_com"), ("cdof", "cdof"),
                     ("xipos", "xipos"), ("xpos", "xpos"), ("xquat", "xquat")):
        assert rel_err(ev(getattr(ref, fld)), tnp(kin[key])) < 2e-6, key
    ci = np.asarray(ref.cinert)  # (E, nb, 6, 6)
    for s, (i, j) in enumerate(SYM6):
        assert rel_err(ci[:, :, i, j].T, tnp(kin["cinA"])[:, s]) < 2e-6
    mass = np.asarray(jm.body_mass)
    # the c offsets of bodies with mass: cinert's B block is m skew(c)
    heavy = mass > 1e-12
    cz = -ci[:, :, 0, 4] / np.where(heavy, mass, 1.0)
    assert rel_err(cz.T[heavy], tnp(kin["cinc"])[heavy, 2]) < 2e-6

    qM_cm = sk.qm_dense_cm(m, qm)
    assert rel_err(ev(ref.qM).reshape(-1, E), tnp(qM_cm)) < 5e-6
    assert rel_err(np.asarray(ref.qfrc_smooth).T, tnp(vel["qfs"])) < 5e-6
    assert rel_err(np.asarray(ref.actuator_force).T, tnp(vel["afrc"])) < 5e-6
    assert rel_err(np.asarray(ref.actuator_velocity).T, tnp(vel["avel"])) < 5e-6
    ref_diag = (np.einsum("eii->ie", np.asarray(Mh))
                - np.einsum("eii->ie", np.asarray(ref.qM)))
    assert rel_err(ref_diag, tnp(vel["diag"])) < 5e-6


def test_crb_pairs_and_dense_layout_match_jax():
    """The packed-pair order and the dense scatter are the JAX ones."""
    from mjlab_tpu.phys.smooth_pallas import _crb_pairs, qm_dense_cm

    mj = g1_mj()
    jm, m = model_pair(mj, G1_NCONMAX, np.float32)
    assert sk._crb_pairs(m) == _crb_pairs(jm)
    assert len(sk._crb_pairs(m)) == 341
    assert sk.collision_geoms(m) == sk.collision_geoms(jm)
    assert len(sk.collision_geoms(m)) == 34
    E = 4
    pairs = np.random.default_rng(0).standard_normal((341, E)).astype(np.float32)
    np.testing.assert_array_equal(
        np.asarray(qm_dense_cm(jm, jnp.asarray(pairs))),
        sk.qm_dense_cm(m, torch.as_tensor(pairs)).numpy(),
    )


def test_integrate_envlast_matches_jax():
    from mjlab_tpu.phys.smooth_pallas import integrate_envlast

    mj = g1_mj()
    jm, m = model_pair(mj, G1_NCONMAX, np.float32)
    E = 16
    q, v, _ = state_np(mj, E, keyframe=True, dtype=np.float32)
    rng = np.random.default_rng(5)
    a = (10 * rng.standard_normal((E, mj.nv))).astype(np.float32)
    a[3, 4] = np.inf  # a diverged env is re-seeded at qpos0
    ref = integrate_envlast(jm, jnp.asarray(q.T), jnp.asarray(v.T), jnp.asarray(a.T))
    got = sk.integrate_envlast(
        m, torch.as_tensor(q.T.copy()), torch.as_tensor(v.T.copy()),
        torch.as_tensor(a.T.copy()),
    )
    for r, g in zip(ref, got):
        np.testing.assert_allclose(np.asarray(r, np.float64), tnp(g), rtol=0, atol=2e-6)
    assert bool(got[2][3]) and int(got[2].sum()) == 1
