"""The port's contact stack against JAX at f64: narrowphase (collision_lm),
per-slot parameters (slot_params) and the kernel-mode constraint rows
(make_constraint_lm with assemble_j=False in the JAX package), on the G1,
the toy with a capsule foot and with a box foot (plane-box), the elliptic
toy (condim 3 and 6, a joint equality) and the YAM lift-cube model
(plane-box, sphere-box, capsule-box and box-box, condim 6 fingertips,
elliptic cone, a joint equality, a mocap base).

Both sides read the same geom frames (the port's kin_com at f64, itself
held against JAX in test_torch_stages.py). Float outputs agree within 1e-9
relative (scale max(1, |ref|max)); the top-K compaction (con_sel), its
activity and the per-slot contact flags are exactly equal, ties included.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mjlab_tpu.phys.lm import collision as jcol
from mjlab_tpu.phys.lm import constraint as jcon
from mjlab_tpu.phys.lm.base import Params as JParams
from mjlab_tpu_torch.phys import smooth_kernels as sk
from mjlab_tpu_torch.phys.lm import collision as pcol
from mjlab_tpu_torch.phys.lm import constraint as pcon
from mjlab_tpu_torch.phys.lm.base import Params

from torch_port_common import (
    G1_NCONMAX, TOY_NCONMAX, YAM_NCONMAX, ell_mj, g1_mj, model_pair,
    rel_err, state_np, tnp, toy_mj, yam_mj, yam_states,
)


def _g1_states(mj, m, E):
    """Keyframe states lowered into the ground (feet and hands in contact),
    the first two envs noise-free so mirrored contacts tie exactly."""
    q, v, c = state_np(mj, E, keyframe=True, qpos_noise=0.05, qvel_noise=0.5)
    base = np.asarray(mj.key_qpos[0], np.float64)
    q[:2] = base
    v[:2] = 0.0
    q[:, 2] -= np.linspace(0.0, 0.12, E)
    return q, v, None


def _toy_states(mj, m, E):
    q, v, c = state_np(mj, E, qpos_noise=0.05)
    q[:, 2] -= np.linspace(0.0, 0.04, E)
    return q, v, None


def _yam_states(mj, m, E):
    """Half the envs at the reset state (the cube on the table), half
    pinching the cube; mocap frames env-last."""
    q, v, _, mp, mq = yam_states(m, E)
    return q, v, tuple(
        torch.as_tensor(np.ascontiguousarray(np.moveaxis(x, 0, -1)))
        for x in (mp, mq)
    )


CASES = {
    "toy": (toy_mj, TOY_NCONMAX, _toy_states),
    "g1": (g1_mj, G1_NCONMAX, _g1_states),
    "toy_box": (lambda: toy_mj(capsule=False), TOY_NCONMAX, _toy_states),
    "ell_toy": (ell_mj, TOY_NCONMAX, _toy_states),
    "yam": (yam_mj, YAM_NCONMAX, _yam_states),
}

# kernel-mode outputs compared as floats / exactly; the friction inputs
# per cone
FLOAT_KEYS = (
    "efc_D", "efc_aref", "efc_fl", "efc_Jeq", "efc_lim_side", "efc_pos",
    "efc_margin", "con_Dc", "con_bb", "con_kimp", "con_W1", "con_W2",
    "con_O1", "con_O2", "con_dist_k", "con_pos_k", "con_frame_k",
    "con_mu_k", "con_dim_k", "con_solref_k", "con_solimp_k", "con_margin_k",
)
CONE_KEYS = (("con_mu_dirs",), ("con_Dfri", "con_mut"))
EXACT_KEYS = ("con_sel", "con_sel_active", "con_on", "efc_active")


def _run_both(name, E=16):
    make, nconmax, states = CASES[name]
    mj = make()
    with jax.enable_x64(True):
        jm, m = model_pair(mj, nconmax, np.float64)
        q, v, mocap = states(mj, m, E)
        qT = torch.as_tensor(np.ascontiguousarray(q.T))
        vT = torch.as_tensor(np.ascontiguousarray(v.T))
        gxpos, gxmat, subcom, *_ = sk.kin_com(m, qT, *(mocap or ()))
        cg = list(sk.collision_geoms(m))
        gx = torch.zeros(m.ngeom, 3, E, dtype=torch.float64)
        gm = torch.zeros(m.ngeom, 9, E, dtype=torch.float64)
        gx[cg] = gxpos
        gm[cg] = gxmat

        # port
        P = Params(m, E)
        kp = pcol.collision_lm(m, P, gx, gm, {"subtree_com": subcom})
        kp = pcon.make_constraint_lm(
            m, P, kp, tuple(qT), tuple(vT), torch.float64
        )
        sp = pcol.slot_params(m, P, torch.float64)

        # JAX, on the same frames
        JP = JParams(jm, frozenset(), E)
        gxn, gmn, scn = gx.numpy(), gm.numpy(), subcom.numpy()
        kj = {
            "geom_xpos": [tuple(jnp.asarray(gxn[g, c]) for c in range(3))
                          for g in range(m.ngeom)],
            "geom_xmat": [tuple(jnp.asarray(gmn[g, c]) for c in range(9))
                          for g in range(m.ngeom)],
            "subtree_com": [tuple(jnp.asarray(scn[b, c]) for c in range(3))
                            for b in range(m.nbody)],
        }
        kj = jcol.collision_lm(jm, JP, kj, jnp.float64)
        qj = tuple(jnp.asarray(q[:, i]) for i in range(m.nq))
        vj = tuple(jnp.asarray(v[:, i]) for i in range(m.nv))
        kj = jcon.make_constraint_lm(
            jm, JP, kj, qj, vj, jnp.float64, assemble_j=False
        )
        sj = jcol.slot_params(jm, JP, jnp.float64)
        kj = {k: np.asarray(x) for k, x in kj.items()
              if not isinstance(x, (list, tuple))}
        sj = [np.asarray(x) for x in sj]
    return m, kp, kj, sp, sj


@pytest.mark.parametrize("name", ["toy", "g1", "toy_box", "ell_toy"])
def test_contact_stack_matches_jax_f64(name):
    """(tests/test_torch_yam.py runs the YAM case.)"""
    check_contact_stack(*_run_both(name))


def check_contact_stack(m, kp, kj, sp, sj):
    # narrowphase
    for key in ("con_dist", "con_pos", "con_frame"):
        assert kj[key].shape == tuple(kp[key].shape), key
        assert rel_err(kj[key], tnp(kp[key])) < 1e-9, key
    # slot parameters (shared by every env)
    for a, b in zip(sj, sp):
        np.testing.assert_allclose(np.asarray(a, np.float64), tnp(b), rtol=1e-12, atol=0)
    # contact flags per slot: dist < includemargin
    found_j = kj["con_dist"] < sj[3]
    found_p = (kp["con_dist"] < sp[3]).numpy()
    np.testing.assert_array_equal(found_j, found_p)
    assert found_p.any(), "the states must touch"
    # kernel-mode rows and the compacted slot record
    for key in EXACT_KEYS:
        np.testing.assert_array_equal(
            kj[key], kp[key].numpy().astype(kj[key].dtype), err_msg=key
        )
    for key in FLOAT_KEYS + CONE_KEYS[int(m.opt.cone)]:
        assert kj[key].shape == tuple(kp[key].shape), key
        assert rel_err(kj[key], tnp(kp[key])) < 1e-9, key
    assert kp["con_sel_active"].any()


def test_g1_ties_keep_jax_slot_order():
    """Noise-free mirrored states give equal scores on left and right
    slots; the compaction must still pick and order them as JAX does."""
    m, kp, kj, _, _ = _run_both("g1", E=4)
    score = kj["con_dist"][:, 0]
    act = score[score < 0.05]
    assert len(act) != len(np.unique(act)), "the noise-free env has ties"
    np.testing.assert_array_equal(kj["con_sel"], kp["con_sel"].numpy())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_topk_lowest_matches_lax_top_k_on_ties(seed):
    rng = np.random.default_rng(seed)
    S, E, K = 60, 32, 12
    # few distinct values: many ties, also across the K-th place
    score = rng.integers(-3, 4, size=(S, E)).astype(np.float64) * 0.5
    score[:, 0] = 0.0
    with jax.enable_x64(True):
        neg, selT = jax.lax.top_k(-(jnp.asarray(score).T), K)
    vals, sel = pcon.topk_lowest(torch.as_tensor(score), K)
    np.testing.assert_array_equal(np.asarray(selT).T, sel.numpy())
    np.testing.assert_array_equal(-np.asarray(neg).T, vals.numpy())


CYLINDER_XML = """
<mujoco>
  <worldbody>
    <geom type="plane" size="1 1 0.1"/>
    <body pos="0 0 0.3"><freejoint/><geom type="cylinder" size="0.05 0.1"/></body>
  </worldbody>
</mujoco>
"""


def test_collision_raises_on_missing_family():
    """A family of the engine's pair catalog the port does not carry (plane
    against a cylinder; the height-field families are carried since the
    rough-terrain slice, tests/test_torch_hfield.py)."""
    import mujoco

    mj = mujoco.MjModel.from_xml_string(CYLINDER_XML)  # the plane-cylinder family
    from mjlab_tpu_torch.phys.model import put_model

    m = put_model(mj, dtype=torch.float64, nconmax=TOY_NCONMAX, device="cpu")
    E = 2
    P = Params(m, E)
    gx = torch.zeros(m.ngeom, 3, E, dtype=torch.float64)
    gm = torch.zeros(m.ngeom, 9, E, dtype=torch.float64)
    with pytest.raises(NotImplementedError, match="not ported"):
        pcol.collision_lm(m, P, gx, gm, {})
