"""The port's ray cast (mjlab_tpu_torch/phys/ray.py raycast) against the
JAX package's (mjlab_tpu/phys/ray.py) on seeded random rays, one model per
geom type: a plane, a sphere, a capsule and a box (solid), a cylinder and
an ellipsoid (transparent in both packages). Each geom stands at a seeded
random pose per env (the frames given to both packages as the same
arrays); the rays start around it and aim near its centre (about half of
them hit), start inside it (every solid one hits, at its exit), or skip
it as the excluded body (every one misses, -1).

At float64 every distance within 1e-9 relative (to max(1, |JAX|max)); at
float32, both packages at float32, the same rays hit and each distance
agrees within 1e-5 of the larger of the coordinate scale (2 m here) and
the distance itself (a ray almost parallel to the plane travels 64 m: the
float32 rounding of its direction's local z, which it divides by, grows
with the distance); a miss that turned into a hit on a grazing ray would
show as a different hit set.
"""

from types import SimpleNamespace

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.phys import ray as jray
from mjlab_tpu_torch.phys import ray as pray
from mjlab_tpu_torch.phys.model import put_model

from torch_port_common import jax_put_model, rel_err

E = 256
GEOMS = {
    "plane": '<geom type="plane" size="1 1 0.1"/>',
    "sphere": '<geom type="sphere" size="0.3"/>',
    "capsule": '<geom type="capsule" size="0.15 0.4"/>',
    "box": '<geom type="box" size="0.3 0.2 0.45"/>',
    "cylinder": '<geom type="cylinder" size="0.2 0.3"/>',
    "ellipsoid": '<geom type="ellipsoid" size="0.2 0.3 0.4"/>',
}
SOLID = ("plane", "sphere", "capsule", "box")


def _xml(kind: str) -> str:
    # a free body holds the geom (a body of its own to exclude); a world
    # plane would be the world body's
    geom = GEOMS[kind]
    if kind == "plane":
        return f"<mujoco><worldbody>{geom}</worldbody></mujoco>"
    return (f'<mujoco><worldbody><body name="obj"><freejoint/>{geom}</body>'
            "</worldbody></mujoco>")


def _rotations(rs, n):
    q = rs.standard_normal((n, 4))
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    w, x, y, z = q.T
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=1).reshape(n, 3, 3)


def _rays(kind: str, mode: str, seed: int):
    """(geom_xpos (E, 1, 3), geom_xmat (E, 1, 3, 3), pnt (E, 3), vec (E,
    3)) in float64."""
    rs = np.random.default_rng(seed)
    gpos = rs.uniform(-1.0, 1.0, (E, 3))
    gmat = _rotations(rs, E)
    if mode == "inside":
        # a point within a third of the geom's smallest half extent
        pnt = gpos + rs.uniform(-0.05, 0.05, (E, 3))
        if kind == "plane":  # below the plane's surface: rays up leave it
            pnt = gpos - 0.1 * gmat[:, :, 2]
    else:
        pnt = gpos + rs.uniform(-2.0, 2.0, (E, 3))
    aim = gpos + rs.uniform(-0.5, 0.5, (E, 3)) - pnt
    if mode == "inside":
        aim = rs.standard_normal((E, 3))
    vec = aim / np.linalg.norm(aim, axis=1, keepdims=True)
    return gpos[:, None], gmat[:, None], pnt, vec


@pytest.fixture(scope="module")
def models():
    out = {}
    for kind in GEOMS:
        mj = mujoco.MjModel.from_xml_string(_xml(kind))
        with jax.enable_x64(True):
            jm = jax_put_model(mj, dtype=jnp.float64, nconmax=0)
        out[kind] = (jm, put_model(mj, dtype=torch.float64, nconmax=0, device="cpu"),
                     put_model(mj, dtype=torch.float32, nconmax=0, device="cpu"))
    return out


def _cast(models, kind, mode, dtype, seed=0):
    """(JAX distances, port distances) of the rays, both at dtype."""
    jm, pm64, pm32 = models[kind]
    gpos, gmat, pnt, vec = (x.astype(dtype) for x in _rays(kind, mode, seed))
    body = int(jm.geom_bodyid[0])
    exclude = body if mode == "excluded" else -1
    with jax.enable_x64(dtype == np.float64):
        jd = SimpleNamespace(geom_xpos=jnp.asarray(gpos), geom_xmat=jnp.asarray(gmat))
        want = np.asarray(jray.raycast(jm, jd, jnp.asarray(pnt), jnp.asarray(vec), exclude))
    pm = pm64 if dtype == np.float64 else pm32
    pd = SimpleNamespace(geom_xpos=torch.as_tensor(gpos), geom_xmat=torch.as_tensor(gmat))
    got = pray.raycast(pm, pd, torch.as_tensor(pnt), torch.as_tensor(vec), exclude).numpy()
    assert want.dtype == got.dtype == dtype
    return want.astype(np.float64), got.astype(np.float64)


@pytest.mark.parametrize("dtype", [np.float64, np.float32], ids=["f64", "f32"])
@pytest.mark.parametrize("mode", ["outside", "inside", "excluded"])
@pytest.mark.parametrize("kind", list(GEOMS))
def test_raycast_matches_jax(models, kind, mode, dtype):
    want, got = _cast(models, kind, mode, dtype)
    hit = want >= 0
    np.testing.assert_array_equal(hit, got >= 0, err_msg="hit sets differ")
    assert np.all(got[~hit] == -1.0)
    if dtype == np.float64:
        assert rel_err(want, got) < 1e-9, rel_err(want, got)
    else:
        assert (np.abs(want - got) < 1e-5 * np.maximum(2.0, np.abs(want))).all()
    if mode == "excluded" or kind not in SOLID:
        assert not hit.any()  # skipped, or transparent
    elif mode == "inside":
        assert hit.all() if kind != "plane" else hit.mean() > 0.4
    else:
        assert hit.mean() > 0.2 and not hit.all(), hit.mean()  # hits and misses


def test_raycast_takes_the_nearest_geom():
    """Two solid geoms along the same rays: the distance is the nearer
    surface's, in both packages; excluding the nearer body leaves the
    farther."""
    xml = ('<mujoco><worldbody><geom type="plane" size="5 5 0.1"/>'
           '<body name="a" pos="0 0 1"><geom type="sphere" size="0.2"/></body>'
           '<body name="b" pos="0 0 2"><geom type="box" size="0.3 0.3 0.1"/></body>'
           "</worldbody></mujoco>")
    mj = mujoco.MjModel.from_xml_string(xml)
    d = mujoco.MjData(mj)
    mujoco.mj_forward(mj, d)
    rs = np.random.default_rng(5)
    pnt = np.concatenate([rs.uniform(-0.05, 0.05, (E, 2)), np.full((E, 1), 3.0)], axis=1)
    vec = np.tile([0.0, 0.0, -1.0], (E, 1))
    gpos = np.broadcast_to(d.geom_xpos, (E,) + d.geom_xpos.shape).copy()
    gmat = np.broadcast_to(d.geom_xmat.reshape(-1, 3, 3), (E, mj.ngeom, 3, 3)).copy()
    with jax.enable_x64(True):
        jm = jax_put_model(mj, dtype=jnp.float64, nconmax=0)
    pm = put_model(mj, dtype=torch.float64, nconmax=0, device="cpu")
    for exclude in (-1, 2, 1):
        with jax.enable_x64(True):
            jd = SimpleNamespace(geom_xpos=jnp.asarray(gpos), geom_xmat=jnp.asarray(gmat))
            want = np.asarray(jray.raycast(jm, jd, jnp.asarray(pnt), jnp.asarray(vec), exclude))
        pd = SimpleNamespace(geom_xpos=torch.as_tensor(gpos), geom_xmat=torch.as_tensor(gmat))
        got = pray.raycast(pm, pd, torch.as_tensor(pnt), torch.as_tensor(vec), exclude).numpy()
        assert rel_err(want, got) < 1e-9
        # the box's top at z 2.1; the sphere's top near z 1.2
        expect = 0.9 if exclude != 2 else 3.0 - (1.0 + np.sqrt(0.04 - (pnt[:, :2] ** 2).sum(1)))
        np.testing.assert_allclose(got, expect, atol=1e-12)
