"""The port's height-field narrowphase (mjlab_tpu_torch/phys/lm/
collision.py: hfield-sphere, hfield-capsule, hfield-box) against the JAX
package.

- Random poses of a sphere, a capsule and a box over a generated terrain
  (pyramid stairs up and down, a sloped pyramid, waves, random uniform
  noise) through both packages' env-last collision_lm at float64: every
  slot's distance, position and frame within 1e-9 relative (scale max(1,
  |JAX|max)), the same geom frames in (the port's kin_com at float64).
- The float32 edges: points on and past all four edges of the height
  field through the port's sampler against the JAX package's vmapped
  _hfield_sample (each index clamped on its own axis) within 1e-6 relative
  (a few float32 ulps: the two round the same formula), all finite; the
  JAX package's env-last gather differs there in the gradient (it wraps to
  the next row at the +x edge), which the last case shows.
- The box family's tie order: a box flat on a flat patch, its four bottom
  corners tied, in the slots JAX's top_k gives them (lower corner first).
- The rest states of tests/test_terrains.py (a sphere, a capsule and a box
  resting on a flat height field, a sphere on a plateau, a sphere rolling
  off a slope) through the port's Simulation step at float32 (the same
  bounds as that file).
"""

import copy

import jax
import jax.numpy as jnp
import mujoco
import numpy as np
import pytest
import torch

from mjlab_tpu.phys import collision as jvmap
from mjlab_tpu.phys.lm import collision as jcol
from mjlab_tpu.phys.lm.base import Params as JParams
from mjlab_tpu_torch.phys import smooth_kernels as sk
from mjlab_tpu_torch.phys.lm import collision as pcol
from mjlab_tpu_torch.phys.lm.base import Params
from mjlab_tpu_torch.terrains import (
    BoxFlatTerrainCfg, BoxInvertedPyramidStairsTerrainCfg, BoxPyramidStairsTerrainCfg,
    HfPyramidSlopedTerrainCfg, HfRandomUniformTerrainCfg, HfWaveTerrainCfg,
    TerrainGenerator, TerrainGeneratorCfg,
)

from torch_port_common import model_pair, rel_err, tnp

E = 64
NCONMAX = 16
OBJECTS = """
<body name="ball" pos="0 0 1"><freejoint/>
  <geom type="sphere" size="0.07" contype="0" conaffinity="1"/></body>
<body name="rod" pos="0 0 1"><freejoint/>
  <geom type="capsule" size="0.04 0.15" contype="0" conaffinity="1"/></body>
<body name="brick" pos="0 0 1"><freejoint/>
  <geom type="box" size="0.12 0.08 0.05" contype="0" conaffinity="1"/></body>
"""


def terrain_cfg(sub_terrains, seed=0, rows=2, cols=3):
    return TerrainGeneratorCfg(size=(4.0, 4.0), border_width=1.0, num_rows=rows,
                               num_cols=cols, seed=seed, curriculum=True,
                               sub_terrains=sub_terrains)


MIXED = {
    "stairs": BoxPyramidStairsTerrainCfg(proportion=0.2, step_height_range=(0.05, 0.15),
                                         step_width=0.3, platform_width=1.0,
                                         border_width=0.25),
    "stairs_inv": BoxInvertedPyramidStairsTerrainCfg(
        proportion=0.2, step_height_range=(0.05, 0.15), step_width=0.3,
        platform_width=1.0, border_width=0.25),
    "slope": HfPyramidSlopedTerrainCfg(proportion=0.2, slope_range=(0.2, 0.4)),
    "wave": HfWaveTerrainCfg(proportion=0.2, amplitude_range=(0.1, 0.2)),
    "noise": HfRandomUniformTerrainCfg(proportion=0.2, noise_range=(0.02, 0.1)),
}


def terrain_mj(gen: TerrainGenerator) -> mujoco.MjModel:
    """The generator's height field (geom 0, contype 1, conaffinity 0) and
    the three free objects, which touch only the terrain."""
    spec = mujoco.MjSpec.from_string(f"<mujoco><worldbody>{OBJECTS}</worldbody></mujoco>")
    gen.compile(spec)
    for g in spec.geoms:
        if g.type == mujoco.mjtGeom.mjGEOM_HFIELD:
            g.contype, g.conaffinity = 1, 0
    return spec.compile()


def poses(mj, gen, seed):
    """E envs: each object at a random xy inside the terrain, its centre
    between 0.1 m below and 0.15 m above the terrain there, a random
    orientation."""
    rng = np.random.default_rng(seed)
    q = np.tile(mj.qpos0, (E, 1))
    for b in range(3):
        a = 7 * b
        x = rng.uniform(gen.x_min + 0.5, gen.x_max - 0.5, E)
        y = rng.uniform(gen.y_min + 0.5, gen.y_max - 0.5, E)
        i = np.round((x - gen.x_min) / gen.cfg.resolution).astype(int)
        j = np.round((y - gen.y_min) / gen.cfg.resolution).astype(int)
        z = gen.heights[i, j] + rng.uniform(-0.1, 0.15, E)
        quat = rng.standard_normal((E, 4))
        q[:, a:a + 3] = np.stack([x, y, z], 1)
        q[:, a + 3:a + 7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    return q


def frames(m, q):
    """Geom frames (ngeom, 3, E), (ngeom, 9, E) from the port's kin_com."""
    qT = torch.as_tensor(np.ascontiguousarray(q.T))
    gxpos, gxmat, *_ = sk.kin_com(m, qT)
    cg = list(sk.collision_geoms(m))
    gx = torch.zeros(m.ngeom, 3, q.shape[0], dtype=qT.dtype)
    gm = torch.zeros(m.ngeom, 9, q.shape[0], dtype=qT.dtype)
    gx[cg] = gxpos
    gm[cg] = gxmat
    return gx, gm


def both(mj, q, dtype=np.float64):
    """(port collision_lm outputs, JAX collision_lm outputs) on the geom
    frames of q."""
    with jax.enable_x64(dtype == np.float64):
        jm, m = model_pair(mj, NCONMAX, dtype)
        gx, gm = frames(m, q.astype(dtype))
        n = q.shape[0]
        kp = pcol.collision_lm(m, Params(m, n), gx, gm, {})
        gxn, gmn = gx.numpy(), gm.numpy()
        kj = {"geom_xpos": [tuple(jnp.asarray(gxn[g, c]) for c in range(3))
                            for g in range(m.ngeom)],
              "geom_xmat": [tuple(jnp.asarray(gmn[g, c]) for c in range(9))
                            for g in range(m.ngeom)]}
        kj = jcol.collision_lm(jm, JParams(jm, frozenset(), n), kj, jnp.dtype(dtype))
        kj = {k: np.asarray(kj[k]) for k in ("con_dist", "con_pos", "con_frame")}
    return m, kp, kj


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_hfield_families_match_jax_f64(seed):
    """The three families over stairs, slopes, waves and noise at float64:
    1e-9."""
    gen = TerrainGenerator(terrain_cfg(copy.deepcopy(MIXED), seed=seed))
    mj = terrain_mj(gen)
    m, kp, kj = both(mj, poses(mj, gen, seed))
    fams = pcol.pair_families(m)
    assert fams == {(1, 2), (1, 3), (1, 6)}, fams
    assert m.pairs.ncon == 1 + 2 + 4
    for key in ("con_dist", "con_pos", "con_frame"):
        assert kj[key].shape == tuple(kp[key].shape), key
        assert rel_err(kj[key], tnp(kp[key])) < 1e-9, (key, rel_err(kj[key], tnp(kp[key])))
    touching = (kj["con_dist"] < 0).mean()
    assert 0.05 < touching < 0.95, touching  # the poses straddle the surface


def edge_points(gen):
    """Local (x, y) points on, just inside and past each edge of the height
    field, with interior coordinates for the other axis."""
    sx, sy = (gen.x_max - gen.x_min) / 2, (gen.y_max - gen.y_min) / 2
    xs = np.array([-sx - 1.0, -sx, -sx + 1e-3, -0.37, 0.41, sx - 1e-3, sx, sx + 1e-4,
                   sx + 2.0])
    ys = np.array([-sy - 1.0, -sy, -sy + 1e-3, -0.53, 0.29, sy - 1e-3, sy, sy + 1e-4,
                   sy + 2.0])
    xx, yy = np.meshgrid(xs, ys, indexing="ij")
    return xx.ravel(), yy.ravel()


def test_hfield_edges_f32_match_the_vmapped_sampler():
    """At float32 a point at or past the +x or +y edge samples with its
    index clamped on its own axis, as the vmapped JAX sampler does; no
    gather leaves the table; height and gradient within 1e-6."""
    gen = TerrainGenerator(terrain_cfg(copy.deepcopy(MIXED), seed=4))
    mj = terrain_mj(gen)
    jm, m = model_pair(mj, NCONMAX, np.float32)
    lx, ly = (x.astype(np.float32) for x in edge_points(gen))
    got = pcol._hfield_sample(m, torch.as_tensor(lx), torch.as_tensor(ly))
    want = jvmap._hfield_sample(jm, jnp.asarray(lx), jnp.asarray(ly))
    for name, w, g in zip(("h", "dhdx", "dhdy"), want, got):
        assert np.isfinite(tnp(g)).all(), name
        assert rel_err(np.asarray(w), tnp(g)) < 1e-6, (name, rel_err(np.asarray(w), tnp(g)))
    # at the +x edge the f32 clip lands on ncol - 1 exactly, where the
    # height is the last column's
    nc = m.hfield_ncol
    assert np.float32((lx.max() / np.float32(m.hfield_size[0, 0]) + 1) * 0.5 * (nc - 1)) \
        >= np.float32(nc - 1.000001) == np.float32(nc - 1)


def test_hfield_edges_f32_through_collision_lm():
    """Objects on and past the four edges through the port's collision_lm at
    float32: finite, and the sphere's distance equal to the vmapped JAX
    engine's (within 1e-5 of the terrain's height scale)."""
    gen = TerrainGenerator(terrain_cfg(copy.deepcopy(MIXED), seed=5))
    mj = terrain_mj(gen)
    lx, ly = edge_points(gen)
    n = len(lx)
    q = np.tile(mj.qpos0, (n, 1))
    for b in range(3):
        q[:, 7 * b] = lx
        q[:, 7 * b + 1] = ly
        q[:, 7 * b + 2] = 0.05
    jm, m = model_pair(mj, NCONMAX, np.float32)
    gx, gm = frames(m, q.astype(np.float32))
    kp = pcol.collision_lm(m, Params(m, n), gx, gm, {})
    for key in ("con_dist", "con_pos", "con_frame"):
        assert torch.isfinite(kp[key]).all(), key
    # the sphere (slot 0) against the vmapped engine's _hfield_sphere
    hf, ball = (int(np.flatnonzero(m.geom_type == t)[0]) for t in (1, 2))
    dist, pos, frame = jvmap._hfield_sphere(
        jm, jnp.asarray(gx[hf].T.numpy()), jnp.asarray(gm[hf].T.numpy().reshape(n, 3, 3)),
        None, jnp.asarray(gx[ball].T.numpy()), None,
        jnp.asarray(np.full((n, 3), 0.07, np.float32)))
    assert rel_err(np.asarray(dist)[:, 0], tnp(kp["con_dist"][0])) < 1e-5
    assert rel_err(np.asarray(frame)[:, 0].reshape(n, 9), tnp(kp["con_frame"][0]).T) < 1e-5


def test_jax_envlast_gather_wraps_at_the_x_edge():
    """The JAX package's env-last sampler reads the next row's first cell
    as the +x neighbour at ix = ncol - 1 (float32): its x gradient there
    differs from the vmapped sampler's, which the port follows (ROADMAP
    queue 3). Recorded so that the difference stays visible."""
    sub = {"wave": HfWaveTerrainCfg(proportion=1.0, amplitude_range=(0.1, 0.2))}
    cfg = terrain_cfg(sub, seed=6)
    cfg.border_width = 0.0
    gen = TerrainGenerator(cfg)
    mj = terrain_mj(gen)
    jm, m = model_pair(mj, NCONMAX, np.float32)
    sx = (gen.x_max - gen.x_min) / 2
    ly = np.linspace(-3.3, 5.1, 7).astype(np.float32)
    lx = np.full_like(ly, sx)
    port = pcol._hfield_sample(m, torch.as_tensor(lx), torch.as_tensor(ly))
    vmapped = jvmap._hfield_sample(jm, jnp.asarray(lx), jnp.asarray(ly))
    assert rel_err(np.asarray(vmapped[1]), tnp(port[1])) < 1e-6
    # the env-last group on spheres at those points
    n = len(lx)
    q = np.tile(mj.qpos0, (n, 1))
    q[:, 0], q[:, 1], q[:, 2] = lx, ly, 0.0
    gx, gm = frames(m, q.astype(np.float32))
    kj = {"geom_xpos": [tuple(jnp.asarray(gx[g, c].numpy()) for c in range(3))
                        for g in range(m.ngeom)],
          "geom_xmat": [tuple(jnp.asarray(gm[g, c].numpy()) for c in range(9))
                        for g in range(m.ngeom)]}
    kj = jcol.collision_lm(jm, JParams(jm, frozenset(), n), kj, jnp.float32)
    kp = pcol.collision_lm(m, Params(m, n), gx, gm, {})
    hf, ball = (int(np.flatnonzero(m.geom_type == t)[0]) for t in (1, 2))
    _, _, frame = jvmap._hfield_sphere(
        jm, jnp.asarray(gx[hf].T.numpy()), jnp.asarray(gm[hf].T.numpy().reshape(n, 3, 3)),
        None, jnp.asarray(gx[ball].T.numpy()), None,
        jnp.asarray(np.full((n, 3), 0.07, np.float32)))
    vm = np.asarray(frame)[:, 0].reshape(n, 9).T
    # the port's contact frames are the vmapped engine's; the env-last
    # JAX code's normals differ (they read a wrapped neighbour)
    assert rel_err(vm, tnp(kp["con_frame"][0])) < 1e-5
    assert rel_err(vm, np.asarray(kj["con_frame"])[0]) > 1e-3


def test_box_tie_order_on_a_flat_patch():
    """A box lying flat on a flat patch: its four bottom corners tie; the
    port keeps them in the slots JAX's top_k gives (corners 0, 2, 4, 6),
    positions equal to 1e-12."""
    gen = TerrainGenerator(terrain_cfg({"flat": BoxFlatTerrainCfg()}, rows=1, cols=1))
    mj = terrain_mj(gen)
    q = np.tile(mj.qpos0, (4, 1))
    for b, z in enumerate((0.5, 0.5, 0.03)):
        q[:, 7 * b:7 * b + 3] = (0.3 * b, -0.2, z)
        q[:, 7 * b + 3:7 * b + 7] = (1.0, 0.0, 0.0, 0.0)
    q[1:, 14] += np.array([0.1, -0.7, 1.3])  # other xy, still flat
    m, kp, kj = both(mj, q)
    box = slice(3, 7)
    d = tnp(kp["con_dist"][box])
    assert np.all(d == d[0]), "the four bottom corners tie"
    np.testing.assert_allclose(tnp(kp["con_pos"][box]), kj["con_pos"][box], rtol=0, atol=1e-12)
    np.testing.assert_allclose(tnp(kp["con_frame"][box]), kj["con_frame"][box], rtol=0,
                               atol=1e-12)
    # the bottom corners are 0, 2, 4, 6 (z sign bit 0), in that order
    x, y = tnp(kp["con_pos"][box])[:, 0, 0], tnp(kp["con_pos"][box])[:, 1, 0]
    assert np.all(np.diff(x) >= 0) and x[0] < x[2] and y[0] < y[1]


def _drop(geom_xml, h_fn, steps=300):
    """tests/test_terrains.py TestHfieldPhysics._drop through the port's
    Simulation at float32 (the same model, the same 300 steps of
    0.002 s)."""
    from mjlab_tpu_torch.sim.sim import Simulation, SimulationCfg

    xml = f"""
    <mujoco>
      <asset><hfield name="hf" nrow="41" ncol="41" size="2 2 0.5 0.5"/></asset>
      <worldbody>
        <body name="terrain"><geom name="terrain" type="hfield" hfield="hf"/></body>
        <body name="obj" pos="0.1 0.05 1.0"><freejoint/>{geom_xml}</body>
      </worldbody>
    </mujoco>"""
    spec = mujoco.MjSpec.from_string(xml)
    x = np.linspace(-1, 1, 41)
    xx, yy = np.meshgrid(x, x, indexing="ij")
    spec.hfields[0].userdata = h_fn(xx, yy).T.reshape(-1)
    mj = spec.compile()
    cfg = SimulationCfg()
    cfg.mujoco.timestep = float(mj.opt.timestep)
    cfg.mujoco.iterations = int(mj.opt.iterations)
    cfg.mujoco.ls_iterations = int(mj.opt.ls_iterations)
    sim = Simulation(1, cfg, mj, device="cpu")
    for _ in range(steps):
        sim.step()
    q = tnp(sim.data.qpos[0])
    assert np.isfinite(q).all()
    return q


REST_CASES = {
    "sphere_flat": ('<geom name="g" type="sphere" size="0.05" mass="1"/>',
                    lambda xx, yy: np.zeros_like(xx), 0.05, 5e-3),
    "capsule_flat": ('<geom name="g" type="capsule" size="0.03 0.1" mass="1" euler="90 0 0"/>',
                     lambda xx, yy: np.zeros_like(xx), 0.03, 5e-3),
    "box_flat": ('<geom name="g" type="box" size="0.1 0.05 0.02" mass="1"/>',
                 lambda xx, yy: np.zeros_like(xx), 0.02, 5e-3),
    "sphere_plateau": ('<geom name="g" type="sphere" size="0.05" mass="1"/>',
                       lambda xx, yy: ((np.abs(xx) < 0.6) & (np.abs(yy) < 0.6)) * 0.5,
                       0.55, 1e-2),
}


@pytest.mark.parametrize("case", sorted(REST_CASES))
def test_objects_rest_on_hfield(case):
    geom, h_fn, z, tol = REST_CASES[case]
    q = _drop(geom, h_fn)
    assert q[2] == pytest.approx(z, abs=tol)


def test_sphere_rolls_down_slope():
    q = _drop('<geom name="g" type="sphere" size="0.1" mass="1"/>',
              lambda xx, yy: 0.4 * np.clip(1 - np.abs(xx) - 0.5 * np.abs(yy), 0, 1))
    assert abs(q[0]) + abs(q[1]) > 0.3
