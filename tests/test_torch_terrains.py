"""The port's terrains (mjlab_tpu_torch/terrains) against the JAX
package's (mjlab_tpu/terrains).

- Each sub-terrain family's heights and spawn origin, bit for bit, for 3
  seeds and 3 difficulties.
- The generator in curriculum and random modes, bit for bit: the global
  heights, the spawn-origin table and the world extent; the default rough
  config's sizes.
- The importer's init_state, update_env_origins and randomize_env_origins
  (in the form of tests/test_terrains.py TestImporter) with the JAX
  package's draws played back (torch_port_common.JaxDraws): levels, types
  and origins equal; the float32 types of init_state at several env and
  column counts.
- The Model a rough task builds without MuJoCo (its model file with the
  generated height field written in, TerrainImporter.fill_hfield) against
  put_model of a fresh MuJoCo compile of the same scene and seed, field
  for field: the default config cut to 2 x 2, the play variant, and a mix
  of the Hf families.
"""

import copy
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import mjlab_tpu.terrains as jt
import mjlab_tpu_torch.terrains as pt
from mjlab_tpu.terrains.importer import TerrainImporter as JaxImporter
from mjlab_tpu.terrains.importer import TerrainImporterCfg as JaxImporterCfg
from mjlab_tpu_torch.phys import model as pm

from torch_port_common import JaxDraws, ReplayRng

SEEDS = (0, 1, 2)

# the families with their parameters, by class name in both packages
FAMILIES = {
    "BoxFlatTerrainCfg": {},
    "BoxPyramidStairsTerrainCfg": dict(step_height_range=(0.05, 0.2), step_width=0.3,
                                       platform_width=1.0, border_width=0.5),
    "BoxInvertedPyramidStairsTerrainCfg": dict(step_height_range=(0.0, 0.1),
                                               step_width=0.3, platform_width=3.0,
                                               border_width=1.0),
    "BoxRandomGridTerrainCfg": dict(grid_width=0.45, grid_height_range=(0.0, 0.2),
                                    platform_width=1.0),
    "HfPyramidSlopedTerrainCfg": dict(slope_range=(0.1, 0.4), platform_width=1.0,
                                      border_width=0.25),
    "HfRandomUniformTerrainCfg": dict(noise_range=(0.02, 0.1), noise_step=0.02,
                                      border_width=0.25),
    "HfWaveTerrainCfg": dict(amplitude_range=(0.0, 0.2), num_waves=3),
}


def sub(pkg, name, **kw):
    return getattr(pkg, name)(**{**FAMILIES[name], **kw})


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_sub_terrain_matches_jax(name, seed):
    """heights and origin of one patch, bit for bit, at three
    difficulties, each package drawing from its own numpy generator of the
    same seed."""
    j, p = sub(jt, name, size=(8.0, 8.0)), sub(pt, name, size=(8.0, 8.0))
    rj, rp = np.random.default_rng(seed), np.random.default_rng(seed)
    for difficulty in (0.0, 0.37, 1.0):
        a, b = j.function(difficulty, rj), p.function(difficulty, rp)
        assert a.heights.dtype == b.heights.dtype == np.float32
        np.testing.assert_array_equal(a.heights, b.heights)
        np.testing.assert_array_equal(a.origin, b.origin)


def generator_cfg(pkg, seed, curriculum, names=("BoxFlatTerrainCfg",
                                                "BoxPyramidStairsTerrainCfg",
                                                "HfRandomUniformTerrainCfg",
                                                "HfWaveTerrainCfg")):
    subs = {n: sub(pkg, n, proportion=1.0 + i) for i, n in enumerate(names)}
    return pkg.TerrainGeneratorCfg(size=(4.0, 4.0), border_width=2.0, num_rows=3, num_cols=4,
                                   seed=seed, curriculum=curriculum, sub_terrains=subs)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("curriculum", [True, False])
def test_generator_matches_jax(curriculum, seed):
    gj = jt.TerrainGenerator(generator_cfg(jt, seed, curriculum))
    gp = pt.TerrainGenerator(generator_cfg(pt, seed, curriculum))
    np.testing.assert_array_equal(gj.heights, gp.heights)
    np.testing.assert_array_equal(gj.terrain_origins, gp.terrain_origins)
    assert (gj.x_min, gj.x_max, gj.y_min, gj.y_max) == (gp.x_min, gp.x_max, gp.y_min, gp.y_max)
    assert float(np.abs(gp.heights).max()) > 0


def test_rough_terrains_cfg_matches_jax():
    """The default rough terrain at full size: 10 x 20 sub-terrains of 8 m
    and a 20 m border at 0.1 m, one 1201 x 2001 grid, bit for bit."""
    from mjlab_tpu.terrains.config import ROUGH_TERRAINS_CFG as JCFG
    from mjlab_tpu_torch.terrains.config import ROUGH_TERRAINS_CFG as PCFG

    cj, cp = copy.deepcopy(JCFG), copy.deepcopy(PCFG)
    for c in (cj, cp):
        c.seed, c.curriculum = 7, True
    gj, gp = jt.TerrainGenerator(cj), pt.TerrainGenerator(cp)
    assert gp.heights.shape == (1201, 2001)
    np.testing.assert_array_equal(gj.heights, gp.heights)
    np.testing.assert_array_equal(gj.terrain_origins, gp.terrain_origins)
    assert (gp.x_min, gp.x_max, gp.y_min, gp.y_max) == (-60.0, 60.0, -100.0, 100.0)
    hf = gp.hfield()
    assert (hf.nrow, hf.ncol) == (2001, 1201) and hf.data.dtype == np.float32
    assert hf.size[:2] == (60.0, 100.0) and hf.data.min() == 0 and hf.data.max() == 1


def test_world_extent():
    """The grid centred on the world origin with its border, in both
    packages."""
    for pkg in (jt, pt):
        g = pkg.TerrainGenerator(generator_cfg(pkg, 0, True))
        assert (g.x_min, g.x_max) == (-3 * 4.0 / 2 - 2.0, 3 * 4.0 / 2 + 2.0)
        assert (g.y_min, g.y_max) == (-4 * 4.0 / 2 - 2.0, 4 * 4.0 / 2 + 2.0)
        assert g.heights.shape == (3 * 40 + 2 * 20 + 1, 4 * 40 + 2 * 20 + 1)


def importers(num_envs=8, max_init=1, seed=0):
    """(JAX importer with its context, port importer) of one generator
    config (3 rows, 4 columns)."""

    class _Ctx:
        terrain_state = {}

    ctx = _Ctx()
    jimp = JaxImporter(JaxImporterCfg(terrain_type="generator",
                                      terrain_generator=generator_cfg(jt, seed, True),
                                      max_init_terrain_level=max_init), num_envs)
    jimp.initialize(num_envs, ctx)
    pimp = pt.TerrainImporter(pt.TerrainImporterCfg(
        terrain_type="generator", terrain_generator=generator_cfg(pt, seed, True),
        max_init_terrain_level=max_init))
    pimp.initialize(num_envs, torch.device("cpu"))
    return jimp, ctx, pimp


def assert_state_equal(ctx, pimp):
    st = ctx.terrain_state
    np.testing.assert_array_equal(np.asarray(st["levels"]), pimp.levels.numpy())
    np.testing.assert_array_equal(np.asarray(st["types"]), pimp.types.numpy())
    np.testing.assert_array_equal(np.asarray(st["origins"]), pimp.origins.numpy())
    assert pimp.levels.dtype == pimp.types.dtype == torch.int32
    assert pimp.origins.dtype == torch.float32


def test_importer_init_state_matches_jax():
    jimp, ctx, pimp = importers()
    with JaxDraws() as draws:
        ctx.terrain_state = jimp.init_state(8, jax.random.PRNGKey(0))
    pimp.init_state(ReplayRng(draws))
    assert_state_equal(ctx, pimp)
    assert int(pimp.levels.max()) <= 1 and int(pimp.types.max()) <= 3
    np.testing.assert_array_equal(np.asarray(jimp.terrain_origins),
                                  pimp.terrain_origins.numpy())


@pytest.mark.parametrize("mask_kind", ["all", "first", "random"])
def test_importer_update_env_origins_matches_jax(mask_kind):
    """Promotions (past the top row to a random level), demotions (held at
    row 0) and masked envs unchanged, with JAX's draws played back."""
    E = 16
    jimp, ctx, pimp = importers(E, max_init=None)
    rs = np.random.default_rng(3)
    with JaxDraws() as draws:
        ctx.terrain_state = jimp.init_state(E, jax.random.PRNGKey(1))
        for i in range(4):
            mask = {"all": np.ones(E, bool), "first": np.arange(E) == 0,
                    "random": rs.random(E) < 0.5}[mask_kind]
            up = rs.random(E) < 0.5
            down = ~up & (rs.random(E) < 0.6)
            jimp.update_env_origins(jnp.asarray(mask), jnp.asarray(up), jnp.asarray(down),
                                    jax.random.PRNGKey(10 + i))
    rng = ReplayRng(draws)
    pimp.init_state(rng)
    rs = np.random.default_rng(3)
    for i in range(4):
        mask = {"all": np.ones(E, bool), "first": np.arange(E) == 0,
                "random": rs.random(E) < 0.5}[mask_kind]
        up = rs.random(E) < 0.5
        down = ~up & (rs.random(E) < 0.6)
        pimp.update_env_origins(torch.as_tensor(mask), torch.as_tensor(up),
                                torch.as_tensor(down), rng)
    assert rng.done()
    assert_state_equal(ctx, pimp)
    assert int(pimp.levels.max()) < pimp.max_terrain_level and int(pimp.levels.min()) >= 0


def test_importer_randomize_env_origins_matches_jax():
    E = 16
    jimp, ctx, pimp = importers(E)
    mask = np.arange(E) % 3 != 1
    with JaxDraws() as draws:
        ctx.terrain_state = jimp.init_state(E, jax.random.PRNGKey(2))
        jimp.randomize_env_origins(jnp.asarray(mask), jax.random.PRNGKey(3))
    rng = ReplayRng(draws)
    pimp.init_state(rng)
    before = (pimp.levels.clone(), pimp.types.clone())
    pimp.randomize_env_origins(torch.as_tensor(mask), rng)
    assert rng.done()
    assert_state_equal(ctx, pimp)
    keep = torch.as_tensor(~mask)
    assert torch.equal(pimp.levels[keep], before[0][keep])
    assert torch.equal(pimp.types[keep], before[1][keep])


@pytest.mark.parametrize("E,cols", [(4096, 20), (4095, 20), (1000, 20), (4096, 5), (7, 3),
                                    (3, 5)])
def test_init_state_types_match_jax(E, cols):
    """types = arange(E) // (E / cols) as a float32 division, as JAX's weak
    type gives it."""
    want = np.clip(np.asarray((jnp.arange(E) // max(E / cols, 1e-9)).astype(jnp.int32)),
                   0, cols - 1)
    per = torch.arange(E, dtype=torch.float32) // max(E / cols, 1e-9)
    got = torch.clamp(per.to(torch.int32), 0, cols - 1)
    np.testing.assert_array_equal(want, got.numpy())


# -- the Model a rough task builds without MuJoCo ----------------------------


def _g1_rough(play=False):
    from mjlab_tpu_torch.tasks import load_env_cfg

    return load_env_cfg("Mjlab-Velocity-Rough-Unitree-G1", play=play)


def _cut(cfg):
    gen = cfg.scene.terrain.terrain_generator
    gen.num_rows = gen.num_cols = 2
    gen.seed = 5
    return cfg


def _hf_mix(cfg):
    gen = cfg.scene.terrain.terrain_generator
    gen.num_rows, gen.num_cols, gen.seed, gen.border_width = 2, 3, 9, 3.0
    gen.sub_terrains = {n: sub(pt, n, proportion=1.0) for n in (
        "HfPyramidSlopedTerrainCfg", "HfRandomUniformTerrainCfg", "HfWaveTerrainCfg")}
    return cfg


FILL_CASES = {
    "default_2x2": lambda: _cut(_g1_rough()),
    "play": lambda: _g1_rough(play=True),
    "hf_mix": lambda: _hf_mix(_g1_rough()),
}


@pytest.mark.parametrize("case", sorted(FILL_CASES))
def test_filled_model_matches_a_fresh_compile(case):
    """The model file with the build's height field written in equals
    put_model of the scene compiled by MuJoCo with the same generator
    seed, every field (tensors at float64, structure, the pair table,
    options)."""
    from mjlab_tpu_torch.scene.scene import Scene
    from mjlab_tpu_torch.tasks.velocity.config.g1.physics import sim_cfg

    cfg = FILL_CASES[case]()
    if case == "play":
        cfg.scene.terrain.terrain_generator.seed = 11
    scene_cfg = copy.deepcopy(cfg.scene)
    scene_cfg.model_file = None
    mj = Scene(scene_cfg).compile()
    sim_cfg().mujoco.apply(mj)
    want = pm.put_model(mj, dtype=torch.float64, nconmax=sim_cfg().nconmax, device="cpu")
    got, _ = pm.load_model(cfg.scene.model_file, dtype=torch.float64, device="cpu")
    got = Scene(cfg.scene).terrain.fill_hfield(got)
    assert want.hfield_nrow > 100 and want.nhfield == 1
    for n in pm.tensor_fields():
        assert torch.equal(getattr(want, n), getattr(got, n)), n
    for n in pm.static_fields():
        if n == "pairs":
            for f in dataclasses.fields(pm.PairTable):
                np.testing.assert_array_equal(np.asarray(getattr(want.pairs, f.name)),
                                              np.asarray(getattr(got.pairs, f.name)), f.name)
        elif isinstance(getattr(want, n), np.ndarray):
            np.testing.assert_array_equal(getattr(want, n), getattr(got, n), n)
        else:
            assert getattr(want, n) == getattr(got, n), n
    for n in pm.OPTION_TENSOR_FIELDS:
        assert torch.equal(getattr(want.opt, n), getattr(got.opt, n)), n
    for n in pm.OPTION_STATIC_FIELDS:
        assert getattr(want.opt, n) == getattr(got.opt, n), n
