"""Terrains: the ground plane, and procedural sub-terrains rasterised into
one height field with a spawn origin per sub-terrain (the JAX package's
mjlab_tpu/terrains, numpy and PyTorch only)."""

from mjlab_tpu_torch.terrains.heightfield_terrains import (  # noqa: F401
    HfPyramidSlopedTerrainCfg,
    HfRandomUniformTerrainCfg,
    HfWaveTerrainCfg,
)
from mjlab_tpu_torch.terrains.importer import TerrainImporter, TerrainImporterCfg  # noqa: F401
from mjlab_tpu_torch.terrains.primitive_terrains import (  # noqa: F401
    BoxFlatTerrainCfg,
    BoxInvertedPyramidStairsTerrainCfg,
    BoxPyramidStairsTerrainCfg,
    BoxRandomGridTerrainCfg,
)
from mjlab_tpu_torch.terrains.terrain_generator import (  # noqa: F401
    HField,
    SubTerrainCfg,
    TerrainGenerator,
    TerrainGeneratorCfg,
    TerrainPatch,
)
