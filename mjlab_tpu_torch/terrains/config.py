"""The default rough terrain of the velocity tasks (the JAX package's
mjlab_tpu/terrains/config.py): 10 x 20 sub-terrains of 8 m, a 20 m
border, flat patches and pyramid stairs up and down. The Hf* families
(heightfield_terrains.py) run through the same height-field narrowphase
and may be mixed in by a custom config.
"""

from mjlab_tpu_torch.terrains.primitive_terrains import (
    BoxFlatTerrainCfg,
    BoxInvertedPyramidStairsTerrainCfg,
    BoxPyramidStairsTerrainCfg,
)
from mjlab_tpu_torch.terrains.terrain_generator import TerrainGeneratorCfg

ROUGH_TERRAINS_CFG = TerrainGeneratorCfg(
    size=(8.0, 8.0),
    border_width=20.0,
    num_rows=10,
    num_cols=20,
    sub_terrains={
        "flat": BoxFlatTerrainCfg(proportion=0.4),
        "pyramid_stairs": BoxPyramidStairsTerrainCfg(
            proportion=0.3,
            step_height_range=(0.0, 0.1),
            step_width=0.3,
            platform_width=3.0,
            border_width=1.0,
        ),
        "pyramid_stairs_inv": BoxInvertedPyramidStairsTerrainCfg(
            proportion=0.3,
            step_height_range=(0.0, 0.1),
            step_width=0.3,
            platform_width=3.0,
            border_width=1.0,
        ),
    },
    add_lights=False,
)
