"""Terrain importer configuration.

PyTorch counterpart of the config of mjlab_tpu/terrains/importer.py. The
port carries the "plane" terrain (an infinite ground plane, env origins
on a grid of env_spacing; scene/scene.py builds it). The "generator"
terrain (procedural sub-terrains as one height field, curriculum origins)
needs terrains/* and the height-field pair families of the contact stack,
which are not ported: a Scene with it raises NotImplementedError.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Literal


@dataclass
class TerrainImporterCfg:
    terrain_type: Literal["plane", "generator"] = "plane"
    # the generator's config (a TerrainGeneratorCfg in the JAX package);
    # carried so that task configs read the same, not built
    terrain_generator: object | None = None
    env_spacing: float = 2.0
    max_init_terrain_level: int | None = None
    friction: tuple[float, float, float] = (1.0, 0.005, 0.0001)
