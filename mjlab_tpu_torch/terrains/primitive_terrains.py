"""Primitive (box-family) sub-terrains, rasterized to height patches.

Numpy copy of mjlab_tpu/terrains/primitive_terrains.py (BoxFlat,
BoxPyramidStairs, BoxInvertedPyramidStairs, BoxRandomGrid): each terrain
is a height patch on the generator's one global height field, not a set
of box geoms (terrain_generator.py). The heights are bit-identical to the
JAX package's for the same seed.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mjlab_tpu_torch.terrains.terrain_generator import SubTerrainCfg, TerrainPatch


@dataclass(kw_only=True)
class BoxFlatTerrainCfg(SubTerrainCfg):
    """Flat patch (reference primitive_terrains.py:53-63)."""

    def function(self, difficulty, rng) -> TerrainPatch:
        del difficulty, rng
        nx, ny = self.grid_shape()
        origin = np.array([self.size[0] / 2, self.size[1] / 2, 0.0])
        return TerrainPatch(np.zeros((nx, ny), np.float32), origin)


@dataclass(kw_only=True)
class BoxPyramidStairsTerrainCfg(SubTerrainCfg):
    """Concentric stairs rising toward a central platform
    (reference primitive_terrains.py:67-222).

    difficulty scales step height within ``step_height_range``; the number
    of steps comes from the patch size, border and platform widths.
    """

    border_width: float = 0.0
    step_height_range: tuple[float, float] = (0.0, 0.2)
    step_width: float = 0.3
    platform_width: float = 1.0
    holes: bool = False
    _sign: float = 1.0  # +1 pyramid (up), -1 inverted (down)

    def _num_steps(self) -> int:
        nx = (self.size[0] - 2 * self.border_width - self.platform_width) // (
            2 * self.step_width
        ) + 1
        ny = (self.size[1] - 2 * self.border_width - self.platform_width) // (
            2 * self.step_width
        ) + 1
        return int(min(nx, ny))

    def function(self, difficulty, rng) -> TerrainPatch:
        del rng
        lo, hi = self.step_height_range
        step_height = lo + difficulty * (hi - lo)
        num_steps = self._num_steps()

        xx, yy = self.xy_grid()
        # distance from the inner (border-excluded) edge, in all 4 directions
        d = np.minimum(
            np.minimum(xx - self.border_width, self.size[0] - self.border_width - xx),
            np.minimum(yy - self.border_width, self.size[1] - self.border_width - yy),
        )
        k = np.clip(np.floor(d / self.step_width), 0, num_steps).astype(np.int32)
        k = np.where(d < 0, 0, k)  # border ring stays at base level
        h = self._sign * step_height * k
        origin_z = self._sign * step_height * num_steps
        origin = np.array([self.size[0] / 2, self.size[1] / 2, origin_z])
        return TerrainPatch(h.astype(np.float32), origin)


@dataclass(kw_only=True)
class BoxInvertedPyramidStairsTerrainCfg(BoxPyramidStairsTerrainCfg):
    """Stairs descending toward the center (reference L226-376)."""

    _sign: float = -1.0


@dataclass(kw_only=True)
class BoxRandomGridTerrainCfg(SubTerrainCfg):
    """Grid of cells at random heights around a flat central platform
    (reference primitive_terrains.py:380-500).

    difficulty scales cell height within ``grid_height_range``; cells are
    ``grid_width`` squares with iid uniform heights in +-grid_height.
    """

    grid_width: float = 0.45
    grid_height_range: tuple[float, float] = (0.0, 0.2)
    platform_width: float = 1.0
    holes: bool = False

    def function(self, difficulty, rng) -> TerrainPatch:
        if self.size[0] != self.size[1]:
            raise ValueError(f"terrain must be square, got {self.size}")
        lo, hi = self.grid_height_range
        grid_height = lo + difficulty * (hi - lo)

        ncells_x = int(self.size[0] / self.grid_width)
        ncells_y = int(self.size[1] / self.grid_width)
        border = self.size[0] - min(ncells_x, ncells_y) * self.grid_width
        if border <= 0:
            raise RuntimeError("grid_width must not divide size exactly")
        b2 = border / 2

        cell_h = rng.uniform(-grid_height, grid_height, (ncells_x, ncells_y))

        xx, yy = self.xy_grid()
        ci = np.clip(((xx - b2) / self.grid_width).astype(np.int32), 0, ncells_x - 1)
        cj = np.clip(((yy - b2) / self.grid_width).astype(np.int32), 0, ncells_y - 1)
        h = cell_h[ci, cj]
        # flat border ring
        in_border = (
            (xx < b2)
            | (xx > self.size[0] - b2)
            | (yy < b2)
            | (yy > self.size[1] - b2)
        )
        h = np.where(in_border, 0.0, h)
        # central platform at +grid_height (reference platform sits at
        # grid_height above base, L484-494)
        half_p = self.platform_width / 2
        cx, cy = self.size[0] / 2, self.size[1] / 2
        on_platform = (np.abs(xx - cx) <= half_p) & (np.abs(yy - cy) <= half_p)
        h = np.where(on_platform, grid_height, h)
        origin = np.array([cx, cy, grid_height])
        return TerrainPatch(h.astype(np.float32), origin)
