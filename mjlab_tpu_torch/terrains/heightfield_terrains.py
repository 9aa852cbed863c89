"""Heightfield-family sub-terrains: HfPyramidSloped, HfRandomUniform and
HfWave as height patches.

Numpy copy of mjlab_tpu/terrains/heightfield_terrains.py; the heights are
bit-identical to the JAX package's for the same seed. Every terrain
collides through the one height-field narrowphase
(phys/lm/collision.py), whatever family made its heights.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from mjlab_tpu_torch.terrains.terrain_generator import SubTerrainCfg, TerrainPatch


def _apply_flat_border(h, xx, yy, size, border_width):
    if border_width <= 0:
        return h
    in_border = (
        (xx < border_width)
        | (xx > size[0] - border_width)
        | (yy < border_width)
        | (yy > size[1] - border_width)
    )
    return np.where(in_border, 0.0, h)


@dataclass(kw_only=True)
class HfPyramidSlopedTerrainCfg(SubTerrainCfg):
    """Pyramid slope rising (or sinking, inverted=True) to a platform
    (reference heightfield_terrains.py:104-252)."""

    slope_range: tuple[float, float] = (0.0, 0.4)
    platform_width: float = 1.0
    border_width: float = 0.0
    inverted: bool = False

    def function(self, difficulty, rng) -> TerrainPatch:
        del rng
        lo, hi = self.slope_range
        slope = lo + difficulty * (hi - lo)
        if self.inverted:
            slope = -slope

        xx, yy = self.xy_grid()
        cx, cy = self.size[0] / 2, self.size[1] / 2
        # bilinear pyramid: product of the two triangle profiles
        # (reference builds hf_raw = height_max * xx * yy with xx, yy
        # ramping 0->1->0, heightfield_terrains.py:146-188)
        px = 1.0 - np.abs(xx - cx) / cx
        py = 1.0 - np.abs(yy - cy) / cy
        height_max = slope * self.size[0] / 2
        h = height_max * px * py

        # flat platform in the center
        half_p = self.platform_width / 2
        on_platform = (np.abs(xx - cx) <= half_p) & (np.abs(yy - cy) <= half_p)
        platform_h = height_max * (1 - half_p / cx) * (1 - half_p / cy)
        h = np.where(on_platform, platform_h, h)
        h = _apply_flat_border(h, xx, yy, self.size, self.border_width)
        origin = np.array([cx, cy, platform_h])
        return TerrainPatch(h.astype(np.float32), origin)


@dataclass(kw_only=True)
class HfRandomUniformTerrainCfg(SubTerrainCfg):
    """Random rough terrain: quantized uniform noise on a coarse grid,
    bilinearly upsampled (reference heightfield_terrains.py:256-345)."""

    noise_range: tuple[float, float] = (0.02, 0.1)
    noise_step: float = 0.02
    downsampled_scale: float | None = None
    border_width: float = 0.0

    def function(self, difficulty, rng) -> TerrainPatch:
        del difficulty  # reference samples noise irrespective of difficulty
        ds = self.downsampled_scale or max(self.resolution, 0.2)
        nxd = max(int(self.size[0] / ds) + 1, 2)
        nyd = max(int(self.size[1] / ds) + 1, 2)
        lo, hi = self.noise_range
        choices = np.arange(lo, hi + self.noise_step, self.noise_step)
        coarse = rng.choice(choices, size=(nxd, nyd))

        nx, ny = self.grid_shape()
        # bilinear upsample
        xi = np.linspace(0, nxd - 1, nx)
        yi = np.linspace(0, nyd - 1, ny)
        x0 = np.clip(xi.astype(np.int32), 0, nxd - 2)
        y0 = np.clip(yi.astype(np.int32), 0, nyd - 2)
        fx = (xi - x0)[:, None]
        fy = (yi - y0)[None, :]
        c00 = coarse[x0][:, y0]
        c01 = coarse[x0][:, y0 + 1]
        c10 = coarse[x0 + 1][:, y0]
        c11 = coarse[x0 + 1][:, y0 + 1]
        h = (
            c00 * (1 - fx) * (1 - fy)
            + c01 * (1 - fx) * fy
            + c10 * fx * (1 - fy)
            + c11 * fx * fy
        )
        xx, yy = self.xy_grid()
        h = _apply_flat_border(h, xx, yy, self.size, self.border_width)
        origin = np.array([self.size[0] / 2, self.size[1] / 2, float(h.max())])
        return TerrainPatch(h.astype(np.float32), origin)


@dataclass(kw_only=True)
class HfWaveTerrainCfg(SubTerrainCfg):
    """Sinusoidal waves (reference heightfield_terrains.py:392-...)."""

    amplitude_range: tuple[float, float] = (0.0, 0.2)
    num_waves: int = 4
    border_width: float = 0.0

    def function(self, difficulty, rng) -> TerrainPatch:
        del rng
        lo, hi = self.amplitude_range
        amplitude = lo + difficulty * (hi - lo)
        xx, yy = self.xy_grid()
        wx = 2 * np.pi * self.num_waves / self.size[0]
        wy = 2 * np.pi * self.num_waves / self.size[1]
        h = 0.5 * amplitude * (np.sin(wx * xx) + np.cos(wy * yy))
        h = _apply_flat_border(h, xx, yy, self.size, self.border_width)
        origin = np.array([self.size[0] / 2, self.size[1] / 2, float(h.max())])
        return TerrainPatch(h.astype(np.float32), origin)
