"""Procedural terrain generator: sub-terrains rasterised into one global
height field, with a spawn origin per sub-terrain.

Numpy copy of mjlab_tpu/terrains/terrain_generator.py, with the same
draws, heights, origins and world extent for the same seed (a seed of None
draws a fresh one per build, as there). Every sub-terrain, the box-stair
families included, is a height patch on one grid, so terrain collision is
one narrowphase family per robot geom type (phys/lm/collision.py), its
cost independent of the terrain's complexity:

- num_rows x num_cols sub-terrains, rows the difficulty axis, centred on
  the world origin, with a flat border around them;
- curriculum mode: difficulty (row + u) / num_rows, each column's type by
  the cumulative proportions; random mode: type by proportion, difficulty
  uniform in the range;
- terrain_origins[row, col]: each sub-terrain's spawn point.

``hfield()`` gives the height field as MuJoCo holds it (the normalised
data, the size, the terrain geom's position); ``compile(spec)`` adds it to
a spec (MuJoCo is imported there only), and terrains/importer.py
``fill_hfield`` writes it into a Model converted from a model file, so
that a machine without MuJoCo builds the same Model.
"""

from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import TYPE_CHECKING, Literal

import numpy as np

if TYPE_CHECKING:
    import mujoco


@dataclass
class TerrainPatch:
    """Output of one sub-terrain: elevation grid + spawn origin.

    ``heights`` has shape (npx, npy): index 0 runs along +x (terrain rows),
    index 1 along +y, in meters, relative to the sub-terrain's base plane.
    ``origin`` is the spawn point relative to the sub-terrain corner.
    """

    heights: np.ndarray
    origin: np.ndarray


@dataclass
class SubTerrainCfg(abc.ABC):
    """Base sub-terrain config."""

    proportion: float = 1.0
    size: tuple[float, float] = (10.0, 10.0)
    # horizontal resolution of the rasterized height patch; stamped by the
    # generator from TerrainGeneratorCfg.resolution.
    resolution: float = 0.1

    def grid_shape(self) -> tuple[int, int]:
        nx = int(round(self.size[0] / self.resolution))
        ny = int(round(self.size[1] / self.resolution))
        return nx + 1, ny + 1

    def xy_grid(self) -> tuple[np.ndarray, np.ndarray]:
        """Meshgrid of sample coordinates in [0, size]."""
        nx, ny = self.grid_shape()
        x = np.linspace(0.0, self.size[0], nx)
        y = np.linspace(0.0, self.size[1], ny)
        return np.meshgrid(x, y, indexing="ij")

    @abc.abstractmethod
    def function(
        self, difficulty: float, rng: np.random.Generator
    ) -> TerrainPatch:
        raise NotImplementedError


@dataclass(kw_only=True)
class TerrainGeneratorCfg:
    """The generator's config (the JAX package's fields); ``resolution``
    is the horizontal spacing of the global height field."""

    seed: int | None = None
    curriculum: bool = False
    size: tuple[float, float]
    border_width: float = 0.0
    border_height: float = 1.0
    num_rows: int = 1
    num_cols: int = 1
    color_scheme: Literal["height", "random", "none"] = "height"
    sub_terrains: dict[str, SubTerrainCfg] = field(default_factory=dict)
    difficulty_range: tuple[float, float] = (0.0, 1.0)
    add_lights: bool = False
    resolution: float = 0.1


@dataclass(frozen=True)
class HField:
    """The terrain's height field as a compiled MuJoCo model holds it:
    ``data`` (nrow, ncol) normalised to [0, 1] (rows along +y, columns
    along +x), ``size`` (x half extent, y half extent, z scale, base
    depth), and the terrain geom's position (the extent's centre, z at the
    lowest height)."""

    data: np.ndarray
    size: tuple[float, float, float, float]
    geom_pos: tuple[float, float, float]

    @property
    def nrow(self) -> int:
        return int(self.data.shape[0])

    @property
    def ncol(self) -> int:
        return int(self.data.shape[1])


class TerrainGenerator:
    """Builds the global heightfield + spawn-origin grid."""

    def __init__(self, cfg: TerrainGeneratorCfg):
        if not cfg.sub_terrains:
            raise ValueError("At least one sub_terrain must be specified.")
        self.cfg = cfg
        for sub in cfg.sub_terrains.values():
            sub.size = cfg.size
            sub.resolution = cfg.resolution
        seed = cfg.seed if cfg.seed is not None else np.random.randint(0, 10000)
        self.np_rng = np.random.default_rng(seed)

        # cells per sub-terrain
        self._cx = int(round(cfg.size[0] / cfg.resolution))
        self._cy = int(round(cfg.size[1] / cfg.resolution))
        self._bx = int(round(cfg.border_width / cfg.resolution))
        self._by = int(round(cfg.border_width / cfg.resolution))

        nx = cfg.num_rows * self._cx + 2 * self._bx + 1
        ny = cfg.num_cols * self._cy + 2 * self._by + 1
        self.heights = np.zeros((nx, ny), np.float32)
        self.terrain_origins = np.zeros((cfg.num_rows, cfg.num_cols, 3))

        if cfg.curriculum:
            self._generate_curriculum()
        else:
            self._generate_random()

        # world extent: the grid centred on the origin
        self.x_min = -cfg.num_rows * cfg.size[0] * 0.5 - cfg.border_width
        self.y_min = -cfg.num_cols * cfg.size[1] * 0.5 - cfg.border_width
        self.x_max = self.x_min + (nx - 1) * cfg.resolution
        self.y_max = self.y_min + (ny - 1) * cfg.resolution

    # -- grid assembly --

    def _proportions(self) -> np.ndarray:
        p = np.array([s.proportion for s in self.cfg.sub_terrains.values()])
        return p / p.sum()

    def _place(self, row: int, col: int, difficulty: float, sub: SubTerrainCfg):
        patch = sub.function(difficulty, self.np_rng)
        nx, ny = sub.grid_shape()
        assert patch.heights.shape == (nx, ny), (
            f"sub-terrain produced {patch.heights.shape}, expected {(nx, ny)}"
        )
        i0 = self._bx + row * self._cx
        j0 = self._by + col * self._cy
        self.heights[i0 : i0 + nx, j0 : j0 + ny] = patch.heights
        corner = np.array(
            [
                -self.cfg.num_rows * self.cfg.size[0] * 0.5 + row * self.cfg.size[0],
                -self.cfg.num_cols * self.cfg.size[1] * 0.5 + col * self.cfg.size[1],
                0.0,
            ]
        )
        self.terrain_origins[row, col] = corner + patch.origin

    def _generate_random(self):
        p = self._proportions()
        subs = list(self.cfg.sub_terrains.values())
        lo, hi = self.cfg.difficulty_range
        for row in range(self.cfg.num_rows):
            for col in range(self.cfg.num_cols):
                k = self.np_rng.choice(len(p), p=p)
                difficulty = self.np_rng.uniform(lo, hi)
                self._place(row, col, difficulty, subs[k])

    def _generate_curriculum(self):
        p = self._proportions()
        subs = list(self.cfg.sub_terrains.values())
        csum = np.cumsum(p)
        col_type = [
            int(np.min(np.where(c / self.cfg.num_cols + 0.001 < csum)[0]))
            for c in range(self.cfg.num_cols)
        ]
        lo, hi = self.cfg.difficulty_range
        for col in range(self.cfg.num_cols):
            for row in range(self.cfg.num_rows):
                d = (row + self.np_rng.uniform()) / self.cfg.num_rows
                self._place(row, col, lo + (hi - lo) * d, subs[col_type[col]])

    # -- the height field --

    def hfield(self) -> HField:
        """The height field MuJoCo compiles from ``compile``: elevations
        normalised to [0, 1] (elevation = data * z scale), in float32 as
        mjModel.hfield_data holds them, transposed to MuJoCo's (nrow = y,
        ncol = x) layout, and the geom offset so that world elevations
        equal ``heights``."""
        h = self.heights
        h_min = float(h.min())
        h_max = float(h.max())
        zscale = max(h_max - h_min, 1e-4)
        norm = ((h - h_min) / zscale).T  # float32 arithmetic, as the JAX package
        return HField(
            data=np.ascontiguousarray(norm, dtype=np.float32),
            size=(
                (self.x_max - self.x_min) / 2,
                (self.y_max - self.y_min) / 2,
                zscale,
                max(self.cfg.border_height, 0.1),
            ),
            geom_pos=(
                (self.x_min + self.x_max) / 2,
                (self.y_min + self.y_max) / 2,
                h_min,
            ),
        )

    def compile(self, spec: "mujoco.MjSpec") -> None:
        """Add the global hfield asset and its geom (body "terrain") to the
        spec."""
        import mujoco

        hf = self.hfield()
        spec.add_hfield(
            name="terrain",
            size=list(hf.size),
            nrow=hf.nrow,
            ncol=hf.ncol,
            userdata=hf.data.reshape(-1).astype(np.float64),
        )
        body = spec.worldbody.add_body(name="terrain")
        body.add_geom(
            name="terrain",
            type=mujoco.mjtGeom.mjGEOM_HFIELD,
            hfieldname="terrain",
            pos=list(hf.geom_pos),
            rgba=(0.45, 0.45, 0.45, 1.0),
        )
        if self.cfg.add_lights:
            spec.worldbody.add_light(
                pos=(0.0, 0.0, max(self.x_max, self.y_max) * 0.6),
                directional=True,
            )
