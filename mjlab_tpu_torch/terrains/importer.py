"""Terrain importer: the ground of a scene and the per-env terrain state.

PyTorch counterpart of mjlab_tpu/terrains/importer.py, with its two
terrain types:

- "plane": an infinite ground plane; env origins on a grid of
  env_spacing about the world origin;
- "generator": procedural sub-terrains as one global height field
  (terrain_generator.py), env origins from the sub-terrains' spawn points.

The per-env state of a generator terrain is three fixed tensors on the
device, ``levels`` and ``types`` (int32) and ``origins`` (float32, the
spawn point of each env's sub-terrain), made once by ``init_state`` and
updated in place by masked writes (``update_env_origins``,
``randomize_env_origins``) with no host read, so that they run inside a
captured env step. Every draw goes through the env's Rng, one integer draw
over all envs per call, as the JAX package draws.

The spec (``spec()``) needs MuJoCo; the runtime does not: a Model read
from a model file gets this terrain's height field through
``fill_hfield``.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import TYPE_CHECKING, Literal

import numpy as np
import torch

from mjlab_tpu_torch.terrains.terrain_generator import TerrainGenerator, TerrainGeneratorCfg

if TYPE_CHECKING:
    import mujoco

    from mjlab_tpu_torch.phys.model import Model
    from mjlab_tpu_torch.utils.random import Rng


@dataclass
class TerrainImporterCfg:
    terrain_type: Literal["plane", "generator"] = "plane"
    terrain_generator: TerrainGeneratorCfg | None = None
    env_spacing: float = 2.0
    max_init_terrain_level: int | None = None
    friction: tuple[float, float, float] = (1.0, 0.005, 0.0001)

    def __post_init__(self):
        if self.terrain_type == "generator" and self.terrain_generator is None:
            raise ValueError("generator terrain requires terrain_generator")


# MuJoCo's default geom density (the terrain's spec sets none)
_GEOM_DENSITY = 1000.0


def grid_origins(num_envs: int, spacing: float, device) -> torch.Tensor:
    """(num_envs, 3) float32 origins on a square grid of ``spacing`` about
    the world origin, row-major (mjlab_tpu/terrains/importer.py:69-78)."""
    side = int(np.ceil(np.sqrt(num_envs)))
    idx = np.arange(num_envs)
    origins = np.zeros((num_envs, 3), np.float32)
    origins[:, 0] = (idx // side - (side - 1) / 2) * spacing
    origins[:, 1] = (idx % side - (side - 1) / 2) * spacing
    return torch.as_tensor(origins, device=device)


class TerrainImporter:
    """The terrain of a scene (see the module docstring)."""

    def __init__(self, cfg: TerrainImporterCfg):
        if cfg.terrain_type not in ("plane", "generator"):
            raise NotImplementedError(f"terrain type {cfg.terrain_type!r}")
        self.cfg = cfg
        self.num_envs = 0
        self.generator = (TerrainGenerator(cfg.terrain_generator)
                          if cfg.terrain_type == "generator" else None)
        self.terrain_origins: torch.Tensor | None = None  # (rows, cols, 3)
        self.levels = self.types = self.origins = None

    # -- host side --

    def spec(self) -> "mujoco.MjSpec":
        """The terrain's spec: a body "terrain" holding the ground plane or
        the height field geom, with the config's friction."""
        import mujoco

        spec = mujoco.MjSpec()
        if self.generator is None:
            body = spec.worldbody.add_body(name="terrain")
            g = body.add_geom(name="terrain")
            g.type = mujoco.mjtGeom.mjGEOM_PLANE
            g.size = [0.0, 0.0, 1.0]
        else:
            self.generator.compile(spec)
        for g in spec.geoms:
            g.friction[:] = self.cfg.friction
        return spec

    def fill_hfield(self, m: "Model", geom_name: str = "terrain/terrain") -> "Model":
        """m with this terrain's height field, as MuJoCo compiles it from
        ``spec()``: hfield_nrow, hfield_ncol, hfield_size, hfield_data, the
        terrain geom's position and size and its body's mass, inertia and
        centre of mass (a body welded to the world: the physics never
        reads them). m is a Model of the same scene converted with any
        generated terrain (a model file); the pair table does not depend on
        the heights. Plane terrains return m."""
        if self.generator is None:
            return m
        if m.nhfield != 1:
            raise ValueError(f"the model has {m.nhfield} height fields; the terrain needs 1")
        hf = self.generator.hfield()
        g = m.geom_names.index(geom_name)
        t = lambda x: torch.as_tensor(np.asarray(x, np.float64), dtype=m.dtype,  # noqa: E731
                                      device=m.device)
        b = int(m.geom_bodyid[g])
        # MuJoCo's hfield geom size: the half extents and the mean depth;
        # the terrain body's mass properties are those of that geom as a
        # solid box at the default density, centred on the geom
        s0, s1, s2 = hf.size[0], hf.size[1], 0.25 * hf.size[2] + 0.5 * hf.size[3]
        mass = _GEOM_DENSITY * (s0 * s1 * s2 * 8)
        inertia = (mass * (s1 * s1 + s2 * s2) / 3, mass * (s0 * s0 + s2 * s2) / 3,
                   mass * (s0 * s0 + s1 * s1) / 3)
        fields = {n: getattr(m, n).clone() for n in (
            "geom_pos", "geom_size", "body_mass", "body_inertia", "body_ipos")}
        fields["geom_pos"][g] = t(hf.geom_pos)
        fields["geom_size"][g] = t((s0, s1, s2))
        fields["body_mass"][b] = mass
        fields["body_inertia"][b] = t(inertia)
        fields["body_ipos"][b] = t(hf.geom_pos)
        return dataclasses.replace(
            m, hfield_nrow=hf.nrow, hfield_ncol=hf.ncol, hfield_size=t([hf.size]),
            hfield_data=t(hf.data), **fields)

    # -- runtime --

    def initialize(self, num_envs: int, device: torch.device) -> None:
        """The plane's origin grid, or the generator's spawn-origin table,
        on ``device``."""
        self.num_envs = num_envs
        if self.generator is None:
            self.origins = grid_origins(num_envs, self.cfg.env_spacing, device)
        else:
            self.terrain_origins = torch.as_tensor(
                self.generator.terrain_origins, dtype=torch.float32, device=device)

    def init_state(self, rng: "Rng") -> None:
        """The initial levels (random up to max_init_terrain_level), types
        (round robin by env index) and origins of a generator terrain
        (mjlab_tpu/terrains/importer.py:80-100)."""
        if self.generator is None:
            return
        rows, cols = self.terrain_origins.shape[:2]
        max_init = rows - 1
        if self.cfg.max_init_terrain_level is not None:
            max_init = min(self.cfg.max_init_terrain_level, rows - 1)
        E = self.num_envs
        dev = self.terrain_origins.device
        self.levels = rng.integers((E,), 0, max_init + 1)
        # a float32 floor division, as the JAX package's weak-typed one
        per = torch.arange(E, dtype=torch.float32, device=dev) // max(E / cols, 1e-9)
        self.types = torch.clamp(per.to(torch.int32), 0, cols - 1)
        self.origins = self.terrain_origins[self.levels.long(), self.types.long()]

    @property
    def max_terrain_level(self) -> int:
        return int(self.terrain_origins.shape[0])

    @property
    def env_origins(self) -> torch.Tensor:
        """(num_envs, 3) float32: each env's origin (a fixed tensor)."""
        return self.origins

    @property
    def terrain_levels(self) -> torch.Tensor:
        return self.levels

    @property
    def terrain_types(self) -> torch.Tensor:
        return self.types

    def update_env_origins(self, mask: torch.Tensor, move_up: torch.Tensor,
                           move_down: torch.Tensor, rng: "Rng") -> None:
        """Masked level change (mjlab_tpu/terrains/importer.py:127-145): +1
        where move_up, -1 where move_down; an env past the top row gets a
        random level in [0, rows) (drawn for every env on every call), one
        below row 0 stays at 0."""
        if self.generator is None:
            return
        rows = self.max_terrain_level
        step = move_up.to(torch.int32) - move_down.to(torch.int32)
        levels = self.levels + torch.where(mask, step, 0)
        rand_levels = rng.integers(tuple(levels.shape), 0, rows)
        self.levels.copy_(torch.where(levels >= rows, rand_levels, torch.clamp(levels, min=0)))
        self.origins.copy_(self.terrain_origins[self.levels.long(), self.types.long()])

    def randomize_env_origins(self, mask: torch.Tensor, rng: "Rng") -> None:
        """A random level and type for the masked envs
        (mjlab_tpu/terrains/importer.py:147-163): two draws over all envs,
        levels first."""
        if self.generator is None:
            return
        rows, cols = self.terrain_origins.shape[:2]
        new_levels = rng.integers(tuple(self.levels.shape), 0, rows)
        new_types = rng.integers(tuple(self.types.shape), 0, cols)
        self.levels.copy_(torch.where(mask, new_levels, self.levels))
        self.types.copy_(torch.where(mask, new_types, self.types))
        self.origins.copy_(self.terrain_origins[self.levels.long(), self.types.long()])

    def state_tensors(self) -> list[torch.Tensor]:
        """The per-env state a captured step writes (none on a plane)."""
        if self.generator is None:
            return []
        return [self.levels, self.types, self.origins]
