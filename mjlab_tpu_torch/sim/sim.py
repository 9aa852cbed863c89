"""Simulation: batched physics over a (Model, Data) pair on one device.

PyTorch counterpart of mjlab_tpu/sim/sim.py: the standalone API for tests,
benchmarks and interactive use. One engine, the env-last kernel path
(phys/hybrid.py). The model is converted once; Data carries a leading
num_envs axis. Runs on CUDA unless the caller passes device="cpu", where
every kernel runs its plain PyTorch version.

The model is a compiled mujoco.MjModel, or a Model already converted (for
instance one read by phys.model.load_model on a machine without MuJoCo).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Literal

import dataclasses

import numpy as np
import torch

from mjlab_tpu_torch.phys.data import Data, make_data, reset_data
from mjlab_tpu_torch.phys.hybrid import forward_hybrid, refresh_envlast, step_envlast
from mjlab_tpu_torch.phys.lm.collision import PAIR_FAMILIES, pair_families
from mjlab_tpu_torch.phys.model import (
    CONE_ELLIPTIC, CONE_PYRAMIDAL, INT_EULER, INT_IMPLICITFAST,
    SMOOTH_HOST_FIELDS, TRN_JOINT, Model, model_from_numpy, model_to_numpy,
    put_model, resolve_device,
)

# mujoco.mjtIntegrator / mjtCone / mjtSolver values
_INTEGRATOR_MAP = {"euler": INT_EULER, "implicitfast": INT_IMPLICITFAST}
_CONE_MAP = {"pyramidal": CONE_PYRAMIDAL, "elliptic": CONE_ELLIPTIC}
_SOLVER_MAP = {"newton": 2}


@dataclass
class MujocoCfg:
    """MuJoCo option configuration."""

    timestep: float = 0.002
    integrator: Literal["euler", "implicitfast"] = "implicitfast"
    impratio: float = 1.0
    cone: Literal["pyramidal", "elliptic"] = "pyramidal"
    solver: Literal["newton"] = "newton"
    iterations: int = 100
    tolerance: float = 1e-8
    ls_iterations: int = 50
    ls_tolerance: float = 0.01
    gravity: tuple[float, float, float] = (0, 0, -9.81)

    def apply(self, model: "mujoco.MjModel") -> None:
        model.opt.cone = _CONE_MAP[self.cone]
        model.opt.integrator = _INTEGRATOR_MAP[self.integrator]
        model.opt.solver = _SOLVER_MAP[self.solver]
        model.opt.timestep = self.timestep
        model.opt.impratio = self.impratio
        model.opt.gravity[:] = self.gravity
        model.opt.iterations = self.iterations
        model.opt.tolerance = self.tolerance
        model.opt.ls_iterations = self.ls_iterations
        model.opt.ls_tolerance = self.ls_tolerance

    def apply_to(self, m: Model) -> Model:
        """The options on a converted Model. The cone fixes the constraint
        row layout, so it must already match."""
        if _CONE_MAP[self.cone] != int(m.opt.cone):
            raise ValueError(
                f"the model was converted with cone {int(m.opt.cone)}; "
                f"cfg asks for {self.cone!r}"
            )
        t = lambda x: torch.as_tensor(x, dtype=m.dtype, device=m.device)  # noqa: E731
        opt = dataclasses.replace(
            m.opt,
            timestep=t(self.timestep), impratio=t(self.impratio),
            gravity=t(self.gravity), integrator=_INTEGRATOR_MAP[self.integrator],
            iterations=self.iterations, tolerance=self.tolerance,
            ls_iterations=self.ls_iterations, ls_tolerance=self.ls_tolerance,
        )
        return dataclasses.replace(m, opt=opt)


@dataclass(kw_only=True)
class SimulationCfg:
    """Simulation configuration. nconmax bounds the compacted contact-slot
    count K per env (constraint rows are laid out statically, so there is
    no njmax)."""

    nconmax: int | None = None
    mujoco: MujocoCfg = field(default_factory=MujocoCfg)
    dtype: str = "float32"


def check_supported(m: Model) -> None:
    """Raise NotImplementedError on a model feature this package does not
    carry yet (see ROADMAP.md); the CPU and the card carry the same."""
    if m.ntendon:
        raise NotImplementedError("tendons are not ported yet")
    if m.na:
        raise NotImplementedError("activation states (na > 0) are not ported yet")
    if any(int(t) != TRN_JOINT for t in m.actuator_trntype):
        raise NotImplementedError("only joint transmissions are ported")
    missing = pair_families(m) - PAIR_FAMILIES if m.pairs.ncon else set()
    if missing:
        raise NotImplementedError(
            f"narrowphase families {sorted(missing)} are not ported yet"
        )
    if not (m.pairs.ncon and m.ncon_max):
        raise NotImplementedError("the solver kernel takes a model with contacts")
    for name in SMOOTH_HOST_FIELDS:
        rows = getattr(m, _FIELD_ROWS[name.split("_")[0]])
        shape = tuple(getattr(m, name).shape)
        ndim = 1 if name in _VECTOR_FIELDS else 2
        if len(shape) != ndim or shape[0] != rows:
            raise NotImplementedError(
                f"per-env model field {name} {shape} is not ported yet"
            )


# leading dimension of a model field, by its name's prefix, and the fields
# that hold one value per row
_FIELD_ROWS = dict(
    qpos0="nq", qpos="nq", body="nbody", jnt="njnt", geom="ngeom",
    dof="nv", actuator="nu",
)
_VECTOR_FIELDS = frozenset({
    "qpos0", "qpos_spring", "body_mass", "dof_armature", "dof_damping",
    "jnt_stiffness",
})


class Simulation:
    """Holds the batched (Model, Data) pair: step(), forward(), reset(mask),
    refresh().

    Per-env (domain-randomised) model fields are not carried yet; every
    env shares the one Model."""

    def __init__(
        self,
        num_envs: int,
        cfg: SimulationCfg,
        mj_model: "mujoco.MjModel | Model",
        device: str | torch.device = "cuda",
    ):
        self.cfg = cfg
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.dtype = torch.float64 if cfg.dtype == "float64" else torch.float32
        if isinstance(mj_model, Model):
            m = mj_model
            want = min(m.pairs.ncon, 64 if cfg.nconmax is None else cfg.nconmax)
            if want != m.ncon_max:
                raise ValueError(
                    f"the model was converted with nconmax {m.ncon_max}; "
                    f"cfg asks for {cfg.nconmax}"
                )
            if m.dtype != self.dtype or m.device != self.device:
                m = model_from_numpy(
                    *model_to_numpy(m), dtype=self.dtype, device=self.device
                )
            self.mj_model = None
            self.model: Model = cfg.mujoco.apply_to(m)
        else:
            cfg.mujoco.apply(mj_model)
            self.mj_model = mj_model
            self.model = put_model(
                mj_model, dtype=self.dtype, nconmax=cfg.nconmax,
                device=self.device,
            )
        check_supported(self.model)
        self.data: Data = make_data(self.model, num_envs)

    def step(self) -> None:
        """One physics step of every env."""
        self.data = step_envlast(self.model, self.data)

    def forward(self) -> None:
        """mj_forward of every env: positions, velocities, forces and the
        constraint solve, with the whole Data surface written (efc rows,
        the packed contact table, qM/qLD/qLDinv, every frame). Pyramidal
        cone only: raises NotImplementedError under the elliptic one."""
        self.data = forward_hybrid(self.model, self.data)

    def refresh(self) -> None:
        """Per-control-step kinematic refresh of every env (frames, com,
        cinert, cdof, cvel, cdof_dot)."""
        self.data = refresh_envlast(self.model, self.data)

    def reset(self, mask: np.ndarray | torch.Tensor | None = None) -> None:
        """Reset the masked envs (all when mask is None) to qpos0, zero
        velocity, the mocap bodies' model frames and fresh derived
        state."""
        if mask is None:
            mask = torch.ones(self.num_envs, dtype=torch.bool)
        mask = torch.as_tensor(mask, dtype=torch.bool, device=self.device)
        self.data = reset_data(self.model, self.data, mask)
