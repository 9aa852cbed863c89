"""Simulation: batched physics over a (Model, Data) pair on one device.

PyTorch counterpart of mjlab_tpu/sim/sim.py: the standalone API for tests,
benchmarks and interactive use. One engine, the env-last kernel path
(phys/hybrid.py). The model is converted once; Data carries a leading
num_envs axis. Runs on CUDA unless the caller passes device="cpu", where
every kernel runs its plain PyTorch version.

The model is a compiled mujoco.MjModel, or a Model already converted (for
instance one read by phys.model.load_model on a machine without MuJoCo).

The control step (ControlStep) plays the role ``jax.jit`` of the vmapped
step plays in the JAX package (mjlab_tpu/sim/sim.py:1-12): decimation
physics substeps, each between the caller's pre- and post-substep calls,
then the kinematic refresh (or the caller's own ``after``, as the env's
step has it), captured on the card as one CUDA graph over the
Simulation's static Data buffers.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Callable, Literal

import numpy as np
import torch

from mjlab_tpu_torch.phys.data import (
    Contact, Data, make_data, reset_data, tensor_fields,
)
from mjlab_tpu_torch.phys.hybrid import forward_hybrid, refresh_envlast, step_envlast
from mjlab_tpu_torch.phys.lm.collision import PAIR_FAMILIES, PARAM_FIELDS, pair_families
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
    # accepted as the JAX package's MujocoCfg accepts them, and unused: the
    # port's constraint rows are dense, and it has no convex-convex CCD
    jacobian: Literal["auto", "dense", "sparse"] = "auto"
    ccd_iterations: int = 50

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
    """Simulation configuration, with the fields of the JAX package's
    SimulationCfg. nconmax bounds the compacted contact-slot count K per
    env. Used by the port: nconmax, mujoco, dtype, and
    contact_sensor_maxmatch (the most contact slots one contact-sensor
    row may match; sensor/contact_sensor.py checks it). Accepted and
    unused, as in the JAX package: njmax (constraint rows are laid out
    statically) and ls_parallel (every env is a batch lane). nan_guard is
    carried for the env, which reads it (the NaN guard is not ported
    yet)."""

    nconmax: int | None = None
    njmax: int | None = None
    ls_parallel: bool = True
    contact_sensor_maxmatch: int = 64
    mujoco: MujocoCfg = field(default_factory=MujocoCfg)
    dtype: str = "float32"
    nan_guard: object | None = None


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
    refresh(), and per-env model fields (expand_model_fields).

    ``data`` is rebound by every call until ``make_static()``; from then on
    (a ControlStep calls it) the Data's tensors are fixed buffers, and
    every write to ``data`` (a step, a reset, ``sim.data = d.replace(...)``)
    copies into them in place, so that a captured graph, which reads and
    writes fixed addresses, sees it. A Data read from ``sim.data`` before a
    write is then the same buffers, not a snapshot."""

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
        self._data: Data = make_data(self.model, num_envs)
        self._static = False
        self._default_fields: dict[str, torch.Tensor] = {}
        self._captured = False

    # -- Data: rebound, or fixed buffers written in place --

    @property
    def data(self) -> Data:
        return self._data

    @data.setter
    def data(self, new: Data) -> None:
        if self._static:
            copy_data_(self._data, new)
        else:
            self._data = new

    def make_static(self) -> None:
        """Give every Data field buffers of its own (no broadcast views)
        and write every later Data in place into them."""
        if not self._static:
            self._data = materialize(self._data)
            self._static = True

    # -- per-env model fields (domain randomisation) --

    def expand_model_fields(self, field_names: list[str]) -> None:
        """Give the named Model fields a leading num_envs axis, each env
        starting from the shared value (mjlab_tpu/sim/sim.py:145-162). A
        domain randomisation event then writes the (num_envs, ...) tensor
        in place; the next step reads it. The slot parameters of the
        contacts (phys/lm/collision.py PARAM_FIELDS) are the fields the
        port carries per env; the others are not ported yet. Expand before
        a control step is captured: the graph holds the Model it saw."""
        if self._captured:
            raise RuntimeError(
                "expand model fields before a control step is captured"
            )
        updates = {}
        for name in field_names:
            if name not in PARAM_FIELDS:
                raise NotImplementedError(
                    f"per-env model field {name} is not ported yet (the "
                    f"port carries {sorted(PARAM_FIELDS)} per env)"
                )
            if name in self._default_fields:
                continue
            val = getattr(self.model, name)
            self._default_fields[name] = val
            updates[name] = val.expand((self.num_envs,) + tuple(val.shape)).clone()
        if updates:
            self.model = dataclasses.replace(self.model, **updates)

    def get_default_field(self, name: str) -> torch.Tensor:
        """The shared value of a model field before expand_model_fields
        (mjlab_tpu/sim/sim.py:164-171): DR events draw around it, so that
        values do not accumulate across resets."""
        if name in self._default_fields:
            return self._default_fields[name]
        return getattr(self.model, name)

    # -- the physics --

    def step(self, frames: bool = False) -> None:
        """One physics step of every env; ``frames`` also writes the
        refreshed fields of the state the step started from (phys/
        hybrid.py step_envlast)."""
        self.data = step_envlast(self.model, self.data, frames=frames)

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


def materialize(d: Data) -> Data:
    """d with every field a contiguous tensor of its own."""
    kw = {name: _field(d, name).contiguous().clone() for name in tensor_fields()}
    kw["contact"] = Contact(packed=kw["contact"])
    return Data(**kw)


def copy_data_(dst: Data, src: Data) -> None:
    """Copy every field of src that is not already dst's own tensor into
    dst's buffers, in place."""
    for name in tensor_fields():
        a, b = _field(dst, name), _field(src, name)
        if a is not b:
            a.copy_(b)


def _field(d: Data, name: str) -> torch.Tensor:
    return d.contact.packed if name == "contact" else getattr(d, name)


class ControlStep:
    """One control step of every env: ``before()``, then ``decimation``
    times ``pre_substep()``, a physics step and ``post_substep()``, then
    ``after()`` (by default the kinematic refresh: the env's decimation
    loop and refresh, mjlab_tpu/envs/manager_based_rl_env.py:424-444 and
    392-397). The env's step passes its own ``before`` (the action) and
    ``after`` (terminations, rewards, masked resets, the refresh where the
    JAX env places it, commands, events, observations) and
    ``frames_last``: the last substep also writes the frames of the state
    it started from, which the terminations and rewards read, as after
    mj_step. The callables read and write the Simulation's Data
    (``sim.data``) and tensors of their own, in place.

    ``eager()`` runs it op by op. ``capture()`` records it on the card as
    one torch.cuda.CUDAGraph, and ``replay()`` then runs that graph. The
    graph reads and writes fixed buffers: the Simulation's Data (made
    static here) and the tensors ``state()`` lists (entity, sensor and
    manager state); a reset, a domain randomisation write or a new input
    written into them between replays is what the next replay reads. The
    ``generators`` (torch.Generator on the card) are registered with the
    graph, so that each replay draws fresh numbers, as the same number of
    eager steps would. There is no fallback: a capture or replay failure
    raises."""

    def __init__(
        self,
        sim: Simulation,
        decimation: int,
        pre_substep: Callable[[], None] | None = None,
        post_substep: Callable[[], None] | None = None,
        state: Callable[[], list[torch.Tensor]] | None = None,
        before: Callable[[], None] | None = None,
        after: Callable[[], None] | None = None,
        generators: tuple[torch.Generator, ...] = (),
        frames_last: bool = False,
    ):
        sim.make_static()
        self.sim = sim
        self.decimation = decimation
        self.pre_substep = pre_substep or (lambda: None)
        self.post_substep = post_substep or (lambda: None)
        self.state = state or (lambda: [])
        self.before = before or (lambda: None)
        self.after = after if after is not None else sim.refresh
        self.generators = tuple(generators)
        self.frames_last = frames_last
        self.graph: torch.cuda.CUDAGraph | None = None

    def eager(self) -> None:
        """The control step, op by op."""
        self.before()
        for i in range(self.decimation):
            self.pre_substep()
            self.sim.step(frames=self.frames_last and i == self.decimation - 1)
            self.post_substep()
        self.after()

    def capture(self, warmup: int = 2) -> None:
        """Record the control step as one CUDA graph. ``warmup`` eager
        control steps run first on a side stream (they fill every lazy
        table and build the kernels), the last of them with host
        synchronisation an error; the state they advance and the
        generators' state they drew from are put back before capture, so
        the next replay starts where the caller left off."""
        sim = self.sim
        if sim.device.type != "cuda":
            raise RuntimeError("a control step is captured on a CUDA device")
        saved = [t.clone() for t in self._buffers()]
        drawn = [g.get_state() for g in self.generators]
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            for i in range(warmup):
                if i == warmup - 1:
                    torch.cuda.set_sync_debug_mode("error")
                try:
                    self.eager()
                finally:
                    torch.cuda.set_sync_debug_mode("default")
            for t, s in zip(self._buffers(), saved):
                t.copy_(s)
        torch.cuda.current_stream().wait_stream(side)
        torch.cuda.synchronize()
        for g, s in zip(self.generators, drawn):
            g.set_state(s)
        graph = torch.cuda.CUDAGraph()
        for g in self.generators:
            graph.register_generator_state(g)
        sim._captured = True
        with torch.cuda.graph(graph):
            self.eager()
        self.graph = graph

    def replay(self) -> None:
        """One control step: a replay of the captured graph."""
        if self.graph is None:
            raise RuntimeError("capture() the control step before replay()")
        self.graph.replay()

    def _buffers(self) -> list[torch.Tensor]:
        d = self.sim.data
        return [_field(d, n) for n in tensor_fields()] + list(self.state())
