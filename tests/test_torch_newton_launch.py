"""The launch shape of the solve kernels and of the crb kernel, the
batched doubling probes of the solves' line search, and the toy models the
card tests run them on.

CPU only: newton_launch_shape (phys/solver_kernels.py) and
dense_launch_shape (phys/solver_dense_kernels.py) are the one place each
solve's launch shape lives; the kernels' launchers check it against their
own layout on the card (tests/test_torch_cuda.py). Here they are held
against an H100's budgets (65,536 registers and 232,448 bytes of shared
memory per SM less 1 KB per block) at the shapes of the G1, the YAM and the
toys, and against the resident-thread target: four times what one warp per
env held (step solves: G1 192, YAM 160 threads per SM; the dense solve:
4 envs, 128 threads per SM on the G1). The crb kernel's block
(smooth_kernels.crb_smem_bytes, 16 envs) is held against the same
shared-memory budget.
"""

import dataclasses

import numpy as np
import pytest
import torch

from mjlab_tpu_torch.phys import model as pm
from mjlab_tpu_torch.phys import smooth_kernels as sk
from mjlab_tpu_torch.phys import solver_dense_kernels as sd
from mjlab_tpu_torch.phys import solver_kernels as sv
from mjlab_tpu_torch.sim.sim import check_supported

import torch_toy_models as toys
from test_torch_cuda import _solve_inputs, _toy_sim

REGISTERS_PER_SM = 65536
SMEM_PER_SM = 232448
SMEM_RESERVED_PER_BLOCK = 1024
# resident threads per SM, four times the one-warp-per-env design's
TARGET = {"g1": 4 * 192, "yam": 4 * 160}


def _model(name):
    if name == "g1":
        from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

        return physics.load_saved_model(device="cpu")[0]
    if name == "yam":
        from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

        return physics.load_saved_model(device="cpu")[0]
    return pm.load_model(toys.DIR / f"{name}.npz", device="cpu")[0]


@pytest.mark.parametrize("name", ["g1", "yam", *toys.NAMES])
def test_launch_shape_fits_the_budgets(name):
    m = _model(name)
    cone = int(m.opt.cone)
    s = sv.newton_launch_shape(cone, m.nv, m.ncon_max, m.rows_per_con, m.neq_jnt, m.nlimit)
    threads = s.threads_per_env * s.envs_per_block
    assert threads % 32 == 0 and threads <= 1024
    # registers: __launch_bounds__(threads, min_blocks) caps a thread at
    # the largest multiple of 8 that lets min_blocks blocks fit
    cap = REGISTERS_PER_SM // (threads * s.min_blocks_per_sm) // 8 * 8
    assert threads * cap * s.min_blocks_per_sm <= REGISTERS_PER_SM
    # shared memory: min_blocks blocks of this model's envs fit an SM
    per_block = s.smem_bytes_per_env * s.envs_per_block + SMEM_RESERVED_PER_BLOCK
    assert per_block * s.min_blocks_per_sm <= SMEM_PER_SM
    assert s.smem_bytes_per_env <= 232448  # what one block may opt in to
    resident = threads * min(s.min_blocks_per_sm, SMEM_PER_SM // per_block)
    assert resident >= TARGET.get(name, min(TARGET.values())), resident


def _fits(s, target):
    """The register and shared-memory budgets of shape s, and its resident
    threads per SM against target."""
    threads = s.threads_per_env * s.envs_per_block
    assert threads % 32 == 0 and threads <= 1024
    cap = REGISTERS_PER_SM // (threads * s.min_blocks_per_sm) // 8 * 8
    assert threads * cap * s.min_blocks_per_sm <= REGISTERS_PER_SM
    per_block = s.smem_bytes_per_env * s.envs_per_block + SMEM_RESERVED_PER_BLOCK
    assert s.smem_bytes_per_env <= 232448  # what one block may opt in to
    resident = threads * min(s.min_blocks_per_sm, SMEM_PER_SM // per_block)
    assert resident >= target, resident
    return resident


@pytest.mark.parametrize("name", ["g1", "yam", *toys.NAMES])
def test_dense_launch_shape_fits_the_budgets(name):
    """Kernel 6 with every row live (the most shared memory a batch can
    ask), and with half of them: the budgets, and at least four times the
    one-warp design's 128 resident threads per SM."""
    m = _model(name)
    full = sd.dense_launch_shape(m.nv, m.nefc, m.nefc)
    half = sd.dense_launch_shape(m.nv, m.nefc, m.nefc // 2)
    assert full.threads_per_env == 128 and full.envs_per_block == 1
    assert half.smem_bytes_per_env < full.smem_bytes_per_env
    assert _fits(half, 4 * 128) >= _fits(full, 4 * 128)
    # the rows' D and class fit the J region before the live rows are known
    assert sd.dense_launch_shape(m.nv, m.nefc, 0).smem_bytes_per_env > 8 * m.nefc


@pytest.mark.parametrize("name", ["g1", "yam", *toys.ALL])
def test_crb_block_fits_the_budgets(name):
    """The crb kernel's block of 16 envs x 16 workers: its shared memory
    (10 floats per body, 12 per dof per env) fits a block, and at least
    two blocks (32 envs) fit an SM."""
    m = _model(name)
    smem = sk.crb_smem_bytes(m)
    assert smem == 4 * 16 * (10 * m.nbody + 12 * m.nv)
    assert smem <= 232448
    assert SMEM_PER_SM // (smem + SMEM_RESERVED_PER_BLOCK) >= 2


def test_launch_shape_refuses_more_dofs_than_the_kernels_take():
    with pytest.raises(ValueError, match="dofs"):
        sv.newton_launch_shape(0, 46, 4, 4, 0, 0)
    with pytest.raises(ValueError, match="dofs"):
        sd.dense_launch_shape(46, 10, 10)


def _serial_hi(slopes):
    """The serial doubling loop on a table of slopes at 2^0 .. 2^11."""
    hi = torch.ones(slopes.shape[1], dtype=slopes.dtype)
    for _ in range(12):
        g = slopes[torch.log2(hi).long().clamp(max=11), torch.arange(slopes.shape[1])]
        hi = torch.where(g < 0, hi * 2, hi)
    return hi


def test_doubling_replay_matches_the_serial_loop():
    rng = np.random.default_rng(0)
    E = 4000
    slopes = torch.as_tensor(rng.choice([-1.0, -0.5, 0.0, 0.5, np.nan], (12, E),
                                        p=[0.6, 0.2, 0.1, 0.08, 0.02]))
    slopes[:, 0] = -1.0  # every probe negative: hi = 2^12
    slopes[:, 1] = 0.0  # the first probe exactly 0: hi stays 1
    slopes[:5, 2] = -1.0
    slopes[5, 2] = 0.0  # exactly 0 at 2^5
    hi = sv.doubling_replay(slopes)
    assert torch.equal(hi, _serial_hi(slopes))
    assert hi[0] == 2.0**12 and hi[1] == 1.0 and hi[2] == 2.0**5


def test_doubling_replay_on_the_plain_versions_slopes(monkeypatch):
    """The plain solve's own slopes at 2^0 .. 2^11 (every Newton iteration
    of a settled toy) give the serial loop's hi."""
    seen, replay = [], sv.doubling_replay

    def checked(slopes):
        hi = replay(slopes)
        seen.append(torch.equal(hi, _serial_hi(slopes)))
        return hi

    monkeypatch.setattr(sv, "doubling_replay", checked)
    args, kw = _solve_inputs(_toy_sim("eq_toy", 16, "cpu"))
    sv.newton_assemble_solve(*args, **kw)
    assert seen and all(seen)


@pytest.mark.parametrize("name", toys.ALL)
def test_toy_model_files_match_fresh_conversion(name):
    fresh = toys.convert(name)
    saved, _ = pm.load_model(toys.DIR / f"{name}.npz", dtype=torch.float64, device="cpu")
    for n in pm.tensor_fields():
        assert torch.equal(getattr(fresh, n), getattr(saved, n)), n
    for n in pm.static_fields():
        if n != "pairs":
            np.testing.assert_array_equal(np.asarray(getattr(fresh, n)),
                                          np.asarray(getattr(saved, n)), err_msg=n)
    for f in dataclasses.fields(pm.PairTable):
        np.testing.assert_array_equal(np.asarray(getattr(fresh.pairs, f.name)),
                                      np.asarray(getattr(saved.pairs, f.name)), err_msg=f.name)
    for n in pm.OPTION_TENSOR_FIELDS:
        assert torch.equal(getattr(fresh.opt, n), getattr(saved.opt, n)), n
    for n in pm.OPTION_STATIC_FIELDS:
        assert getattr(fresh.opt, n) == getattr(saved.opt, n), n


@pytest.mark.parametrize("name", toys.NAMES)
def test_simulation_steps_the_toys(name):
    """A joint equality under the pyramidal cone and models without joint
    limits are accepted and step (on the CPU, through the plain solve)."""
    sim = _toy_sim(name, 4, "cpu")
    check_supported(sim.model)
    m = sim.model
    if name == "eq_toy":
        assert m.neq_jnt == 1 and int(m.opt.cone) == 0
    else:
        assert m.nlimit == 0
    assert bool(torch.isfinite(sim.data.qpos).all())
    assert int(sim.data.ncheck_reset.sum()) == 0
