#!/usr/bin/env python3
"""Smoke run of the PyTorch port (mjlab_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

    python3 chip_smoke.py --only-explicit  # this slice's two paths, no result line
    python3 chip_smoke.py --only-jump      # the jump paths, no result line
    python3 chip_smoke.py --only-tracking  # the tracking paths, no result line
    python3 chip_smoke.py --only-yam     # the lift-cube paths, no result line
    python3 chip_smoke.py --only-rough   # the rough-terrain paths, no result line

Twenty main paths, each driven at 4096 envs through its public entry
points, and the six kernels they run. This slice's main path is training
the G1 flat-velocity env with mixed explicit actuator groups
(mjlab_tpu_torch/tasks/velocity/config/g1/explicit.py: delayed DC motors
on the legs, ideal PD on the arms and waist, builtin position actuators on
the wrists with their force range, gain and bias per env; the PD-gain and
effort-limit events on reset, the lag range at startup, an external
wrench on the torso every 1-3 s; the nan_detection termination; the NaN
guard on):

- g1_explicit_train: PPO on that env through the flat G1 task's runner
  and PPO config, three learn() iterations, with the learner checks (the
  update on the card against the CPU), the checkpoint round trip and the
  ONNX: kin_com, crb_packed, vel_smooth (reading actuator_forcerange,
  gainprm and biasprm per env) and newton_assemble_solve cone 0 inside
  the env's graph, the actuators' delays drawn inside it;
- g1_explicit_env: the env captured against an eager twin bit for bit
  across forced resets (tipped roots, time-outs) and a NaN step (one env's
  wrist gain set to NaN between replays: nan_detection ends it alone, the
  NaN guard flags it inside the graph, and the dumps the host writes at
  close() are equal; another env's qvel set to NaN, which the physics
  step's own bad-state reset absorbs, as in the JAX package); eager and
  captured env-steps/s; kernels 1-4 against their plain versions on the
  env's state with every force range cut so that forces saturate (rows 1-4
  of the kernels line); 64 envs on the card against the CPU port on the
  same draws, every env held, then the NaN step in both and the card's
  dump against the CPU twin's window.

Training the G1 to jump from a crouch, the first task whose physics is
not dt 0.005 with decimation 4: dt 0.002 and decimation 2, so a control
step launches kin_com 3 times and the other kernels twice:

- jump_train: PPO on the Mjlab-Jump-Flat-Unitree-G1 env (the G1 flat
  scene with the feet's contact sensor, nconmax 35, the pyramidal cone,
  dt 0.002, decimation 2, a 5 s episode; the crouched start
  JUMP_CROUCH_KEYFRAME, the feet ~13 cm into the floor) through
  OnPolicyRunner (the task registers no runner class) with the task's PPO
  config (actor 256-128-64, critic 512-256-128, 6 epochs), three learn()
  iterations: kin_com, crb_packed, vel_smooth and newton_assemble_solve
  cone 0 inside the env's graph; the update on the card against the CPU;
  the checkpoint round trip and the ONNX;
- jump_env: the jump env, captured against an eager twin bit for bit
  (outputs, qpos, qvel, the command's and the reward terms' state) across
  forced resets (roots tipped: fell_over; roots low: height_too_low;
  time-outs; drops from a lift: a flight, then a landing); the global step
  count written between replays past the curricula's second and last
  stages, which the next replay's curricula read and write in place (the
  command's 0-d target and tolerance, the landing_stability weight);
  eager and captured env-steps/s; kernels 1-4 against their plain
  versions on the env's state (rows 1-4 of the kernels line); 64 envs on
  the card against the CPU port, every env held (the reward of the first
  step after the reset, ill-conditioned at float32, printed; a second
  step from the card's state copied into the CPU env, every output);
- jumping_env and jumping_train: the same on
  Mjlab-Jumping-Flat-Unitree-G1 (dt 0.005, decimation 4; the G1
  standing), its command's mid-episode resample, flight and landing
  latches and trigger decay inside the graph, the curriculum widening the
  command's target range in place (roots low: lying on their side,
  fell_down);

and the paths of the slices before. Training the G1 to track a motion,
with the torso's body_ipos carried per env (the task's base_com event),
which kernels 1-3 read from the Model's (E, ...) tensor in place of their
table's constant:

- tracking_train: PPO on the Mjlab-Tracking-Flat-Unitree-G1 env (the
  G1 flat scene, nconmax 35, the pyramidal cone; the motion
  evidence/tracking_r4/motion.npz: 400 frames at 50 fps; adaptive start
  frames) through the task's runner (MotionTrackingOnPolicyRunner) with
  its PPO config, three learn() iterations: kin_com, crb_packed,
  vel_smooth and newton_assemble_solve cone 0 inside the env's graph; the
  checkpoint round trip and the motion-embedded ONNX;
- tracking_env: the tracking env, captured against an eager twin bit for
  bit (outputs, qpos, qvel, the command's time steps, failure counts and
  metrics) across forced resets (roots lifted: the anchor-height
  termination; rolled: the anchor-orientation one; arms raised: the
  end-effector one; time-outs; motions run past their end), whose failed
  envs the adaptive sampler counts; a base_com write of new body_ipos
  values between replays, which the next replay reads; two replays that
  draw different start frames; eager and captured env-steps/s; kernels
  1-4 against their plain versions on the env's state (with the per-env
  fields each read); 64 envs on the card against the CPU port;

and the paths of the slices before. Training the YAM arm's cube lift, the
one task on the elliptic cone:

- yam_train: PPO on the Mjlab-Lift-Cube-Yam env (the task's full config:
  nconmax 55, the elliptic cone at impratio 10, a joint equality, a mocap
  base, the fingertips' friction per env) through OnPolicyRunner (the
  task registers no runner class) with the task's PPO config, three
  learn() iterations: kin_com (with the mocap frames), crb_packed,
  vel_smooth and newton_assemble_solve cone 1 (kernel 5) inside the env's
  graph; the checkpoint round trip and the deployment ONNX;
- yam_env: the lift-cube env, captured against an eager twin bit for bit
  across forced resets (arms lowered into the table: the ground-contact
  termination; time-outs; commands run out mid-episode: the lifting
  command's resample writes the cube's free joint inside the graph);
  eager and captured env-steps/s; kernels 1-3 and 5 against their plain
  versions on the env's state; 64 envs on the card against the CPU port;

and the paths of the slices before. Training on rough terrain:

- g1_rough_train: PPO on the Mjlab-Velocity-Rough-Unitree-G1 env (the
  full ROUGH_TERRAINS_CFG: 10 x 20 sub-terrains of 8 m and a 20 m border,
  one 2001 x 1201 height field on the card; the terrain curriculum; at
  most level 5 at the start) through the task's runner with its full PPO
  config, three learn() iterations: kin_com, crb_packed, vel_smooth and
  newton_assemble_solve cone 0 inside the env's graph, the height-field
  pair families in the eager contact stack the graph holds;
- g1_rough_env and go1_rough_env: the rough G1 and Go1 envs, captured
  against an eager twin across forced resets that the terrain
  curriculum promotes (roots moved past half a sub-terrain) and demotes
  (roots left near their origin): levels and origins bit for bit; eager
  and captured env-steps/s; kernels 1-4 against their plain versions on
  the env's state (robots on flat patches and stairs up and down; the Go1
  a third model shape: nv 18, 15 bodies, 17 slots); the height-field
  narrowphase on the card against the CPU with geoms on and past the
  field's four edges (HFIELD_TOL); 64 envs on the card against the CPU
  port on the same draws;

and the paths of the slices before:

- g1_train: PPO on the Mjlab-Velocity-Flat-Unitree-G1 env through the
  task's runner (rl/runner.py, tasks/velocity/rl/runner.py) from the port's
  registry, with the task's full PPO config (actor and critic (512, 256,
  128) ELU, 24 steps per env, 5 epochs of 4 minibatches, the adaptive KL
  schedule, obs normalisation): three learn() iterations, each a rollout
  of 24 env steps (one CUDA graph replay each: kin_com, crb_packed,
  vel_smooth and newton_assemble_solve cone 0 inside it, plus the policy)
  and the update;

and the paths of the slices before:

- g1_env: the Mjlab-Velocity-Flat-Unitree-G1 env (envs/
  manager_based_rl_env.py), built from the port's registry, its whole step
  (the action, 4 x (actuators, physics, sensors), terminations, rewards,
  masked resets, the refresh, the command, the push event, observations)
  captured as one CUDA graph by its first step(), on bench.py's traffic (a
  fresh action 0.5 N(0, 1) per control step): kin_com, crb_packed,
  vel_smooth and newton_assemble_solve cone 0 inside the graph;

- g1_capture: the G1 control step as the env runs it
  (tasks/velocity/config/g1/physics.py control_step): 4 substeps of the
  robot's actuator controls from its joint targets, the physics step and
  the sensors' update (contact air time), then the refresh, with the feet's
  friction per env (the task's startup event) and the task's scene (entity,
  two contact sensors, the XML's four builtin sensors); captured as one
  CUDA graph (sim.ControlStep): kin_com, crb_packed, vel_smooth and
  newton_assemble_solve cone 0 inside the graph;
- yam_capture: the YAM physics control step (4 substeps and the refresh,
  fingertip friction per env, the task's own traffic) captured the same
  way: the elliptic kernel inside the graph;

- g1: Mjlab-Velocity-Flat-Unitree-G1 physics (nconmax 35, pyramidal cone),
  reset, step and refresh: kin_com, crb_packed (the kernel of crb_dense:
  the dense mass matrix and its implicit diagonal in one launch),
  vel_smooth and newton_assemble_solve cone 0;
- yam: Mjlab-Lift-Cube-Yam physics (nconmax 55, elliptic cone with
  impratio 10, a joint equality, a mocap base, the box contact families),
  reset, step and refresh: kin_com with mocap frames, crb_packed,
  vel_smooth and newton_assemble_solve cone 1 (the elliptic kernel);
- g1_forward: the G1's Simulation.forward() (mj_forward over the whole
  Data surface: the batched stages, the dense contact rows, every efc row
  and the packed contact table written): newton_solve_dense, the solve
  over the dense constraint Jacobian (nefc 204).

All: 10 Newton / 20 line-search iterations, implicitfast; dt 0.005 and
4 substeps per control step but for the jump task's dt 0.002 and 2: each
path's launch counts and time checks follow its task's decimation.

Phases, each of which raises on a failure (no phase failure is caught):

1. build the CUDA kernels from mjlab_tpu_torch/csrc (nvcc, one process per
   source, all at once) and print the build time;
then for each path:
2. build the model from the file the repo keeps and a Simulation;
3. reset, seed a state (G1: the knees-bent keyframe plus numpy noise; YAM:
   half the envs at the task's reset state, half pinching the cube, with
   noise on the arm, so that the kernels meet every contact regime) and
   settle it for a few control steps;
4. hold each kernel of the path against its plain PyTorch version on that
   state, at the path's shapes (float32; TF32 matmuls off), and time both
   (the tolerances are those of the CPU parity tests; qfrc_constraint
   under the iteration-count rule of solver_kernels.qfrc_errors, and the
   count of envs whose Newton iteration counts differ is printed, with the
   solve kernel's launch shape and resident threads per SM);
5. the main path on the path's traffic (G1: the settled state, random
   ctrl around the keyframe; YAM: the task's own, every env reset and
   random actions, as bench.py): 25 control steps of the task's physics
   substeps (4) plus the kinematic refresh, ctrl from a seeded generator, timed with
   CUDA events after one warm control step; the launch counts, set to 0
   just before and read just after, must show the path went through each
   of its kernels (and through the solve kernel of its cone only);
6. the output is right: finite qpos, no diverged-state resets, and three
   steps of a 64-env Simulation on the card agree with the same steps on
   the CPU (the plain versions) within the step tolerances (E2E_TOL), with
   the same active contact slots in every env.

The g1_forward path seeds and settles the G1 state as the g1 path does,
holds newton_solve_dense against its plain version on the dense inputs of
that state's forward pass, times FORWARD_CALLS forward() calls after a
warm one (launch counts: newton_solve_dense once per call, no other
kernel) with a per-phase breakdown (position, contact, velocity, solve,
writeback), and checks forward() of 64 envs on the card against the CPU
field by field.

Each captured path (after the three above) builds two twins on one seeded
state, sets the launch counts to 0 and captures the second twin's control
step (two eager warm-up steps first, the last with host synchronisation an
error; the counts must show each kernel of the step once per control step
for the three steps the wrappers ran), then: 3 control steps, eager
against replays, within the step tolerances (E2E_TOL) with the same active
contact slots in every env; a masked reset and a per-env friction write
between replays, which the next replay must read (the reset envs restart,
the slots' friction is the mix of the new values); eager and captured
env-steps/s, each the median of CAPTURE_REPEATS x CAPTURE_STEPS control
steps (CUDA events, commands written between steps); one eager and one
captured control step under the profiler (CUDA kernels, device busy ms,
idle share; every kernel of the step must show in the replay). The G1
path then holds the scene's sensors on the card, after 3 replays of 64
envs, against the CPU port's on the same Data (SENSOR_TOL).

The g1_env path builds two envs on one seed (an eager twin and the
captured one), resets both, sets the launch counts to 0 and drives the
captured env's first step() (its two warm-up steps and the capture must
show each kernel once per control step: kin_com 5, the other three 4),
then: the captured env against its eager twin (the same generator state:
the same draws) over 3 more steps, the first after tipping every 7th env
past fell_over's limit and bringing every 11th to its time-out (the same
terminated and truncated envs, reset to episode length 0; observations,
reward and command within ENV_TOL, the state within E2E_TOL, the same
active contact slots); two replays that reset every env draw different
observation noise and reset poses; eager and captured env-steps/s (the
median of CAPTURE_REPEATS x CAPTURE_STEPS control steps); one eager and
one captured step under the profiler (CUDA kernels, busy ms, idle share,
the kernels the env adds over g1_capture's replay); and the env of 64
envs on the card against the CPU port's on the same draws (a reset and
one step).

The g1_train path sets the launch counts to 0 just before learn() and
reads them after it (learn()'s env.reset() runs kin_com once; the env's
capture in the first rollout step then runs each kernel once per control
step: kin_com 5, the other three 4), checks after each iteration that the
losses, the KL and every param are finite and the learning rate inside the
adaptive rule's [1e-5, 1e-2], and prints each iteration's seconds,
rollout and update ms (CUDA events), losses, KL, learning rate and mean
reward; the training env-steps/s is T x N over the iteration's seconds,
the median of the iterations after the one that captures. Then: one
rollout step and one update under the profiler (CUDA kernels, busy ms,
idle share; the rollout step's replay must launch kin_com 5 and the other
three kernels 4 times each); the update on the card (TF32 off) against
the CPU port from the same learner state, storage and permutations, on
TRAIN_CHECK_ENVS envs of the card's first rollout (TRAIN_TOL); and a
checkpoint saved on the card (model_<it>.pt and the ONNX policy) and
loaded with the optimiser into a fresh runner: every learner tensor and
the generator state equal bit for bit.

The rough paths follow (run_rough_paths): g1_rough_env, go1_rough_env
(run_env_path on a generated terrain, whose seed is pinned to SEED so
that twins and the CPU env stand on one terrain), then g1_rough_train
(run_train_path without the learner checks, which g1_train makes: the
learner is the task's own, the same code), whose launch counts the
kernel rows 1-4 carry; its profiled rollout step gives kernel 4's ms per
launch on stairs.

The YAM paths follow (run_yam_paths): yam_env (run_env_path on the
lift-cube task: ENV_KINDS says what it reads of the task; every 7th env's
arm lowered into the table, every 11th at its time-out, every 13th's
command run out with its cube moved, then the outputs, qpos and qvel of
the captured env equal to its eager twin's bit for bit; the resampled
envs' targets, cubes and time left inside the command's ranges; kernels
1-3 and 5 on the env's state, the solve on its stable envs), then
yam_train (run_train_path with the checkpoint round trip and the ONNX
export, which rl/exporter.py writes for the generic runner), whose
launch counts kernel row 5 carries; its profiled rollout step gives
kernel 5's ms per launch.

The tracking paths follow (run_tracking_paths): tracking_env
(run_env_path on the tracking task, ENV_KINDS["tracking"]:
force_tracking_resets and tracking_forced, then com_write between the
first and second check steps and com_seen after the second); then
tracking_train (run_train_path with the checkpoint round trip).

The jump paths run last (run_jump_paths): jump_env (run_env_path on the
jump task, ENV_KINDS["jump"]: force_jump_resets with the global step count
past the curricula's second stage, jump_forced after the first of
JUMP_CHECK_STEPS check steps, the count past their last stage written
between replays and jump_second_stage after the second, jump_landed after
the last), whose kernel checks give rows 1-4 their numbers; jump_train
(run_train_path with the learner checks: its actor and critic differ in
width and it runs 6 epochs; and the checkpoint round trip), whose launch
counts rows 1-4 carry (kin_com 10: the reset's refresh and 3 x 3 in the
capture; the others 6); then jumping_env and jumping_train the same way.

The line before the last is the card's name and power limit (nvidia-smi);
the lines before hold the kernels, the captured steps, the env, the
training runs, the rough, YAM, tracking and jump paths (JSON each), the
substep breakdowns and
the physics throughputs. The last line is {"ok": true, "device": {...}}. Exits
non-zero, printing no result, when there is no CUDA card (2) and when
mjlab_tpu_torch is not importable, e.g. the script copied alone into an
empty directory (1).
"""

from __future__ import annotations

import functools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

NUM_ENVS = 4096
CONTROL_STEPS = 25
SETTLE_STEPS = 10
SEED = 0
PATHS = ("g1", "yam")

# H100 SXM published peaks (NVIDIA data sheet): HBM3 bandwidth and f32
# rate outside the tensor cores, at the full 700 W power limit
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

# kernel vs plain version, float32 (tests/test_torch_stages.py,
# tests/test_torch_solver.py): relative to max(1, |plain|max)
TOL_FRAMES = 2e-6  # kin_com outputs
TOL_SMOOTH = 5e-6  # crb_packed (qM, Mh), vel_smooth
# the solve kernels: phys/solver_kernels.py SOLVE_TOL and FORCE_TOL
# 64 envs x 3 steps on the card against the CPU: the step tolerances of
# tests/test_torch_step.py; under the elliptic cone the contact dynamics
# amplify an f32 difference about 3x per step, so the YAM path takes the
# elliptic multistep tolerances of tests/test_pallas2_solver.py
E2E_TOL = {
    "g1": (("qpos", 1e-4), ("qvel", 1e-3), ("qacc", 5e-3)),
    "yam": (("qpos", 2e-4), ("qvel", 2e-2), ("qacc", 5e-3)),
}

# the forward path: timed forward() calls, and the forward() fields held
# card against CPU on 64 envs (float32 tolerances of the CPU tests,
# tests/test_torch_forward.py; the solve's outputs at the solve
# tolerances, qfrc_constraint at the force tolerance where Newton
# iteration counts may differ by a step)
FORWARD_CALLS = 10
FORWARD_TOL = 5e-5

# the captured control steps: warm-up control steps before capture, the
# control steps held captured against eager, and the timed repeats
CAPTURE_WARMUP = 2
CAPTURE_CHECK_STEPS = 3
CAPTURE_REPEATS = 3
CAPTURE_STEPS = 10
# the G1 sensors on the card against the CPU port on the same Data, float32
SENSOR_TOL = 1e-5
# torch.profiler sessions: how many before a refused one fails, the wait
# for the last kernel records before a session stops, and the pause before
# a retry (times the retry's number): the profiler drops whole sessions in
# bursts (3 in a row once; 2 of 90 sessions of 20 launches in a probe)
PROFILE_TRIES = 6
# late in a full run (minutes into the process) sessions of short launches
# kept only their first records (8 of 20 kin_com launches; a pause before
# the first launch changed nothing): with a wait of 0.3 s (0.02 s
# before) they kept all 20; sessions of kernel 4 there still kept 0-1 of
# 10 (check_kernels times the rough states with CUDA graphs)
PROFILE_DRAIN_S = 0.3
PROFILE_BACKOFF_S = 0.25

# the TPU kernels the rows replace
REPLACES = {
    "kin_com": "mjlab_tpu/phys/smooth_pallas.py:237",
    "crb_packed": "mjlab_tpu/phys/smooth_pallas.py:321",
    "vel_smooth": "mjlab_tpu/phys/smooth_pallas.py:389",
    "newton_assemble_solve": "mjlab_tpu/phys/solver_pallas2.py:623",
    "newton_assemble_solve_elliptic": "mjlab_tpu/phys/solver_pallas2.py:623",
    "newton_solve_dense": "mjlab_tpu/phys/solver_pallas.py:255",
}
# the CUDA kernel (entry function) of each row
KERNEL_NAMES = {
    "kin_com": "kin_com_kernel",
    "crb_packed": "crb_packed_kernel",
    "vel_smooth": "vel_smooth_kernel",
    "newton_assemble_solve": "newton_solve_kernel",
    "newton_assemble_solve_elliptic": "newton_solve_elliptic_kernel",
    "newton_solve_dense": "newton_solve_dense_kernel",
}
SOURCES = {
    "kin_com": "mjlab_tpu_torch/csrc/kin_com.cu",
    "crb_packed": "mjlab_tpu_torch/csrc/crb_packed.cu",
    "vel_smooth": "mjlab_tpu_torch/csrc/vel_smooth.cu",
    "newton_assemble_solve": "mjlab_tpu_torch/csrc/newton_solve.cu",
    "newton_assemble_solve_elliptic": "mjlab_tpu_torch/csrc/newton_solve_elliptic.cu",
    "newton_solve_dense": "mjlab_tpu_torch/csrc/newton_solve_dense.cu",
}


def log(*a):
    print(*a, flush=True)


def rel_err(ref: torch.Tensor, got: torch.Tensor, length: float = 1.0) -> float:
    """max |ref - got| over max(1, |ref|max, length): ``length`` is the
    state's coordinate scale for the kernel checks (coordinate_scale)."""
    ref = ref.double()
    scale = max(1.0, length, float(ref.abs().max())) if ref.numel() else 1.0
    return float((ref - got.double()).abs().max()) / scale if ref.numel() else 0.0


def coordinate_scale(xpos: torch.Tensor) -> float:
    """The largest |world coordinate| of the state's bodies, in metres.
    float32 rounds a coordinate L to about 6e-8 L (7.6e-6 m at 100 m, the
    rough terrain's reach), and a difference of two coordinates (a com
    offset, cdof's linear part, a contact's lever arm) keeps that absolute
    error; so the kernels are held against their plain versions relative
    to max(1, |plain|max, L). A state at the world origin (the physics
    paths) has L about 1 and its tolerances are unchanged; the rough envs'
    robots stand up to 100 m from it."""
    return float(xpos.abs().max())


def max_abs(ref: torch.Tensor, got: torch.Tensor) -> float:
    return float((ref.double() - got.double()).abs().max()) if ref.numel() else 0.0


def cuda_ms(fn, reps: int, warm: int = 1) -> float:
    """Mean time of fn over reps calls back to back, CUDA events: for a
    kernel wrapper this includes the host's work between launches (output
    allocations, argument checks), where it is longer than the kernel."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def profiled(run, accept, prepare=None, tries: int = PROFILE_TRIES) -> tuple[list, str | None]:
    """The CUDA kernel records of one call of run() under torch.profiler, and
    None, or the last session's records and why accept refused them. The
    profiler drops a record now and then, on a rare run every record of a
    short session: a session whose records accept refuses (it returns the
    reason, else None) is made again, up to ``tries`` sessions, each after a
    pause of PROFILE_BACKOFF_S times its number and prepare(). The session
    waits PROFILE_DRAIN_S after the last kernel has ended before it stops,
    for the last records to come in."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    why = None
    for i in range(tries):
        time.sleep(PROFILE_BACKOFF_S * i)
        if prepare is not None:
            prepare()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_DRAIN_S)
        kernels = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
        why = accept(kernels)
        if why is None:
            return kernels, None
        log(f"[profiler] session {i + 1} of {tries}: {why}")
    return kernels, why


def kernel_ms(fn, kernel: str, reps: int, warm: int = 1) -> float:
    """Mean device time per launch of the CUDA kernel whose name contains
    ``kernel`` over reps calls of fn, from the profiler's kernel records
    (the kernel's own execution, without the gaps between launches). The
    mean is over the records the profiler kept. Raises when no session kept
    half of them."""
    def launches(kernels):
        return [e.time_range.elapsed_us() for e in kernels if kernel in e.name]

    def accept(kernels):
        n = len(launches(kernels))
        return None if 2 * n >= reps else (
            f"recorded {n} launches of {kernel}, expected {reps}")

    for _ in range(warm):
        fn()
    kernels, why = profiled(lambda: [fn() for _ in range(reps)], accept)
    if why is not None:
        # the profiler kept too few records in every session (late in a
        # full run it kept 0-4 of 10 in every session of the rough paths'
        # checks): the calls captured in one CUDA graph, timed by events
        ms = graph_ms(fn, reps)
        log(f"[profiler] {kernel}: the profiler {why} in all {PROFILE_TRIES} sessions; "
            f"{reps} calls in one CUDA graph under CUDA events: {ms:.4f} ms per call")
        return ms
    times = launches(kernels)
    return sum(times) / len(times) / 1e3


def graph_ms(fn, reps: int) -> float:
    """Mean device ms per call of fn: reps calls captured in one CUDA graph
    (after a warm call on a side stream), one replay timed with CUDA
    events. No host time between launches; the wrapper's own small kernels
    (output fills) are included."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    graph.replay()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / reps


def cuda_kernels_per_call(fn, reps: int = 10) -> tuple[float, set]:
    """(CUDA kernel records per call, the set of their names, shortened to
    the KERNEL_NAMES entry they contain where there is one) over reps calls
    of fn under the profiler, which may drop a record now and then."""
    fn()
    kernels, why = profiled(lambda: [fn() for _ in range(reps)],
                            lambda ks: None if ks else "recorded no CUDA kernel")
    if why is not None:
        raise RuntimeError(f"the profiler {why}")
    names = [e.name for e in kernels]
    short = {next((k for k in KERNEL_NAMES.values() if k in n), n) for n in names}
    return len(names) / reps, short


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(bytes_moved: float, flops: float) -> tuple[float, str]:
    """Least time the card could take (ms) and what bounds it."""
    t_bytes = bytes_moved / PEAK_BYTES_PER_S
    t_ops = flops / PEAK_F32_FLOPS
    return 1e3 * max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


# ---------------------------------------------------------------------------
# operation counts (f32 FLOPs per env, counted from the kernels' sources)
# ---------------------------------------------------------------------------


def kin_com_flops(m, ncg: int) -> int:
    # per body: frame 70 (+135 per hinge/slide/ball joint, 15 for a free
    # joint's normalisation, 15 for a mocap frame's), xipos 36, com 10,
    # cinert 130; per dof: cdof 20; per collision geom: frame 36 + rotation 90
    njoint_moving = int(np.sum(m.jnt_type != 0))
    nfree = int(np.sum(m.jnt_type == 0))
    return (
        (m.nbody - 1) * 70 + njoint_moving * 135 + 15 * (nfree + m.nmocap)
        + m.nbody * (36 + 10 + 130) + m.nv * 20 + ncg * 126
    )


def crb_flops(m, npair: int) -> int:
    # composite inertias 13 per body, f = I cdof 36 per dof, 11 per pair
    return m.nbody * 13 + m.nv * 36 + npair * 11


def vel_smooth_flops(m) -> int:
    # cvel/cdof_dot 12+30 per dof, cacc 12 per dof, body forces 100 per
    # body, bias 11 per dof, passive 2 per dof, actuation 20 per actuator,
    # xfrc 15 per body + 12 per ancestor dof, the sum 4 per dof
    anc = int(np.sum(np.asarray(_ancestor_counts(m))))
    return (
        m.nv * (42 + 12 + 11 + 2 + 4) + m.nbody * (100 + 15)
        + m.nu * 20 + anc * 12
    )


def _ancestor_counts(m):
    from mjlab_tpu_torch.phys.lm.stages import ancestor_dof_mask

    return ancestor_dof_mask(m).sum(axis=1)


# a dense row's share of the Hessian J^T diag(D) J: D J once (nv), then a
# multiply-add per entry of the lower triangle (nv (nv + 1))
def hessian_row_flops(nv) -> int:
    return nv * (nv + 1) + nv


# one row in one line-search probe: the residual at the step (2), the force
# (1) and the slope's multiply-add (2); the curvature's D v v (3) only in
# the Newton-bisection probes, not in the 12 bracket doublings
SLOPE_ROW_FLOPS, CURVATURE_ROW_FLOPS = 5, 3


def line_search_flops(nrows, ls) -> int:
    return nrows * (12 * SLOPE_ROW_FLOPS + ls * (SLOPE_ROW_FLOPS + CURVATURE_ROW_FLOPS))


def newton_flops(nv, nlim, nlive, nact, iters, ls) -> float:
    """FLOPs of the pyramidal solve for one env: nlive contact rows built
    and carried, nact of them in the quadratic zone (in the Hessian),
    iters Newton iterations. The dof-friction and limit rows are unit
    rows: their Hessian terms are diagonal (nv + nlim)."""
    chol = nv**3 / 3 + 3 * nv * nv
    solve = 4 * nv * nv
    matvec = 2 * nv * nv
    rows = 2 * nv * nlive  # one product of the rows with a vector
    build = 48 * nv * nlive
    cost = 6 * nv + 4 * nlim + 4 * nlive
    setup = chol + solve + 2 * (nv + nlim + rows + matvec + cost)
    hessian = nact * hessian_row_flops(nv) + nv + nlim
    per_iter = (
        matvec + rows + hessian + chol + solve + rows + matvec
        + line_search_flops(nv + nlim + nlive, ls) + matvec + cost
    )
    tail = rows + matvec + chol + solve
    return build + setup + iters * per_iter + tail


def newton_flops_elliptic(nv, nlim, neq, R, nlive, ncon, nblock, iters, ls) -> float:
    """FLOPs of the elliptic solve for one env: nlive contact rows of ncon
    contacts, nblock of them with a nonzero cone block, neq equality
    rows, iters Newton iterations."""
    chol = nv**3 / 3 + 3 * nv * nv
    solve = 4 * nv * nv
    matvec = 2 * nv * nv
    rows = 2 * nv * (nlive + neq)
    state = 5 * R + 15  # one contact's 3-zone state
    cost = 6 * nv + 4 * nlim + ncon * (state + 6) + 5 * neq
    forces = ncon * (state + 8 * R) + rows
    build = 48 * nv * nlive
    setup = chol + solve + 2 * (nv + nlim + rows + matvec + cost)
    hessian = (
        ncon * (state + 12 * R * R) + 2 * nv * nblock * R * R
        + nv * (nv + 1) * R * nblock + 1.5 * nv * nv * neq
    )
    probe = 6 * nv + 5 * nlim + ncon * (state + 10 * R + 10 * R + 15) + 6 * neq
    per_iter = (
        matvec + forces + hessian + chol + solve + rows + matvec
        + (12 + ls) * probe + matvec + cost
    )
    tail = forces + matvec + chol + solve
    return build + setup + iters * per_iter + tail


def dense_flops(nv, nlive, nact, iters, ls) -> float:
    """FLOPs of the dense-Jacobian solve for one env: nlive live rows
    (D != 0) carried, nact of them in the quadratic zone (in the Hessian),
    iters Newton iterations."""
    chol = nv**3 / 3 + 3 * nv * nv
    solve = 4 * nv * nv
    matvec = 2 * nv * nv
    rows = 2 * nv * nlive  # one product of the rows with a vector
    cost = 6 * nv + 8 * nlive
    setup = 2 * (nv + rows + matvec + cost)
    per_iter = (
        matvec + rows + nact * hessian_row_flops(nv) + nv * (nv + 1) / 2
        + chol + solve + rows + matvec + line_search_flops(nlive, ls)
        + matvec + cost
    )
    return setup + iters * per_iter + 4 * nlive


# ---------------------------------------------------------------------------
# the two paths
# ---------------------------------------------------------------------------


def make_sim(path: str, num_envs: int, device: str):
    """A Simulation of the path's model, read from the model file the repo
    keeps (MuJoCo, the model compiler, need not be installed), and the
    path's initial state of one env."""
    from mjlab_tpu_torch.sim.sim import Simulation

    if path == "g1":
        from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

        m, key_qpos, key_ctrl = physics.load_saved_model(device=device)
        state = {"qpos": key_qpos, "ctrl": key_ctrl}
    else:
        from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

        m, state = physics.load_saved_model(device=device)
    return Simulation(num_envs, physics.sim_cfg(), m, device=device), state


def seed_state(sim, path: str, state: dict, seed: int):
    """G1: the keyframe plus numpy noise, ctrl at the keyframe. YAM: half
    the envs at the task's reset state, half pinching the cube, noise on
    the arm. Returns the ctrl the settling holds."""
    m = sim.model
    E = sim.num_envs
    t = lambda x: torch.as_tensor(x, dtype=sim.dtype, device=sim.device)  # noqa: E731
    sim.reset()
    if path == "g1":
        rng = np.random.default_rng(seed)
        qpos = np.tile(state["qpos"], (E, 1))
        qpos[:, 7:] += 0.05 * rng.standard_normal((E, m.nq - 7))
        qpos[:, 2] += 0.02 * rng.standard_normal(E)
        qvel = 0.1 * rng.standard_normal((E, m.nv))
        ctrl = np.tile(state["ctrl"], (E, 1))
        sim.data = sim.data.replace(qpos=t(qpos), qvel=t(qvel), ctrl=t(ctrl))
    else:
        from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

        batch = physics.task_states(m, state, E, seed)
        sim.data = sim.data.replace(**{k: t(v) for k, v in batch.items()})
    return sim.data.ctrl.clone()


@functools.cache
def physics_decimation(path: str) -> int:
    """The physics substeps per control step of a physics path (g1, yam):
    its task's, from the task's env config."""
    from mjlab_tpu_torch.tasks import load_env_cfg

    return load_env_cfg({"g1": ENV_TASK, "yam": YAM_TASK}[path]).decimation


def control_step(sim, path: str, ctrl=None):
    if ctrl is not None:
        sim.data = sim.data.replace(ctrl=ctrl)
    for _ in range(physics_decimation(path)):
        sim.step()
    sim.refresh()


def build_kernels():
    from mjlab_tpu_torch import cuda_build

    t0 = time.perf_counter()
    times = cuda_build.build_all()
    log(f"[build] {len(times)} kernels built in {time.perf_counter() - t0:.1f} s "
        f"(nvcc, sm_90a): " + ", ".join(f"{k} {v:.1f} s" for k, v in times.items()))
    for name in cuda_build.SOURCES:
        for k in cuda_build.ptxas_report(name):
            log(f"[build] {name}: {k['kernel']}: {k['registers']} registers, "
                f"{k['stack']} bytes stack frame, {k['spill_stores']} bytes spill "
                f"stores, {k['spill_loads']} bytes spill loads")


# a state's share of envs whose plain solve is stable under ulp nudges
# (stable_envs), at least: tests/test_torch_cuda.py's rule
STABLE_SHARE = 0.95


def stable_envs(args, kw, so_p) -> torch.Tensor:
    """(E,) the envs whose plain solve moves less than a third of its
    tolerance (qacc at SOLVE_TOL, the row forces at FORCE_TOL) when qvel,
    qfrc_smooth or the warmstart changes by a few ulps (2e-7 and 1e-6
    relative, both signs): where it moves more, the float32 line search has
    not converged (often at the iteration cap) and its result turns on
    rounding, so any two sums of it differ by more than the tolerance
    (tests/test_torch_cuda.py _check_kernels, stable_only)."""
    from mjlab_tpu_torch.phys import solver_kernels as sv

    E = so_p[0].shape[1]
    keep = torch.ones(E, dtype=torch.bool, device=so_p[0].device)
    for index in (1, 2, 3):  # qfrc_smooth, the warmstart, qvel
        for nudge in (1 + 2e-7, 1 - 2e-7, 1 + 1e-6, 1 - 1e-6):
            nudged = args[:index] + (args[index] * nudge,) + args[index + 1:]
            so_n = sv.newton_assemble_solve_plain(*nudged, **kw)
            for i, tol in ((0, sv.SOLVE_TOL), (1, sv.FORCE_TOL), (2, sv.FORCE_TOL)):
                scale = max(1.0, float(so_p[i].abs().max()))
                keep &= (so_p[i] - so_n[i]).abs().amax(0) / scale < tol / 3
    return keep


# the model fields each smooth kernel reads per env where the Model carries
# them so (phys/model.py PER_ENV_SMOOTH_FIELDS; csrc/smooth_tree.cuh mcv):
# their (E, ...) tensors count among the bytes a launch must read
KERNEL_PLANES = {
    "kin_com": ("qpos0", "body_ipos", "body_mass", "body_inertia", "geom_pos"),
    "crb_packed": ("body_mass", "dof_armature"),
    "vel_smooth": ("body_mass", "dof_damping", "jnt_stiffness", "actuator_gainprm",
                   "actuator_biasprm", "actuator_forcerange"),
}


def check_kernels(sim, path: str, env_state: bool = False) -> dict:
    """Each kernel of the path against its plain version on the settled
    state: {kernel name: its numbers at the path's shapes}. ``env_state``:
    an env's state after its run (the rough envs' robots up to 100 m from
    the origin with feet on stair edges, the YAM's arms on a grid of env
    origins 32 m across): errors relative to max(1, |plain|max, the
    coordinate scale) (coordinate_scale), and the solve held in the envs
    whose plain solve is stable (stable_envs), at least STABLE_SHARE of
    them, its errors over all envs printed; the kernels timed as CUDA
    graphs of their calls (graph_ms: these checks run minutes into the
    process, where the profiler kept 0-1 of 10 records in every session of
    a full run)."""
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys import solver_kernels as sv
    from mjlab_tpu_torch.phys.hybrid import (
        contact_stack, has_implicit, mocap_planes, solve_args,
    )
    from mjlab_tpu_torch.phys.lm.base import Params
    from mjlab_tpu_torch.phys.model import per_env_smooth

    m, d = sim.model, sim.data
    E = d.qpos.shape[0]
    planned = per_env_smooth(m)
    if planned:
        log(f"[check] {path}: the Model carries {list(planned)} per env: kernels 1-3 read "
            "them from the Model's (E, ...) tensors (" + "; ".join(
                f"{n}: {[f for f in fs if f in planned]}" for n, fs in KERNEL_PLANES.items())
            + ")")
    nv = m.nv
    qT = d.qpos.T.contiguous()
    vT = d.qvel.T.contiguous()
    ctrlT = d.ctrl.T.contiguous()
    mcT, mcqT = mocap_planes(m, d)
    xfrcT = d.xfrc_applied.permute(1, 2, 0).contiguous()
    qfaT = d.qfrc_applied.T.contiguous()
    out = {}

    def record(name, errs, outs_in_bytes, flops, fn_k, fn_p, reps, abs_err):
        for label, (err, tol) in errs.items():
            log(f"[check] {path} {name} {label}: rel err {err:.3e} (tol {tol:.0e})")
            if not err < tol:
                raise AssertionError(f"{path} {name} {label}: {err:.3e} >= {tol:.0e}")
        ms = graph_ms(fn_k, reps) if env_state else kernel_ms(fn_k, KERNEL_NAMES[name], reps)
        wrapper_ms = cuda_ms(fn_k, reps)
        plain_ms = cuda_ms(fn_p, 2)
        dr = [f for f in KERNEL_PLANES.get(name, ()) if f in planned]
        outs_in_bytes += nbytes(*(getattr(m, f) for f in dr))
        b_ms, b_by = bound(outs_in_bytes, flops * E)
        out[name] = dict(
            ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms,
            bound_by=b_by, bytes=outs_in_bytes, flops=flops * E,
            max_abs_err=abs_err, max_rel_err=max(e for e, _ in errs.values()),
            dr_planes=dr,
        )
        log(f"[time] {path} {name}: kernel {ms:.4f} ms (device, "
            f"{'a CUDA graph of the calls' if env_state else 'profiler'}), wrapper "
            f"{wrapper_ms:.4f} ms (back to back, CUDA events), plain {plain_ms:.3f} ms, "
            f"bound {b_ms:.4f} ms ({b_by})")

    # kernel 1: kin_com (with the mocap frames where the model has them)
    outs_k = sk.kin_com(m, qT, mcT, mcqT)
    outs_p = sk.kin_com_plain(m, qT, mcT, mcqT)
    L = coordinate_scale(outs_p[7]) if env_state else 1.0
    if env_state:
        log(f"[check] {path}: coordinate scale {L:.3f} m (errors relative to max(1, "
            "|plain|max, this))")
    names = ("gxpos", "gxmat", "subcom", "cdof", "cinA", "cinc", "xipos",
             "xpos", "xquat")
    mocap_in = (mcT, mcqT) if m.nmocap else ()
    record("kin_com",
           {n: (rel_err(p, k, L), TOL_FRAMES) for n, p, k in zip(names, outs_p, outs_k)},
           nbytes(qT, *mocap_in, *outs_k),
           kin_com_flops(m, len(sk.collision_geoms(m))),
           lambda: sk.kin_com(m, qT, mcT, mcqT),
           lambda: sk.kin_com_plain(m, qT, mcT, mcqT), 20,
           max(max_abs(p, k) for p, k in zip(outs_p, outs_k)))
    gxpos, gxmat, subcom, cdof, cinA, cinc, xipos, _, _ = outs_p

    # kernel 3: vel_smooth
    xq = (subcom, xipos, xfrcT, qfaT)
    vs_k = sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    vs_p = sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq)
    names = ("qfrc_smooth", "actuator_force", "actuator_velocity", "mh_diag")
    record("vel_smooth",
           {n: (rel_err(p, k, L), TOL_SMOOTH) for n, p, k in zip(names, vs_p, vs_k)},
           nbytes(qT, vT, ctrlT, cdof, cinA, cinc, subcom, xipos, xfrcT, qfaT, *vs_k),
           vel_smooth_flops(m),
           lambda: sk.vel_smooth(m, qT, vT, ctrlT, cdof, cinA, cinc, xq),
           lambda: sk.vel_smooth_plain(m, qT, vT, ctrlT, cdof, cinA, cinc, xq),
           20, max(max_abs(p, k) for p, k in zip(vs_p, vs_k)))
    qfs, _, _, mh_diag = vs_p

    # kernel 2: crb_packed, fused with the dense scatter and the implicit
    # diagonal (crb_dense): the whole crb phase of the step in one launch
    mh = mh_diag if has_implicit(m) else None
    crb_k = sk.crb_dense(m, cdof, cinA, cinc, mh)
    qM_cm, Mh_cm = sk.crb_dense_plain(m, cdof, cinA, cinc, mh)
    errs = {"qM": (rel_err(qM_cm, crb_k[0], L), TOL_SMOOTH)}
    if mh is not None:
        errs["Mh"] = (rel_err(Mh_cm, crb_k[1], L), TOL_SMOOTH)
    outs = [x for x in crb_k if x is not None]
    record("crb_packed", errs,
           nbytes(cdof, cinA, cinc, *([mh] if mh is not None else []), *outs),
           crb_flops(m, len(sk._crb_pairs(m))),
           lambda: sk.crb_dense(m, cdof, cinA, cinc, mh),
           lambda: sk.crb_dense_plain(m, cdof, cinA, cinc, mh), 20,
           max(max_abs(p, kk) for p, kk in zip((qM_cm, Mh_cm), crb_k) if p is not None))
    if not env_state:
        # the wrapper's structure, whatever the state: counted on the
        # physics paths (the profiler, late in a full run, keeps no record
        # of sessions like this one)
        per_call, names = cuda_kernels_per_call(lambda: sk.crb_dense(m, cdof, cinA, cinc, mh))
        per_call_p, _ = cuda_kernels_per_call(
            lambda: sk.crb_dense_plain(m, cdof, cinA, cinc, mh))
        log(f"[check] {path} crb phase: {per_call:.2f} CUDA kernels per call (profiler, 10 "
            f"calls), all {sorted(names)}; the plain version {per_call_p:.1f}")
        if names != {KERNEL_NAMES["crb_packed"]}:
            raise AssertionError(f"{path}: the crb phase launched {sorted(names)}")
        out["crb_packed"]["phase_kernels_per_call"] = per_call

    # kernel 4 / 5: newton_assemble_solve (the path's cone), on the plain
    # versions' inputs
    k = contact_stack(m, Params(m, E), qT, vT, gxpos, gxmat, subcom)
    args, kw = solve_args(m, k, qM_cm, qfs, d.qacc_warmstart.T, vT,
                          cdof.reshape(nv * 6, E), Mh_cm)
    it_k = torch.zeros(E, dtype=torch.int32, device=qT.device)
    it_p = torch.zeros(E, dtype=torch.int32, device=qT.device)
    so_k = sv.newton_assemble_solve(*args, **kw, iters=it_k)
    so_p = sv.newton_assemble_solve_plain(*args, **kw, iters=it_p)
    names = ("qacc", "f_noncontact", "f_contact", "qfrc_constraint",
             "qacc_smooth", "qacc_int")
    S, F = sv.SOLVE_TOL, sv.FORCE_TOL
    tols = (S, F, F, S, S, S)
    all_p, all_k, all_it_p, all_it_k = so_p, so_k, it_p, it_k
    if env_state:
        keep = stable_envs(args, kw, so_p)
        share = float(keep.double().mean())
        full = {n: rel_err(p, kk, L) for n, p, kk in zip(names, so_p, so_k)}
        cap = kw["iterations"]
        log(f"[check] {path} solve: envs whose plain solve "
            f"moves less than a third of its tolerance under ulp nudges of qvel, qfrc_smooth "
            f"and the warmstart: {int(keep.sum())} of {E} ({share:.4f}, at least "
            f"{STABLE_SHARE}); the others at the {cap}-iteration cap: "
            f"{int((it_p[~keep] == cap).sum())} of {int((~keep).sum())}; over all envs "
            "(not held): " + ", ".join(f"{n} {e:.3e}" for n, e in full.items()))
        if share < STABLE_SHARE:
            raise AssertionError(f"{path}: only {share:.4f} of the envs have a stable solve")
        so_p, so_k = ([o[:, keep] for o in outs] for outs in (so_p, so_k))
        it_p, it_k = it_p[keep], it_k[keep]
    errs = {n: (rel_err(p, kk, L), t) for n, p, kk, t in zip(names, so_p, so_k, tols)}
    # qfrc_constraint under the iteration-count rule (sv.qfrc_errors: under
    # the elliptic cone relative to the row forces' scale); its own scale,
    # the row forces' and the errors on its own scale are printed beside
    same = it_k == it_p
    del errs["qfrc_constraint"]
    force_scale = sv.row_force_scale(so_p)
    row_scale = force_scale if kw["cone"] else 0.0
    for label, e_t in sv.qfrc_errors(so_p[3], so_k[3], it_p, it_k, row_scale).items():
        errs[f"qfrc_constraint, {label}"] = e_t
    own = sv.qfrc_errors(so_p[3], so_k[3], it_p, it_k)
    qfrc_scale = float(so_p[3].abs().max())
    log(f"[check] {path} qfrc_constraint: |qfrc|max {qfrc_scale:.4g}, row forces "
        f"|f|max {force_scale:.4g} (ratio {force_scale / max(1.0, qfrc_scale):.3g}); "
        "on qfrc's own scale: " + ", ".join(f"{k} {e:.3e}" for k, (e, _) in own.items()))
    so_p, so_k, it_p, it_k = all_p, all_k, all_it_p, all_it_k
    same = it_k == it_p
    on = args[20]
    K, R = kw["K"], kw["R"]
    nlive = (on != 0).sum(0).double()
    if kw["cone"]:
        name = "newton_assemble_solve_elliptic"
        ncon = (on[:K] != 0).sum(0).double()
        nblock = (so_p[2][:K] != 0).sum(0).double()
        flops = float(sum(
            newton_flops_elliptic(nv, kw["nlim"], kw["neq"], R, nl, nc, nb, it,
                                  kw["ls_iterations"])
            for nl, nc, nb, it in zip(nlive.tolist(), ncon.tolist(),
                                      nblock.tolist(), it_p.tolist())
        )) / E
        rows_note = (f"contacts mean {float(ncon.mean()):.1f}, with a cone "
                     f"block {float(nblock.mean()):.1f}")
    else:
        name = "newton_assemble_solve"
        nact = (so_p[2] > 0).sum(0).double()
        flops = float(sum(
            newton_flops(nv, kw["nlim"], nl, na, it, kw["ls_iterations"])
            for nl, na, it in zip(nlive.tolist(), nact.tolist(), it_p.tolist())
        )) / E
        rows_note = f"active rows {float(nact.mean()):.1f}"
    shape = sv.newton_launch_shape(kw["cone"], nv, K, R, kw["neq"], kw["nlim"])
    blocks = sv.blocks_per_sm(kw["cone"], R, shape.smem_bytes_per_env)
    log(f"[check] {path} {name}: launch shape {shape.threads_per_env} threads per env, "
        f"{shape.envs_per_block} env per block, {shape.smem_bytes_per_env} bytes of shared "
        f"memory per env; {blocks} envs per SM, {blocks * shape.threads_per_env} resident "
        "threads per SM")
    log(f"[check] {path} {name}: iterations mean {it_k.double().mean():.2f} kernel, "
        f"{it_p.double().mean():.2f} plain, different in {int((~same).sum())} "
        f"of {E} envs; at the {kw['iterations']}-iteration cap {int((it_k == kw['iterations']).sum())} "
        f"kernel, {int((it_p == kw['iterations']).sum())} plain; live contact rows mean "
        f"{float(nlive.mean()):.1f}, {rows_note}")
    in_args = [a for a in args if a.shape[0] > 1]
    record(name, errs, nbytes(*in_args, *so_k), flops,
           lambda: sv.newton_assemble_solve(*args, **kw),
           lambda: sv.newton_assemble_solve_plain(*args, **kw), 10,
           max(max_abs(p, kk) for p, kk in zip(so_p, so_k)))
    out[name]["iteration_counts_differ"] = int((~same).sum())
    out[name]["resident_threads_per_sm"] = blocks * shape.threads_per_env
    return out


def traffic(sim, path: str, state: dict, ctrl0, seed: int):
    """Put the path's traffic on sim; return the function that draws each
    control step's ctrl. G1: the settled state, ctrl0 + 0.3 N(0, 1). YAM:
    the task's own, as bench.py measures it: every env reset to the task's
    reset state (yam.reset_states: home keyframe, the cube where the lifting
    command puts it), then random actions 0.5 N(0, 1) scaled by the task's
    action scale around the home targets, SETTLE_STEPS control steps of it
    before the timed run (bench.py's warm-up chunk)."""
    gen = torch.Generator(device=sim.device).manual_seed(seed)
    t = lambda x: torch.as_tensor(x, dtype=sim.dtype, device=sim.device)  # noqa: E731
    if path == "g1":
        noise = 0.3
    else:
        from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

        sim.reset()
        batch = physics.reset_states(sim.model, state, sim.num_envs, seed)
        sim.data = sim.data.replace(**{k: t(v) for k, v in batch.items()})
        ctrl0 = sim.data.ctrl.clone()
        noise = 0.5 * physics.action_scale(sim.model)

    def random_ctrl():
        return ctrl0 + noise * torch.randn(ctrl0.shape, generator=gen,
                                           device=sim.device)

    if path == "yam":
        for _ in range(SETTLE_STEPS):
            control_step(sim, path, random_ctrl())
        torch.cuda.synchronize()
        log(f"[traffic] yam: the task's reset and random actions, {SETTLE_STEPS} "
            f"control steps; contacts active per env "
            f"{float(sim.data.con_sel_active.sum(1).double().mean()):.2f}")
    return random_ctrl


def timed_launches(calls) -> dict:
    """Run the callables in ``calls`` timed with CUDA events, every kernel
    wrapper's launch count set to 0 just before and read just after."""
    torch.cuda.synchronize()
    zero_launches()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    t0 = time.perf_counter()
    start.record()
    for call in calls:
        call()
    end.record()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return dict(launches=read_launches(), dev_ms=start.elapsed_time(end), wall=wall)


def zero_launches() -> None:
    """Set every kernel wrapper's launch count to 0."""
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys import solver_dense_kernels as sd
    from mjlab_tpu_torch.phys import solver_kernels as sv

    for w in (sk.kin_com, sk.crb_dense, sk.vel_smooth, sv.newton_assemble_solve,
              sd.newton_solve_dense):
        w.launches = 0
    sv.newton_assemble_solve.launches_by_cone = [0, 0]


def read_launches() -> dict:
    """Every kernel wrapper's launch count, by kernel row."""
    from mjlab_tpu_torch.phys import smooth_kernels as sk
    from mjlab_tpu_torch.phys import solver_dense_kernels as sd
    from mjlab_tpu_torch.phys import solver_kernels as sv

    by_cone = sv.newton_assemble_solve.launches_by_cone
    return {"kin_com": sk.kin_com.launches, "crb_packed": sk.crb_dense.launches,
            "vel_smooth": sk.vel_smooth.launches, "newton_assemble_solve": by_cone[0],
            "newton_assemble_solve_elliptic": by_cone[1],
            "newton_solve_dense": sd.newton_solve_dense.launches}


def main_path(sim, path: str, random_ctrl) -> dict:
    """CONTROL_STEPS control steps with random_ctrl's ctrl after a warm
    one, with launch counts (timed_launches)."""
    control_step(sim, path, random_ctrl())  # warm
    ctrls = [random_ctrl() for _ in range(CONTROL_STEPS)]
    run = timed_launches([lambda c=c: control_step(sim, path, c) for c in ctrls])
    return dict(run, random_ctrl=random_ctrl)


def device_profile(step, prepare=None, accept=None) -> dict:
    """One call of ``step`` under torch.profiler (after prepare(), outside
    the session): CUDA kernels launched, their summed device time, and the
    device's idle share between the first kernel's start and the last one's
    end (the profiler slows the host, so this idle share is an upper
    bound). ``accept(profile)`` returns why a profile is refused, else None;
    a refused or empty session is made again (``profiled``). {"kernels": 0,
    "refused": why} when no session passed."""
    profile = {}

    def check(kernels):
        if not kernels:
            return "recorded no CUDA kernel"
        profile.clear()
        profile.update(summarise(kernels))
        return accept(profile) if accept is not None else None

    _, why = profiled(step, check, prepare)
    return profile if why is None else {"kernels": 0, "refused": why}


def summarise(kernels) -> dict:
    busy = sum(e.time_range.elapsed_us() for e in kernels) / 1e3
    span = (max(e.time_range.end for e in kernels)
            - min(e.time_range.start for e in kernels)) / 1e3
    ours = {}
    for row, name in KERNEL_NAMES.items():
        times = [e.time_range.elapsed_us() / 1e3 for e in kernels if name in e.name]
        if times:
            ours[row] = {"launches": len(times), "ms_per_launch": sum(times) / len(times)}
    by_name: dict[str, list] = {}
    for e in kernels:
        t = by_name.setdefault(e.name, [0, 0.0])
        t[0] += 1
        t[1] += e.time_range.elapsed_us() / 1e3
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:8]
    return {"kernels": len(kernels), "busy_ms": busy, "span_ms": span,
            "idle_share": 1.0 - busy / span, "by_kernel": ours,
            "top": [{"name": n[:80], "launches": c, "ms": ms} for n, (c, ms) in top]}


def breakdown(sim, steps: int, decimation: int) -> dict:
    """Device time per substep phase (CUDA events at the step's phase
    marks) and of the refresh, averaged over ``steps`` control steps of
    ``decimation`` substeps."""
    from mjlab_tpu_torch.phys.hybrid import refresh_envlast, step_envlast

    order = ("kin_com", "contact", "vel_smooth", "crb", "solve", "integrate")
    acc = {n: 0.0 for n in order + ("refresh",)}
    for _ in range(steps):
        for _ in range(decimation):
            ev = [torch.cuda.Event(enable_timing=True)]
            ev[0].record()
            marks = []

            def mark(name):
                e = torch.cuda.Event(enable_timing=True)
                e.record()
                ev.append(e)
                marks.append(name)

            sim.data = step_envlast(sim.model, sim.data, mark=mark)
            torch.cuda.synchronize()
            for name, a, b in zip(marks, ev[:-1], ev[1:]):
                acc[name] += a.elapsed_time(b)
        a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        a.record()
        sim.data = refresh_envlast(sim.model, sim.data)
        b.record()
        torch.cuda.synchronize()
        acc["refresh"] += a.elapsed_time(b)
    out = {n: acc[n] / (steps * decimation) for n in order}
    out["refresh"] = acc["refresh"] / steps
    return out


def end_to_end_check(path: str, seed: int):
    """3 steps of a 64-env Simulation on the card against the same steps
    on the CPU (the plain versions): the kernels carry the whole step."""
    sims = [make_sim(path, 64, dev) for dev in ("cuda", "cpu")]
    for s, state in sims:
        seed_state(s, path, state, seed + 1)
    sims = [s for s, _ in sims]
    for _ in range(3):
        for s in sims:
            s.step()
    dc, dp = (s.data for s in sims)
    for f, tol in E2E_TOL[path]:
        err = rel_err(getattr(dp, f), getattr(dc, f).cpu())
        log(f"[e2e] {path} 64 envs x 3 steps, card vs CPU: {f} rel err {err:.3e} "
            f"(tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"{path} end-to-end {f}: {err:.3e} >= {tol:.0e}")
    # every env must select the same active contact slots; their order may
    # differ where mirrored slots tie to a few f32 ulps
    sel_c, act_c = dc.con_sel.cpu(), dc.con_sel_active.cpu()
    sel_p, act_p = dp.con_sel, dp.con_sel_active
    same_order = float((sel_c == sel_p).all(dim=1).double().mean())
    differ = [e for e in range(sel_p.shape[0])
              if not torch.equal(sel_c[e][act_c[e]].sort().values,
                                 sel_p[e][act_p[e]].sort().values)]
    log(f"[e2e] {path} envs with the same active contact slots: "
        f"{sel_p.shape[0] - len(differ)} of {sel_p.shape[0]}; in the same order: "
        f"{same_order:.3f}")
    if differ:
        raise AssertionError(f"{path}: envs {differ} select other active slots "
                             "on the card than on the CPU")
    if not bool(torch.isfinite(dc.qpos).all()):
        raise AssertionError(f"{path}: non-finite qpos on the card")


def run_path(path: str) -> tuple[dict, dict, dict]:
    """Phases 2-6 of one path: (kernel numbers, launches, summary)."""
    sim, state = make_sim(path, NUM_ENVS, "cuda")
    m = sim.model
    log(f"[model] {path}: nq {m.nq} nv {m.nv} nu {m.nu} nbody {m.nbody} "
        f"ngeom {m.ngeom} nmocap {m.nmocap} neq {m.neq_jnt}, {m.pairs.ncon} "
        f"contact slots, K {m.ncon_max}, R {m.rows_per_con}, cone "
        f"{int(m.opt.cone)}, nefc {m.nefc}; {NUM_ENVS} envs")
    ctrl0 = seed_state(sim, path, state, SEED)
    n = physics_decimation(path)
    for _ in range(SETTLE_STEPS):
        control_step(sim, path, ctrl0)
    torch.cuda.synchronize()
    log(f"[settle] {path}: {SETTLE_STEPS} control steps; contacts active per "
        f"env {float(sim.data.con_sel_active.sum(1).double().mean()):.1f}")

    kernels = check_kernels(sim, path)

    run = main_path(sim, path, traffic(sim, path, state, ctrl0, SEED))
    launches = run["launches"]
    substeps = CONTROL_STEPS * n
    elliptic = int(m.opt.cone) != 0
    expected = {
        "kin_com": substeps + CONTROL_STEPS, "crb_packed": substeps,
        "vel_smooth": substeps,
        "newton_assemble_solve": 0 if elliptic else substeps,
        "newton_assemble_solve_elliptic": substeps if elliptic else 0,
        "newton_solve_dense": 0,
    }
    log(f"[main] {path} launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"{path} kernel launches {launches} != {expected}")

    d = sim.data
    if not bool(torch.isfinite(d.qpos).all()):
        raise AssertionError(f"{path}: non-finite qpos after the main path")
    resets = int(d.ncheck_reset.sum())
    overflow = int(d.ncon_overflow.sum())
    log(f"[main] {path} diverged-state resets {resets}, contact-slot overflow "
        f"{overflow}; contacts active per env at the end "
        f"{float(d.con_sel_active.sum(1).double().mean()):.2f}")
    if resets:
        raise AssertionError(f"{path}: {resets} diverged-state resets")
    dev_ms = run["dev_ms"]
    env_steps = NUM_ENVS * CONTROL_STEPS / (dev_ms / 1e3)
    log(f"[main] {path} {CONTROL_STEPS} control steps x {n} substeps + "
        f"refresh at {NUM_ENVS} envs: {dev_ms:.1f} ms (CUDA events), "
        f"{run['wall'] * 1e3:.1f} ms (host clock); {dev_ms / CONTROL_STEPS:.2f} ms "
        f"per control step")
    log(f"[main] {path} physics env-steps/s at {NUM_ENVS} envs: {env_steps:.1f}")

    parts = breakdown(sim, 4, n)
    sub = sum(v for k, v in parts.items() if k != "refresh")
    log(f"[breakdown] {path} ms per substep: " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items() if k != "refresh")
        + f" (sum {sub:.3f}); refresh {parts['refresh']:.3f} ms per control step")
    ctrl = run["random_ctrl"]()
    prof = device_profile(lambda: control_step(sim, path, ctrl))
    if prof["kernels"]:
        log(f"[profile] {path} one control step: {prof['kernels']} CUDA kernels, "
            f"device busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms "
            f"span, idle share {prof['idle_share']:.3f} (under the profiler); "
            + ", ".join(f"{k} {v['launches']} x {v['ms_per_launch']:.4f} ms"
                        for k, v in prof["by_kernel"].items()))
    else:
        log(f"[profile] {path}: torch.profiler recorded no CUDA kernels: idle "
            "share not measured")
    del sim, d
    torch.cuda.empty_cache()

    end_to_end_check(path, SEED)
    summary = {"physics_env_steps_per_s": env_steps, "ms_per_control_step":
               dev_ms / CONTROL_STEPS, "ms_per_substep": sub,
               "breakdown_ms_per_substep": parts, "profile": prof}
    return kernels, launches, summary


# ---------------------------------------------------------------------------
# the captured control steps (sim.ControlStep): one CUDA graph per step
# ---------------------------------------------------------------------------


def joint_targets(robot, ctrl: torch.Tensor) -> torch.Tensor:
    """The robot's joint position targets (joint order) whose position
    actuators write ``ctrl`` (actuator order)."""
    joints = [j for a in robot.actuators for j in a.joint_ids]
    target = torch.zeros(ctrl.shape[0], robot.num_joints, device=ctrl.device)
    target[:, joints] = ctrl[:, robot.indexing.ctrl_ids].float()
    return target


def capture_twins(path: str, num_envs: int, seed: int, count: int = 2) -> list[dict]:
    """``count`` Simulations of the path on one seeded state (twins: the
    first to run its control step eagerly, the second captured): the G1's
    env-side step
    (the task's scene: the robot's actuators from joint targets, the
    sensors' update) with the feet's friction per env, as the task's
    startup event leaves it; the YAM's physics step with the fingertips'
    friction per env (lift_cube_env_cfg.py's three startup events) on the
    task's own traffic (every env at its reset state, random actions). Each
    twin: {sim, scene, step, inputs}, inputs(c) writing the control step's
    command c (G1: joint targets; YAM: ctrl)."""
    from mjlab_tpu_torch.sim.sim import ControlStep

    twins = []
    for _ in range(count):
        sim, state = make_sim(path, num_envs, "cuda")
        ctrl0 = seed_state(sim, path, state, seed)
        sim.expand_model_fields(["geom_friction"])
        gf = sim.model.geom_friction
        names = sim.model.geom_names
        gen = torch.Generator(device="cuda").manual_seed(seed)
        if path == "g1":
            from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

            geoms = [i for i, n in enumerate(names) if "_foot" in n and n.startswith("robot/")]
            draw = 0.3 + 0.9 * torch.rand(num_envs, len(geoms), generator=gen, device="cuda")
            gf[:, geoms, 0] = draw
            scene = physics.make_scene(sim)
            robot = scene["robot"]
            robot.data.set_joint_position_target(joint_targets(robot, ctrl0))
            step = physics.control_step(sim, scene)
            inputs = robot.data.set_joint_position_target
        else:
            # the task's own traffic, as the yam path's (bench.py): every
            # env at the task's reset state
            from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

            sim.reset()
            batch = physics.reset_states(sim.model, state, num_envs, seed)
            sim.data = sim.data.replace(**{k: torch.as_tensor(v, dtype=sim.dtype, device="cuda")
                                           for k, v in batch.items()})
            ctrl0 = sim.data.ctrl.clone()
            geoms = [i for i, n in enumerate(names) if n.startswith("robot/")]
            gf[:, geoms, 0] = 0.3 + 1.2 * torch.rand(num_envs, len(geoms), generator=gen,
                                                     device="cuda")
            scene = None
            step = ControlStep(sim, physics_decimation(path))
            inputs = lambda c, sim=sim: setattr(sim, "data", sim.data.replace(ctrl=c))  # noqa: E731
        twins.append(dict(sim=sim, scene=scene, step=step, inputs=inputs, ctrl0=ctrl0,
                          geoms=geoms))
    return twins


def capture_commands(path: str, twin: dict, steps: int, seed: int) -> list:
    """Seeded commands for ``steps`` control steps: G1 joint targets at the
    keyframe + 0.3 N(0, 1); YAM ctrl at the task's home targets + 0.5 N(0,
    1) times its action scale (the eager paths' traffic)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    c0 = twin["ctrl0"]
    if path == "g1":
        robot = twin["scene"]["robot"]
        base = joint_targets(robot, c0)
        return [base + 0.3 * torch.randn(base.shape, generator=gen, device="cuda")
                for _ in range(steps)]
    from mjlab_tpu_torch.tasks.manipulation.config.yam import physics

    scale = 0.5 * physics.action_scale(twin["sim"].model)
    return [c0 + scale * torch.randn(c0.shape, generator=gen, device="cuda")
            for _ in range(steps)]


def assert_twins_agree(path: str, label: str, de, dc) -> dict:
    """The captured twin's Data against the eager one's: the step
    tolerances (E2E_TOL) and the same active contact slots in every env."""
    errs = {}
    for f, tol in E2E_TOL[path]:
        errs[f] = err = rel_err(getattr(de, f), getattr(dc, f))
        log(f"[capture] {path} {label}: {f} rel err {err:.3e} (tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"{path} captured vs eager {label} {f}: {err:.3e} >= {tol:.0e}")
    differ = [e for e in range(de.qpos.shape[0])
              if not torch.equal(de.con_sel[e][de.con_sel_active[e]].sort().values,
                                 dc.con_sel[e][dc.con_sel_active[e]].sort().values)]
    log(f"[capture] {path} {label}: envs with the same active contact slots "
        f"{de.qpos.shape[0] - len(differ)} of {de.qpos.shape[0]}")
    if differ:
        raise AssertionError(f"{path} captured vs eager {label}: envs {differ[:10]} "
                             "select other active slots")
    if int(dc.ncheck_reset.sum()) or not bool(torch.isfinite(dc.qpos).all()):
        raise AssertionError(f"{path} captured {label}: diverged or non-finite state")
    return errs


def timed_control_steps(run, commands) -> float:
    """Milliseconds (CUDA events) of one control step per command, each
    command written just before its step."""
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for c in commands:
        run(c)
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / len(commands)


def sensors_on_card_match_cpu(seed: int) -> dict:
    """The G1 scene's sensors on the card after 3 captured control steps of
    64 envs against the CPU port's sensors on the same Data and state (the
    plain PyTorch path): builtin sensors within SENSOR_TOL relative, the
    contact sensors' found counts and air times equal, the net foot
    forces within SENSOR_TOL."""
    from mjlab_tpu_torch.phys.data import data_from_numpy, tensor_fields
    from mjlab_tpu_torch.tasks.velocity.config.g1 import physics

    twin = capture_twins("g1", 64, seed, count=1)[0]
    sim, scene = twin["sim"], twin["scene"]
    twin["step"].capture(warmup=CAPTURE_WARMUP)
    for c in capture_commands("g1", twin, 3, seed):
        twin["inputs"](c)
        twin["step"].replay()
    torch.cuda.synchronize()
    cpu_sim, _ = make_sim("g1", 64, "cpu")
    cpu_sim.expand_model_fields(["geom_friction"])
    cpu_sim.model.geom_friction.copy_(sim.model.geom_friction.cpu())
    d = sim.data
    cpu_sim.data = data_from_numpy({n: (d.contact.packed if n == "contact" else getattr(d, n))
                                    .cpu().numpy() for n in tensor_fields()}, device="cpu")
    cpu_scene = physics.make_scene(cpu_sim)
    for a, b in zip(cpu_scene.state_tensors(), scene.state_tensors()):
        a.copy_(b.cpu())
    errs = {}
    for name, s in scene.sensors.items():
        got, ref = s.data, cpu_scene[name].data
        if isinstance(got, torch.Tensor):
            errs[name] = rel_err(ref, got.cpu())
            ok = errs[name] < SENSOR_TOL
        else:
            fields = [f for f in ("found", "force", "current_air_time", "last_air_time")
                      if getattr(ref, f) is not None]
            errs[name] = max(rel_err(getattr(ref, f), getattr(got, f).cpu()) for f in fields)
            ok = errs[name] < SENSOR_TOL and all(
                torch.equal(getattr(ref, f), getattr(got, f).cpu())
                for f in fields if f != "force")
        log(f"[capture] g1 sensor {name} on the card vs the CPU port, 64 envs: rel err "
            f"{errs[name]:.3e} (tol {SENSOR_TOL:.0e})")
        if not ok:
            raise AssertionError(f"g1 sensor {name}: card and CPU disagree ({errs[name]:.3e})")
    return errs


def run_capture_path(path: str) -> tuple[dict, dict]:
    """The path's control step captured as one CUDA graph at NUM_ENVS envs:
    (launches, summary). The kernel launch counts are set to 0 just
    before the twins are built and read after the capture: the capture
    records each kernel once per control step (the warm-up steps launch
    them too); replays do not pass through the wrappers, and the profile of
    one replay shows the graph launching them."""
    zero_launches()
    eager, cap = capture_twins(path, NUM_ENVS, SEED)
    t0 = time.perf_counter()
    cap["step"].capture(warmup=CAPTURE_WARMUP)
    capture_s = time.perf_counter() - t0
    launches = read_launches()
    per_step = {k: v / (CAPTURE_WARMUP + 1) for k, v in launches.items()}
    n = cap["step"].decimation
    expected = expected_launches(
        "newton_assemble_solve_elliptic" if path == "yam" else "newton_assemble_solve", n)
    log(f"[capture] {path}: captured in {capture_s:.2f} s ({CAPTURE_WARMUP} warm-up "
        f"control steps, the last with host synchronisation an error); launches "
        f"{launches}, per control step {per_step}, expected {expected}")
    if per_step != expected:
        raise AssertionError(f"{path} captured launches per control step {per_step} "
                             f"!= {expected}")

    # captured against eager after CAPTURE_CHECK_STEPS control steps
    commands = capture_commands(path, eager, CAPTURE_CHECK_STEPS + 2 * CAPTURE_STEPS
                                * CAPTURE_REPEATS, SEED + 1)
    check, timed = commands[:CAPTURE_CHECK_STEPS], commands[CAPTURE_CHECK_STEPS:]
    for c in check:
        for t, run in ((eager, eager["step"].eager), (cap, cap["step"].replay)):
            t["inputs"](c)
            run()
    torch.cuda.synchronize()
    errs = assert_twins_agree(path, f"{CAPTURE_CHECK_STEPS} control steps",
                              eager["sim"].data, cap["sim"].data)

    # a masked reset and a friction write between replays: the graph reads
    # the buffers they wrote
    mask = torch.zeros(NUM_ENVS, dtype=torch.bool, device="cuda")
    mask[::3] = True
    draw = torch.linspace(0.35, 1.15, NUM_ENVS, device="cuda")[:, None]
    for t in (eager, cap):
        t["sim"].reset(mask)
        if t["scene"] is not None:
            t["scene"].reset(mask)
        t["sim"].model.geom_friction[:, t["geoms"], 0] = draw
        t["inputs"](check[-1])
    eager["step"].eager()
    cap["step"].replay()
    torch.cuda.synchronize()
    assert_twins_agree(path, "after a masked reset and a friction write",
                       eager["sim"].data, cap["sim"].data)
    d = cap["sim"].data
    dt = cap["sim"].cfg.mujoco.timestep
    if not torch.allclose(d.time[mask], torch.full_like(d.time[mask], n * dt)):
        raise AssertionError(f"{path}: the replay did not restart the reset envs")
    # the slots' friction is what the per-env mixing makes of the new
    # values (slot_params, evaluated now, outside the graph)
    from mjlab_tpu_torch.phys.lm.base import Params
    from mjlab_tpu_torch.phys.lm.collision import slot_params

    m = cap["sim"].model
    f5 = slot_params(m, Params(m, NUM_ENVS), d.qpos.dtype)[0][:, 0]  # (S, E)
    sel = d.con_sel.long().T  # (K, E)
    want = torch.gather(f5.expand(-1, NUM_ENVS), 0, sel).T
    pt = m.pairs
    geoms = np.asarray(cap["geoms"])
    on_geom = torch.as_tensor(np.isin(pt.con_geom1, geoms) | np.isin(pt.con_geom2, geoms),
                              device="cuda")[d.con_sel.long()] & d.con_sel_active
    act = d.con_sel_active
    ok = torch.equal(d.con_packed_c[..., 5][act], want[act])
    log(f"[capture] {path}: after the reset, {int(mask.sum())} reset envs at time "
        f"{n * dt:.3f} s; the friction of all {int(act.sum())} active slots "
        f"({int(on_geom.sum())} on the written geoms) is the mix of the new values: {ok}")
    if not (ok and bool(on_geom.any())):
        raise AssertionError(f"{path}: the replay did not read the friction write")

    # throughput: eager and captured control steps, CAPTURE_REPEATS repeats
    # of CAPTURE_STEPS each, in turns
    def runner(t, fn):
        def run(c):
            t["inputs"](c)
            fn()
        return run

    ms = {"eager": [], "captured": []}
    for r in range(CAPTURE_REPEATS):
        chunk = timed[2 * r * CAPTURE_STEPS:(2 * r + 2) * CAPTURE_STEPS]
        ms["eager"].append(timed_control_steps(runner(eager, eager["step"].eager),
                                               chunk[:CAPTURE_STEPS]))
        ms["captured"].append(timed_control_steps(runner(cap, cap["step"].replay),
                                                  chunk[CAPTURE_STEPS:]))
    rates = {k: [NUM_ENVS / (v / 1e3) for v in vals] for k, vals in ms.items()}
    med = {k: float(np.median(v)) for k, v in rates.items()}
    for k in ("eager", "captured"):
        log(f"[capture] {path} {k}: env-steps/s at {NUM_ENVS} envs, median of "
            f"{CAPTURE_REPEATS} x {CAPTURE_STEPS} control steps: {med[k]:.1f} (repeats "
            + ", ".join(f"{x:.1f}" for x in rates[k]) + "); ms per control step "
            + ", ".join(f"{x:.3f}" for x in ms[k]))
    c = timed[-1]
    want = {n: v for n, v in expected.items() if v}

    def replay_launched(prof):
        # the profiler may drop a record now and then: every kernel of the
        # step must show, at most as often as the capture recorded it
        seen = {n: v["launches"] for n, v in prof["by_kernel"].items()}
        if set(seen) != set(want) or any(seen[n] > want[n] for n in seen):
            return f"one replay launched {seen}, expected {want}"
        return None

    profiles = {}
    for k, t, fn in (("eager", eager, eager["step"].eager), ("captured", cap, cap["step"].replay)):
        prof = device_profile(fn, prepare=lambda t=t: t["inputs"](c),
                              accept=replay_launched if k == "captured" else None)
        if not prof["kernels"]:
            raise AssertionError(f"{path} {k}: the profiler {prof['refused']}")
        profiles[k] = prof
        log(f"[capture] {path} {k} control step under the profiler: {prof['kernels']} CUDA "
            f"kernels, device busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms "
            f"span, idle share {prof['idle_share']:.3f}; " + ", ".join(
                f"{n} {v['launches']} x {v['ms_per_launch']:.4f} ms"
                for n, v in prof["by_kernel"].items()))
        log(f"[capture] {path} {k}: the CUDA kernels with the most device time: " + "; ".join(
            f"{t['name'][:60]} {t['launches']} x, {t['ms']:.3f} ms" for t in prof["top"]))
    del eager, cap, d
    torch.cuda.empty_cache()
    summary = {"env_steps_per_s": med, "env_steps_per_s_repeats": rates,
               "ms_per_control_step": {k: float(np.median(v)) for k, v in ms.items()},
               "device_ms_per_control_step": {k: p["busy_ms"] for k, p in profiles.items()},
               "idle_share": {k: p["idle_share"] for k, p in profiles.items()},
               "cuda_kernels_per_control_step": {k: p["kernels"] for k, p in profiles.items()},
               "capture_s": capture_s, "launches_per_control_step": per_step,
               "check_rel_err": errs}
    if path == "g1":
        summary["sensor_rel_err_card_vs_cpu"] = sensors_on_card_match_cpu(SEED + 2)
    return launches, summary


# ---------------------------------------------------------------------------
# the env path: the G1 flat-velocity env's step (managers, MDP terms, the
# velocity task) captured as one CUDA graph
# ---------------------------------------------------------------------------

ENV_TASK = "Mjlab-Velocity-Flat-Unitree-G1"
# bench.py's traffic: a fresh action 0.5 N(0, 1) per control step
ENV_ACTION_STD = 0.5
# the env's outputs, captured against eager after ENV_CHECK_STEPS steps
# across resets and the card against the CPU: the step tolerances on the
# state (E2E_TOL), and on what each output reads of it
# (tests/test_torch_env.py): the policy observations and the reward
# qvel's, the critic observations (the feet's contact forces)
# con_force_c's, the command (the heading) qpos's
ENV_TOL = {"policy": 1e-3, "critic": 5e-3, "reward": 1e-3, "command": 1e-4}
ENV_CHECK_STEPS = 3
# the jump tasks' check steps: the jump task's drops land in its fourth
# to seventh control step (0.016-0.028 s), the jumping task's in its first
# to fourth
JUMP_CHECK_STEPS = 7
# the card's env against the CPU port's on the same draws, 64 envs
ENV_CPU_ENVS = 64

YAM_TASK = "Mjlab-Lift-Cube-Yam"
# what an env path reads of its task, by kind (the velocity tasks, the
# lift-cube task): the physics path whose step tolerances (E2E_TOL) hold
# its state; its outputs' tolerances card against CPU (the YAM's: the
# elliptic multistep qvel's for the joint velocities the observations and
# the hinge reward read, qpos's for the target and cube of the command);
# the command term and the state entry read as "command"; the termination
# the forced resets fire besides the time-out; the solve kernel of its
# cone; the policy group's noisy columns, which the critic group repeats
# without noise (velocity: base velocities, gravity, joint positions and
# velocities; YAM: joint positions and velocities, end effector to cube,
# cube to goal); the qpos columns of the xy a reset draws (the robot's
# root; the cube's)
ENV_KINDS = {
    "velocity": dict(physics="g1", tol=ENV_TOL, command=("twist", "command"),
                     terminate="fell_over", solve="newton_assemble_solve",
                     noisy=lambda joints: slice(0, 3 + 3 + 3 + 2 * joints), pose=slice(0, 2)),
    "yam": dict(physics="yam", tol={"policy": 2e-2, "critic": 2e-2, "reward": 2e-2,
                                    "command": 2e-4},
                command=("lift_height", "target_pos"), terminate="ee_ground_collision",
                solve="newton_assemble_solve_elliptic",
                noisy=lambda joints: slice(0, 2 * joints + 3 + 3), pose=slice(8, 10)),
    # the tracking task: the command's time steps (equal), the anchor's
    # position and orientation in the robot's anchor frame after the
    # motion's joint positions and velocities (the columns the critic
    # repeats without noise)
    "tracking": dict(physics="g1", tol=ENV_TOL, command=("motion", "time_steps"),
                     terminate="anchor_pos", solve="newton_assemble_solve",
                     noisy=lambda joints: slice(2 * joints, 2 * joints + 3 + 6),
                     pose=slice(0, 2)),
    # the jump and jumping tasks: the jump command (jump: the target
    # height; jumping: the trigger and the target); the policy's noisy
    # columns lead as in the velocity tasks'
    "jump": dict(physics="g1", tol=ENV_TOL, command=("jump", "command"),
                 terminate="fell_over", solve="newton_assemble_solve",
                 noisy=lambda joints: slice(0, 3 + 3 + 3 + 2 * joints), pose=slice(0, 2)),
}
# the YAM's forced resets: an arm lowered into the table (link_6's subtree
# meets it: the ground sensor fires), and a cube moved along x before its
# command's resample (tests/test_torch_env_yam.py)
YAM_GROUND_ARM = {1: 1.75, 2: 0.8}
YAM_CUBE_QPOS = 8
YAM_CUBE_SHIFT = 0.05


TRACKING_TASK = "Mjlab-Tracking-Flat-Unitree-G1"
# the motion the tracking paths follow: 400 frames at 50 fps of the G1's 29
# joints and 30 bodies, float32
TRACKING_MOTION = "evidence/tracking_r4/motion.npz"
# the tracking env's forced resets (tests/test_torch_env_tracking.py): the
# root lifted (the anchor's height), rolled 90 degrees about x (the
# anchor's orientation), the left arm raised (the end effectors; the
# shoulder pitch's qpos address and value); a motion two frames from its
# end
TRACKING_LIFT = 0.4
TRACKING_ARM = (22, -2.8)
# the torso's com offsets a base_com write between replays adds (the
# event's ranges: +-2.5, +-5 and +-5 cm)
TRACKING_COM_SHIFT = (0.02, -0.04, 0.03)


JUMP_TASK = "Mjlab-Jump-Flat-Unitree-G1"
JUMPING_TASK = "Mjlab-Jumping-Flat-Unitree-G1"
# the jump tasks' forced resets (tests/test_torch_env_jump.py,
# tests/test_torch_env_jumping.py), by kind: the termination of a low root
# and the root's height and roll there (an upright G1 put below the
# jumping task's 0.3 m is pushed back up within its 20 ms control step: it
# lies on its side); a drop's lift (m) and vertical velocity (m/s); the
# global step counts written before the first and the second check step
# (past the curricula's second stage, then their last)
JUMP_LOW = {"jump": ("height_too_low", 0.30, 0.0), "jumping": ("fell_down", 0.15, 90.0)}
JUMP_DROP = {"jump": (0.18, -3.13), "jumping": (0.05, -1.0)}
JUMP_COUNTERS = {"jump": (400_000, 900_000), "jumping": (200_000, 800_000)}
# the jump paths' tasks by name (the keys above)
JUMP_NAMES = {JUMP_TASK: "jump", JUMPING_TASK: "jumping"}
# the outputs the card-against-CPU env check does not hold in the first
# step after the reset, by task: the jump task's crouch (the feet ~13 cm
# into the floor) makes that step's reward ill-conditioned at float32 (a
# 1e-6 nudge of the action moves the CPU port's reward by 4e-3 of its
# scale, and the JAX reference's alike); the second step, from the card's
# state copied into the CPU env, holds every output on every env
RESET_STEP_UNHELD = {JUMP_TASK: ("reward",)}


# the G1 flat-velocity env with mixed explicit actuator groups
# (mjlab_tpu_torch/tasks/velocity/config/g1/explicit.py; a configuration of
# the registered flat task, not a registered task): the label its paths
# pass for a task name, its NaN guard's dumps under the git-ignored build/
EXPLICIT_TASK = "G1-Velocity-Flat-Explicit-Actuators"
EXPLICIT_NAN_DIR = "build/nan_dumps"
# its NaN checks: the env whose first wrist gain (a per-env model field
# kernel 3 reads) turns NaN, and the env whose qvel does (the physics
# step's own bad-state reset absorbs that one: no termination, as in the
# JAX package, tests/test_torch_env_explicit.py)
EXPLICIT_NAN_ENV, EXPLICIT_QVEL_NAN_ENV = 5, 9
ENV_KINDS["explicit"] = dict(ENV_KINDS["velocity"])


def env_kind(env) -> dict:
    """The env's ENV_KINDS entry: the lift-cube, tracking and jump tasks'
    by their command, the explicit env by its NaN guard."""
    terms = env.command_manager.active_terms
    if env.nan_guard is not None:
        return ENV_KINDS["explicit"]
    if "lift_height" in terms:
        return ENV_KINDS["yam"]
    if "jump" in terms:
        return ENV_KINDS["jump"]
    return ENV_KINDS["tracking" if "motion" in terms else "velocity"]


def make_env(num_envs: int, device: str, capture: bool = True, seed: int = SEED,
             task: str = ENV_TASK):
    """The port's env of ``task``, built from the port's registry; a
    generated terrain's seed pinned to SEED (the task's own is None, a
    fresh terrain per build), so that twins and the CPU env stand on the
    same terrain."""
    import os

    os.environ.setdefault("MJLAB_QUIET", "1")
    # the tracking tasks' motion (the task config reads it from here)
    os.environ.setdefault("MJLAB_TPU_MOTION_FILE", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), TRACKING_MOTION))
    from mjlab_tpu_torch.envs import ManagerBasedRlEnv
    from mjlab_tpu_torch.tasks import load_env_cfg

    if task == EXPLICIT_TASK:
        import tempfile

        from mjlab_tpu_torch.tasks.velocity.config.g1.explicit import make_g1_explicit_env

        here = os.path.dirname(os.path.abspath(__file__))
        os.makedirs(os.path.join(here, EXPLICIT_NAN_DIR), exist_ok=True)
        nan_dir = tempfile.mkdtemp(dir=os.path.join(here, EXPLICIT_NAN_DIR))
        return make_g1_explicit_env(num_envs, device, capture=capture, seed=seed,
                                    nan_dir=nan_dir)
    cfg = load_env_cfg(task)
    cfg.scene.num_envs = num_envs
    cfg.seed = seed
    gen = cfg.scene.terrain.terrain_generator
    if gen is not None:
        gen.seed = SEED
    return ManagerBasedRlEnv(cfg, device=device, capture=capture)


def env_actions(env, steps: int, seed: int) -> list:
    gen = torch.Generator(device=env.device).manual_seed(seed)
    A = env.action_manager.total_action_dim
    return [ENV_ACTION_STD * torch.randn(env.num_envs, A, generator=gen, device=env.device)
            for _ in range(steps)]


def force_resets(env, tip: torch.Tensor, late: torch.Tensor, shift=None) -> None:
    """Tip the ``tip`` envs 80 degrees about x (past fell_over's 70) and set
    the ``late`` envs one step before their time-out: the next step resets
    both sets. The ``shift`` envs' roots move by ROUGH_SHIFT (past half a
    sub-terrain: the terrain curriculum promotes a late one; a late one
    left near its origin may be demoted)."""
    import math

    qpos = env.sim.data.qpos.clone()
    a = math.radians(80.0) / 2
    q = torch.tensor([math.cos(a), math.sin(a), 0.0, 0.0], dtype=qpos.dtype, device=qpos.device)
    qpos[tip, 3:7] = q
    if shift is not None:
        qpos[shift, :3] += torch.tensor(ROUGH_SHIFT, dtype=qpos.dtype, device=qpos.device)
    env.sim.data = env.sim.data.replace(qpos=qpos)
    env.episode_length_buf[late] = env.max_episode_length - 1


def force_lift_resets(env, ground: torch.Tensor, late: torch.Tensor,
                      resample: torch.Tensor) -> None:
    """Lower the ``ground`` envs' arms into the table (YAM_GROUND_ARM), set
    the ``late`` envs one step before their time-out, and move the
    ``resample`` envs' cubes by YAM_CUBE_SHIFT along x with their lifting
    command's time left at 0.01 s: the next step terminates the first set
    (illegal_contact), times out the second and resets both, and resamples
    the third's target and cube pose mid-episode."""
    qpos = env.sim.data.qpos.clone()
    for j, v in YAM_GROUND_ARM.items():
        qpos[ground, j] = v
    qpos[resample, YAM_CUBE_QPOS] += YAM_CUBE_SHIFT
    env.sim.data = env.sim.data.replace(qpos=qpos)
    env.episode_length_buf[late] = env.max_episode_length - 1
    env.command_manager.get_term("lift_height").state["time_left"][resample] = 0.01


def force_jump_resets(env, name: str, tip, late, low, drop, resample=None) -> None:
    """The jump tasks' forced resets (``name``: "jump" or "jumping"): the
    ``tip`` envs rolled 80 degrees (past both tasks' fell_over limits), the
    ``late`` envs one step before their time-out, the ``low`` envs' roots
    low (JUMP_LOW: height_too_low, fell_down), the ``drop`` envs lifted and
    falling (JUMP_DROP: a flight, then a landing); the jumping task's
    ``resample`` envs' command with 0.01 s left (a resample mid-episode)."""
    _, z, roll = JUMP_LOW[name]
    lift, vz = JUMP_DROP[name]
    qpos, qvel = env.sim.data.qpos.clone(), env.sim.data.qvel.clone()
    rot = lambda deg: torch.tensor(  # noqa: E731
        [math.cos(math.radians(deg) / 2), math.sin(math.radians(deg) / 2), 0.0, 0.0],
        dtype=qpos.dtype, device=qpos.device)
    qpos[tip, 3:7] = rot(80.0)
    qpos[low, 2] = z
    if roll:
        qpos[low, 3:7] = rot(roll)
    qpos[drop, 2] += lift
    qvel[drop, 2] = vz
    env.sim.data = env.sim.data.replace(qpos=qpos, qvel=qvel)
    env.episode_length_buf[late] = env.max_episode_length - 1
    if resample is not None:
        env.command_manager.get_term("jump").state["time_left"][resample] = 0.01


def jump_forced(path: str, name: str, env, sets: dict) -> dict:
    """After the step of the jump tasks' forced resets, the global step
    count written past the curricula's second stage before it: each forced
    set ended by its own termination and reset; the curricula moved (the
    jump command's target and tolerance and the landing_stability weight;
    the jumping command's range) inside the graph; the reset envs (and the
    jumping task's resampled ones) took the new target (jump: the target;
    jumping: a target inside the new range, the trigger at 1, a time left
    drawn in the resampling range, less the step's dt for the reset envs);
    the dropped envs in the air."""
    tm = env.termination_manager
    low_term = JUMP_LOW[name][0]
    fired = {n: tm.get_term(n) for n in ("fell_over", low_term, "time_out")}
    want = {"fell_over": sets["tip"], low_term: sets["low"], "time_out": sets["late"]}
    done = fired["fell_over"] | fired[low_term] | fired["time_out"]
    s = env.command_manager.get_term("jump").state
    cmd = s["command"]
    air = env.scene["feet_ground_contact"].data.current_air_time
    info = {n: int(v.sum()) for n, v in fired.items()}
    info["forced"] = {n: int(v.sum()) for n, v in sets.items()}
    ok = all(bool(fired[n][want[n]].all()) for n in want)
    ok &= int(env.episode_length_buf[done].max()) == 0
    ok &= bool((air[sets["drop"]] > 0).all())
    if name == "jump":
        w = env.reward_manager.weights["landing_stability"]
        info["curriculum"] = [float(s["target_height"]), float(s["height_tolerance"]), float(w)]
        ok &= info["curriculum"] == [np.float32(0.15), np.float32(0.05), 2.5]
        ok &= bool((cmd[done, 0] == s["target_height"]).all())
    else:
        resampled = done | sets["resample"]
        rng = s["ranges"]["target_height"]
        info["curriculum"] = rng.tolist()
        tl = s["time_left"][resampled]
        ok &= info["curriculum"] == np.float32([0.05, 0.10]).tolist()
        ok &= bool(((cmd[resampled, 1] >= rng[0]) & (cmd[resampled, 1] <= rng[1])).all())
        ok &= bool((cmd[resampled, 0] == 1.0).all())
        # the reset envs' draw, then the step's command update: dt less
        lo, hi = env.command_manager.get_term("jump").cfg.resampling_time_range
        ok &= bool(((tl >= lo - env.step_dt) & (tl <= hi)).all())
        info["resampled"] = int(resampled.sum())
        info["time_left"] = [float(tl.min()), float(tl.max())]
    log(f"[env] {path} step 1: terminations {[(n, info[n]) for n in fired]} (forced "
        f"{info['forced']}); the curriculum inside the graph: {info['curriculum']}; the "
        f"dropped envs' feet in the air: {bool((air[sets['drop']] > 0).all())}"
        + (f"; {info['resampled']} envs resampled to targets in the new range, trigger 1"
           if name == "jumping" else "; the reset envs' command at the new target"))
    if not ok:
        raise AssertionError(f"{path}: the forced resets did not end, reset and move the "
                             f"curricula as forced: {info}")
    return info


def jump_second_stage(path: str, name: str, env) -> list:
    """After the step whose global step count was written past the
    curricula's last stage between replays: the replay read the write and
    the curricula wrote their tensors in place (jump: target 0.25,
    tolerance 0.08, weight 4.0; jumping: the range (0.10, 0.25))."""
    s = env.command_manager.get_term("jump").state
    if name == "jump":
        w = env.reward_manager.weights["landing_stability"]
        got = [float(s["target_height"]), float(s["height_tolerance"]), float(w)]
        ok = got == [np.float32(0.25), np.float32(0.08), 4.0]
    else:
        got = s["ranges"]["target_height"].tolist()
        ok = got == np.float32([0.10, 0.25]).tolist()
    log(f"[env] {path}: the global step count written between replays: the next replay "
        f"moved the curriculum to {got}")
    if not ok:
        raise AssertionError(f"{path}: the replay did not read the step-count write: {got}")
    return got


def jump_landed(path: str, name: str, env, drop: torch.Tensor) -> float:
    """After the check steps: the dropped envs landed (jump: a foot on the
    ground; jumping: the landing latched by the command and its trigger
    decaying inside the graph), at least nine in ten of them."""
    s = env.command_manager.get_term("jump").state
    if name == "jump":
        landed = (env.scene["feet_ground_contact"].data.found[drop] > 0).any(1)
    else:
        landed = s["jump_completed"][drop] & (s["command"][drop, 0] < 1.0)
    share = float(landed.double().mean())
    log(f"[env] {path}: dropped envs landed"
        + (" (the landing latched, the trigger decaying)" if name == "jumping"
           else "") + f": {share:.3f} of {int(drop.sum())}")
    if share < 0.9:
        raise AssertionError(f"{path}: only {share:.3f} of the dropped envs landed")
    return share


def force_tracking_resets(env, lift, roll, arm, late, near_end) -> None:
    """The tracking env's forced resets: the ``lift`` envs' roots raised by
    TRACKING_LIFT (the anchor-height termination), the ``roll`` envs
    rolled 90 degrees about x (the anchor's orientation), the ``arm``
    envs' left arms raised (TRACKING_ARM: the end effectors), the ``late``
    envs one step before their time-out, the ``near_end`` envs' motion two
    frames from its end (the command's update runs past it in the next
    step and resamples them)."""
    import math

    qpos = env.sim.data.qpos.clone()
    qpos[lift, 2] += TRACKING_LIFT
    a = math.radians(90.0) / 2
    qpos[roll, 3:7] = torch.tensor([math.cos(a), math.sin(a), 0.0, 0.0], dtype=qpos.dtype,
                                   device=qpos.device)
    qpos[arm, TRACKING_ARM[0]] = TRACKING_ARM[1]
    env.sim.data = env.sim.data.replace(qpos=qpos)
    env.episode_length_buf[late] = env.max_episode_length - 1
    term = env.command_manager.get_term("motion")
    term.state["time_steps"][near_end] = term.motion.time_step_total - 2


def tracking_forced(path: str, env, sets: dict, before: dict) -> dict:
    """After the step of the tracking env's forced resets: each forced set
    ended by its own termination and reset; the failed envs' bins counted
    into the moving average; the resampled envs (failed, timed out, past
    the motion's end) at frames the adaptive sampler drew, spread over the
    motion."""
    tm = env.termination_manager
    term = env.command_manager.get_term("motion")
    T = term.motion.time_step_total
    fired = {name: tm.get_term(name) for name in ("anchor_pos", "anchor_ori", "ee_body_pos",
                                                  "time_out")}
    want = {"anchor_pos": sets["lift"], "anchor_ori": sets["roll"],
            "ee_body_pos": sets["arm"], "time_out": sets["late"]}
    done = fired["anchor_pos"] | fired["anchor_ori"] | fired["ee_body_pos"] | fired["time_out"]
    ts = term.state["time_steps"]
    resampled = done | sets["near_end"]
    counts = term.state["bin_failed_count"]
    m = term.state["metrics"]
    info = {n: int(v.sum()) for n, v in fired.items()}
    info.update(forced={n: int(v.sum()) for n, v in sets.items()},
                frames=[int(ts[resampled].min()), int(ts[resampled].max())],
                distinct_frames=int(torch.unique(ts[resampled]).numel()),
                bin_failed_count=counts.tolist(),
                sampling_entropy=float(m["sampling_entropy"][0]),
                sampling_top1_bin=float(m["sampling_top1_bin"][0]))
    log(f"[env] {path} step 1: terminations {[(n, info[n]) for n in fired]} (forced "
        f"{info['forced']}); resampled {int(resampled.sum())} envs (the done ones and "
        f"{int(sets['near_end'].sum())} past the motion's end) to frames in {info['frames']} "
        f"({info['distinct_frames']} distinct of {T}); the failure counts' moving average "
        f"{[round(x, 6) for x in info['bin_failed_count']]}; sampling entropy "
        f"{info['sampling_entropy']:.4f}, top-1 bin {info['sampling_top1_bin']:.3f}")
    ok = all(bool(fired[n][want[n]].all()) for n in want)
    ok &= int(env.episode_length_buf[done].max()) == 0
    ok &= bool((counts > before["bin_failed_count"]).any()) and bool(counts.sum() > 0)
    ok &= bool((ts[sets["near_end"]] < T - 2).all()) and info["distinct_frames"] > 50
    if not ok:
        raise AssertionError(f"{path}: the forced resets did not end, count and resample as "
                             f"forced: {info}")
    return info


def env_outputs(env, out) -> dict:
    """The step's outputs, cloned, with the Data's qpos and qvel; on a
    generated terrain also the terrain levels and origins; for the
    tracking task also the failure counts and the command's metrics."""
    obs, rew, term, trunc, extras = out
    name, key = env_kind(env)["command"]
    res = {"policy": obs["policy"].clone(), "critic": obs["critic"].clone(),
           "reward": rew.clone(), "terminated": term.clone(), "truncated": trunc.clone(),
           "episode_length": env.episode_length_buf.clone(),
           "command": env.command_manager.get_term(name).state[key].clone(),
           "qpos": env.sim.data.qpos.clone(), "qvel": env.sim.data.qvel.clone()}
    terrain = env.scene.terrain
    if terrain is not None and terrain.generator is not None:
        res.update(levels=terrain.levels.clone(), origins=terrain.origins.clone())
    if name == "motion":
        s = env.command_manager.get_term(name).state
        res.update(bin_failed_count=s["bin_failed_count"].clone(),
                   metrics=torch.stack(list(s["metrics"].values())))
    if name == "jump":
        # the jump command's whole state (targets, flags, range, time left,
        # metrics) and the stateful reward terms' (peaks, timers, flags)
        from mjlab_tpu_torch.managers.manager_base import tensors_of

        state = (tensors_of(env.command_manager.get_term(name).state)
                 + env.reward_manager.state_tensors())
        res["jump_state"] = torch.cat([t.reshape(-1).to(torch.float64) for t in state])
    return res


def assert_envs_agree(label: str, a_env, a: dict, b_env, b: dict, path: str = "g1_env",
                      bitwise: bool = False, unheld: tuple = ()) -> dict:
    """Two envs' outputs and Data: equal flags, episode lengths and terrain
    levels and origins, the observations and rewards within the kind's
    tolerances (ENV_KINDS), the state within E2E_TOL and the same active
    contact slots (assert_twins_agree). ``bitwise``: every output, qpos and
    qvel equal bit for bit besides; ``unheld`` outputs are not held."""
    kind = env_kind(a_env)
    tols = {k: tol for k, tol in kind["tol"].items() if k not in unheld}
    for k in ("terminated", "truncated", "episode_length", "levels", "origins"):
        if k in a and not torch.equal(a[k].cpu(), b[k].cpu()):
            raise AssertionError(f"{path} {label}: {k} differ")
    if bitwise:
        differ = [k for k in a if not torch.equal(a[k].cpu(), b[k].cpu())]
        if differ:
            raise AssertionError(f"{path} {label}: {differ} not equal bit for bit")
    errs = {}
    for k, tol in tols.items():
        errs[k] = rel_err(a[k].cpu(), b[k].cpu())
        if not errs[k] < tol:
            raise AssertionError(f"{path} {label}: {k} rel err {errs[k]:.3e} >= {tol:.0e}")
    log(f"[env] {path} {label}: " + ", ".join(f"{k} rel err {v:.3e} (tol {tols[k]:.0e})"
                                              for k, v in errs.items())
        + f"; terminated {int(a['terminated'].sum())}, truncated "
        f"{int(a['truncated'].sum())} in both"
        + (", terrain levels and origins equal" if "levels" in a else "")
        + (f"; {sorted(a)} equal bit for bit" if bitwise else ""))
    da, db = a_env.sim.data, b_env.sim.data
    if da.qpos.device == db.qpos.device:
        errs.update(assert_twins_agree(kind["physics"], f"env {label}", da, db))
    return errs


class _HostRng:
    """Draws made on the host from one numpy seed and moved to a device:
    two envs, or two learners, on different devices draw the same numbers
    (used by the card-against-CPU checks only, never captured)."""

    def __init__(self, seed: int, device):
        self.rs = np.random.default_rng(seed)
        self.device = torch.device(device)

    def draw(self, kind, shape, dtype, low=0, high=1, probs=None):
        if kind == "categorical":
            # the inverse CDF at host draws (Rng.draw's), on the device
            cdf = torch.cumsum(probs, 0)
            u = torch.as_tensor(self.rs.random(shape, dtype=np.float32), device=self.device)
            idx = torch.searchsorted(cdf, (u.to(cdf.dtype) * cdf[-1]).contiguous(), right=True)
            return idx.clamp_max(cdf.shape[0] - 1)
        if kind == "uniform":
            x = self.rs.random(shape, dtype=np.float32)
        elif kind == "normal":
            x = self.rs.standard_normal(shape, dtype=np.float32)
        elif kind == "permutation":
            x = self.rs.permutation(shape[0])
        else:
            x = self.rs.integers(low, high, shape).astype(np.int32)
        return torch.as_tensor(x, device=self.device).to(dtype)


def env_on_card_matches_cpu(seed: int, task: str = ENV_TASK, path: str = "g1_env") -> dict:
    """The env of ENV_CPU_ENVS envs on the card (eager) against the CPU
    port's (the plain versions, held against the JAX env by the CPU
    tests) on the same draws, every env held: a reset and one step of
    bench.py's traffic (every output but the task's RESET_STEP_UNHELD,
    whose errors are printed), then a second step from the card's state
    copied into the CPU env (every output), each with the Data within
    E2E_TOL."""
    from mjlab_tpu_torch.sim.sim import copy_data_

    card = make_env(ENV_CPU_ENVS, "cuda", capture=False, seed=seed, task=task)
    card.rng.draw = _HostRng(seed, "cuda").draw  # every draw goes through Rng.draw
    # the draws made at construction (the terrain levels, the startup
    # events' per-env model fields and encoder bias, the interval timers)
    # came from each env's own generator: the card's are copied
    cpu = make_env(ENV_CPU_ENVS, "cpu", capture=False, seed=seed, task=task)
    cpu.rng.draw = _HostRng(seed, "cpu").draw
    for field in card.sim._default_fields:
        getattr(cpu.sim.model, field).copy_(getattr(card.sim.model, field).cpu())
    for name, ent in card.scene.entities.items():
        cpu.scene[name].state.encoder_bias.copy_(ent.state.encoder_bias.cpu())
    for name, t in card.event_manager.interval_left.items():
        cpu.event_manager.interval_left[name].copy_(t.cpu())
    for a, b in zip(cpu.scene.state_tensors(), card.scene.state_tensors()):
        a.copy_(b.cpu())
    kind = env_kind(card)

    def outputs(env, act):
        out = env_outputs(env, env.step(act.to(env.device)))
        out.pop("jump_state", None)  # not per env
        return out

    def held(label, outs, unheld=()):
        errs = assert_envs_agree(label, cpu, outs[1], card, outs[0], path, unheld=unheld)
        dc, dp = card.sim.data, cpu.sim.data
        for f, tol in E2E_TOL[kind["physics"]]:
            errs[f] = err = rel_err(getattr(dp, f), getattr(dc, f).cpu())
            log(f"[env] {path} {label}: {f} rel err {err:.3e} (tol {tol:.0e})")
            if not err < tol:
                raise AssertionError(f"{path} {label} {f}: {err:.3e} >= {tol:.0e}")
        return errs

    for e in (card, cpu):
        e.reset()
    acts = env_actions(cpu, 2, seed)
    outs = [outputs(e, acts[0]) for e in (card, cpu)]
    unheld = RESET_STEP_UNHELD.get(task, ())
    label = f"card vs CPU, {ENV_CPU_ENVS} envs, reset and one step"
    first = {k: rel_err(outs[1][k].cpu(), outs[0][k].cpu()) for k in unheld}
    if unheld:
        log(f"[env] {path} {label}: not held (ill-conditioned at float32): " + ", ".join(
            f"{k} rel err {e:.3e}" for k, e in first.items()))
    errs = {"reset_step": held(label, outs, unheld), "reset_step_unheld": first}

    # the second step: the card's state (the Data and every tensor the
    # step reads and writes) copied into the CPU env, fresh draws for both
    copy_data_(cpu.sim.data, card.sim.data)
    for a, b in zip(cpu._state_tensors(), card._state_tensors()):
        a.copy_(b)
    card.rng.draw = _HostRng(seed + 1, "cuda").draw
    cpu.rng.draw = _HostRng(seed + 1, "cpu").draw
    outs = [outputs(e, acts[1]) for e in (card, cpu)]
    errs["second_step"] = held(f"card vs CPU, {ENV_CPU_ENVS} envs, a second step from the "
                               "card's state", outs)
    if kind is ENV_KINDS["explicit"]:
        # a third step, both envs' gains and qvel poisoned alike: the
        # dump written on the card against the CPU twin's window
        card.rng.draw = _HostRng(seed + 2, "cuda").draw
        cpu.rng.draw = _HostRng(seed + 2, "cpu").draw
        outs = explicit_nan_step(path, (card, cpu), acts[1])
        tol = dict(E2E_TOL["g1"])
        errs["nan_step"] = nan_step_agree(path, f"card vs CPU, {ENV_CPU_ENVS} envs, the NaN "
                                          "step", cpu, outs[1], card, outs[0],
                                          dict(kind["tol"], **tol))
        errs["nan_dump"] = explicit_dumps(path, "the card against the CPU", cpu, card,
                                          {"qpos": tol["qpos"], "qvel": tol["qvel"],
                                           "ctrl": tol["qvel"]})
    return errs


def explicit_nan_step(path: str, envs, act: torch.Tensor) -> list:
    """In each env of ``envs`` (twins, or the card and the CPU): env
    EXPLICIT_NAN_ENV's first wrist gain set to NaN (a per-env model field,
    written between steps, which kernel 3 reads in the next replay) and env
    EXPLICIT_QVEL_NAN_ENV's qvel set to NaN, then one step on ``act``: its
    outputs. Checked in each: nan_detection ends EXPLICIT_NAN_ENV alone
    (its accelerations went NaN) and its reset's PD-gain event draws the
    gain anew; the qvel NaN never reaches the termination (the physics
    step's bad-state reset puts that env back at qpos0, at rest, as in the
    JAX package); the NaN guard flags EXPLICIT_NAN_ENV alone."""
    outs = []
    for e in envs:
        wrist = next(a for a in e.scene["robot"].actuators if a.is_passthrough)
        e.sim.model.actuator_gainprm[EXPLICIT_NAN_ENV, int(wrist.ctrl_ids[0]), 0] = float("nan")
        qvel = e.sim.data.qvel.clone()
        qvel[EXPLICIT_QVEL_NAN_ENV] = float("nan")
        e.sim.data = e.sim.data.replace(qvel=qvel)
        outs.append(env_outputs(e, e.step(act.to(e.device))))
    for e, o in zip(envs, outs):
        want = torch.zeros(e.num_envs, dtype=torch.bool)
        want[EXPLICIT_NAN_ENV] = True
        ended = e.termination_manager.get_term("nan_term").cpu()
        guard = e.nan_guard
        log(f"[env] {path} NaN step ({e.device.type}): nan_detection ended envs "
            f"{torch.nonzero(ended).flatten().tolist()}, terminated "
            f"{int(o['terminated'].sum())}; the NaN guard flagged "
            f"{torch.nonzero(guard.bad_envs.cpu()).flatten().tolist()}; env "
            f"{EXPLICIT_QVEL_NAN_ENV} (qvel NaN) terminated "
            f"{bool(o['terminated'][EXPLICIT_QVEL_NAN_ENV])}, its qvel finite "
            f"{bool(torch.isfinite(o['qvel'][EXPLICIT_QVEL_NAN_ENV]).all())}")
        if not torch.equal(ended, want) or not torch.equal(guard.bad_envs.cpu(), want):
            raise AssertionError(f"{path}: the NaN gain did not end env {EXPLICIT_NAN_ENV} "
                                 "alone through nan_detection")
        if not bool(guard.stopped) or bool(o["terminated"][EXPLICIT_QVEL_NAN_ENV]):
            raise AssertionError(f"{path}: the NaN guard's flag, or the qvel NaN's env")
        if not (bool(torch.isfinite(e.sim.model.actuator_gainprm).all())
                and bool(torch.isfinite(o["qvel"]).all())):
            raise AssertionError(f"{path}: a NaN left after the step's resets")
    return outs


def nan_step_agree(path: str, label: str, a_env, a: dict, b_env, b: dict,
                   tols: dict | None = None) -> dict:
    """The NaN step's outputs and Data (qpos, qvel, qacc) of two envs: the
    same non-finite entries (the NaN env's reward and qacc), the finite ones
    bit for bit (tols None) or within tols[field] relative to max(1,
    |a|max) (the outputs at the kind's tolerances, the Data at E2E_TOL)."""
    a = dict(a, qacc=a_env.sim.data.qacc.clone())
    b = dict(b, qacc=b_env.sim.data.qacc.clone())
    errs = {}
    for k in ("terminated", "truncated", "episode_length", "policy", "critic", "reward",
              "command", "qpos", "qvel", "qacc"):
        x, y = a[k].cpu(), b[k].cpu()
        if x.dtype == torch.bool or not x.is_floating_point():
            ok = torch.equal(x, y)
        else:
            bad = ~torch.isfinite(x)
            ok = torch.equal(bad, ~torch.isfinite(y))
            if ok and tols is None:
                ok = torch.equal(x[~bad], y[~bad])
            elif ok:
                errs[k] = rel_err(x[~bad], y[~bad])
                ok = errs[k] < tols[k]
        if not ok:
            raise AssertionError(f"{path} {label}: {k} differ" + (
                f" (rel err {errs[k]:.3e})" if k in errs else ""))
    log(f"[env] {path} {label}: the NaN env's non-finite entries the same in both, the rest "
        + ("equal bit for bit" if tols is None else ", ".join(
            f"{k} rel err {v:.3e}" for k, v in errs.items())))
    return errs


def explicit_dumps(path: str, label: str, a_env, b_env, tols=None) -> dict:
    """Both envs' NaN dumps, written by close() (the host reads the guard's
    flag there, outside the graph): one npz each, once (a second close()
    writes none); bad_envs [EXPLICIT_NAN_ENV] in both; the qpos, qvel and
    ctrl windows of the detection step bit for bit (tols None), or each
    within its tolerance ({field: tol}, relative to max(1, |a|max)).
    b_env's window is also what its guard holds."""
    paths = []
    for e in (a_env, b_env):
        e.close()
        e.close()
        files = [f for f in os.listdir(e.cfg.sim.nan_guard.output_dir)
                 if f.startswith("nan_dump") and f.endswith(".npz") and "_model" not in f]
        if len(files) != 1 or e.nan_guard.dumped is None:
            raise AssertionError(f"{path} {label}: {len(files)} dumps")
        paths.append(e.nan_guard.dumped)
    errs = {}
    with np.load(paths[0]) as a, np.load(paths[1]) as b:
        if not (a["bad_envs"].tolist() == b["bad_envs"].tolist() == [EXPLICIT_NAN_ENV]):
            raise AssertionError(f"{path} {label}: bad_envs {a['bad_envs']}, {b['bad_envs']}")
        held = b_env.nan_guard.windows()
        for k in ("qpos", "qvel", "ctrl"):
            if not np.array_equal(b[k], held[k]):
                raise AssertionError(f"{path} {label}: the dump's {k} is not the guard's window")
            if tols is None:
                if not np.array_equal(a[k], b[k]):
                    raise AssertionError(f"{path} {label}: {k} windows differ")
                errs[k] = 0.0
            else:
                errs[k] = rel_err(torch.as_tensor(a[k]), torch.as_tensor(b[k]))
                if not errs[k] < tols[k]:
                    raise AssertionError(f"{path} {label}: {k} window rel err {errs[k]:.3e}")
        shape = {k: list(a[k].shape) for k in ("qpos", "qvel", "ctrl")}
    log(f"[env] {path} NaN dumps, {label}: one each, bad_envs [{EXPLICIT_NAN_ENV}] in both, "
        f"windows {shape} " + ("equal bit for bit" if tols is None else ", ".join(
            f"{k} rel err {v:.3e} (tol {tols[k]:.0e})" for k, v in errs.items()))
        + f"; {os.path.relpath(paths[1])}")
    return {"window_rel_err": errs, "shape": shape}


def expected_launches(solve: str, decimation: int) -> dict:
    """Each kernel's launches per control step of ``decimation`` physics
    substeps (the task's): the smooth kernels per substep, kin_com once
    more in the refresh, the solve of the task's cone per substep, the
    others never."""
    out = {"kin_com": decimation + 1, "crb_packed": decimation, "vel_smooth": decimation,
           "newton_assemble_solve": 0, "newton_assemble_solve_elliptic": 0,
           "newton_solve_dense": 0}
    out[solve] = decimation
    return out


def resampled(path: str, env, mask: torch.Tensor) -> None:
    """After a step in which the ``mask`` envs' lifting command ran out:
    their time left drawn anew in the resampling range, their targets and
    cubes inside the command's boxes about their env origins, the cubes
    at rest (the resample wrote the free joint mid-episode)."""
    term = env.command_manager.get_term("lift_height")
    cfg = term.cfg
    origins = env.scene.env_origins[mask]
    rel_target = term.state["target_pos"][mask] - origins
    qpos = env.sim.data.qpos[mask]
    rel_cube = qpos[:, YAM_CUBE_QPOS:YAM_CUBE_QPOS + 3] - origins
    tl = term.state["time_left"][mask]
    lo_t, hi_t = cfg.resampling_time_range

    def inside(x, r):
        lo = torch.tensor([r.x[0], r.y[0], r.z[0]], device=x.device, dtype=x.dtype)
        hi = torch.tensor([r.x[1], r.y[1], r.z[1]], device=x.device, dtype=x.dtype)
        return bool(((x >= lo - 1e-6) & (x <= hi + 1e-6)).all())

    ok = (inside(rel_target, cfg.target_position_range)
          and inside(rel_cube, cfg.object_pose_range)
          and bool(((tl >= lo_t) & (tl <= hi_t)).all()))
    log(f"[env] {path} step 1: the lifting command resampled {int(mask.sum())} envs "
        f"mid-episode: time left in [{float(tl.min()):.3f}, {float(tl.max()):.3f}] s, targets "
        f"and cubes inside the command's boxes about their origins: {ok}")
    if not ok:
        raise AssertionError(f"{path}: the resampled envs' command or cube is off")


def com_write(path: str, envs) -> dict:
    """Shift the torso's com (body_ipos) of every env by TRACKING_COM_SHIFT
    scaled by a ramp over the envs, in place in each env's Model (the
    base_com event's write, after capture): the shifts written."""
    out = {}
    for env in envs:
        m = env.sim.model
        torso = m.body_names.index("robot/torso_link")
        ramp = torch.linspace(-1.0, 1.0, env.num_envs, device=m.body_ipos.device)[:, None]
        shift = ramp * torch.tensor(TRACKING_COM_SHIFT, device=ramp.device)
        m.body_ipos[:, torso] += shift.to(m.body_ipos.dtype)
        out = {"torso": torso, "max_shift_m": float(shift.abs().max())}
    log(f"[env] {path}: base_com write between replays: the torso's body_ipos moved by up to "
        f"{out['max_shift_m']:.3f} m per env, in place (per-env fields "
        f"{list(envs[-1].sim._default_fields)})")
    return out


def com_seen(path: str, env, com: dict) -> None:
    """After the replay that followed com_write: the refreshed torso com
    (xipos) is its frame plus the new per-env body_ipos rotated, in every
    env (kin_com read the written tensor, not a snapshot), within
    TOL_FRAMES of the coordinate scale (the env origins' grid)."""
    from mjlab_tpu_torch.utils.math import quat_apply

    d, m = env.sim.data, env.sim.model
    b = com["torso"]
    want = d.xpos[:, b] + quat_apply(d.xquat[:, b], m.body_ipos[:, b])
    err = float((want - d.xipos[:, b]).abs().max())
    tol = TOL_FRAMES * max(1.0, coordinate_scale(d.xpos))
    log(f"[env] {path}: the replay after the write: torso xipos - (xpos + R body_ipos) "
        f"max |.| {err:.3e} m over {env.num_envs} envs (tol {tol:.1e})")
    com["xipos_err_m"] = err
    if not err < tol:
        raise AssertionError(f"{path}: the replay did not read the written body_ipos ({err})")


def run_env_path(capture_kernels: int | None, task: str = ENV_TASK,
                 path: str = "g1_env") -> tuple[dict, dict]:
    """The env's step of ``task`` at NUM_ENVS envs, captured as one CUDA
    graph: (launches, summary). The launch counts are set to 0 just
    before the captured env's first step() and read after it: its two
    warm-up steps and the capture each run the step once through the
    wrappers (replays do not pass through them; the profile of one replay
    shows the graph launching them). On a generated terrain the forced
    resets also promote and demote envs through the terrain curriculum,
    and the path then holds kernels 1-4 against their plain versions on
    the env's state and the height-field narrowphase on the card against
    the CPU (summary["kernel_checks"], summary["hfield_card_vs_cpu"]). The
    lift-cube task's forced resets are its own (force_lift_resets), its
    twins must agree bit for bit, and the path holds kernels 1-3 and 5 on
    the env's state. ``capture_kernels``: the CUDA kernels of the task's
    captured physics path's replay, to count what the env adds."""
    t0 = time.perf_counter()
    eager = make_env(NUM_ENVS, "cuda", capture=False, task=task)
    cap = make_env(NUM_ENVS, "cuda", task=task)
    build_s = time.perf_counter() - t0
    m = cap.sim.model
    terrain = cap.scene.terrain
    rough = terrain is not None and terrain.generator is not None
    A = cap.action_manager.total_action_dim
    log(f"[env] {path}: {task} at {NUM_ENVS} envs built from the port's registry in "
        f"{build_s:.2f} s (two envs): action dim {A}, policy obs "
        f"{cap.observation_manager.group_obs_dim('policy')}, critic obs "
        f"{cap.observation_manager.group_obs_dim('critic')}; nq {m.nq} nv {m.nv} nu {m.nu}, "
        f"{m.pairs.ncon} contact slots, K {m.ncon_max}; decimation {cap.cfg.decimation}, "
        f"step_dt {cap.step_dt}, max episode length {cap.max_episode_length}"
        + (f"; terrain {terrain.max_terrain_level} x {terrain.terrain_origins.shape[1]} "
           f"sub-terrains, height field {m.hfield_nrow} x {m.hfield_ncol} "
           f"({m.hfield_data.numel() * m.hfield_data.element_size()} bytes on the card)"
           if rough else ""))
    for e in (eager, cap):
        e.reset()
    if not torch.equal(eager.sim.data.qpos, cap.sim.data.qpos):
        raise AssertionError(f"{path}: the twins' resets differ")

    kind = env_kind(cap)
    jump_name = JUMP_NAMES.get(task)
    jump = jump_name is not None
    n_check = JUMP_CHECK_STEPS if jump else ENV_CHECK_STEPS
    acts = env_actions(cap, 1 + n_check + 2 * CAPTURE_REPEATS * CAPTURE_STEPS, SEED + 1)
    first, check, timed = acts[0], acts[1:1 + n_check], acts[1 + n_check:]

    # the main path: the captured env's first step() captures the graph
    # (CAPTURE_WARMUP eager warm-up steps, then the capture, each through
    # the kernel wrappers) and replays it; the counts are set to 0 just
    # before and read just after
    zero_launches()
    t0 = time.perf_counter()
    oc = env_outputs(cap, cap.step(first))
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    launches = read_launches()
    per_step = {k: v / (CAPTURE_WARMUP + 1) for k, v in launches.items()}
    yam = kind is ENV_KINDS["yam"]
    tracking = kind is ENV_KINDS["tracking"]
    explicit = kind is ENV_KINDS["explicit"]
    bitwise = yam or tracking or jump or explicit
    expected = expected_launches(kind["solve"], cap.cfg.decimation)
    log(f"[env] {path}: the first step() captured the env step and replayed it in "
        f"{capture_s:.2f} s ({CAPTURE_WARMUP} warm-up steps, the last with host "
        f"synchronisation an error); launches {launches}, per control step {per_step}, "
        f"expected {expected}")
    if not cap.captured or per_step != expected:
        raise AssertionError(f"{path} launches per control step {per_step} != {expected}")
    errs = assert_envs_agree("captured vs eager, the capturing step", eager,
                             env_outputs(eager, eager.step(first)), cap, oc, path,
                             bitwise=bitwise)

    # captured against eager: ENV_CHECK_STEPS steps, the first after
    # tipping some envs (the YAM: lowering their arms into the table) and
    # bringing others to their time-out (on a generated terrain half of
    # those moved past half a sub-terrain; the YAM: others' commands to
    # their resample, mid-episode)
    E = NUM_ENVS
    idx = torch.arange(E, device="cuda")
    tip, late = idx % 7 == 0, idx % 11 == 3
    shift = (idx % 22 == 3) & ~tip if rough else None
    resample = (idx % 13 == 5) & ~tip & ~late if yam else None
    before = (terrain.levels.clone(), terrain.origins.clone()) if rough else None
    if tracking:
        roll = (idx % 17 == 2) & ~tip & ~late
        arm = (idx % 19 == 4) & ~tip & ~late & ~roll
        near_end = (idx % 13 == 5) & ~tip & ~late & ~roll & ~arm
        forced_sets = {"lift": tip, "roll": roll, "arm": arm, "late": late,
                       "near_end": near_end}
        before = {"bin_failed_count": cap.command_manager.get_term(
            "motion").state["bin_failed_count"].clone()}
    if jump:
        # a low root, a drop (and the jumping command's run out), besides
        # the tipped and late envs; the global step count past the
        # curricula's second stage, written in both twins between replays
        low = (idx % 17 == 2) & ~tip & ~late
        drop = (idx % 19 == 4) & ~tip & ~late & ~low
        resample = ((idx % 13 == 5) & ~tip & ~late & ~low & ~drop
                    if jump_name == "jumping" else None)
        forced_sets = {"tip": tip, "late": late, "low": low, "drop": drop,
                       **({"resample": resample} if resample is not None else {})}
        counters = JUMP_COUNTERS[jump_name]
    for e in (eager, cap):
        if yam:
            force_lift_resets(e, tip, late, resample)
        elif tracking:
            force_tracking_resets(e, tip, roll, arm, late, near_end)
        elif jump:
            force_jump_resets(e, jump_name, tip, late, low, drop, resample)
            e.common_step_counter.fill_(counters[0])
        else:
            force_resets(e, tip, late, shift)
    for i, act in enumerate(check):
        if jump and i == 1:
            for e in (eager, cap):
                e.common_step_counter.fill_(counters[1])
        oe = env_outputs(eager, eager.step(act))
        oc = env_outputs(cap, cap.step(act))
        torch.cuda.synchronize()
        if i == 0 and tracking:
            forced = tracking_forced(path, cap, forced_sets, before)
        elif i == 0 and jump:
            forced = jump_forced(path, jump_name, cap, forced_sets)
        elif i == 1 and jump:
            forced["second_stage"] = jump_second_stage(path, jump_name, cap)
        elif i == 0:
            if yam:
                resampled(path, cap, resample)
            fell = cap.termination_manager.get_term(kind["terminate"])
            timed_out = cap.termination_manager.get_term("time_out")
            log(f"[env] {path} step 1: {kind['terminate']} in {int(fell.sum())} envs (forced "
                f"{int(tip.sum())}), time_out in {int(timed_out.sum())} (set {int(late.sum())}); "
                f"their episode lengths after the reset: "
                f"{int(cap.episode_length_buf[fell | timed_out].max())}")
            if not (bool(fell[tip].all()) and bool(timed_out[late].all())):
                raise AssertionError(f"{path}: the tipped or late envs did not terminate")
            if int(cap.episode_length_buf[fell | timed_out].max()) != 0:
                raise AssertionError(f"{path}: the done envs were not reset")
            if rough:
                curriculum_moves(path, terrain, before, shift, late & ~tip & ~shift,
                                 fell | timed_out)
        errs = assert_envs_agree(f"captured vs eager, step {i + 1}", eager, oe, cap, oc, path,
                                 bitwise=bitwise)
        if tracking and i == 0:
            # a base_com write between replays: the next replay reads the
            # new torso offsets (kin_com reads the Model's (E, nbody, 3)
            # tensor at every launch), as its eager twin does
            com = com_write(path, (eager, cap))
        elif tracking and i == 1:
            com_seen(path, cap, com)
    if jump:
        forced["landed_share"] = jump_landed(path, jump_name, cap, drop)
    if explicit:
        # the NaN step in both twins (the captured one between replays),
        # then their dumps, bit for bit
        oe, oc = explicit_nan_step(path, (eager, cap), check[-1])
        nan_step_agree(path, "captured vs eager, the NaN step", eager, oe, cap, oc)
        nan_dumps = explicit_dumps(path, "captured against eager", eager, cap)
        eager.step(check[0])
        oc = env_outputs(cap, cap.step(check[0]))
    for k in ("policy", "critic", "reward"):
        if not bool(torch.isfinite(oc[k]).all()):
            raise AssertionError(f"{path}: non-finite {k}")
    P = cap.observation_manager.group_obs_dim("policy")
    if oc["policy"].shape != (E, P) or oc["critic"].shape[0] != E:
        raise AssertionError(f"{path}: obs shapes {oc['policy'].shape}, {oc['critic'].shape}")

    # fresh draws per replay: the policy group's noise (policy obs minus
    # the noise-free critic terms it shares, ENV_KINDS) and the reset poses
    # (the robot's root; the YAM's cube) of envs reset in two consecutive
    # replays
    noise, poses, frames = [], [], []
    reset_all = torch.ones(E, dtype=torch.bool, device="cuda")
    none = ~reset_all
    noisy = kind["noisy"](cap.scene["robot"].num_joints)
    for _ in range(2):
        if yam:
            force_lift_resets(cap, none, reset_all, none)
        elif tracking:
            force_tracking_resets(cap, none, none, none, reset_all, none)
        else:
            force_resets(cap, none, reset_all)
        o = cap.step(timed[0])[0]
        noise.append((o["policy"][:, noisy] - o["critic"][:, noisy]).clone())
        poses.append(cap.sim.data.qpos[:, kind["pose"]].clone() - cap.scene.env_origins[:, :2])
        if tracking:
            frames.append(cap.command_manager.get_term("motion").state["time_steps"].clone())
    torch.cuda.synchronize()
    same_noise = float((noise[0] == noise[1]).double().mean())
    same_pose = float((poses[0] == poses[1]).all(1).double().mean())
    same_frame = float((frames[0] == frames[1]).double().mean()) if tracking else 0.0
    log(f"[env] {path} two replays: share of equal policy-noise entries {same_noise:.4f}, of "
        f"envs reset to equal xy offsets {same_pose:.4f}"
        + (f", of envs reset to equal start frames {same_frame:.4f}" if tracking else "")
        + f"; noise range [{float(noise[0].min()):.3f}, {float(noise[0].max()):.3f}], reset "
        f"xy offsets in [{float(poses[1].min()):.3f}, {float(poses[1].max()):.3f}]")
    if same_noise > 0.01 or same_pose > 0.01 or same_frame > 0.01:
        raise AssertionError(f"{path}: two replays drew the same numbers")

    # throughput on bench.py's traffic: eager and captured, in turns
    ms = {"eager": [], "captured": []}
    for r in range(CAPTURE_REPEATS):
        chunk = timed[2 * r * CAPTURE_STEPS:(2 * r + 2) * CAPTURE_STEPS]
        ms["eager"].append(timed_control_steps(eager.step, chunk[:CAPTURE_STEPS]))
        ms["captured"].append(timed_control_steps(cap.step, chunk[CAPTURE_STEPS:]))
    rates = {k: [NUM_ENVS / (v / 1e3) for v in vals] for k, vals in ms.items()}
    med = {k: float(np.median(v)) for k, v in rates.items()}
    for k in ("eager", "captured"):
        log(f"[env] {path} {k}: env-steps/s at {NUM_ENVS} envs, median of {CAPTURE_REPEATS} x "
            f"{CAPTURE_STEPS} control steps: {med[k]:.1f} (repeats "
            + ", ".join(f"{x:.1f}" for x in rates[k]) + "); ms per control step "
            + ", ".join(f"{x:.3f}" for x in ms[k]))

    want = {n: v for n, v in expected.items() if v}

    def replay_launched(prof):
        seen = {n: v["launches"] for n, v in prof["by_kernel"].items()}
        if set(seen) != set(want) or any(seen[n] > want[n] for n in seen):
            return f"one replay launched {seen}, expected {want}"
        return None

    act = timed[-1]
    profiles = {}
    for k, env, accept in (("eager", eager, None), ("captured", cap, replay_launched)):
        prof = device_profile(lambda env=env: env.step(act), accept=accept)
        if not prof["kernels"]:
            raise AssertionError(f"{path} {k}: the profiler {prof['refused']}")
        profiles[k] = prof
        log(f"[env] {path} {k} env step under the profiler: {prof['kernels']} CUDA kernels, "
            f"device busy {prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span, "
            f"idle share {prof['idle_share']:.3f}; " + ", ".join(
                f"{n} {v['launches']} x {v['ms_per_launch']:.4f} ms"
                for n, v in prof["by_kernel"].items()))
        log(f"[env] {path} {k}: the CUDA kernels with the most device time: " + "; ".join(
            f"{t['name'][:60]} {t['launches']} x, {t['ms']:.3f} ms" for t in prof["top"]))
    added = (None if capture_kernels is None
             else profiles["captured"]["kernels"] - capture_kernels)
    if capture_kernels is not None:
        log(f"[env] {path}: the managers, terms and resets add {added} CUDA kernels per "
            f"control step over the captured physics path's replay ({capture_kernels})")
    summary = {"task": task, "env_steps_per_s": med, "env_steps_per_s_repeats": rates,
               "ms_per_control_step": {k: float(np.median(v)) for k, v in ms.items()},
               "device_ms_per_control_step": {k: p["busy_ms"] for k, p in profiles.items()},
               "idle_share": {k: p["idle_share"] for k, p in profiles.items()},
               "cuda_kernels_per_control_step": {k: p["kernels"] for k, p in profiles.items()},
               "kernels_added_over_physics_capture": added, "capture_s": capture_s,
               "launches_per_control_step": per_step, "check_rel_err": errs,
               "equal_noise_share": same_noise, "equal_reset_pose_share": same_pose}
    if tracking:
        summary.update(forced_resets=forced, equal_start_frame_share=same_frame,
                       base_com_write=com)
        # the kernels on the env's state after the timed steps: the robots
        # following the motion from the frames the sampler drew, the
        # torso's body_ipos per env (the base_com event and the write)
        summary["kernel_checks"] = check_kernels(cap.sim, path, env_state=True)
    if yam:
        # the kernels on the env's state after the timed steps: arms
        # reaching on random actions, cubes on the table, envs reset among
        # them
        summary["kernel_checks"] = check_kernels(cap.sim, path, env_state=True)
    if explicit:
        # the kernels on the env's state after the timed steps: the robots
        # walking on random actions under explicit PD and delayed DC
        # torques, the wrists' force range, gain and bias per env (kernel 3
        # reads all three from the Model's (E, ...) tensors); every force
        # range then cut to 5-100 % per env and actuator and one physics
        # step taken, so that the check's forces saturate at their env's
        # bound (kernel 3's clip and its implicit diagonal's test)
        fr = cap.sim.model.actuator_forcerange
        gen = torch.Generator(device="cuda").manual_seed(SEED + 9)
        fr.mul_(torch.empty(fr.shape[:2] + (1,), device="cuda").uniform_(0.05, 1.0,
                                                                        generator=gen))
        cap.sim.step()
        at_bound = (cap.sim.data.actuator_force.abs() - fr[..., 1]).abs() < 1e-5
        log(f"[check] {path}: kernels 1-4 on the env's state; per-env force range "
            f"{tuple(fr.shape)} cut, its upper bounds in [{float(fr[..., 1].min()):.3f}, "
            f"{float(fr[..., 1].max()):.3f}]; after one step {int(at_bound.sum())} of "
            f"{at_bound.numel()} actuator forces at their env's bound")
        if not bool(at_bound.any()):
            raise AssertionError(f"{path}: no force at its bound for the kernel check")
        summary["nan_dumps"] = nan_dumps
        summary["kernel_checks"] = check_kernels(cap.sim, path, env_state=True)
    if jump:
        summary["forced_resets"] = forced
        # the kernels on the env's state after the timed steps (jump: dt
        # 0.002, crouched robots pushing off on random actions, feet
        # planted, envs reset into the floor among them)
        log(f"[check] {path}: kernels 1-4 on the env's state at dt "
            f"{float(cap.sim.model.opt.timestep)}, decimation {cap.cfg.decimation}; roots at "
            f"z {float(cap.sim.data.qpos[:, 2].min()):.3f}-{float(cap.sim.data.qpos[:, 2].max()):.3f}"
            f" m, feet on the ground "
            f"{float((cap.scene['feet_ground_contact'].data.found > 0).double().mean()):.3f}")
        summary["kernel_checks"] = check_kernels(cap.sim, path, env_state=True)
    if rough:
        # the kernels on the env's state after the timed steps: the robots
        # on the terrain's flat patches and stairs up and down
        on_stairs = cap.scene.terrain.types.long()
        log(f"[check] {path}: kernels 1-4 on the env's state: envs by sub-terrain column "
            f"{torch.bincount(on_stairs, minlength=terrain.terrain_origins.shape[1]).tolist()}, "
            f"levels {torch.bincount(terrain.levels.long()).tolist()}")
        summary["kernel_checks"] = check_kernels(cap.sim, path, env_state=True)
        summary["hfield_card_vs_cpu"] = hfield_card_matches_cpu(m, path, SEED + 7)
    del eager, cap
    torch.cuda.empty_cache()
    summary["card_vs_cpu_rel_err"] = env_on_card_matches_cpu(SEED + 3, task, path)
    return launches, summary


# the rough paths' forced promotions: the root moved past half a
# sub-terrain (8 m wide; the reset's offset is at most 0.71 m) along +x and
# lifted above the highest neighbouring step (stairs of at most 0.6 m up
# or down), so that it lands on nothing before its reset
ROUGH_SHIFT = (5.0, 0.0, 1.3)
# the height-field narrowphase on the card against the CPU, float32, absolute:
# local coordinates reach 100 m, where a float32 step is 7.6e-6 m, and a
# grid coordinate reaches 2000 cells, where a float32 step is 1.2e-4 of a
# cell: a position a few steps (5e-5 m); a distance through the height's
# slope at a stair edge (0.1 m over a 0.1 m cell: 1.2e-4 cell = 1.2e-5 m,
# 2e-5); a normal through the gradient of one cell (1e-4). Both devices
# pick the same cell: the sampler divides by tensors (phys/lm/
# collision.py _hfield_sample), so a grid coordinate rounds alike; the
# gradient jumps across a stair edge, and another cell would move a normal
# by up to 0.7
HFIELD_TOL = {"con_dist": 2e-5, "con_pos": 5e-5, "con_frame": 1e-4}


def curriculum_moves(path: str, terrain, before, up, down, done) -> None:
    """After the forced resets: each ``up`` env one level higher (a random
    level past the top row); each ``down`` env one lower (held at 0) or,
    where its command was too slow for the rule, unchanged; some demoted;
    the envs that did not reset unchanged; origins from the table."""
    old, _ = before
    new = terrain.levels
    rows = terrain.max_terrain_level
    ok_up = torch.where(old[up] + 1 < rows, new[up] == old[up] + 1, new[up] < rows)
    demoted = new[down] == torch.clamp(old[down] - 1, min=0)
    ok_down = demoted | (new[down] == old[down])
    table = terrain.terrain_origins[new.long(), terrain.types.long()]
    log(f"[env] {path} terrain curriculum at step 1: {int(up.sum())} timed-out envs moved "
        f"by {ROUGH_SHIFT} m, {int(ok_up.sum())} promoted; {int(down.sum())} timed out near "
        f"their origin, {int((new[down] < old[down]).sum())} demoted; levels now "
        f"{torch.bincount(new.long(), minlength=rows).tolist()}")
    if not (bool(ok_up.all()) and bool(ok_down.all()) and torch.equal(table, terrain.origins)
            and torch.equal(new[~done], old[~done])):
        raise AssertionError(f"{path}: the terrain curriculum did not move the levels "
                             "by its rule")
    if not bool((new[down] < old[down]).any()):
        raise AssertionError(f"{path}: no env was demoted")


def hfield_card_matches_cpu(m, path: str, seed: int) -> dict:
    """The height-field narrowphase (phys/lm/collision.py) on the card
    against the CPU port at float32, NUM_ENVS envs of geom frames: every
    robot geom at a random pose above the terrain, a quarter of them on or
    past the height field's four edges; the height-field slots within
    HFIELD_TOL, everything finite."""
    from mjlab_tpu_torch.phys.lm import collision as pcol
    from mjlab_tpu_torch.phys.lm.base import Params
    from mjlab_tpu_torch.phys.model import model_from_numpy, model_to_numpy

    E = NUM_ENVS
    cpu = model_from_numpy(*model_to_numpy(m), dtype=torch.float32, device="cpu")
    rs = np.random.default_rng(seed)
    hf = m.geom_names.index("terrain/terrain")
    sx, sy, sz = (float(v) for v in m.hfield_size[0, :3].cpu())
    g0 = m.geom_pos[hf].cpu().numpy()
    G = m.ngeom
    x = rs.uniform(-sx, sx, (G, E))
    y = rs.uniform(-sy, sy, (G, E))
    edge = rs.random((G, E)) < 0.25
    x = np.where(edge & (rs.random((G, E)) < 0.5), rs.choice([-sx - 0.5, -sx, sx, sx + 0.5],
                                                             (G, E)), x)
    y = np.where(edge, rs.choice([-sy - 0.5, -sy, sy, sy + 0.5], (G, E)), y)
    z = rs.uniform(-0.2, sz + 0.3, (G, E))
    quat = rs.standard_normal((G, E, 4))
    quat /= np.linalg.norm(quat, axis=-1, keepdims=True)
    w, a, b, c = np.moveaxis(quat, -1, 0)
    mat = np.stack([1 - 2 * (b * b + c * c), 2 * (a * b - w * c), 2 * (a * c + w * b),
                    2 * (a * b + w * c), 1 - 2 * (a * a + c * c), 2 * (b * c - w * a),
                    2 * (a * c - w * b), 2 * (b * c + w * a), 1 - 2 * (a * a + b * b)], 1)
    gx = np.stack([x, y, z], 1) + g0[None, :, None]
    gx[hf] = g0[:, None]
    mat[hf] = np.eye(3).reshape(9, 1)
    out = {}
    for dev, mm in (("cuda", m), ("cpu", cpu)):
        k = pcol.collision_lm(mm, Params(mm, E), torch.as_tensor(gx, dtype=torch.float32,
                                                                   device=dev),
                              torch.as_tensor(mat, dtype=torch.float32, device=dev), {})
        out[dev] = {key: k[key].cpu() for key in HFIELD_TOL}
    slots = torch.as_tensor(m.pairs.con_geom1 == hf)
    errs = {}
    for key, tol in HFIELD_TOL.items():
        card, host = out["cuda"][key][slots], out["cpu"][key][slots]
        if not (bool(torch.isfinite(card).all()) and bool(torch.isfinite(host).all())):
            raise AssertionError(f"{path} hfield {key}: non-finite values")
        errs[key] = float((card.double() - host.double()).abs().max())
    past = int(((np.abs(x) >= sx) | (np.abs(y) >= sy)).sum())
    log(f"[check] {path} height-field narrowphase card vs CPU ({int(slots.sum())} slots x {E} "
        f"envs, {past} geom samples on or past an edge): " + ", ".join(
            f"{k} max abs err {v:.3e} (tol {HFIELD_TOL[k]:.0e})" for k, v in errs.items()))
    for key, tol in HFIELD_TOL.items():
        if not errs[key] < tol:
            raise AssertionError(f"{path} hfield card vs CPU {key}: {errs[key]:.3e} >= {tol:.0e}")
    return errs


# ---------------------------------------------------------------------------
# the training path: PPO on the captured env (rl/runner.py, rl/ppo.py)
# ---------------------------------------------------------------------------

# learn iterations of the timed run; the first captures the env step, the
# throughput is the median of the ones after it
TRAIN_ITERATIONS = 3
# the update on the card against the CPU port: a sub-batch of the card's
# first rollout, every env's T steps; the tolerances of
# tests/test_torch_ppo.py (params: all but a share of 1e-3 of the
# learner's param entries to 1e-5 relative to max(1, |CPU|), every one
# within a tenth of the summed steps; Adam's moments 1e-3 of their largest entry; the
# minibatch KL 1e-4, the learning rates equal to 1e-6)
TRAIN_CHECK_ENVS = 256
TRAIN_TOL = {"params": 1e-5, "outlier_share": 1e-3, "outlier_step": 0.1, "moments": 1e-3,
             "kl": 1e-4, "lr": 1e-6, "stats": 1e-4}


def make_train_runner(env=None, task: str = ENV_TASK):
    """The task's runner from the port's registry on the card (OnPolicyRunner
    where the task registers none, as the train CLI): the task's env at
    NUM_ENVS envs (or ``env``), its PPO config in full."""
    import os

    os.environ.setdefault("MJLAB_QUIET", "1")
    from mjlab_tpu_torch.rl import OnPolicyRunner, RslRlVecEnvWrapper
    from mjlab_tpu_torch.tasks import load_rl_cfg, load_runner_cls

    # the explicit env trains with the flat G1 task's PPO config and runner
    rl_task = ENV_TASK if task == EXPLICIT_TASK else task
    agent = load_rl_cfg(rl_task)
    agent.seed = SEED
    if env is None:
        env = make_env(NUM_ENVS, "cuda", task=task)
    runner_cls = load_runner_cls(rl_task) or OnPolicyRunner
    return runner_cls(RslRlVecEnvWrapper(env, clip_actions=agent.clip_actions),
                      agent, log_dir=None, device="cuda")


def learner_snapshot(ppo, envs: int) -> dict:
    """The learner's state and the first ``envs`` envs of its storage,
    cloned (what update() reads)."""
    keep = ("aobs", "cobs", "action", "logprob", "value", "advantage", "returns", "old_mean",
            "old_std", "reward", "raw_reward", "done")
    return {"tensors": {k: v.detach().clone() for k, v in ppo.learner_tensors().items()},
            "storage": {k: ppo.storage[k][:, :envs].clone() for k in keep}}


def update_on(device: str, runner, snap: dict) -> "object":
    """A learner of TRAIN_CHECK_ENVS envs on ``device`` with the card
    learner's state and storage slice, after one update() whose
    permutations come from _HostRng."""
    from mjlab_tpu_torch.rl.ppo import PPO

    src = runner.ppo
    ppo = PPO(src.cfg, None, TRAIN_CHECK_ENVS, src.ac.num_actions, src.ac.actor_obs_dim,
              src.ac.critic_obs_dim, device=device)
    with torch.no_grad():
        for k, v in ppo.learner_tensors().items():
            v.copy_(snap["tensors"][k])
        shapes = {"policy": snap["storage"]["aobs"][0], "critic": snap["storage"]["cobs"][0]}
        for k, v in ppo._storage(shapes).items():
            if k in snap["storage"]:
                v.copy_(snap["storage"][k])
    ppo.rng = _HostRng(SEED + 5, device)
    ppo.update()
    return ppo


def update_card_matches_cpu(runner, snap: dict, path: str = "g1_train") -> dict:
    """The update phase on the card (TF32 off) against the CPU port on the
    same learner state, storage and permutations."""
    cpu, card = update_on("cpu", runner, snap), update_on("cuda", runner, snap)
    torch.cuda.synchronize()
    want, got = cpu.learner_tensors(), card.learner_tensors()
    lrs = [r[-1] for r in cpu.minibatch_stats.tolist()]
    steps = float(np.sum(lrs, dtype=np.float64))
    errs = {"params": 0.0, "outliers": 0, "moments": 0.0}
    total = 0
    for k, w in want.items():
        g = got[k].cpu()
        if k.startswith("param/"):
            w64 = w.double()
            err = (w64 - g.double()).abs() / max(1.0, float(w64.abs().max()))
            off = int((err >= TRAIN_TOL["params"]).sum())
            errs["outliers"] += off
            total += err.numel()
            errs["params"] = max(errs["params"], float(err.max()))
            if not float(err.max()) < TRAIN_TOL["outlier_step"] * steps:
                raise AssertionError(f"{path} update card vs CPU {k}: {off} of {err.numel()} "
                                     f"entries off, at most {float(err.max()):.3e}")
        elif k.startswith("adam_"):
            e = float((w.double() - g.double()).abs().max()) / max(
                float(w.double().abs().max()), 1e-30)
            errs["moments"] = max(errs["moments"], e)
            if not e < TRAIN_TOL["moments"]:
                raise AssertionError(f"{path} update card vs CPU {k}: {e:.3e}")
        elif not torch.equal(w, g) and k != "lr":
            raise AssertionError(f"{path} update card vs CPU: {k} differs")
    if errs["outliers"] > TRAIN_TOL["outlier_share"] * total:
        raise AssertionError(f"{path} update card vs CPU: {errs['outliers']} of {total} "
                             f"param entries off by >= {TRAIN_TOL['params']:.0e}")
    sc, sg = cpu.minibatch_stats.double(), card.minibatch_stats.double().cpu()
    errs["kl"] = rel_err(sc[:, 3], sg[:, 3])
    errs["lr"] = float(((sc[:, 4] - sg[:, 4]).abs() / sc[:, 4]).max())
    errs["losses"] = rel_err(sc[:, :3], sg[:, :3])
    log(f"[train] {path}: update card vs CPU ({TRAIN_CHECK_ENVS} envs x "
        f"{runner.cfg.num_steps_per_env} steps of the card's first rollout, "
        f"{sc.shape[0]} minibatches): params rel err {errs['params']:.3e} ({errs['outliers']} "
        f"of {total} entries >= {TRAIN_TOL['params']:.0e}; summed steps {steps:.3e}), Adam "
        f"moments {errs['moments']:.3e}, KL {errs['kl']:.3e}, lr {errs['lr']:.3e}, losses "
        f"{errs['losses']:.3e}; KL per minibatch " + ", ".join(f"{x:.4f}" for x in sc[:, 3]))
    for k in ("kl", "lr"):
        if not errs[k] < TRAIN_TOL[k]:
            raise AssertionError(f"{path} update card vs CPU {k}: {errs[k]:.3e}")
    if not errs["losses"] < TRAIN_TOL["stats"]:
        raise AssertionError(f"{path} update card vs CPU losses: {errs['losses']:.3e}")
    return errs


def checkpoint_round_trip(runner, task: str = ENV_TASK) -> dict:
    """Save on the card (the task's runner: model_<it>.pt, and the ONNX
    policy beside it where the runner exports one; else the deployment
    ONNX through rl/exporter.py, as a user exports a checkpoint of the
    generic runner), load with the optimiser into a fresh runner on the same
    env: every learner tensor and the generator state equal bit for bit."""
    import os
    import tempfile

    from mjlab_tpu_torch.rl.exporter import export_policy_as_onnx, get_base_metadata

    with tempfile.TemporaryDirectory() as d:
        run = os.path.join(d, "run")
        path = os.path.join(run, f"model_{runner.iteration}.pt")
        runner.save(path)
        if not any(f.endswith(".onnx") for f in os.listdir(run)):
            export_policy_as_onnx(runner.ppo, os.path.join(run, "run.onnx"),
                                  metadata=get_base_metadata(runner.env, run))
        files = sorted(os.listdir(run))
        size = os.path.getsize(path)
        onnx = sum(os.path.getsize(os.path.join(run, f)) for f in files if f.endswith(".onnx"))
        if not onnx:
            raise AssertionError(f"{task}: no ONNX policy written")
        fresh = make_train_runner(runner.env, task)
        fresh.load(path, load_optimizer=True)
    want, got = runner.ppo.learner_tensors(), fresh.ppo.learner_tensors()
    differ = [k for k in want if not torch.equal(want[k], got[k])]
    same_gen = torch.equal(runner.ppo.rng.generator.get_state(),
                           fresh.ppo.rng.generator.get_state())
    log(f"[train] {task} checkpoint round trip: wrote {files} (checkpoint {size} bytes, ONNX "
        f"{onnx} bytes), {len(want)} learner "
        f"tensors, {len(differ)} differ after load; generator state equal: {same_gen}")
    if differ or not same_gen or fresh.iteration != runner.iteration:
        raise AssertionError(f"g1_train checkpoint round trip: {differ[:5]} differ, generator "
                             f"equal {same_gen}")
    return {"files": files, "bytes": size, "onnx_bytes": onnx, "tensors": len(want)}


def run_train_path(task: str = ENV_TASK, path: str = "g1_train",
                   learner_checks: bool = True, checkpoint: bool = True) -> tuple[dict, dict]:
    """PPO on the task's env at NUM_ENVS envs with the task's full PPO
    config, through the task's runner: (launches, summary). The launch
    counts are set to 0 just before learn() and read after it: its
    env.reset() runs kin_com once (the refresh), then the env's capture (two
    warm-up steps and the capture, in the first rollout step) runs each
    kernel through its wrapper once per control step; replays do not pass
    the wrappers (the profile of one rollout step shows the graph
    launching them). ``learner_checks``: the update on the card against
    the CPU (the learner is the same on every task); ``checkpoint``: the
    checkpoint round trip and the ONNX export."""
    t0 = time.perf_counter()
    runner = make_train_runner(task=task)
    ppo, cfg = runner.ppo, runner.cfg
    alg = cfg.algorithm
    T, N = cfg.num_steps_per_env, NUM_ENVS
    nparams = sum(p.numel() for p in ppo.params)
    log(f"[train] {path}: {task} runner ({type(runner).__name__}) at {N} envs built in "
        f"{time.perf_counter() - t0:.2f} s: actor {ppo.ac.actor_obs_dim} -> "
        f"{tuple(cfg.policy.actor_hidden_dims)} -> {ppo.ac.num_actions}, critic "
        f"{ppo.ac.critic_obs_dim} -> {tuple(cfg.policy.critic_hidden_dims)} -> 1, "
        f"{cfg.policy.activation}, {nparams} params; {T} steps per env, "
        f"{alg.num_learning_epochs} epochs x {alg.num_mini_batches} minibatches of "
        f"{T * N // alg.num_mini_batches}, schedule {alg.schedule}, lr {alg.learning_rate}")

    # the first update's inputs, for the card-against-CPU check
    snaps = []
    update = ppo.update

    def update_keeping_first():
        if not snaps:
            snaps.append(learner_snapshot(ppo, TRAIN_CHECK_ENVS))
        return update()

    ppo.update = update_keeping_first
    per_iter = []

    def check_iteration(m):
        finite = all(math.isfinite(m[k]) for k in ("loss/surrogate", "loss/value",
                                                   "loss/entropy", "train/kl"))
        params_finite = all(bool(torch.isfinite(p).all()) for p in ppo.params)
        per_iter.append(dict(m, params_finite=params_finite))
        if not (finite and params_finite):
            raise AssertionError(f"{path} iteration {runner.iteration}: non-finite losses, KL "
                                 f"or params: {m}")
        # the rule's clamps, as float32 numbers
        if not np.float32(1e-5) <= m["train/lr"] <= np.float32(1e-2):
            raise AssertionError(f"{path}: lr {m['train/lr']} outside [1e-5, 1e-2]")

    # the main path: learn(), the launch counts set to 0 just before and
    # read just after
    torch.cuda.synchronize()
    zero_launches()
    runner.learn(TRAIN_ITERATIONS, on_iteration=check_iteration)
    torch.cuda.synchronize()
    launches = read_launches()
    ppo.update = update
    # learn() starts with env.reset(), whose kinematic refresh runs kin_com
    # once, eagerly
    reset = {"kin_com": 1}
    per_step = {k: (v - reset.get(k, 0)) / (CAPTURE_WARMUP + 1) for k, v in launches.items()}
    solve = env_kind(runner.env)["solve"]
    expected = expected_launches(solve, runner.env.cfg.decimation)
    log(f"[train] {path}: learn({TRAIN_ITERATIONS}): launches {launches} (the reset's refresh "
        f"{reset}, then the capture), per control step of the capture {per_step}, "
        f"expected {expected}")
    if not runner.env.captured or per_step != expected:
        raise AssertionError(f"{path} launches per control step {per_step} != {expected}")
    timings = runner.timings
    for i, (tm, m) in enumerate(zip(timings, per_iter)):
        log(f"[train] {path} iteration {i + 1}: {tm['seconds']:.3f} s, rollout "
            f"{tm['rollout_ms']:.2f} ms ({tm['rollout_ms'] / T:.2f} per step), update "
            f"{tm['update_ms']:.2f} ms; {T * N / tm['seconds']:.1f} env-steps/s; surrogate "
            f"{m['loss/surrogate']:.5f}, value {m['loss/value']:.5f}, entropy "
            f"{m['loss/entropy']:.4f}, kl {m['train/kl']:.5f}, lr {m['train/lr']:.3e}, mean "
            f"reward {m['train/mean_reward']:.5f}, mean std {m['train/mean_std']:.4f}, episode "
            f"length {m.get('Episode/length', float('nan')):.2f}")
    steady = timings[1:]
    rate = float(np.median([T * N / t["seconds"] for t in steady]))
    rollout_ms = float(np.median([t["rollout_ms"] for t in steady]))
    update_ms = float(np.median([t["update_ms"] for t in steady]))
    log(f"[train] {path}: training env-steps/s at {N} envs (T x N / the iteration's seconds, median "
        f"of iterations 2-{TRAIN_ITERATIONS}): {rate:.1f}; rollout {rollout_ms:.2f} ms "
        f"({rollout_ms / T:.3f} per control step), update {update_ms:.2f} ms; the first "
        f"iteration (it captures the env step) {timings[0]['seconds']:.3f} s")

    # one rollout step and one update phase under the profiler
    obs = runner.obs
    want = {n: v for n, v in expected.items() if v}

    def replay_launched(prof):
        seen = {n: v["launches"] for n, v in prof["by_kernel"].items()}
        if seen != want:
            return f"one rollout step launched {seen}, expected {want}"
        return None

    profiles = {}
    for k, run, accept in (("rollout_step", lambda: ppo.rollout_step(0, obs), replay_launched),
                           ("update", ppo.update, None)):
        prof = device_profile(run, accept=accept)
        if not prof["kernels"]:
            raise AssertionError(f"{path} {k}: the profiler {prof['refused']}")
        profiles[k] = prof
        log(f"[train] {path} {k} under the profiler: {prof['kernels']} CUDA kernels, device busy "
            f"{prof['busy_ms']:.3f} ms of a {prof['span_ms']:.3f} ms span, idle share "
            f"{prof['idle_share']:.3f}; " + ", ".join(
                f"{n} {v['launches']} x {v['ms_per_launch']:.4f} ms"
                for n, v in prof["by_kernel"].items()))
        log(f"[train] {path} {k}: the CUDA kernels with the most device time: " + "; ".join(
            f"{t['name'][:60]} {t['launches']} x, {t['ms']:.3f} ms" for t in prof["top"]))

    solve_ms = profiles["rollout_step"]["by_kernel"][solve]["ms_per_launch"]
    log(f"[train] {path}: the solve kernel ({solve}) in one rollout step: "
        f"{solve_ms:.4f} ms per launch")
    card_vs_cpu = (update_card_matches_cpu(runner, snaps[0], path) if learner_checks
                   else None)
    ckpt = checkpoint_round_trip(runner, task) if checkpoint else None
    summary = {"task": task, "env_steps_per_s": rate, "solve_kernel": solve,
               "solve_ms_per_launch": solve_ms, "rollout_ms": rollout_ms, "update_ms": update_ms,
               "rollout_ms_per_control_step": rollout_ms / T, "timings": timings,
               "iterations": per_iter, "launches_per_control_step": per_step,
               "profile": {k: {kk: p[kk] for kk in ("kernels", "busy_ms", "span_ms",
                                                     "idle_share", "by_kernel")}
                           for k, p in profiles.items()},
               "update_card_vs_cpu": card_vs_cpu, "checkpoint": ckpt,
               "num_steps_per_env": T, "params": nparams}
    del runner, ppo
    torch.cuda.empty_cache()
    return launches, summary


# ---------------------------------------------------------------------------
# the forward path: Simulation.forward() of the G1 (kernel 6)
# ---------------------------------------------------------------------------


def check_dense_kernel(sim) -> dict:
    """Kernel 6 against its plain version on the dense inputs of the
    settled state's forward pass: {"newton_solve_dense": its numbers}."""
    from mjlab_tpu_torch.phys import solver_dense_kernels as sd
    from mjlab_tpu_torch.phys import solver_kernels as sv
    from mjlab_tpu_torch.phys.hybrid import forward_stages, solve_dense_inputs

    m = sim.model
    E = sim.num_envs
    d, k, _ = forward_stages(m, sim.data)
    args, kw = solve_dense_inputs(m, k, d)
    it_k = torch.zeros(E, dtype=torch.int32, device=sim.device)
    it_p = torch.zeros(E, dtype=torch.int32, device=sim.device)
    x_k, f_k = sd.newton_solve_dense(*args, **kw, iters=it_k)
    x_p, f_p = sd.newton_solve_dense_plain(*args, **kw, iters=it_p)
    torch.cuda.synchronize()
    Jt = args[0]
    q_k = torch.einsum("vre,re->ve", Jt, f_k)
    q_p = torch.einsum("vre,re->ve", Jt, f_p)
    errs = {"qacc": (rel_err(x_p, x_k), sv.SOLVE_TOL),
            "efc_force": (rel_err(f_p, f_k), sv.FORCE_TOL)}
    for label, e_t in sv.qfrc_errors(q_p, q_k, it_p, it_k).items():
        errs[f"qfrc_constraint, {label}"] = e_t
    for label, (err, tol) in errs.items():
        log(f"[check] g1_forward newton_solve_dense {label}: rel err {err:.3e} "
            f"(tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"g1_forward newton_solve_dense {label}: "
                                 f"{err:.3e} >= {tol:.0e}")
    # live rows (D != 0: the kernel reads and carries only these) and the
    # rows in the quadratic zone at the final residuals (row_quad: every
    # equality row, a dof-friction row below its frictionloss, a one-sided
    # row with a positive force), which stand for every iteration's
    D, fl = args[1], args[3]
    mask = lambda c: torch.as_tensor(c, device=D.device)[:, None]  # noqa: E731
    live = (D != 0) & (mask(kw["os_mask"]) | mask(kw["fr_mask"]) | mask(kw["eq_mask"]))
    quad = live & (D > 0) & (mask(kw["eq_mask"]) | (mask(kw["fr_mask"]) & (f_p.abs() < fl))
                             | (mask(kw["os_mask"]) & (f_p > 0)))
    nlive = live.sum(0).double()
    nact = quad.sum(0).double()
    differ = int((it_k != it_p).sum())
    shape = sd.dense_launch_shape(m.nv, m.nefc, int(nlive.max()))
    blocks = sd.dense_blocks_per_sm(shape.smem_bytes_per_env)
    log(f"[check] g1_forward newton_solve_dense: launch shape {shape.threads_per_env} "
        f"threads per env, {shape.smem_bytes_per_env} bytes of shared memory per env "
        f"({int(nlive.max())} live rows); {blocks} envs per SM, "
        f"{blocks * shape.threads_per_env} resident threads per SM")
    log(f"[check] g1_forward newton_solve_dense: iterations mean "
        f"{it_k.double().mean():.2f} kernel, {it_p.double().mean():.2f} plain, "
        f"different in {differ} of {E} envs; at the {kw['iterations']}-iteration cap "
        f"{int((it_k == kw['iterations']).sum())} kernel, "
        f"{int((it_p == kw['iterations']).sum())} plain; live rows max "
        f"{int(nlive.max())}, mean {float(nlive.mean()):.1f}, rows in the quadratic "
        f"zone {float(nact.mean()):.1f} of {m.nefc}")
    flops = float(sum(
        dense_flops(m.nv, nl, na, it, kw["ls_iterations"])
        for nl, na, it in zip(nlive.tolist(), nact.tolist(), it_p.tolist())
    ))
    # Jt's live rows only: a row with D = 0 adds nothing and is not read
    moved = (nbytes(*args[1:], x_k, f_k)
             + int(live.sum()) * m.nv * Jt.element_size())
    fn_k = lambda: sd.newton_solve_dense(*args, **kw)  # noqa: E731
    ms = kernel_ms(fn_k, KERNEL_NAMES["newton_solve_dense"], 10)
    wrapper_ms = cuda_ms(fn_k, 10)
    plain_ms = cuda_ms(lambda: sd.newton_solve_dense_plain(*args, **kw), 2)
    b_ms, b_by = bound(moved, flops)
    log(f"[time] g1_forward newton_solve_dense: kernel {ms:.4f} ms (device, profiler), "
        f"wrapper {wrapper_ms:.4f} ms (back to back, CUDA events), plain "
        f"{plain_ms:.3f} ms, bound {b_ms:.4f} ms ({b_by}: {moved / 1e6:.1f} MB, "
        f"{flops / 1e9:.3f} GFLOP)")
    return {"newton_solve_dense": dict(
        ms=ms, wrapper_ms=wrapper_ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
        bytes=moved,
        flops=flops, max_abs_err=max(max_abs(x_p, x_k), max_abs(f_p, f_k)),
        max_rel_err=max(e for e, _ in errs.values()),
        iteration_counts_differ=differ, live_rows_max=int(nlive.max()),
        live_rows_mean=float(nlive.mean()),
        resident_threads_per_sm=blocks * shape.threads_per_env,
    )}


def forward_breakdown(sim, calls: int) -> dict:
    """Device time per phase of forward() (CUDA events at its phase
    marks) and kernel 6's mean Newton iteration count, averaged over
    ``calls`` calls."""
    from mjlab_tpu_torch.phys.hybrid import forward_hybrid

    order = ("position", "contact", "velocity", "solve", "writeback")
    acc = {n: 0.0 for n in order}
    iters = torch.zeros(sim.num_envs, dtype=torch.int32, device=sim.device)
    acc["newton_iterations"] = 0.0
    for _ in range(calls):
        ev = [torch.cuda.Event(enable_timing=True)]
        ev[0].record()
        marks = []

        def mark(name):
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            ev.append(e)
            marks.append(name)

        sim.data = forward_hybrid(sim.model, sim.data, iters=iters, mark=mark)
        torch.cuda.synchronize()
        for name, a, b in zip(marks, ev[:-1], ev[1:]):
            acc[name] += a.elapsed_time(b)
        acc["newton_iterations"] += float(iters.double().mean())
    return {n: v / calls for n, v in acc.items()}


def forward_op_counts(sim) -> dict:
    """Torch operators dispatched per phase of one forward() call (views
    included: an upper bound on the CUDA kernels each phase launches)."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from mjlab_tpu_torch.phys.hybrid import forward_hybrid

    class Count(TorchDispatchMode):
        n = 0

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            Count.n += 1
            return func(*args, **(kwargs or {}))

    counts, last = {}, [0]

    def mark(name):
        counts[name] = Count.n - last[0]
        last[0] = Count.n

    with Count():
        sim.data = forward_hybrid(sim.model, sim.data, mark=mark)
    torch.cuda.synchronize()
    return counts


def forward_check(seed: int):
    """forward() of 64 settled envs on the card against forward() on the
    CPU (the plain versions) from the same Data."""
    from mjlab_tpu_torch.phys import solver_kernels as sv
    from mjlab_tpu_torch.phys.data import data_from_numpy, tensor_fields

    card, state = make_sim("g1", 64, "cuda")
    seed_state(card, "g1", state, seed)
    for _ in range(3):
        control_step(card, "g1")
    cpu, _ = make_sim("g1", 64, "cpu")
    get = lambda d, n: d.contact.packed if n == "contact" else getattr(d, n)  # noqa: E731
    cpu.data = data_from_numpy(
        {n: get(card.data, n).cpu().numpy() for n in tensor_fields()}, device="cpu")
    card.forward()
    cpu.forward()
    dc, dp = card.data, cpu.data
    # the same active contact slots in every env; rows compared row by row
    # in the envs whose slots are in the same order (mirrored slots may
    # tie to a few f32 ulps and swap)
    sel_c, act_c = dc.con_sel.cpu(), dc.con_sel_active.cpu()
    sel_p, act_p = dp.con_sel, dp.con_sel_active
    differ = [e for e in range(64)
              if not torch.equal(sel_c[e][act_c[e]].sort().values,
                                 sel_p[e][act_p[e]].sort().values)]
    if differ:
        raise AssertionError(f"g1_forward: envs {differ} select other active "
                             "slots on the card than on the CPU")
    same = (sel_c == sel_p).all(dim=1) & (act_c == act_p).all(dim=1)
    log(f"[e2e] g1_forward 64 envs, card vs CPU: the same active contact slots "
        f"in all 64, in the same order in {int(same.sum())}")
    if int(same.sum()) < 32:
        raise AssertionError("g1_forward: fewer than half the envs keep the "
                             "CPU's slot order")
    active = dp.efc_active[same]
    checks = (
        ("qacc", sv.SOLVE_TOL, None), ("qacc_smooth", FORWARD_TOL, None),
        ("efc_force", sv.FORCE_TOL, same), ("qfrc_constraint", sv.FORCE_TOL, None),
        ("qM", FORWARD_TOL, None), ("qLD", FORWARD_TOL, None),
        ("efc_D", FORWARD_TOL, same), ("efc_aref", FORWARD_TOL, same),
        ("efc_Jc", FORWARD_TOL, same), ("geom_xpos", FORWARD_TOL, None),
        ("geom_xmat", FORWARD_TOL, None), ("site_xpos", FORWARD_TOL, None),
        ("site_xmat", FORWARD_TOL, None), ("xanchor", FORWARD_TOL, None),
        ("xaxis", FORWARD_TOL, None), ("contact", FORWARD_TOL, None),
    )
    for f, tol, envs in checks:
        ref, got = get(dp, f), get(dc, f).cpu()
        if envs is not None:
            ref, got = ref[envs], got[envs]
        if f == "efc_Jc":  # the contact rows that are active
            on = active[:, -ref.shape[1]:, None]
            ref, got = ref * on, got * on
        err = rel_err(ref, got)
        log(f"[e2e] g1_forward {f}: rel err {err:.3e} (tol {tol:.0e})")
        if not err < tol:
            raise AssertionError(f"g1_forward {f}: {err:.3e} >= {tol:.0e}")
    if not torch.equal(dp.efc_active[same], dc.efc_active.cpu()[same]):
        raise AssertionError("g1_forward: other active rows on the card")
    if not bool(torch.isfinite(dc.qacc).all()):
        raise AssertionError("g1_forward: non-finite qacc on the card")


def run_forward_path() -> tuple[dict, dict, dict]:
    """The g1_forward path: (kernel numbers, launches, summary)."""
    sim, state = make_sim("g1", NUM_ENVS, "cuda")
    m = sim.model
    log(f"[model] g1_forward: nq {m.nq} nv {m.nv} nefc {m.nefc}, K "
        f"{m.ncon_max}, R {m.rows_per_con}; {NUM_ENVS} envs, Simulation.forward()")
    ctrl0 = seed_state(sim, "g1", state, SEED)
    for _ in range(SETTLE_STEPS):
        control_step(sim, "g1", ctrl0)
    torch.cuda.synchronize()
    log(f"[settle] g1_forward: {SETTLE_STEPS} control steps; contacts active per "
        f"env {float(sim.data.con_sel_active.sum(1).double().mean()):.1f}")

    kernels = check_dense_kernel(sim)

    sim.forward()  # warm
    run = timed_launches([sim.forward] * FORWARD_CALLS)
    launches = run["launches"]
    expected = {"kin_com": 0, "crb_packed": 0, "vel_smooth": 0,
                "newton_assemble_solve": 0, "newton_assemble_solve_elliptic": 0,
                "newton_solve_dense": FORWARD_CALLS}
    log(f"[main] g1_forward launches {launches}, expected {expected}")
    if launches != expected:
        raise AssertionError(f"g1_forward kernel launches {launches} != {expected}")
    d = sim.data
    if not (bool(torch.isfinite(d.qacc).all()) and bool(torch.isfinite(d.efc_force).all())):
        raise AssertionError("g1_forward: non-finite qacc or efc_force")
    ms = run["dev_ms"] / FORWARD_CALLS
    log(f"[main] g1_forward {FORWARD_CALLS} forward() calls at {NUM_ENVS} envs: "
        f"{run['dev_ms']:.1f} ms (CUDA events), {run['wall'] * 1e3:.1f} ms (host "
        f"clock); {ms:.2f} ms per forward()")
    parts = forward_breakdown(sim, 3)
    its = parts.pop("newton_iterations")
    log("[breakdown] g1_forward ms per forward(): " + ", ".join(
        f"{k} {v:.3f}" for k, v in parts.items()) + f" (sum {sum(parts.values()):.3f}); "
        f"Newton iterations per env {its:.2f} (warm-started from the previous "
        "forward()'s qacc)")
    ops = forward_op_counts(sim)
    log("[ops] g1_forward torch operators per forward(): " + ", ".join(
        f"{k} {v}" for k, v in ops.items()) + f" (sum {sum(ops.values())})")
    prof = device_profile(sim.forward)
    if prof["kernels"]:
        log(f"[profile] g1_forward one forward(): {prof['kernels']} CUDA kernels, "
            f"device busy {prof['busy_ms']:.2f} ms of a {prof['span_ms']:.2f} ms "
            f"span, idle share {prof['idle_share']:.3f} (under the profiler)")
    del sim, d
    torch.cuda.empty_cache()

    forward_check(SEED + 1)
    summary = {"ms_per_forward": ms, "breakdown_ms_per_forward": parts,
               "newton_iterations_per_env": its, "torch_ops_per_phase": ops,
               "profile": prof}
    return kernels, launches, summary


# the kernel rows' numbers: the kernel checks of the path that runs the
# kernel (the G1 physics for kernels 1-4, the YAM for 5, g1_forward for 6;
# every path's checks, the rough envs' and the YAM env's included, under
# "per_path"), and the launches of the main paths: the rough-terrain
# training run for kernels 1-4 (g1_rough_train: the env's capture in the
# first rollout step), the YAM's training run for kernel 5 (yam_train),
# g1_forward for kernel 6
CHECK_PATH = {"kin_com": "g1_explicit_env", "crb_packed": "g1_explicit_env",
              "vel_smooth": "g1_explicit_env", "newton_assemble_solve": "g1_explicit_env",
              "newton_assemble_solve_elliptic": "yam", "newton_solve_dense": "g1_forward"}
LAUNCH_PATH = {"kin_com": "g1_explicit_train", "crb_packed": "g1_explicit_train",
               "vel_smooth": "g1_explicit_train", "newton_assemble_solve": "g1_explicit_train",
               "newton_assemble_solve_elliptic": "yam_train",
               "newton_solve_dense": "g1_forward"}


def kernel_rows(per_path: dict, launches: dict, per_step: dict) -> list[dict]:
    """One row per kernel: its check's numbers (CHECK_PATH), its launches
    on this slice's main path (LAUNCH_PATH, with the launches per control
    step its capture recorded, ``per_step`` by path), and every path's
    numbers under "per_path"."""
    rows = []
    for name in REPLACES:
        runs = {p: per_path[p][name] for p in per_path if name in per_path[p]}
        top, lp = CHECK_PATH[name], LAUNCH_PATH[name]
        r = runs[top]
        row = dict(
            name=name, route="cuda", source=SOURCES[name], replaces=REPLACES[name],
            launches=launches[lp][name], max_abs_err=r["max_abs_err"],
            ms=r["ms"], wrapper_ms=r["wrapper_ms"], plain_ms=r["plain_ms"],
            bound_ms=r["bound_ms"],
            bound_by=r["bound_by"], library_ms=None, path=top, launch_path=lp,
            **({"launches_per_forward": launches[lp][name] / FORWARD_CALLS}
               if lp == "g1_forward" else
               {"launches_per_control_step": per_step[lp][name]}),
            max_rel_err=r["max_rel_err"], bytes=r["bytes"], flops=r["flops"],
        )
        if "iteration_counts_differ" in r:
            row["iteration_counts_differ"] = r["iteration_counts_differ"]
        if name in KERNEL_PLANES:
            # the fields the kernel reads per env where the Model carries
            # them so, and those it read so on its check state
            row["per_env_fields"] = list(KERNEL_PLANES[name])
            row["dr_planes"] = r.get("dr_planes", [])
        row["per_path"] = {p: dict(runs[p], launches=launches[p][name]) for p in runs}
        rows.append(row)
    return rows


# this slice's paths: the rough-terrain envs (G1 and Go1), then the main
# path, PPO on the rough G1 task
ROUGH_ENV_PATHS = {"g1_rough_env": "Mjlab-Velocity-Rough-Unitree-G1",
                   "go1_rough_env": "Mjlab-Velocity-Rough-Unitree-Go1"}
ROUGH_TRAIN_TASK = "Mjlab-Velocity-Rough-Unitree-G1"


def run_yam_paths(yam_capture_kernels: int | None = None) -> tuple[dict, dict]:
    """yam_env and yam_train, the lift-cube task (the elliptic cone inside
    an env's graph and a PPO iteration): (launches by path, summary by
    path)."""
    launches, summary = {}, {}
    launches["yam_env"], summary["yam_env"] = run_env_path(
        yam_capture_kernels, YAM_TASK, "yam_env")
    launches["yam_train"], summary["yam_train"] = run_train_path(
        YAM_TASK, "yam_train", learner_checks=False)
    return launches, summary


def run_tracking_paths() -> tuple[dict, dict]:
    """tracking_env and tracking_train, the G1 motion-tracking task (the
    torso's body_ipos per env in kernels 1-3, inside an env's graph and a
    PPO iteration): (launches by path, summary by path)."""
    launches, summary = {}, {}
    launches["tracking_env"], summary["tracking_env"] = run_env_path(
        None, TRACKING_TASK, "tracking_env")
    launches["tracking_train"], summary["tracking_train"] = run_train_path(
        TRACKING_TASK, "tracking_train", learner_checks=False)
    return launches, summary


def run_jump_paths() -> tuple[dict, dict]:
    """jump_env, jump_train, jumping_env and jumping_train, the G1 jump
    tasks (the jump task at dt 0.002 and decimation 2: kin_com 3 and the
    other kernels 2 per control step; the jumping command's resample and
    trigger decay inside the graph), each training path with the learner
    checks: (launches by path, summary by path)."""
    launches, summary = {}, {}
    for name, task in (("jump", JUMP_TASK), ("jumping", JUMPING_TASK)):
        launches[f"{name}_env"], summary[f"{name}_env"] = run_env_path(
            None, task, f"{name}_env")
        launches[f"{name}_train"], summary[f"{name}_train"] = run_train_path(
            task, f"{name}_train")
    return launches, summary


def run_explicit_paths() -> tuple[dict, dict]:
    """g1_explicit_env and g1_explicit_train, the G1 flat-velocity env with
    mixed explicit actuator groups (this slice's main path; kernel 3 reads
    the per-env force range), the training path with the learner checks:
    (launches by path, summary by path)."""
    launches, summary = {}, {}
    launches["g1_explicit_env"], summary["g1_explicit_env"] = run_env_path(
        None, EXPLICIT_TASK, "g1_explicit_env")
    launches["g1_explicit_train"], summary["g1_explicit_train"] = run_train_path(
        EXPLICIT_TASK, "g1_explicit_train")
    return launches, summary


def run_rough_paths() -> tuple[dict, dict]:
    """g1_rough_env, go1_rough_env and g1_rough_train: (launches by path,
    summary by path)."""
    launches, summary = {}, {}
    for p, task in ROUGH_ENV_PATHS.items():
        launches[p], summary[p] = run_env_path(None, task, p)
    launches["g1_rough_train"], summary["g1_rough_train"] = run_train_path(
        ROUGH_TRAIN_TASK, "g1_rough_train", learner_checks=False, checkpoint=False)
    return launches, summary


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
              file=sys.stderr)
        return 2

    try:
        import mjlab_tpu_torch  # noqa: F401
    except ImportError:
        print("chip_smoke: the package mjlab_tpu_torch is not importable: run this "
              "script from the root of a checkout of the repository", file=sys.stderr)
        return 1

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    log(f"[env] python {sys.version.split()[0]}, torch {torch.__version__}, "
        f"cuda {torch.version.cuda}, {torch.cuda.get_device_name(0)}")

    build_kernels()
    if sys.argv[1:2] == ["--only-env"]:
        # a quick run of the env's path alone: no result line
        run_env_path(None)
        log("[partial] --only-env: the other paths did not run; no result")
        return 0
    if sys.argv[1:2] == ["--only-train"]:
        # a quick run of the flat training path alone: no result line
        run_train_path()
        log("[partial] --only-train: the other paths did not run; no result")
        return 0
    if sys.argv[1:2] == ["--only-rough"]:
        # a quick run of the rough-terrain paths alone: no result line
        launches, rough = run_rough_paths()
        log(json.dumps({"rough": rough, "num_envs": NUM_ENVS}))
        log("[partial] --only-rough: the other paths did not run; no result")
        return 0
    if sys.argv[1:2] == ["--only-tracking"]:
        # a quick run of the tracking env and training paths alone: no
        # result line
        launches, tracking = run_tracking_paths()
        log(json.dumps({"tracking": tracking, "num_envs": NUM_ENVS}))
        log("[partial] --only-tracking: the other paths did not run; no result")
        return 0
    if sys.argv[1:2] == ["--only-jump"]:
        # a quick run of the jump tasks' env and training paths alone: no
        # result line
        launches, jump = run_jump_paths()
        log(json.dumps({"jump": jump, "num_envs": NUM_ENVS}))
        log("[partial] --only-jump: the other paths did not run; no result")
        return 0
    if sys.argv[1:2] == ["--only-explicit"]:
        # a quick run of the explicit-actuator env and training paths
        # alone: no result line
        launches, explicit = run_explicit_paths()
        log(json.dumps({"explicit": explicit, "num_envs": NUM_ENVS}))
        log("[partial] --only-explicit: the other paths did not run; no result")
        return 0
    if sys.argv[1:2] == ["--only-yam"]:
        # a quick run of the lift-cube env and training paths alone: no
        # result line
        launches, yam = run_yam_paths()
        log(json.dumps({"yam": yam, "num_envs": NUM_ENVS}))
        log("[partial] --only-yam: the other paths did not run; no result")
        return 0
    per_path, launches, summary = {}, {}, {}
    for path in PATHS:
        per_path[path], launches[path], summary[path] = run_path(path)
    path = "g1_forward"
    per_path[path], launches[path], summary[path] = run_forward_path()
    capture = {}
    for path in PATHS:
        launches[f"{path}_capture"], capture[path] = run_capture_path(path)
    launches["g1_env"], env = run_env_path(
        capture["g1"]["cuda_kernels_per_control_step"]["captured"])
    per_step = {f"{p}_capture": capture[p]["launches_per_control_step"] for p in PATHS}
    per_step["g1_env"] = env["launches_per_control_step"]
    launches["g1_train"], train = run_train_path()
    per_step["g1_train"] = train["launches_per_control_step"]
    rough_launches, rough = run_rough_paths()
    launches.update(rough_launches)
    for p in ROUGH_ENV_PATHS:
        per_path[p] = rough[p]["kernel_checks"]
    per_step.update({p: rough[p]["launches_per_control_step"] for p in rough})
    yam_launches, yam = run_yam_paths(capture["yam"]["cuda_kernels_per_control_step"]["captured"])
    launches.update(yam_launches)
    per_path["yam_env"] = yam["yam_env"]["kernel_checks"]
    per_step.update({p: yam[p]["launches_per_control_step"] for p in yam})
    tracking_launches, tracking = run_tracking_paths()
    launches.update(tracking_launches)
    per_path["tracking_env"] = tracking["tracking_env"]["kernel_checks"]
    per_step.update({p: tracking[p]["launches_per_control_step"] for p in tracking})
    jump_launches, jump = run_jump_paths()
    launches.update(jump_launches)
    for p in ("jump_env", "jumping_env"):
        per_path[p] = jump[p]["kernel_checks"]
    per_step.update({p: jump[p]["launches_per_control_step"] for p in jump})
    explicit_launches, explicit = run_explicit_paths()
    launches.update(explicit_launches)
    per_path["g1_explicit_env"] = explicit["g1_explicit_env"]["kernel_checks"]
    per_step.update({p: explicit[p]["launches_per_control_step"] for p in explicit})

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    log(json.dumps({"kernels": kernel_rows(per_path, launches, per_step)}))
    log(json.dumps({"capture": capture, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"g1_env": env, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"g1_train": train, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"rough": rough, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"yam": yam, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"tracking": tracking, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"jump": jump, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"explicit": explicit, "num_envs": NUM_ENVS, "power_limit": smi}))
    log(json.dumps({"paths": summary, "num_envs": NUM_ENVS,
                    "control_steps": CONTROL_STEPS,
                    "seconds": time.perf_counter() - t_start}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
