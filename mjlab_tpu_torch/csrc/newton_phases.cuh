// newton_phases.cuh: cycle counters by phase for the Newton solve kernels
// (newton_solve.cu, newton_solve_elliptic.cu), compiled in only with
// -DNEWTON_PHASES (scripts/newton_phases.py builds them so). Thread 0 of a
// block adds the clock64() cycles since the block's previous mark to the
// counter of the phase that ends there; newton_phases_read copies the
// counters (and the summed Newton iteration counts) to the host and zeroes
// them. Without the define every mark compiles to nothing.
#pragma once

#include <cuda_runtime.h>

enum NewtonPhase {
  kPhLoad,      // the env's inputs and phase A (the dense contact rows)
  kPhSmooth,    // a_smooth: factor M, solve
  kPhInit,      // the initial point: residuals and costs at ws and a_smooth
  kPhGrad,      // per Newton iteration: the gradient
  kPhHess,      // the Hessian
  kPhFactor,    // its factor and the Newton direction
  kPhDir,       // the direction in row space, q1 and q2
  kPhDoubling,  // the 12 doubling probes
  kPhBisect,    // the ls_iterations Newton/bisection probes
  kPhAccept,    // the accepting cost and the step
  kPhOut,       // the outputs with qacc_int
  kNumPhases
};

#ifdef NEWTON_PHASES
__device__ unsigned long long g_phase_cycles[kNumPhases + 1];  // + iterations
__shared__ long long s_phase_t0;

#define PHASE_BEGIN()                           \
  do {                                          \
    if (threadIdx.x == 0) s_phase_t0 = clock64(); \
  } while (0)
#define PHASE_MARK(p)                                                           \
  do {                                                                          \
    if (threadIdx.x == 0) {                                                     \
      const long long t_ = clock64();                                           \
      atomicAdd(&g_phase_cycles[p], (unsigned long long)(t_ - s_phase_t0));     \
      s_phase_t0 = t_;                                                          \
    }                                                                           \
  } while (0)
#define PHASE_ITERS(n)                                                                 \
  do {                                                                                 \
    if (threadIdx.x == 0) atomicAdd(&g_phase_cycles[kNumPhases], (unsigned long long)(n)); \
  } while (0)

extern "C" int newton_phases_read(unsigned long long* out) {
  cudaError_t err = cudaMemcpyFromSymbol(out, g_phase_cycles, sizeof(g_phase_cycles));
  if (err != cudaSuccess) return static_cast<int>(err);
  static const unsigned long long zero[kNumPhases + 1] = {};
  return static_cast<int>(cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
}
#else
#define PHASE_BEGIN() do {} while (0)
#define PHASE_MARK(p) do {} while (0)
#define PHASE_ITERS(n) do {} while (0)
#endif
