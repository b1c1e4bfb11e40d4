// Kernel B (stencil_sweep.cuh): bf16 levels (f32 compute) with the w stream,
// radius 1-2. One translation unit per mode and radius range, so that nvcc
// builds them in parallel.

#include "stencil_sweep.cuh"

TPUFDTD_SWEEP_MODE(sweep_bf16_w_r12, bf16) {
  return sweep::launch_mode<bf16, true, 1, 2>(uin, uout, w, g, radius, k, iso, c, s);
}
