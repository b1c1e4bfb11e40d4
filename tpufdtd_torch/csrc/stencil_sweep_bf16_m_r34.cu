// Kernel B (stencil_sweep.cuh): bf16 levels (f32 compute) with a scalar m,
// radius 3. One translation unit per mode and radius range, so that nvcc
// builds them in parallel.

#include "stencil_sweep.cuh"

TPUFDTD_SWEEP_MODE(sweep_bf16_m_r34, bf16) {
  return sweep::launch_mode<bf16, false, 3, 3>(uin, uout, w, g, radius, k, iso, c, s);
}
