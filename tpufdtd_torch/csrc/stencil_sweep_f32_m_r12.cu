// Kernel B (stencil_sweep.cuh): f32 levels with a scalar m, radius 1-2. One
// translation unit per mode and radius range, so that nvcc builds them in
// parallel.

#include "stencil_sweep.cuh"

TPUFDTD_SWEEP_MODE(sweep_f32_m_r12, float) {
  return sweep::launch_mode<float, false, 1, 2>(uin, uout, w, g, radius, k, iso, c, s);
}
