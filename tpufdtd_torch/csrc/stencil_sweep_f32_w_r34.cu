// Kernel B (stencil_sweep.cuh): f32 levels with the w stream, radius 3. One
// translation unit per mode and radius range, so that nvcc builds them in
// parallel.

#include "stencil_sweep.cuh"

TPUFDTD_SWEEP_MODE(sweep_f32_w_r34, float) {
  return sweep::launch_mode<float, true, 3, 3>(uin, uout, w, g, radius, k, iso, c, s);
}
