// Kernel B's deep form (stencil_sweep_deep.cuh): f32 storage with a scalar m, radius 2.
// One translation unit per mode and radius, so that nvcc builds them in parallel.

#include "stencil_sweep_deep.cuh"

TPUFDTD_SWEEP_MODE(sweep_deep_f32_m_r2, float) {
  return sweep_deep::launch_mode<float, false, 2>(uin, uout, w, g, radius, k, iso, c, s);
}
