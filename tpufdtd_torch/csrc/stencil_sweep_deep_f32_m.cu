// Kernel B's deep form (stencil_sweep_deep.cuh): f32 levels with a scalar m.
// One translation unit per mode, so that nvcc builds them in parallel.

#include "stencil_sweep_deep.cuh"

TPUFDTD_SWEEP_MODE(sweep_deep_f32_m, float) {
  return sweep_deep::launch_mode<float, false>(uin, uout, w, g, radius, k, iso, c, s);
}
