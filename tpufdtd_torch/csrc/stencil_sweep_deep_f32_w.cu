// Kernel B's deep form (stencil_sweep_deep.cuh): f32 levels with the w stream.
// One translation unit per mode, so that nvcc builds them in parallel.

#include "stencil_sweep_deep.cuh"

TPUFDTD_SWEEP_MODE(sweep_deep_f32_w, float) {
  return sweep_deep::launch_mode<float, true>(uin, uout, w, g, radius, k, iso, c, s);
}
