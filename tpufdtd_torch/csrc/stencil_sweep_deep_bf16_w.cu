// Kernel B's deep form (stencil_sweep_deep.cuh): bf16 levels (f32 compute) with the w stream.
// One translation unit per mode, so that nvcc builds them in parallel.

#include "stencil_sweep_deep.cuh"

TPUFDTD_SWEEP_MODE(sweep_deep_bf16_w, bf16) {
  return sweep_deep::launch_mode<bf16, true>(uin, uout, w, g, radius, k, iso, c, s);
}
