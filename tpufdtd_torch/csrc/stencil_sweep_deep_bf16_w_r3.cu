// Kernel B's deep form (stencil_sweep_deep.cuh): bf16 storage with the w stream, radius 3.
// One translation unit per mode and radius, so that nvcc builds them in parallel.

#include "stencil_sweep_deep.cuh"

TPUFDTD_SWEEP_MODE(sweep_deep_bf16_w_r3, bf16) {
  return sweep_deep::launch_mode<bf16, true, 3>(uin, uout, w, g, radius, k, iso, c, s);
}
