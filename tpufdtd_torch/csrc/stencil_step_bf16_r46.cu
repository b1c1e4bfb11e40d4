// Kernel A (stencil_step.cuh): bf16 levels, radius 4-6. One translation
// unit per storage type and radius range, so that nvcc builds them in
// parallel.

#include "stencil_step.cuh"

TPUFDTD_STEP_MODE(step_bf16_r46, bf16) {
  return step::launch_mode<bf16, 4, 6>(cur, prev, m, target, g, radius, c, s);
}
