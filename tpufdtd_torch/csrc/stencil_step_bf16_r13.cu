// Kernel A (stencil_step.cuh): bf16 levels, radius 1-3. One translation
// unit per storage type and radius range, so that nvcc builds them in
// parallel.

#include "stencil_step.cuh"

TPUFDTD_STEP_MODE(step_bf16_r13, bf16) {
  return step::launch_mode<bf16, 1, 3>(cur, prev, m, target, g, radius, c, s);
}
