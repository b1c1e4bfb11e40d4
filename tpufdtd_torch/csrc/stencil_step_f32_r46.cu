// Kernel A (stencil_step.cuh): f32 levels, radius 4-6. One translation
// unit per storage type and radius range, so that nvcc builds them in
// parallel.

#include "stencil_step.cuh"

TPUFDTD_STEP_MODE(step_f32_r46, float) {
  return step::launch_mode<float, 4, 6>(cur, prev, m, target, g, radius, c, s);
}
