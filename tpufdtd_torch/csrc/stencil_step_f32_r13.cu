// Kernel A (stencil_step.cuh): f32 levels, radius 1-3. One translation
// unit per storage type and radius range, so that nvcc builds them in
// parallel.

#include "stencil_step.cuh"

TPUFDTD_STEP_MODE(step_f32_r13, float) {
  return step::launch_mode<float, 1, 3>(cur, prev, m, target, g, radius, c, s);
}
