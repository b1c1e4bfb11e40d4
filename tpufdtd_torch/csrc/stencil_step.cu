// Kernel A (stencil_step.cuh): the C entries. Its storage types and radius
// ranges are built in stencil_step_<f32|bf16>_r<13|46>.cu.

#include "stencil_step.cuh"

// cur, prev and target are f32, or bf16 when bf16_storage is nonzero. m may
// be null: then coeffs[13] is the scalar medium value. A block of
// step::THREADS threads sweeps a ty x tz column over xc x-planes.
// Returns cudaGetLastError() after the launch; 1000 + radius for a radius
// this library was not built for; cudaErrorInvalidValue for a column beyond
// its threads' cells.
extern "C" int tpufdtd_leapfrog_step(const void* cur, const void* prev, const float* m,
                                     void* target, int nx, int ny, int nz, int halo,
                                     int radius, int bf16_storage, int xc, int ty, int tz,
                                     const float* coeffs, void* stream) {
  const Coeffs c = coeffs_from_host(coeffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const step::Geom g{nx, ny, nz, halo, ty, tz, xc, 0, 0, 0};
  if (bf16_storage) {
    const bf16 *bc = static_cast<const bf16*>(cur), *bp = static_cast<const bf16*>(prev);
    return (radius <= 3 ? step_bf16_r13 : step_bf16_r46)(bc, bp, m, static_cast<bf16*>(target),
                                                         g, radius, c, s);
  }
  const float *fc = static_cast<const float*>(cur), *fp = static_cast<const float*>(prev);
  return (radius <= 3 ? step_f32_r13 : step_f32_r46)(fc, fp, m, static_cast<float*>(target), g,
                                                     radius, c, s);
}

// The dynamic shared memory tpufdtd_leapfrog_step requests for a block, in
// bytes (ops/stencil_step.py:smem_bytes must agree).
extern "C" long long tpufdtd_step_smem(int radius, int ty, int tz, int bf16_storage,
                                       int per_point_m) {
  return (long long)step::smem(radius, ty, tz, bf16_storage ? 2 : 4, per_point_m != 0);
}

// The register policy of the instantiation a ty x tz column takes at this
// radius: cells per thread (two per pair) and blocks per SM
// (ops/stencil_step.py:cells_per_thread and blocks_per_sm must agree).
extern "C" void tpufdtd_step_policy(int radius, int ty, int tz, int* out) {
  out[1] = step::blocks_for(radius, ty, tz);
  out[0] = 2 * step::pairs(radius, out[1]);
}
