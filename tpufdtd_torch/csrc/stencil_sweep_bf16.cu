// Kernel B (stencil_sweep.cuh) on bf16 levels with f32 compute: scalar m
// and the w stream, radius 1-3. Its own translation unit, so that nvcc
// builds it beside the f32 modes of stencil_sweep.cu.

#include "stencil_sweep.cuh"

int sweep_bf16(const bf16* uin, bf16* uout, const float* w, int nx, int ny,
               int nz, int halo, int radius, int k, bool iso, int xc, int ty,
               int tz, int ythreads, const Coeffs& c, cudaStream_t s) {
  return w ? launch_mode<bf16, true, 3>(uin, uout, w, nx, ny, nz, halo, radius, k, iso, xc,
                                        ty, tz, ythreads, c, s)
           : launch_mode<bf16, false, 3>(uin, uout, w, nx, ny, nz, halo, radius, k, iso, xc,
                                         ty, tz, ythreads, c, s);
}
