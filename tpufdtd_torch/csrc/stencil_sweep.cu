// Kernel B (stencil_sweep.cuh): the C entry, and the f32 modes, scalar m at
// radius 1-4 and the w stream at radius 1-3. The bf16 modes are built in
// stencil_sweep_bf16.cu.

#include "stencil_sweep.cuh"

// uin and uout are f32, or bf16 when bf16_storage is nonzero; w is the
// per-point w stream (f32), or null for a scalar m (coeffs[13] and the
// isotropic scale coeffs[15]). Returns cudaGetLastError() after the launch;
// 1000 + radius for a radius this mode is not built for.
extern "C" int tpufdtd_sweep(const void* uin, void* uout, const float* w, int nx,
                             int ny, int nz, int halo, int radius, int k,
                             int isotropic, int bf16_storage, int xc, int ty,
                             int tz, int ythreads, const float* coeffs,
                             void* stream) {
  const Coeffs c = coeffs_from_host(coeffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool iso = isotropic != 0;
  if (bf16_storage)
    return sweep_bf16(static_cast<const bf16*>(uin), static_cast<bf16*>(uout), w, nx, ny,
                      nz, halo, radius, k, iso, xc, ty, tz, ythreads, c, s);
  const float* fin = static_cast<const float*>(uin);
  float* fout = static_cast<float*>(uout);
  return w ? launch_mode<float, true, 3>(fin, fout, w, nx, ny, nz, halo, radius, k, iso, xc,
                                         ty, tz, ythreads, c, s)
           : launch_mode<float, false, 4>(fin, fout, w, nx, ny, nz, halo, radius, k, iso, xc,
                                          ty, tz, ythreads, c, s);
}
