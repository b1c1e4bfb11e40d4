// Kernel B (stencil_sweep.cuh): the C entries. Its modes are built in
// stencil_sweep_<storage>_<medium>_r<radii>.cu: f32 with a scalar m at
// radius 1-4, f32 with the w stream and bf16 with either at radius 1-3.

#include "stencil_sweep.cuh"

// uin and uout are f32, or bf16 when bf16_storage is nonzero; w is the
// per-point w stream (f32), or null for a scalar m (coeffs[13] and the
// isotropic scale coeffs[15]). A block of sweep::THREADS threads sweeps a
// ty x tz column over xc x-planes. Returns cudaGetLastError() after the
// launch; 1000 + radius for a radius this mode is not built for, 2000 + k
// for a depth.
extern "C" int tpufdtd_sweep(const void* uin, void* uout, const float* w, int nx,
                             int ny, int nz, int halo, int radius, int k,
                             int isotropic, int bf16_storage, int xc, int ty,
                             int tz, const float* coeffs, void* stream) {
  const Coeffs c = coeffs_from_host(coeffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool iso = isotropic != 0;
  const sweep::Geom g{nx, ny, nz, halo, ty, tz, xc, 0, 0};
  if (bf16_storage) {
    const bf16* bin = static_cast<const bf16*>(uin);
    bf16* bout = static_cast<bf16*>(uout);
    if (w)
      return (radius <= 2 ? sweep_bf16_w_r12 : sweep_bf16_w_r34)(bin, bout, w, g, radius, k,
                                                                 iso, c, s);
    return (radius <= 2 ? sweep_bf16_m_r12 : sweep_bf16_m_r34)(bin, bout, w, g, radius, k,
                                                               iso, c, s);
  }
  const float* fin = static_cast<const float*>(uin);
  float* fout = static_cast<float*>(uout);
  if (w)
    return (radius <= 2 ? sweep_f32_w_r12 : sweep_f32_w_r34)(fin, fout, w, g, radius, k, iso,
                                                             c, s);
  return (radius <= 2 ? sweep_f32_m_r12 : sweep_f32_m_r34)(fin, fout, w, g, radius, k, iso, c,
                                                           s);
}

// The dynamic shared memory tpufdtd_sweep requests for a block, in bytes
// (ops/stencil_sweep.py:smem_bytes must agree).
extern "C" long long tpufdtd_sweep_smem(int radius, int k, int ty, int tz, int bf16_storage,
                                        int w_stream) {
  return (long long)sweep::smem(radius, k, ty, tz, bf16_storage ? 2 : 4, w_stream != 0);
}

// The register policy at (radius, k): cells per thread and blocks per SM
// (ops/stencil_sweep.py:cells_per_thread and min_blocks must agree).
extern "C" void tpufdtd_sweep_policy(int radius, int k, int* out) {
  out[0] = sweep::cells(radius, k);
  out[1] = sweep::min_blocks(radius, k);
}
