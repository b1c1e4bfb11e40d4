// Kernel B (stencil_sweep.cuh): the C entries. Its modes are built in
// stencil_sweep_<storage>_<medium>_r<radii>.cu: f32 with a scalar m at
// radius 1-4, f32 with the w stream and bf16 with either at radius 1-3.

#include <algorithm>

#include "stencil_sweep.cuh"

namespace {

// u_n (level 1 of uin) into both levels of uout over the box [x0, x0+ex) x
// [y0, y0+ey) x [z0, z0+ez) of padded coordinates: the frozen margins.
template <typename T>
__global__ void frozen_copy(const T* __restrict__ uin, T* __restrict__ uout, int64_t sx,
                            int64_t sl, int nzp, int x0, int y0, int z0, int ex, int ey,
                            int ez) {
  const int64_t n = (int64_t)ex * ey * ez;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int z = (int)(i % ez);
    const int64_t r = i / ez;
    const int y = (int)(r % ey), x = (int)(r / ey);
    const int64_t gi = (int64_t)(x0 + x) * sx + (int64_t)(y0 + y) * nzp + z0 + z;
    const T v = uin[sl + gi];
    uout[gi] = v;
    uout[sl + gi] = v;
  }
}

template <typename T>
int copy_margins(const T* uin, T* uout, int nx, int ny, int nz, int h, int flo, int fhi,
                 int fylo, int fyhi, int64_t sx, int64_t sl, cudaStream_t s) {
  // x margins over all interior rows, y margins over the planes between
  const int boxes[4][4] = {{h, flo, h, ny},
                           {h + nx - fhi, fhi, h, ny},
                           {h + flo, nx - flo - fhi, h, fylo},
                           {h + flo, nx - flo - fhi, h + ny - fyhi, fyhi}};
  for (const auto& b : boxes) {
    const int64_t n = (int64_t)b[1] * b[3] * nz;
    if (n <= 0) continue;
    const int blocks = (int)std::min<int64_t>((n + 255) / 256, 4096);
    frozen_copy<T><<<blocks, 256, 0, s>>>(uin, uout, sx, sl, nz + 2 * h, b[0], b[2], h, b[1],
                                           b[3], nz);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// uin and uout are f32, or bf16 when bf16_storage is nonzero; w is the
// per-point w stream (f32), or null for a scalar m (coeffs[13] and the
// isotropic scale coeffs[15]). A block of sweep::THREADS threads sweeps a
// ty x tz column over xc x-planes. frozen_lo/hi and frozen_ylo/yhi freeze
// that many interior planes at each x end and rows at each y end (0: none):
// the kernel runs on the view without them, and they get u_n in both
// output levels. nxpa is the padded x extent of the arrays uin and uout
// are cut from (nx + 2 * halo for whole arrays): their level stride is
// nxpa planes, so both may be x-slabs of larger two-level arrays (the
// sharded sweep's overlap). Returns cudaGetLastError() after the
// launches; 1000 + radius for a radius this mode is not built for, 2000 +
// k for a depth.
extern "C" int tpufdtd_sweep(const void* uin, void* uout, const float* w, int nx,
                             int ny, int nz, int halo, int radius, int k,
                             int isotropic, int bf16_storage, int xc, int ty,
                             int tz, int frozen_lo, int frozen_hi, int frozen_ylo,
                             int frozen_yhi, int nxpa, const float* coeffs, void* stream) {
  const Coeffs c = coeffs_from_host(coeffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool iso = isotropic != 0;
  const int nzp = nz + 2 * halo;
  const int64_t sx = (int64_t)(ny + 2 * halo) * nzp, sl = (int64_t)nxpa * sx;
  const int64_t off = frozen_lo * sx + (int64_t)frozen_ylo * nzp;
  const int vnx = nx - frozen_lo - frozen_hi, vny = ny - frozen_ylo - frozen_yhi;
  if (frozen_lo || frozen_hi || frozen_ylo || frozen_yhi) {
    const int e = bf16_storage
        ? copy_margins(static_cast<const bf16*>(uin), static_cast<bf16*>(uout), nx, ny, nz,
                       halo, frozen_lo, frozen_hi, frozen_ylo, frozen_yhi, sx, sl, s)
        : copy_margins(static_cast<const float*>(uin), static_cast<float*>(uout), nx, ny, nz,
                       halo, frozen_lo, frozen_hi, frozen_ylo, frozen_yhi, sx, sl, s);
    if (e != 0 || vnx <= 0 || vny <= 0) return e;
  }
  const sweep::Geom g{vnx, vny, nz, halo, ty, tz, xc, 0, 0, nxpa, ny + 2 * halo};
  const float* wv = w ? w + off : nullptr;
  if (bf16_storage) {
    const bf16* bin = static_cast<const bf16*>(uin) + off;
    bf16* bout = static_cast<bf16*>(uout) + off;
    if (w)
      return (radius <= 2 ? sweep_bf16_w_r12 : sweep_bf16_w_r34)(bin, bout, wv, g, radius, k,
                                                                 iso, c, s);
    return (radius <= 2 ? sweep_bf16_m_r12 : sweep_bf16_m_r34)(bin, bout, wv, g, radius, k,
                                                               iso, c, s);
  }
  const float* fin = static_cast<const float*>(uin) + off;
  float* fout = static_cast<float*>(uout) + off;
  if (w)
    return (radius <= 2 ? sweep_f32_w_r12 : sweep_f32_w_r34)(fin, fout, wv, g, radius, k, iso,
                                                             c, s);
  return (radius <= 2 ? sweep_f32_m_r12 : sweep_f32_m_r34)(fin, fout, wv, g, radius, k, iso, c,
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
