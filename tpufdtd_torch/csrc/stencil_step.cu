// Kernel A: one leapfrog step from (cur, prev) into a separate target.
//
// Replaces tpufdtd/ops/stencil_pallas_z.py:leapfrog_step_zsplit (the exact
// three-level ring behind simulate()) and stencil_pallas.py:
// leapfrog_step_pallas (orders 10-12). It writes the target's interior
// only: each ring level keeps its own frozen rim, and source deposits one
// cell beyond the interior persist there.
//
// Bound: device memory. Per interior point it reads cur and prev and writes
// the target, 12 B in f32 and 6 B in bf16, plus 4 B for a per-point m. The
// 2R neighbours along x and y come from the L1/L2 caches, since
// neighbouring threads and blocks read the same lines. Design: one thread
// per interior point, z on threadIdx.x so that a warp reads contiguous
// bytes; no shared memory. Offsets are 64-bit: a [1032]^3 level passes 2^31
// elements.
//
// Storage: cur, prev and target share one type T, f32 or bf16 (the TPU
// kernels store in the dtype of their inputs). A bf16 value is widened to
// f32 as it is loaded, all arithmetic is f32, and the result is rounded
// once on the store. m stays f32.
//
// Arithmetic follows the oracle term for term (openacc.cpp:102-107);
// nvcc contracts a*b+c into FMAs, so results differ from the plain
// version by a few ulp.

#include "fdtd_common.cuh"

namespace {

template <int R, typename T>
__global__ void leapfrog_step_kernel(const T* __restrict__ cur,
                                     const T* __restrict__ prev,
                                     const float* __restrict__ m,
                                     T* __restrict__ target, int ny, int nz,
                                     int halo, Coeffs c) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;  // the grid spans exactly nx along z
  if (z >= nz || y >= ny) return;
  const int64_t ys = nz + 2 * halo;  // y stride; z is contiguous
  const int64_t xs = (int64_t)(ny + 2 * halo) * ys;  // x stride
  const int64_t i = (int64_t)(x + halo) * xs + (int64_t)(y + halo) * ys + (z + halo);

  const float u = to_f32(cur[i]);
  const float r5 = c.w[0] * u;
  float tx = r5, ty = r5, tz = r5;
#pragma unroll
  for (int d = R; d >= 1; --d) {
    tx = tx + c.w[d] * (to_f32(cur[i - d * xs]) + to_f32(cur[i + d * xs]));
    ty = ty + c.w[d] * (to_f32(cur[i - d * ys]) + to_f32(cur[i + d * ys]));
    tz = tz + c.w[d] * (to_f32(cur[i - d]) + to_f32(cur[i + d]));
  }
  const float mm = m ? m[i] : c.m;
  target[i] = from_f32<T>(c.dt2 * (c.r2 * tx + c.r3 * ty + c.r4 * tz -
                                   (c.neg2r1 * u + c.r1 * to_f32(prev[i])) * mm) /
                          mm);
}

template <int R, typename T>
void launch(const void* cur, const void* prev, const float* m, void* target,
            int nx, int ny, int nz, int halo, const Coeffs& c,
            cudaStream_t stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid((nz + 31) / 32, (ny + 7) / 8, nx);
  leapfrog_step_kernel<R, T><<<grid, block, 0, stream>>>(
      static_cast<const T*>(cur), static_cast<const T*>(prev), m,
      static_cast<T*>(target), ny, nz, halo, c);
}

template <typename T>
int launch_r(const void* cur, const void* prev, const float* m, void* target,
             int nx, int ny, int nz, int halo, int radius, const Coeffs& c,
             cudaStream_t s) {
  switch (radius) {
    case 1: launch<1, T>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 2: launch<2, T>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 3: launch<3, T>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 4: launch<4, T>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 5: launch<5, T>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 6: launch<6, T>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    default: return 1000 + radius;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// cur, prev and target are f32, or bf16 when bf16_storage is nonzero. m may
// be null: then coeffs[13] is the scalar medium value.
// Returns cudaGetLastError() after the launch; 1000 + radius for a radius
// this library was not built for.
extern "C" int tpufdtd_leapfrog_step(const void* cur, const void* prev,
                                     const float* m, void* target, int nx,
                                     int ny, int nz, int halo, int radius,
                                     int bf16_storage, const float* coeffs,
                                     void* stream) {
  const Coeffs c = coeffs_from_host(coeffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return bf16_storage
             ? launch_r<bf16>(cur, prev, m, target, nx, ny, nz, halo, radius, c, s)
             : launch_r<float>(cur, prev, m, target, nx, ny, nz, halo, radius, c, s);
}
