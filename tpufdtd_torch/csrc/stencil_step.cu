// Kernel A: one leapfrog step from (cur, prev) into a separate target.
//
// Replaces tpufdtd/ops/stencil_pallas_z.py:leapfrog_step_zsplit (the exact
// three-level ring behind simulate()). It writes the target's interior
// only: each ring level keeps its own frozen rim, and source deposits one
// cell beyond the interior persist there.
//
// Bound: device memory. Per interior point it reads cur and prev and writes
// the target, 12 B, plus 4 B for a per-point m (16 B). The 2R neighbours
// along x and y come from the L1/L2 caches, since neighbouring threads
// and blocks read the same lines. Design: one thread per interior point, z
// on threadIdx.x so that a warp reads 128 contiguous bytes; no shared
// memory. Offsets are 64-bit: a [1032]^3 level passes 2^31 elements.
//
// Arithmetic follows the oracle term for term (openacc.cpp:102-107);
// nvcc contracts a*b+c into FMAs, so results differ from the plain
// version by a few ulp.

#include "fdtd_common.cuh"

namespace {

template <int R>
__global__ void leapfrog_step_kernel(const float* __restrict__ cur,
                                     const float* __restrict__ prev,
                                     const float* __restrict__ m,
                                     float* __restrict__ target, int ny, int nz,
                                     int halo, Coeffs c) {
  const int z = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int x = blockIdx.z;  // the grid spans exactly nx along z
  if (z >= nz || y >= ny) return;
  const int64_t ys = nz + 2 * halo;  // y stride; z is contiguous
  const int64_t xs = (int64_t)(ny + 2 * halo) * ys;  // x stride
  const int64_t i = (int64_t)(x + halo) * xs + (int64_t)(y + halo) * ys + (z + halo);

  const float u = cur[i];
  const float r5 = c.w[0] * u;
  float tx = r5, ty = r5, tz = r5;
#pragma unroll
  for (int d = R; d >= 1; --d) {
    tx = tx + c.w[d] * (cur[i - d * xs] + cur[i + d * xs]);
    ty = ty + c.w[d] * (cur[i - d * ys] + cur[i + d * ys]);
    tz = tz + c.w[d] * (cur[i - d] + cur[i + d]);
  }
  const float mm = m ? m[i] : c.m;
  target[i] = c.dt2 * (c.r2 * tx + c.r3 * ty + c.r4 * tz -
                       (c.neg2r1 * u + c.r1 * prev[i]) * mm) /
              mm;
}

template <int R>
void launch(const float* cur, const float* prev, const float* m, float* target,
            int nx, int ny, int nz, int halo, const Coeffs& c,
            cudaStream_t stream) {
  const dim3 block(32, 8, 1);
  const dim3 grid((nz + 31) / 32, (ny + 7) / 8, nx);
  leapfrog_step_kernel<R><<<grid, block, 0, stream>>>(cur, prev, m, target, ny,
                                                      nz, halo, c);
}

}  // namespace

// m may be null: then coeffs[13] is the scalar medium value.
// Returns cudaGetLastError() after the launch; 1000 + radius for a radius
// this library was not built for.
extern "C" int tpufdtd_leapfrog_step(const float* cur, const float* prev,
                                     const float* m, float* target, int nx,
                                     int ny, int nz, int halo, int radius,
                                     const float* coeffs, void* stream) {
  const Coeffs c = coeffs_from_host(coeffs);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: launch<1>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 2: launch<2>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 3: launch<3>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 4: launch<4>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 5: launch<5>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    case 6: launch<6>(cur, prev, m, target, nx, ny, nz, halo, c, s); break;
    default: return 1000 + radius;
  }
  return static_cast<int>(cudaGetLastError());
}
