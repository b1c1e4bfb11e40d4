// Shared definitions of the hand-written Hopper kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_pipeline_primitives.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Storage types of the levels: f32, or bf16 with f32 compute. A bf16 value
// is widened once where it is loaded and rounded once where it is stored,
// to nearest even (what Tensor.to(torch.bfloat16) does).
using bf16 = __nv_bfloat16;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_f32<bf16>(float v) { return __float2bfloat16_rn(v); }

// Every f32 scalar a step needs, rounded on the host exactly as the oracle
// rounds it (tpufdtd_torch/ops/stencil_torch.py:coefficients). Passed by
// value as a kernel parameter, so it lives in the constant bank.
struct Coeffs {
  float w[7];     // stencil weights, w[0] = center, w[d] = pair at distance d
  float dt2;      // dt*dt
  float r1;       // 1/dt^2
  float neg2r1;   // -2*r1
  float r2, r3, r4;  // 1/h^2 per axis
  float m;        // scalar medium value (when no per-point m is given)
  float w0x3;     // 3*w[0], isotropic form
  float scale;    // dt*dt*r2/m, isotropic form
};

// The host passes the 16 floats above as one array, in this order.
static inline Coeffs coeffs_from_host(const float* h) {
  Coeffs c;
  for (int i = 0; i < 7; ++i) c.w[i] = h[i];
  c.dt2 = h[7];
  c.r1 = h[8];
  c.neg2r1 = h[9];
  c.r2 = h[10];
  c.r3 = h[11];
  c.r4 = h[12];
  c.m = h[13];
  c.w0x3 = h[14];
  c.scale = h[15];
  return c;
}

// Staging of planes into shared memory, shared by kernels A and B.

// Copies of one staged plane: `rows` rows of `nch` chunks of VB bytes
// from src (row stride sstride elements) to dst (row stride dstride).
// VB = 2 (a bf16 row of odd pitch) copies plainly.
template <int VB, typename T>
__device__ __forceinline__ void copy_rows(T* dst, int dstride, const T* __restrict__ src,
                                          int sstride, int rows, int nch) {
  constexpr int VE = VB / (int)sizeof(T);
  const int n = rows * nch;
  // i / nch by a float reciprocal: exact while n < 2^12 nch, far beyond
  // any region
  const float inv = 1.0f / (float)nch;
  // blockDim.x (== THREADS): a run-time stride, here and for the cells, is
  // what ptxas fits without spills in every mode
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int r = (int)(((float)i + 0.5f) * inv), ch = i - r * nch;
    T* d = dst + r * dstride + ch * VE;
    const T* s = src + (int64_t)r * sstride + ch * VE;
    if constexpr (VB >= 4) {
      __pipeline_memcpy_async(d, s, VB);
    } else {
      *d = *s;
    }
  }
}

// bytes per staging copy for rows of nzp elements of T at p: the widest of
// 16, 8, 4 that divides the row pitch and the pointer's alignment; 2 (a
// plain copy) for a bf16 row of odd pitch
template <typename T>
int copy_bytes(const void* p, int nzp) {
  for (int vb = 16; vb >= 4; vb /= 2)
    if ((nzp * (int)sizeof(T)) % vb == 0 && reinterpret_cast<uintptr_t>(p) % vb == 0) return vb;
  return (int)sizeof(T) == 4 ? 4 : 2;
}
