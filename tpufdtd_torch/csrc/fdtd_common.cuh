// Shared definitions of the hand-written Hopper kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

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
