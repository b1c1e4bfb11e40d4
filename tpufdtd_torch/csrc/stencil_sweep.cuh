// Kernel B: K fused leapfrog steps per pass over device memory.
//
// Replaces the kernels of the fast two-level ring behind Simulator:
// tpufdtd/ops/stencil_sweep.py:sweep_fused (radius 1-3, any K; its w and
// bf16 modes included), tpufdtd/ops/stencil_pallas_z.py:packed_step (one
// step, radius <= 4; here K = 1) and packed_fused2 (two steps; here radius
// 4, K = 2). Input U_in = [u_{n-1}, u_n], output U_out = [u_{n+K-1},
// u_{n+K}], both [2, nx+2H, ny+2H, nz+2H] in the reference layout, radius R
// = 1..4 (orders 2-8, a template parameter). Rims stay frozen: the kernel
// writes interior points only, and every stage keeps cells outside the
// global interior at their frozen (loaded) values.
//
// Modes (template parameters; both take R = 1..3, as the TPU sweep does):
//   * medium: a scalar m, or a per-point w stream for a heterogeneous m
//     (WM). w = dt^2/(h^2 m) for isotropic h, else dt^2/m, precomputed in
//     f64 on the host. Each stage reads w at its own plane straight from
//     device memory (__ldg, a batch of cells' loads in flight together):
//     the K stages of a block touch each w plane K times, (K-1)R planes
//     apart, and those planes sit in the 50 MB L2. A shared-memory w ring
//     would cost (K-1)R+1 planes of the column and lower the deepest K.
//   * storage T: f32, or bf16 with f32 compute. Each arriving plane is
//     widened once into the f32 rings, every stage computes in f32 and
//     hands f32 planes to the next with no intermediate rounding, and only
//     the two output levels are rounded to bf16, once per K-block.
//
// Bound: device memory. One step alone moves 12 B per point in f32 (read
// cur and prev, write next), 6 B in bf16; K fused steps move 16 (8) B per
// point per K steps, plus 4 B of w per point per call in w mode, plus the
// re-read halo of each block. Design: a 2.5-D sweep with temporal
// blocking, the form of the reference's cuda_optimized.cu plane sweep.
// Each block owns a TY x TZ column of (y, z) and a chunk of XC x-planes;
// its threads walk each plane region's cells flattened.
// It walks x, loading one plane of both input levels per iteration (in f32
// with cp.async, so the next plane is in flight while the current one is
// used; in bf16 with plain loads), and runs the K stages as a pipeline
// along x: stage s updates plane p - s*R of level u_{n+s}, over a (y, z)
// region R*(K-s) cells wider than the column. Each level lives in a
// shared-memory ring of f32 planes; stage K writes straight to device
// memory. The halo costs
// (TY+2KR)(TZ+2KR)/(TY*TZ) in loads and 2KR/XC planes in x. The rings take
// 4 (PREV + CUR + RING (K-1)) (TY+2KR) (TZ+2KR) bytes of shared memory in
// every mode, at most 227 KB, so a larger R or K takes a narrower column
// (tpufdtd_torch/ops/stencil_sweep.py:TILES).
//
// Not in place, unlike the TPU kernel: there one program swept x in order,
// so it could overwrite planes it had finished reading. Hopper blocks run in
// parallel in no order, and one block's halo is another's output, so the
// result goes to a second buffer and the stepper ping-pongs between the
// two (two more levels of device memory).
//
// Arithmetic: leap_isotropic of the TPU sweep kernel when hx == hy == hz
// (one accumulator, times scale = dt*dt*r2/m rounded on the host, or times
// w), else the oracle's exact form, which is also what packed_step and
// packed_fused2 compute, or in w mode the TPU sweep's leap_exact w form
// w (r2 tx + r3 ty + r4 tz) + (2c - prev). The forms differ by association
// order only; nvcc contracts FMAs, so results differ from the plain version
// by a few ulp per step.
#pragma once

#include <cuda_pipeline_primitives.h>

#include <type_traits>

#include "fdtd_common.cuh"

// Kernel B on bf16 levels (stencil_sweep_bf16.cu, its own translation unit
// so that nvcc builds it beside the f32 modes); arguments as tpufdtd_sweep.
int sweep_bf16(const bf16* uin, bf16* uout, const float* w, int nx, int ny,
               int nz, int halo, int radius, int k, bool iso, int xc, int ty,
               int tz, int ythreads, const Coeffs& c, cudaStream_t s);

namespace {

// Shared-memory plane rings of one level, in planes, at radius R.
template <int R>
struct Rings {
  static constexpr int RING = 2 * R + 1;      // each of u_{n+1} .. u_{n+K-1}
  static constexpr int PREV = R + 2;          // u_{n-1}: planes p-R .. p+1
  static constexpr int CUR = 2 * R + 2;       // u_n: planes p-2R .. p+1
};
constexpr int BATCH = 4;      // z points per thread per pass of a stage
constexpr int LOADS = 4;      // bf16 elements per thread in flight per level

// Update at offset o of the centre plane; x[d] points to plane x-R+d,
// sy is the y stride of a plane (z is contiguous); wv is the cell's w in
// w mode (WM), unused otherwise.
template <int R, bool ISO, bool WM>
__device__ __forceinline__ float leap(const float* const* x, int o, int sy,
                                      float up, const Coeffs& c, float wv) {
  const float* u = x[R];
  const float uc = u[o];
  if constexpr (ISO) {
    float acc = c.w0x3 * uc;
#pragma unroll
    for (int d = R; d >= 1; --d) {
      float nb = x[R - d][o] + x[R + d][o];
      nb = nb + u[o - d * sy];
      nb = nb + u[o + d * sy];
      nb = nb + u[o + d];
      nb = nb + u[o - d];
      acc = acc + c.w[d] * nb;
    }
    if constexpr (WM) {
      return wv * acc + (2.0f * uc - up);
    } else {
      return c.scale * acc + (2.0f * uc - up);
    }
  } else {
    const float r5 = c.w[0] * uc;
    float tx = r5, ty = r5, tz = r5;
#pragma unroll
    for (int d = R; d >= 1; --d) {
      tx = tx + c.w[d] * (x[R - d][o] + x[R + d][o]);
      ty = ty + c.w[d] * (u[o - d * sy] + u[o + d * sy]);
      tz = tz + c.w[d] * (u[o - d] + u[o + d]);
    }
    if constexpr (WM) {
      return wv * (c.r2 * tx + c.r3 * ty + c.r4 * tz) + (2.0f * uc - up);
    } else {
      return c.dt2 * (c.r2 * tx + c.r3 * ty + c.r4 * tz -
                      (c.neg2r1 * uc + c.r1 * up) * c.m) /
             c.m;
    }
  }
}

struct Geometry {
  int nx, ny, nz, halo;
  int nxp, nyp, nzp;
  int64_t gsx, level;  // x stride and level stride of the padded arrays
  int K, G;            // depth and halo G = K*R
  int PY, PZ, PS;      // plane region (TY+2G) x (TZ+2G) and its size
  int y0, z0;          // region origin, padded coordinates
  int ya, yb, za, zb;  // region clipped to the array, local coordinates
};

// Walks the cells start, start+step, ... of a region w cells wide, row by
// row, keeping (row, col) up to date without a division per cell. Threads
// of a block walk the region's cells flattened, so a row width that is not
// a multiple of 32 leaves no lanes idle.
struct Walk {
  int row, col, drow, dcol, w;
  __device__ __forceinline__ Walk(int start, int step, int w_) : w(w_) {
    row = start / w;
    col = start - row * w;
    drow = step / w;
    dcol = step - drow * w;
  }
  __device__ __forceinline__ void next() {
    row += drow;
    col += dcol;
    if (col >= w) {
      col -= w;
      ++row;
    }
  }
};

// The ring slot holding plane x of level j (-1 = u_{n-1}, 0 = u_n, ...).
template <int R>
__device__ __forceinline__ float* plane(float* smem, const Geometry& g, int j,
                                        int x) {
  using Q = Rings<R>;
  if (j < 0) return smem + (x % Q::PREV) * g.PS;
  if (j == 0) return smem + (Q::PREV + x % Q::CUR) * g.PS;
  return smem + (Q::PREV + Q::CUR + (j - 1) * Q::RING + x % Q::RING) * g.PS;
}

// Start the copies of input plane p of both levels into their rings, as
// one commit group (empty when !live, which keeps the group count uniform).
// bf16: cp.async copies 4, 8 or 16 bytes and cannot move one 2-byte
// element alone, and a padded row of nz + 2H bf16 elements is 16-byte
// aligned only when (nz + 2H) % 8 == 0; so each element is loaded plainly,
// LOADS at a time per level, widened in registers and stored to the f32
// rings, which is right at every alignment. Its commit group is empty.
template <int R, typename T>
__device__ __forceinline__ void load_plane(float* smem, const Geometry& g,
                                           const T* __restrict__ uin,
                                           int p, bool live) {
  float* dp = plane<R>(smem, g, -1, p);
  float* dc = plane<R>(smem, g, 0, p);
  const int64_t base = (int64_t)p * g.gsx + (int64_t)g.y0 * g.nzp + g.z0;
  const int w = g.zb - g.za, n = w * (g.yb - g.ya);
  const int nt = blockDim.x * blockDim.y;
  const int tid = threadIdx.x + blockDim.x * threadIdx.y;
  if (!live || w <= 0 || n <= 0) {
    __pipeline_commit();
    return;
  }
  Walk c(tid, nt, w);
  if constexpr (std::is_same_v<T, float>) {
    for (int i = tid; i < n; i += nt, c.next()) {
      const int ly = g.ya + c.row, lz = g.za + c.col;
      const int64_t gi = base + (int64_t)ly * g.nzp + lz;
      __pipeline_memcpy_async(dp + ly * g.PZ + lz, uin + gi, sizeof(float));
      __pipeline_memcpy_async(dc + ly * g.PZ + lz, uin + g.level + gi, sizeof(float));
    }
  } else {
    for (int i = tid; i < n; i += LOADS * nt) {
      float vp[LOADS], vc[LOADS];
      int o[LOADS];
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        o[j] = -1;
        if (i + j * nt < n) {
          const int ly = g.ya + c.row, lz = g.za + c.col;
          const int64_t gi = base + (int64_t)ly * g.nzp + lz;
          vp[j] = to_f32(uin[gi]);
          vc[j] = to_f32(uin[g.level + gi]);
          o[j] = ly * g.PZ + lz;
        }
        c.next();
      }
#pragma unroll
      for (int j = 0; j < LOADS; ++j) {
        if (o[j] >= 0) {
          dp[o[j]] = vp[j];
          dc[o[j]] = vc[j];
        }
      }
    }
  }
  __pipeline_commit();
}

template <int R, bool ISO, typename T, bool WM>
__global__ void sweep_kernel(const T* __restrict__ uin, T* __restrict__ uout,
                             const float* __restrict__ wgt, int nx, int ny,
                             int nz, int halo, int K, int TY, int TZ, int XC,
                             Coeffs c) {
  extern __shared__ float smem[];
  Geometry g;
  g.nx = nx; g.ny = ny; g.nz = nz; g.halo = halo;
  g.nxp = nx + 2 * halo; g.nyp = ny + 2 * halo; g.nzp = nz + 2 * halo;
  g.gsx = (int64_t)g.nyp * g.nzp;
  g.level = (int64_t)g.nxp * g.gsx;
  g.K = K; g.G = K * R;
  g.PY = TY + 2 * g.G; g.PZ = TZ + 2 * g.G; g.PS = g.PY * g.PZ;
  g.y0 = halo + (int)blockIdx.y * TY - g.G;
  g.z0 = halo + (int)blockIdx.x * TZ - g.G;
  g.ya = max(0, -g.y0); g.yb = min(g.PY, g.nyp - g.y0);
  g.za = max(0, -g.z0); g.zb = min(g.PZ, g.nzp - g.z0);

  // output planes [xs, xe); input planes [p0, p1)
  const int xs = halo + (int)blockIdx.z * XC;
  const int xe = min(xs + XC, halo + nx);
  const int p0 = max(0, xs - g.G), p1 = min(g.nxp, xe + g.G);
  // the global interior in local (y, z) coordinates
  const int iy0 = halo - g.y0, iy1 = halo + ny - g.y0;
  const int iz0 = halo - g.z0, iz1 = halo + nz - g.z0;

  load_plane<R, T>(smem, g, uin, p0, true);
  for (int p = p0; p < xe + g.G; ++p) {
    __pipeline_wait_prior(0);
    __syncthreads();  // plane p has landed; iteration p-1 is done with its slots
    load_plane<R, T>(smem, g, uin, p + 1, p + 1 < p1);
    for (int s = 1; s <= K; ++s) {
      const int x = p - s * R;
      const int e = R * (K - s);
      if (x >= max(0, xs - e) && x < min(g.nxp, xe + e)) {
        const bool x_in = x >= halo && x < halo + nx;
        const float* in[2 * R + 1];
#pragma unroll
        for (int d = 0; d <= 2 * R; ++d)
          in[d] = plane<R>(smem, g, s - 1, x_in ? x - R + d : x);
        const float* prev = plane<R>(smem, g, s - 2, x);
        const float* done = s == K ? plane<R>(smem, g, K - 1, x) : nullptr;
        float* outp = s < K ? plane<R>(smem, g, s, x) : nullptr;
        const int ya = max(g.G - e, g.ya), yb = min(g.G + TY + e, g.yb);
        const int za = max(g.G - e, g.za), zb = min(g.G + TZ + e, g.zb);
        // BATCH cells per thread per pass, all computed before any is
        // stored: the stores alias the shared-memory reads, so batching is
        // what lets their loads overlap
        const int w = zb - za, n = w > 0 && yb > ya ? w * (yb - ya) : 0;
        const int nt = blockDim.x * blockDim.y;
        const int tid = threadIdx.x + blockDim.x * threadIdx.y;
        Walk cell(tid, nt, max(w, 1));
        for (int i = tid; i < n; i += BATCH * nt) {
          float v[BATCH];
          int ly[BATCH], lz[BATCH];
          bool inside[BATCH];
          if constexpr (WM) {
            // the batch's w loads are all in flight before its first leap
            float wv[BATCH];
#pragma unroll
            for (int j = 0; j < BATCH; ++j) {
              ly[j] = ya + cell.row;
              lz[j] = za + cell.col;
              cell.next();
              inside[j] = x_in && ly[j] >= iy0 && ly[j] < iy1 && lz[j] >= iz0 && lz[j] < iz1;
              const int64_t gi =
                  (int64_t)x * g.gsx + (int64_t)(g.y0 + ly[j]) * g.nzp + g.z0 + lz[j];
              wv[j] = i + j * nt < n && inside[j] ? __ldg(wgt + gi) : 0.0f;
            }
#pragma unroll
            for (int j = 0; j < BATCH; ++j) {
              const int o = ly[j] * g.PZ + lz[j];
              v[j] = 0.0f;
              if (i + j * nt < n)
                v[j] = inside[j] ? leap<R, ISO, true>(in, o, g.PZ, prev[o], c, wv[j]) : in[R][o];
            }
          } else {
#pragma unroll
            for (int j = 0; j < BATCH; ++j) {
              ly[j] = ya + cell.row;
              lz[j] = za + cell.col;
              cell.next();
              const int o = ly[j] * g.PZ + lz[j];
              inside[j] = x_in && ly[j] >= iy0 && ly[j] < iy1 && lz[j] >= iz0 && lz[j] < iz1;
              v[j] = 0.0f;
              if (i + j * nt < n)
                v[j] = inside[j] ? leap<R, ISO, false>(in, o, g.PZ, prev[o], c, 0.0f) : in[R][o];
            }
          }
#pragma unroll
          for (int j = 0; j < BATCH; ++j) {
            if (i + j * nt >= n) break;
            const int o = ly[j] * g.PZ + lz[j];
            if (s < K) {
              outp[o] = v[j];
            } else if (inside[j]) {
              const int64_t gi =
                  (int64_t)x * g.gsx + (int64_t)(g.y0 + ly[j]) * g.nzp + g.z0 + lz[j];
              uout[gi] = from_f32<T>(done[o]);
              uout[g.level + gi] = from_f32<T>(v[j]);
            }
          }
        }
      }
      if (s < K) __syncthreads();
    }
  }
}

template <int R, bool ISO, typename T, bool WM>
int launch(const T* uin, T* uout, const float* w, int nx, int ny, int nz,
           int halo, int k, int xc, int ty, int tz, int ythreads,
           const Coeffs& c, cudaStream_t stream) {
  using Q = Rings<R>;
  const int g2 = 2 * k * R;
  const int planes = Q::PREV + Q::CUR + Q::RING * (k - 1);
  const size_t smem = sizeof(float) * (size_t)planes * (ty + g2) * (tz + g2);
  cudaError_t e = cudaFuncSetAttribute(
      sweep_kernel<R, ISO, T, WM>, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 block(32, ythreads, 1);
  const dim3 grid((nz + tz - 1) / tz, (ny + ty - 1) / ty, (nx + xc - 1) / xc);
  sweep_kernel<R, ISO, T, WM><<<grid, block, smem, stream>>>(
      uin, uout, w, nx, ny, nz, halo, k, ty, tz, xc, c);
  return static_cast<int>(cudaGetLastError());
}

template <int R, typename T, bool WM>
int launch_r(const T* uin, T* uout, const float* w, int nx, int ny, int nz,
             int halo, int k, bool iso, int xc, int ty, int tz, int ythreads,
             const Coeffs& c, cudaStream_t s) {
  return iso ? launch<R, true, T, WM>(uin, uout, w, nx, ny, nz, halo, k, xc, ty, tz,
                                      ythreads, c, s)
             : launch<R, false, T, WM>(uin, uout, w, nx, ny, nz, halo, k, xc, ty, tz,
                                       ythreads, c, s);
}

// Kernel B in one mode (storage T, medium WM) at radius 1..MAXR; 1000 +
// radius for a radius this mode is not built for.
template <typename T, bool WM, int MAXR>
int launch_mode(const T* uin, T* uout, const float* w, int nx, int ny, int nz,
                int halo, int radius, int k, bool iso, int xc, int ty, int tz,
                int ythreads, const Coeffs& c, cudaStream_t s) {
  switch (radius) {
    case 1: return launch_r<1, T, WM>(uin, uout, w, nx, ny, nz, halo, k, iso, xc, ty, tz, ythreads, c, s);
    case 2: return launch_r<2, T, WM>(uin, uout, w, nx, ny, nz, halo, k, iso, xc, ty, tz, ythreads, c, s);
    case 3: return launch_r<3, T, WM>(uin, uout, w, nx, ny, nz, halo, k, iso, xc, ty, tz, ythreads, c, s);
    default: break;
  }
  if constexpr (MAXR >= 4) {
    if (radius == 4)
      return launch_r<4, T, WM>(uin, uout, w, nx, ny, nz, halo, k, iso, xc, ty, tz, ythreads, c, s);
  }
  return 1000 + radius;
}

}  // namespace
