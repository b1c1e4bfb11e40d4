// Kernel B: K fused leapfrog steps per pass over device memory.
//
// Replaces the kernels of the fast two-level ring behind Simulator:
// tpufdtd/ops/stencil_sweep.py:sweep_fused (radius 1-3, its w and bf16
// modes included), tpufdtd/ops/stencil_pallas_z.py:packed_step (one step,
// radius <= 4; here K = 1) and packed_fused2 (two steps; here radius 4,
// K = 2). Input U_in = [u_{n-1}, u_n], output U_out = [u_{n+K-1}, u_{n+K}],
// both [2, nx+2H, ny+2H, nz+2H] in the reference layout, radius R = 1..4
// (orders 2-8). Rims stay frozen: the kernel writes interior points only,
// and every stage keeps cells outside the global interior at their loaded
// values.
//
// Frozen margins (the TPU sweep's frozen_lo/hi/ylo/yhi, which the sharded
// sweep sets on its edge shards): interior planes and rows at the x and y
// ends that no stage updates. The C entry (stencil_sweep.cu) runs the
// kernel on a view of the arrays that starts and ends that many planes and
// rows further in, so the margins are the view's rim, carried through every
// stage at their loaded u_n; Geom's strides are the whole array's. A small
// copy kernel there writes u_n into both output levels at the margins.
//
// Modes (template parameters; the w stream and bf16 take R = 1..3, as the
// TPU sweep does):
//   * medium: a scalar m, or a per-point w stream for a heterogeneous m
//     (WM). w = dt^2/(h^2 m) for isotropic h, else dt^2/m, precomputed in
//     f64 on the host, staged like u_{n-1} (below) in a ring of STAGES + KR
//     f32 planes, from which each stage reads its own plane.
//   * storage T: f32, or bf16 with f32 compute. Planes are staged in T and
//     widened once, where a thread reads its cells into registers; stages
//     compute in f32 and only the two output levels are rounded to bf16,
//     once per K-block.
//
// Bound: device memory. K fused steps move 16 B per point in f32 (8 in
// bf16), plus 4 B of w per point in w mode, plus the re-read halo of each
// block (mostly from L2). Tensor cores have no role: a radius-R stencil is
// a few adds and multiplies per loaded value, no matrix product.
//
// Design: a 2.5-D sweep along x with temporal blocking, with x-neighbours
// in registers. A block owns a TY x TZ column of (y, z) and XC x-planes;
// with its K*R = G halo that is a PY x PZ = (TY+2G) x (TZ+2G) plane region.
// Each thread owns up to cells(R, K) cells of the region for the whole
// sweep, in onion order (the column first, then each band of R cells
// around it), so stage s updates a prefix of the cells and a warp idles
// only where that prefix ends; their offsets and masks are computed once,
// before the x loop. Per owned cell and level u_n .. u_{n+K-1} it keeps a
// ring of L = 2R+1 planes in registers. Iteration p brings input plane p;
// stage s then updates plane p - sR of level s over the region R*(K-s)
// cells wider than the column. Its x+R neighbour, level s-1 at plane
// p-(s-1)R, is what stage s-1 produced at the same cell in the same
// iteration, so x-neighbours never touch shared memory; its y/z neighbours
// come from a shared-memory centre plane of level s-1 at plane p-sR, which
// every thread knows R iterations early, so all K centre planes are
// written before the iteration's one barrier (double-buffered: one
// __syncthreads per plane). Shared loads per cell-stage: 4R, and 1 for
// u_{n-1} at stage 1 (the old kernel read 6R + 2). The x loop is unrolled
// by L, so each ring slot is a fixed register and nothing is shifted.
// Input planes arrive through cp.async of 16 bytes (8 or 4 when the row
// pitch or the pointer allows no more; a bf16 row of odd pitch is copied
// plainly), STAGES-1 planes ahead: u_n into a ring of STAGES planes, read
// into the registers; u_{n-1} (and w) over stage 1's region into a ring of
// STAGES + R (STAGES + KR) planes, read where stage 1 (each stage) needs
// them. Each row is copied as its aligned superset and the extra columns
// are never read. Shared memory (smem(); ops/stencil_sweep.py:smem_bytes)
// is 25-200 KB; the registers bound the column: at K <= 2 two blocks of
// THREADS = 256 share an SM (128 registers each, min_blocks), deeper K
// takes one block whose threads hold more cells in up to 255 registers.
//
// Not in place, unlike the TPU kernel: Hopper blocks run in parallel in no
// order, and one block's halo is another's output, so the result goes to a
// second buffer and the stepper ping-pongs between the two.
//
// Arithmetic: leap_isotropic of the TPU sweep kernel when hx == hy == hz
// (one accumulator, times scale = dt*dt*r2/m rounded on the host, or times
// w), else the oracle's exact form, which is also what packed_step and
// packed_fused2 compute, or in w mode the TPU sweep's leap_exact w form
// w (r2 tx + r3 ty + r4 tz) + (2c - prev). The forms differ by association
// order only; nvcc contracts FMAs, so results differ from the plain version
// by a few ulp per step.
#pragma once

#include "fdtd_common.cuh"

namespace sweep {

constexpr int STAGES = 4;         // staging ring of u_n planes (STAGES-1 in flight)
constexpr int THREADS = 256;      // threads per block
constexpr int REG_OVERHEAD = 64;  // registers per thread besides the cells'

// Blocks per SM the registers must allow at (R, K): two at K <= 2 where a
// cell's rings are short, so that two blocks share an SM (128 registers a
// thread); else one, whose threads may then take 255 registers and hold
// enough cells for a column that is not mostly halo.
__host__ __device__ constexpr int min_blocks(int R, int K) {
  return K <= 2 && K * (2 * R + 1) <= 14 ? 2 : 1;
}

// Cells per thread at (R, K): each takes K rings of 2R+1 registers, three
// offsets and K temporaries.
__host__ __device__ constexpr int cells(int R, int K) {
  return ((min_blocks(R, K) == 2 ? 128 : 240) - REG_OVERHEAD) / (K * (2 * R + 1) + 3 + K);
}

// The (R, K) built: R * K <= 8, so K <= 4 at R <= 2 and K <= 2 at R = 3-4
// (ops/stencil_sweep.py:TILES). Deeper, the rings leave a column that is
// mostly halo: R = 3 at K = 3-4 and R = 4 at K = 3 ran 3-11 times slower
// per step than K = 1 at 512^3. The deep form (stencil_sweep_deep.cuh)
// takes the TPU sweep's deeper depths.
__host__ __device__ constexpr bool built(int R, int K) {
  return R >= 1 && R <= 4 && K >= 1 && K <= 4 && R * K <= 8;
}

// Dynamic shared memory of one block; ops/stencil_sweep.py:smem_bytes
// states the same expression.
inline size_t smem(int R, int K, int ty, int tz, int esz, bool wm) {
  const int g2 = 2 * K * R, py = ty + g2, pz = tz + g2, v = 16 / esz;
  const int sp = (pz + v - 1) / v * v + v;
  const size_t w_ring = wm ? (size_t)(STAGES + K * R) * py * sp * sizeof(float) : 0;
  return (size_t)(2 * STAGES + R) * py * sp * esz + w_ring + (size_t)2 * K * py * pz * sizeof(float);
}

struct Geom {
  int nx, ny, nz, halo;  // interior extents, halo H
  int ty, tz, xc;        // the block's column and x-planes
  int vb;                // bytes per staging copy: 16, 8, 4, or 2 (plain)
  int vbw;               // the same for the w stream
  int nxpa, nypa;        // padded x and y extents of the whole array (its strides)
};

// Update of one cell: xn[d] = the level at plane x-R+d (xn[R] the centre),
// u = the centre plane in shared memory at the cell's offset o, y stride sy.
template <int R, bool ISO, bool WM>
__device__ __forceinline__ float leap(const float (&xn)[2 * R + 1], const float* u, int o,
                                      int sy, float up, const Coeffs& c, float wv) {
  const float uc = xn[R];
  if constexpr (ISO) {
    float acc = c.w0x3 * uc;
#pragma unroll
    for (int d = R; d >= 1; --d) {
      float nb = xn[R - d] + xn[R + d];
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
      tx = tx + c.w[d] * (xn[R - d] + xn[R + d]);
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

// (row, col) in a block's region of the cell at onion index idx: the
// column's TY x TZ cells first, row by row, then each band of R cells
// around it, inner band first, each band's rows in order. The cells stage
// s updates are then the first n_s = (TY+2e)(TZ+2e), e = R(K-s), so a warp
// is idle at a stage only where that prefix ends.
template <int R, int K>
__device__ __forceinline__ void onion(int idx, int ty, int tz, int& row, int& col) {
  int h = ty, w = tz, off = K * R;
  if (idx < h * w) {
    row = off + idx / w;
    col = off + idx % w;
    return;
  }
  idx -= h * w;
#pragma unroll
  for (int j = 1; j <= K; ++j) {
    off -= R;
    const int w2 = w + 2 * R, nb = (h + 2 * R) * w2 - h * w;
    if (idx < nb) {
      if (idx < R * w2) {  // the band's top rows
        row = off + idx / w2;
        col = off + idx % w2;
      } else if ((idx -= R * w2) < h * 2 * R) {  // R cells each side of a middle row
        const int rr = idx / (2 * R), cc = idx % (2 * R);
        row = off + R + rr;
        col = off + (cc < R ? cc : w + cc);
      } else {  // the band's bottom rows
        idx -= h * 2 * R;
        row = off + R + h + idx / w2;
        col = off + idx % w2;
      }
      return;
    }
    idx -= nb;
    h += 2 * R;
    w = w2;
  }
  row = col = 0;
}

template <int R, int K, bool ISO, typename T, bool WM>
__global__ void __launch_bounds__(THREADS, min_blocks(R, K))
kernel(const T* __restrict__ uin, T* __restrict__ uout, const float* __restrict__ wgt,
       Geom g, Coeffs c) {
  constexpr int L = 2 * R + 1, G = K * R, C = cells(R, K);
  constexpr int V = 16 / (int)sizeof(T), SM = STAGES + R, SW = STAGES + K * R;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = g.halo, NT = blockDim.x;
  const int nxp = g.nx + 2 * H, nyp = g.ny + 2 * H, nzp = g.nz + 2 * H;
  const int64_t gsx = (int64_t)g.nypa * nzp, lvl = (int64_t)g.nxpa * gsx;
  const int PY = g.ty + 2 * G, PZ = g.tz + 2 * G, PS = PY * PZ;
  const int SP = (PZ + V - 1) / V * V + V, SS = PY * SP;
  T* stage = reinterpret_cast<T*>(smem_raw);  // u_n: STAGES planes
  T* pring = stage + STAGES * SS;              // u_{n-1}: STAGES + R planes
  // w (w mode): STAGES + K*R f32 planes, row pitch SP
  float* wring = reinterpret_cast<float*>(smem_raw + (size_t)(2 * STAGES + R) * SS * sizeof(T));
  float* centre = wring + (WM ? SW * SS : 0);
  // cells updated at stage s (s = 0: the whole region)
  auto ncells = [&](int s) { return (g.ty + 2 * R * (K - s)) * (g.tz + 2 * R * (K - s)); };

  // the region's origin (padded coordinates), clipped to the array
  const int y0 = H + (int)blockIdx.y * g.ty - G, z0 = H + (int)blockIdx.x * g.tz - G;
  const int ya = max(0, -y0), yb = min(PY, nyp - y0);
  const int za = max(0, -z0), zb = min(PZ, nzp - z0);
  // staged rows: the aligned superset [zA, zB) of the columns in the array
  // (u_n), and of those of stage 1's region (u_{n-1}), at staging column
  // z - zA
  const int ve = max(1, g.vb / (int)sizeof(T));
  const int zA = (z0 + za) / ve * ve, zB = (z0 + zb + ve - 1) / ve * ve;
  const int nrow = max(0, yb - ya), nch = zb > za ? (zB - zA) / ve : 0;
  const int e1 = R * (K - 1);
  const int ya1 = max(ya, G - e1), yb1 = min(yb, G + g.ty + e1);
  const int za1 = max(za, G - e1), zb1 = min(zb, G + g.tz + e1);
  const int zA1 = (z0 + za1) / ve * ve;
  const int nrow1 = max(0, yb1 - ya1);
  const int nch1 = zb1 > za1 ? ((z0 + zb1 + ve - 1) / ve * ve - zA1) / ve : 0;
  const int vew = max(1, g.vbw / 4);  // w: stage 1's region, from staging column zAw - zA
  const int zAw = (z0 + za1) / vew * vew;
  const int nchw = zb1 > za1 ? ((z0 + zb1 + vew - 1) / vew * vew - zAw) / vew : 0;
  // output planes [xs, xe); input planes [p0, p1); iterations [p0, pend);
  // u_{n-1}'s planes [lo1, hi1), stage 1's
  const int xs = H + (int)blockIdx.z * g.xc, xe = min(xs + g.xc, H + g.nx);
  const int p0 = max(0, xs - G), p1 = min(nxp, xe + G), pend = xe + G;
  const int lo1 = max(0, xs - e1), hi1 = min(nxp, xe + e1);

  // the cells of this thread, fixed for the sweep
  int o[C], so[C], gof[C];  // offset in a centre plane, in staging, in a padded plane
  unsigned long long lp = 0;  // bit i*K + s-1: cell i is updated (not frozen) at stage s
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int idx = threadIdx.x + i * NT;
    int r = 0, col = 0;
    if (idx < PS) onion<R, K>(idx, g.ty, g.tz, r, col);
    o[i] = r * PZ + col;
    const bool arr = idx < PS && r >= ya && r < yb && col >= za && col < zb;
    so[i] = arr ? r * SP + col + (z0 - zA) : 0;
    gof[i] = arr ? (y0 + r) * nzp + z0 + col : 0;
    const int gy = y0 + r, gz = z0 + col;
    const bool in = arr && gy >= H && gy < H + g.ny && gz >= H && gz < H + g.nz;
#pragma unroll
    for (int s = 1; s <= K; ++s)
      if (in && idx < ncells(s)) lp |= 1ull << (i * K + s - 1);
  }

  // the copies of input plane x, both levels and (w mode) w, as one commit
  // group (empty past the input planes)
  const T* src0 = uin + lvl + (int64_t)(y0 + ya) * nzp + zA;
  const T* src1 = uin + (int64_t)(y0 + ya1) * nzp + zA1;
  const float* srcw = wgt + (int64_t)(y0 + ya1) * nzp + zAw;
  auto copy = [&](auto* dst, const auto* src, int rows, int chunks, int vb) {
    switch (vb) {
      case 16: copy_rows<16>(dst, SP, src, nzp, rows, chunks); break;
      case 8: copy_rows<8>(dst, SP, src, nzp, rows, chunks); break;
      case 4: copy_rows<4>(dst, SP, src, nzp, rows, chunks); break;
      default: copy_rows<2>(dst, SP, src, nzp, rows, chunks); break;
    }
  };
  auto issue = [&](int x, int slot, int pslot, int wslot) {
    if (x < p1 && nrow > 0 && nch > 0)
      copy(stage + slot * SS + ya * SP, src0 + (int64_t)x * gsx, nrow, nch, g.vb);
    if (x >= lo1 && x < hi1 && nrow1 > 0 && nch1 > 0) {
      copy(pring + pslot * SS + ya1 * SP + (zA1 - zA), src1 + (int64_t)x * gsx, nrow1, nch1, g.vb);
      if constexpr (WM)
        copy(wring + wslot * SS + ya1 * SP + (zAw - zA), srcw + (int64_t)x * gsx, nrow1, nchw,
             g.vbw);
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int d = 0; d < STAGES - 1; ++d) issue(p0 + d, d, d, d);

  float q[K][C][L];  // q[j]: level j (u_{n+j}) at plane x in slot (x - p0) % L
  int slot = 0;      // staging slot of plane p
  int pslot = 0;     // slot of plane p in u_{n-1}'s ring
  int wslot = 0;     // slot of plane p in w's ring
  for (int base = p0; base < pend; base += L) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const int p = base + j;
      if (p < pend) {
        // register slot of plane p - a
#define SLOT(a) ((j + (K + 2) * L - (a)) % L)
        float* cbuf = centre + ((p - p0) & 1) * K * PS;
        // the centre planes of this iteration, known R iterations ago, over
        // the region of the stage before
#pragma unroll
        for (int s = 1; s <= K; ++s) {
          const int x = p - s * R;
          const int e = R * (K - s);
          if (x >= max(0, xs - e) && x < min(nxp, xe + e)) {
            float* u = cbuf + (s - 1) * PS;
            const int n = ncells(s - 1);
#pragma unroll
            for (int i = 0; i < C; ++i) {
              if (i * NT < n && (int)threadIdx.x + i * NT < n) u[o[i]] = q[s - 1][i][SLOT(s * R)];
            }
          }
        }
        __pipeline_wait_prior(STAGES - 2);
        __syncthreads();  // plane p has landed; the centre planes are written
        if (p < p1) {
          const T* sp = stage + slot * SS;
#pragma unroll
          for (int i = 0; i < C; ++i)
            if (i * NT < PS) q[0][i][SLOT(0)] = to_f32(sp[so[i]]);
        }
        const T* prev = pring + (pslot >= R ? pslot - R : pslot + SM - R) * SS;
        // slots read in the last iteration, before this barrier
        const int wbase = wslot;
        issue(p + STAGES - 1, slot == 0 ? STAGES - 1 : slot - 1,
              pslot + STAGES - 1 < SM ? pslot + STAGES - 1 : pslot + STAGES - 1 - SM,
              wslot + STAGES - 1 < SW ? wslot + STAGES - 1 : wslot + STAGES - 1 - SW);
        slot = slot == STAGES - 1 ? 0 : slot + 1;
        pslot = pslot == SM - 1 ? 0 : pslot + 1;
        wslot = wslot == SW - 1 ? 0 : wslot + 1;
#pragma unroll
        for (int s = 1; s <= K; ++s) {
          const int x = p - s * R;
          const int e = R * (K - s);
          if (x >= max(0, xs - e) && x < min(nxp, xe + e)) {
            const bool x_in = x >= H && x < H + g.nx;
            const float* u = cbuf + (s - 1) * PS;
            const float* wp = wring + (wbase >= s * R ? wbase - s * R : wbase + SW - s * R) * SS;
            const int n = ncells(s);
#pragma unroll
            for (int i = 0; i < C; ++i) {
              if (i * NT >= n) continue;
              float v = q[s - 1][i][SLOT(s * R)];
              if (x_in && (lp >> (i * K + s - 1) & 1ull)) {
                float xn[L];
#pragma unroll
                for (int d = 0; d < L; ++d) xn[d] = q[s - 1][i][SLOT((s + 1) * R - d)];
                const float up = s == 1 ? to_f32(prev[so[i]])
                                        : q[s >= 2 ? s - 2 : 0][i][SLOT(s * R)];
                float w = 0.0f;
                if constexpr (WM) w = wp[so[i]];
                v = leap<R, ISO, WM>(xn, u, o[i], PZ, up, c, w);
                if (s == K) {
                  const int64_t gi = (int64_t)x * gsx + gof[i];
                  uout[gi] = from_f32<T>(q[K - 1][i][SLOT(K * R)]);
                  uout[lvl + gi] = from_f32<T>(v);
                }
              }
              if (s < K) q[s][i][SLOT(s * R)] = v;
            }
          }
        }
#undef SLOT
      }
    }
  }
}

template <int R, int K, bool ISO, typename T, bool WM>
int launch_k(const T* uin, T* uout, const float* w, Geom g, const Coeffs& c,
             cudaStream_t stream) {
  const int g2 = 2 * K * R;
  if ((g.ty + g2) * (g.tz + g2) > cells(R, K) * THREADS) return (int)cudaErrorInvalidValue;
  const size_t bytes = smem(R, K, g.ty, g.tz, (int)sizeof(T), WM);
  cudaError_t e = cudaFuncSetAttribute(kernel<R, K, ISO, T, WM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  g.vb = copy_bytes<T>(uin, g.nz + 2 * g.halo);
  // w's chunks start at staging columns aligned to u's copies: no wider
  g.vbw = WM ? min(copy_bytes<float>(w, g.nz + 2 * g.halo), 4 * max(1, g.vb / (int)sizeof(T))) : 0;
  const dim3 grid((g.nz + g.tz - 1) / g.tz, (g.ny + g.ty - 1) / g.ty, (g.nx + g.xc - 1) / g.xc);
  kernel<R, K, ISO, T, WM><<<grid, THREADS, bytes, stream>>>(uin, uout, w, g, c);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int K, typename T, bool WM>
int launch_iso(const T* uin, T* uout, const float* w, Geom g, bool iso,
               const Coeffs& c, cudaStream_t s) {
  if constexpr (built(R, K)) {
    return iso ? launch_k<R, K, true, T, WM>(uin, uout, w, g, c, s)
               : launch_k<R, K, false, T, WM>(uin, uout, w, g, c, s);
  } else {
    return 2000 + K;
  }
}

template <int R, typename T, bool WM>
int launch_r(const T* uin, T* uout, const float* w, Geom g, int k, bool iso,
             const Coeffs& c, cudaStream_t s) {
  switch (k) {
    case 1: return launch_iso<R, 1, T, WM>(uin, uout, w, g, iso, c, s);
    case 2: return launch_iso<R, 2, T, WM>(uin, uout, w, g, iso, c, s);
    case 3: return launch_iso<R, 3, T, WM>(uin, uout, w, g, iso, c, s);
    case 4: return launch_iso<R, 4, T, WM>(uin, uout, w, g, iso, c, s);
    default: return 2000 + k;
  }
}

// Kernel B in one mode (storage T, medium WM) at radius RLO..RHI; 1000 +
// radius for a radius not built here, 2000 + K for a depth.
template <typename T, bool WM, int RLO, int RHI>
int launch_mode(const T* uin, T* uout, const float* w, Geom g, int radius, int k, bool iso,
                const Coeffs& c, cudaStream_t s) {
  if constexpr (RLO <= RHI) {
    if (radius == RLO) return launch_r<RLO, T, WM>(uin, uout, w, g, k, iso, c, s);
    return launch_mode<T, WM, RLO + 1, RHI>(uin, uout, w, g, radius, k, iso, c, s);
  } else {
    return 1000 + radius;
  }
}

}  // namespace sweep

// The modes at radius 1-2 and 3-4, one translation unit each so that nvcc
// builds them in parallel (stencil_sweep_<storage>_<medium>_r<radii>.cu);
// arguments as tpufdtd_sweep (stencil_sweep.cu).
#define TPUFDTD_SWEEP_MODE(name, T)                                                        \
  int name(const T* uin, T* uout, const float* w, sweep::Geom g, int radius, int k,        \
           bool iso, const Coeffs& c, cudaStream_t s)
TPUFDTD_SWEEP_MODE(sweep_f32_m_r12, float);
TPUFDTD_SWEEP_MODE(sweep_f32_m_r34, float);
TPUFDTD_SWEEP_MODE(sweep_f32_w_r12, float);
TPUFDTD_SWEEP_MODE(sweep_f32_w_r34, float);
TPUFDTD_SWEEP_MODE(sweep_bf16_m_r12, bf16);
TPUFDTD_SWEEP_MODE(sweep_bf16_m_r34, bf16);
TPUFDTD_SWEEP_MODE(sweep_bf16_w_r12, bf16);
TPUFDTD_SWEEP_MODE(sweep_bf16_w_r34, bf16);
