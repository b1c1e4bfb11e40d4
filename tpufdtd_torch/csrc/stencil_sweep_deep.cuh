// Kernel B's deep form: K fused leapfrog steps per pass over device memory
// at the depths the register form does not build (R = 1-2 at K = 5-6, R = 3
// at K = 3-4).
//
// Replaces tpufdtd/ops/stencil_sweep.py:sweep_fused at those depths, in all
// four of its modes (f32 or bf16 storage, a scalar m or the w stream), with
// the frozen margins and the x-slab level stride that the C entry
// (stencil_sweep.cu) handles for both forms. It computes what the register
// form (stencil_sweep.cuh) computes: U_in = [u_{n-1}, u_n] ->
// U_out = [u_{n+K-1}, u_{n+K}], K leapfrog steps in f32, interior points
// only (every stage carries the cells outside the global interior at their
// loaded u_n), the two output levels rounded to the storage dtype once, at
// the end of the K-block.
//
// Bound: device memory, as at every depth: K fused steps move 16 B per point
// in f32 (8 in bf16), plus 4 B of w per point in w mode, plus each block's
// re-read halo. At these depths the work per output point grows with the
// halo, and the shared-memory loads (6R + 2 a cell-stage) may bound it first.
//
// Design: the register form keeps K rings of 2R+1 planes per owned cell in
// registers; at R = 3, K = 6 one thread's 255 registers cannot hold them even
// for one cell, so here every intermediate level lives in shared memory. A
// block owns a TY x TZ output column and sweeps x over XC planes. u_n and
// u_{n-1} arrive by cp.async (16 bytes where the row pitch and pointer
// allow, as in the register form) AHEAD planes ahead, in the storage dtype,
// over the whole (TY + 2KR) x (TZ + 2KR) region: u_n into a ring of
// 2R+1+AHEAD planes, u_{n-1} into a ring of AHEAD+1. Stage j = 1..K-1 keeps a
// ring of the level u_{n+j}, 2R+1 f32 planes over its region (TY + 2(K-j)R) x
// (TZ + 2(K-j)R). Iteration p brings input plane p; stage j then computes
// plane p - jR, reading level j-1's planes p-(j+1)R .. p-(j-1)R (its whole
// ring) and level j-2's plane p - jR (the oldest plane of that ring; for
// stage 1, u_{n-1}). Stage K writes u_{n+K} to device memory, and the centre
// of level K-1's plane to output level 0. One barrier separates two stages
// (K barriers an iteration), so stage j reads the plane stage j-1 wrote in
// the same iteration and no ring needs a spare plane. Each stage's cells are
// its region clipped to the array; cells beyond the array are never read by
// an interior cell. w mode reads w per stage from device memory through the
// read-only cache: a block's stages touch the same planes within (K-1)R
// iterations, so L2 serves the repeats, and a w ring would not fit beside
// the level rings. Shared memory (smem(); ops/stencil_sweep.py:
// deep_smem_bytes) is 100-220 KB, so one block of THREADS threads runs on
// an SM; without register rings a thread needs far fewer than the 128
// registers that THREADS = 512 leaves it.
//
// Arithmetic: the register form's leap (the TPU sweep's isotropic form, the
// oracle's exact form, the w form), term for term.
#pragma once

#include <type_traits>

#include "stencil_sweep.cuh"

namespace sweep_deep {

constexpr int THREADS = 512;  // threads per block, one block an SM
constexpr int AHEAD = 2;      // input planes in flight

// The (R, K) of the deep form (ops/stencil_sweep.py:DEEP_TILES): the depths
// of the TPU sweep (K <= 6 at R <= 2, K <= 4 at R = 3) that the register
// form does not build.
__host__ __device__ constexpr bool built(int R, int K) {
  return (R >= 1 && R <= 2 && K >= 5 && K <= 6) || (R == 3 && K >= 3 && K <= 4);
}

// Dynamic shared memory of one block (ops/stencil_sweep.py:deep_smem_bytes
// states the same expression): the staged rings of u_n (2R+1+AHEAD planes)
// and u_{n-1} (AHEAD+1) over the whole region in the storage dtype, each row
// padded to a 16-byte multiple plus 16 bytes for its aligned superset; then
// the rings of levels 1..K-1, 2R+1 f32 planes each over the stage's region.
inline size_t smem(int R, int K, int ty, int tz, int esz) {
  const int g2 = 2 * K * R, py = ty + g2, pz = tz + g2, v = 16 / esz;
  const int sp = (pz + v - 1) / v * v + v;
  size_t levels = 0;
  for (int j = 1; j < K; ++j) levels += (size_t)(ty + 2 * (K - j) * R) * (tz + 2 * (K - j) * R);
  return (size_t)(2 * R + 2 + 2 * AHEAD) * py * sp * esz + (size_t)(2 * R + 1) * levels * 4;
}

// The register form's leap with the y/z neighbours in a plane of S (f32, or
// the staged u_n in bf16): xn[d] = the level at plane x-R+d, u the centre
// plane, o the cell's offset in it, sy its row stride.
template <int R, bool ISO, bool WM, typename S>
__device__ __forceinline__ float leap(const float (&xn)[2 * R + 1], const S* u, int o, int sy,
                                      float up, const Coeffs& c, float wv) {
  const float uc = xn[R];
  if constexpr (ISO) {
    float acc = c.w0x3 * uc;
#pragma unroll
    for (int d = R; d >= 1; --d) {
      float nb = xn[R - d] + xn[R + d];
      nb = nb + to_f32(u[o - d * sy]);
      nb = nb + to_f32(u[o + d * sy]);
      nb = nb + to_f32(u[o + d]);
      nb = nb + to_f32(u[o - d]);
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
      ty = ty + c.w[d] * (to_f32(u[o - d * sy]) + to_f32(u[o + d * sy]));
      tz = tz + c.w[d] * (to_f32(u[o - d]) + to_f32(u[o + d]));
    }
    if constexpr (WM) {
      return wv * (c.r2 * tx + c.r3 * ty + c.r4 * tz) + (2.0f * uc - up);
    } else {
      return c.dt2 * (c.r2 * tx + c.r3 * ty + c.r4 * tz - (c.neg2r1 * uc + c.r1 * up) * c.m) /
             c.m;
    }
  }
}

// f(std::integral_constant<int, J>) for J = J0..J1, in order
template <int J0, int J1, typename F>
__device__ __forceinline__ void for_stages(F&& f) {
  if constexpr (J0 <= J1) {
    f(std::integral_constant<int, J0>{});
    for_stages<J0 + 1, J1>(f);
  }
}

template <int R, int K, bool ISO, typename T, bool WM>
__global__ void __launch_bounds__(THREADS, 1)
kernel(const T* __restrict__ uin, T* __restrict__ uout, const float* __restrict__ wgt,
       sweep::Geom g, Coeffs c) {
  constexpr int P = 2 * R + 1, L0 = P + AHEAD, LP = AHEAD + 1, G = K * R;
  constexpr int V = 16 / (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = g.halo, NT = blockDim.x, tid = threadIdx.x;
  const int nxp = g.nx + 2 * H, nyp = g.ny + 2 * H, nzp = g.nz + 2 * H;
  const int64_t gsx = (int64_t)g.nypa * nzp, lvl = (int64_t)g.nxpa * gsx;
  const int PY = g.ty + 2 * G, PZ = g.tz + 2 * G;
  const int SP = (PZ + V - 1) / V * V + V, SS = PY * SP;
  T* ring0 = reinterpret_cast<T*>(smem_raw);  // u_n: L0 planes
  T* pring = ring0 + L0 * SS;                  // u_{n-1}: LP planes
  float* lev = reinterpret_cast<float*>(pring + LP * SS);  // levels 1..K-1
  // level j's region: (ty + 2(K-j)R) x (tz + 2(K-j)R) at (jR, jR) of the
  // whole region; loff[j] its ring's offset in lev
  int loff[K];
  loff[0] = loff[1] = 0;
#pragma unroll
  for (int j = 2; j < K; ++j) {
    const int e = (K - j + 1) * R;  // level j-1's halo
    loff[j] = loff[j - 1] + P * (g.ty + 2 * e) * (g.tz + 2 * e);
  }

  // the region's origin (padded coordinates), clipped to the array
  const int y0 = H + (int)blockIdx.y * g.ty - G, z0 = H + (int)blockIdx.x * g.tz - G;
  const int ya = max(0, -y0), yb = min(PY, nyp - y0);
  const int za = max(0, -z0), zb = min(PZ, nzp - z0);
  // staged rows: the aligned superset [zA, zB) of the columns in the array
  // (u_n), and of those of stage 1's region (u_{n-1}), at staging column
  // z - zA, so the cell (r, col) of the region lies at r * SP + col + zo
  const int ve = max(1, g.vb / (int)sizeof(T));
  const int zA = (z0 + za) / ve * ve, zB = (z0 + zb + ve - 1) / ve * ve, zo = z0 - zA;
  const int nrow = max(0, yb - ya), nch = zb > za ? (zB - zA) / ve : 0;
  const int e1 = R * (K - 1);
  const int ya1 = max(ya, G - e1), yb1 = min(yb, G + g.ty + e1);
  const int za1 = max(za, G - e1), zb1 = min(zb, G + g.tz + e1);
  const int zA1 = (z0 + za1) / ve * ve;
  const int nrow1 = max(0, yb1 - ya1);
  const int nch1 = zb1 > za1 ? ((z0 + zb1 + ve - 1) / ve * ve - zA1) / ve : 0;
  // output planes [xs, xe); input planes [p0, p1); iterations [p0, pend);
  // u_{n-1}'s planes [lo1, hi1), stage 1's
  const int xs = H + (int)blockIdx.z * g.xc, xe = min(xs + g.xc, H + g.nx);
  const int p0 = max(0, xs - G), p1 = min(nxp, xe + G), pend = xe + G;
  const int lo1 = max(0, xs - e1), hi1 = min(nxp, xe + e1);

  // group q: u_n's plane q and u_{n-1}'s plane q - R (read by stage 1 at
  // iteration q), one commit group, empty past the input planes
  const T* src0 = uin + lvl + (int64_t)(y0 + ya) * nzp + zA;
  const T* src1 = uin + (int64_t)(y0 + ya1) * nzp + zA1;
  auto copy = [&](T* dst, const T* src, int rows, int chunks) {
    switch (g.vb) {
      case 16: copy_rows<16>(dst, SP, src, nzp, rows, chunks); break;
      case 8: copy_rows<8>(dst, SP, src, nzp, rows, chunks); break;
      case 4: copy_rows<4>(dst, SP, src, nzp, rows, chunks); break;
      default: copy_rows<2>(dst, SP, src, nzp, rows, chunks); break;
    }
  };
  auto issue = [&](int q) {
    if (q < p1 && nrow > 0 && nch > 0)
      copy(ring0 + (q % L0) * SS + ya * SP, src0 + (int64_t)q * gsx, nrow, nch);
    const int x = q - R;
    if (x >= lo1 && x < hi1 && nrow1 > 0 && nch1 > 0)
      copy(pring + (x % LP) * SS + ya1 * SP + (zA1 - zA), src1 + (int64_t)x * gsx, nrow1, nch1);
    __pipeline_commit();
  };
#pragma unroll
  for (int d = 0; d < AHEAD; ++d) issue(p0 + d);

  for (int p = p0; p < pend; ++p) {
    __pipeline_wait_prior(AHEAD - 1);
    __syncthreads();  // plane p has landed; the last iteration's reads are done
    issue(p + AHEAD);
    for_stages<1, K>([&](auto jc) {
      constexpr int J = decltype(jc)::value;
      const int x = p - J * R, e = R * (K - J);
      if (x >= max(0, xs - e) && x < min(nxp, xe + e)) {
        const bool x_in = x >= H && x < H + g.nx;
        // stage J's region, (hj x wj) at (JR, JR) of the whole region,
        // clipped to the array: rows [rlo, rhi), columns [clo, chi)
        const int hj = g.ty + 2 * e, wj = g.tz + 2 * e;
        const int gy0 = y0 + J * R, gz0 = z0 + J * R;
        const int rlo = max(0, -gy0), rhi = min(hj, nyp - gy0);
        const int clo = max(0, -gz0), chi = min(wj, nzp - gz0);
        const int cw = chi - clo, n = max(0, rhi - rlo) * max(0, cw);
        const float inv = 1.0f / (float)max(1, cw);
        // level J-1's planes x-R .. x+R: in ring0 (J = 1) or its level ring
        const int sb = J == 1 ? (x + L0 - R) % L0 : (x + P - R) % P;
        const int lsz = (g.ty + 2 * (e + R)) * (g.tz + 2 * (e + R));  // level J-1's plane
        for (int i = tid; i < n; i += NT) {
          const int rr = (int)(((float)i + 0.5f) * inv), cc = i - rr * cw;
          const int r = rlo + rr, col = clo + cc;
          const int gy = gy0 + r, gz = gz0 + col;
          const bool in = x_in && gy >= H && gy < H + g.ny && gz >= H && gz < H + g.nz;
          float xn[P];
          float v;
          if constexpr (J == 1) {
            // level 0: u_n, staged; the cell at (r + R, col + R) of the region
            const int o = (r + R) * SP + col + R + zo;
            if (in) {
#pragma unroll
              for (int d = 0; d < P; ++d) {
                const int s = sb + d < L0 ? sb + d : sb + d - L0;
                xn[d] = to_f32(ring0[s * SS + o]);
              }
              const int sc = sb + R < L0 ? sb + R : sb + R - L0;
              const float up = to_f32(pring[(x % LP) * SS + o]);
              float wv = 0.0f;
              if constexpr (WM) wv = __ldg(wgt + (int64_t)x * gsx + (int64_t)gy * nzp + gz);
              v = leap<R, ISO, WM>(xn, ring0 + sc * SS, o, SP, up, c, wv);
            } else {
              const int sc = sb + R < L0 ? sb + R : sb + R - L0;
              v = to_f32(ring0[sc * SS + o]);
            }
          } else {
            // level J-1: the cell at (r + R, col + R) of its region
            const float* l1 = lev + loff[J - 1];
            const int wl = g.tz + 2 * (e + R);
            const int o = (r + R) * wl + col + R;
            if (in) {
#pragma unroll
              for (int d = 0; d < P; ++d) {
                const int s = sb + d < P ? sb + d : sb + d - P;
                xn[d] = l1[s * lsz + o];
              }
              const int sc = sb + R < P ? sb + R : sb + R - P;
              // level J-2 at plane x: its ring's oldest plane
              float up;
              if constexpr (J == 2) {
                up = to_f32(ring0[(x % L0) * SS + (r + 2 * R) * SP + col + 2 * R + zo]);
              } else {
                const int w2 = g.tz + 2 * (e + 2 * R);
                const int l2sz = (g.ty + 2 * (e + 2 * R)) * w2;
                up = lev[loff[J - 2] + (x % P) * l2sz + (r + 2 * R) * w2 + col + 2 * R];
              }
              float wv = 0.0f;
              if constexpr (WM) wv = __ldg(wgt + (int64_t)x * gsx + (int64_t)gy * nzp + gz);
              v = leap<R, ISO, WM>(xn, l1 + sc * lsz, o, wl, up, c, wv);
              if constexpr (J == K) {
                const int64_t gi = (int64_t)x * gsx + (int64_t)gy * nzp + gz;
                uout[gi] = from_f32<T>(xn[R]);
                uout[lvl + gi] = from_f32<T>(v);
              }
            } else {
              const int sc = sb + R < P ? sb + R : sb + R - P;
              v = l1[sc * lsz + o];
            }
          }
          if constexpr (J < K) lev[loff[J] + (x % P) * (hj * wj) + r * wj + col] = v;
        }
      }
      if constexpr (J < K) __syncthreads();  // stage J's plane is written
    });
  }
}

template <int R, int K, bool ISO, typename T, bool WM>
int launch_k(const T* uin, T* uout, const float* w, sweep::Geom g, const Coeffs& c,
             cudaStream_t stream) {
  const size_t bytes = smem(R, K, g.ty, g.tz, (int)sizeof(T));
  // qualified here and below: sweep::Geom brings the register form's
  // kernel and launch_* in by argument-dependent lookup
  cudaError_t e = cudaFuncSetAttribute(sweep_deep::kernel<R, K, ISO, T, WM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  g.vb = copy_bytes<T>(uin, g.nz + 2 * g.halo);
  g.vbw = 0;
  const dim3 grid((g.nz + g.tz - 1) / g.tz, (g.ny + g.ty - 1) / g.ty, (g.nx + g.xc - 1) / g.xc);
  sweep_deep::kernel<R, K, ISO, T, WM><<<grid, THREADS, bytes, stream>>>(uin, uout, w, g, c);
  return static_cast<int>(cudaGetLastError());
}

template <int R, int K, typename T, bool WM>
int launch_iso(const T* uin, T* uout, const float* w, sweep::Geom g, bool iso, const Coeffs& c,
               cudaStream_t s) {
  return iso ? sweep_deep::launch_k<R, K, true, T, WM>(uin, uout, w, g, c, s)
             : sweep_deep::launch_k<R, K, false, T, WM>(uin, uout, w, g, c, s);
}

// The deep form in one mode (storage T, medium WM); 2000 + k for an (R, K)
// it does not build.
template <typename T, bool WM>
int launch_mode(const T* uin, T* uout, const float* w, sweep::Geom g, int radius, int k,
                bool iso, const Coeffs& c, cudaStream_t s) {
  switch (radius * 10 + k) {
    case 15: return sweep_deep::launch_iso<1, 5, T, WM>(uin, uout, w, g, iso, c, s);
    case 16: return sweep_deep::launch_iso<1, 6, T, WM>(uin, uout, w, g, iso, c, s);
    case 25: return sweep_deep::launch_iso<2, 5, T, WM>(uin, uout, w, g, iso, c, s);
    case 26: return sweep_deep::launch_iso<2, 6, T, WM>(uin, uout, w, g, iso, c, s);
    case 33: return sweep_deep::launch_iso<3, 3, T, WM>(uin, uout, w, g, iso, c, s);
    case 34: return sweep_deep::launch_iso<3, 4, T, WM>(uin, uout, w, g, iso, c, s);
    default: return 2000 + k;
  }
}

}  // namespace sweep_deep

// The four modes, one translation unit each so that nvcc builds them in
// parallel (stencil_sweep_deep_<storage>_<medium>.cu); arguments as
// tpufdtd_sweep (stencil_sweep.cu).
TPUFDTD_SWEEP_MODE(sweep_deep_f32_m, float);
TPUFDTD_SWEEP_MODE(sweep_deep_f32_w, float);
TPUFDTD_SWEEP_MODE(sweep_deep_bf16_m, bf16);
TPUFDTD_SWEEP_MODE(sweep_deep_bf16_w, bf16);
