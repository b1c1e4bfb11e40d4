// Kernel A: one leapfrog step from (cur, prev) into a separate target.
//
// Replaces tpufdtd/ops/stencil_pallas_z.py:leapfrog_step_zsplit (the exact
// three-level ring behind simulate()) and stencil_pallas.py:
// leapfrog_step_pallas (orders 10-12). It writes the target's interior
// only: each ring level keeps its own frozen rim, and source deposits one
// cell beyond the interior persist there.
//
// Bound: device memory. Per interior point it reads cur and prev and writes
// the target, 12 B in f32 and 6 B in bf16, plus 4 B for a per-point m.
// Tensor cores have no role: a radius-R stencil is a few adds and
// multiplies per loaded value.
//
// Design: kernel B's x-sweep (stencil_sweep.cuh) at one step with one
// output level. A block of THREADS threads owns a TY x TZ column of (y, z)
// and XC x-planes and walks x, one plane per iteration. Each thread owns up
// to pairs(R, MB) pairs of z-neighbouring cells of the column for the whole
// sweep (pair i of thread t: index t + i*THREADS in row order, so a warp
// covers 64 neighbouring z); their offsets are computed once, before the x
// loop. Per cell it keeps a ring of L = 2R+1 planes of cur in registers, so
// the x-neighbours never touch shared memory; the ring shifts by one
// register move per slot and plane (unrolled by L instead, as kernel B is,
// with three staging copies in each of the L bodies, it ran 2.5 times
// slower at R = 6; PERF.md). cur's
// planes over the column and its R-cell halo arrive by cp.async of 16 bytes
// (8 or 4 when the row pitch or the pointer allows no more; a bf16 row of
// odd pitch is copied plainly) STAGES-1 planes ahead into a ring of
// STAGES + R planes in the storage type, each row as its aligned superset
// (starting at an even column, so that a pair is one aligned word); prev
// and a per-point m arrive with them, over the column only, into rings of
// STAGES planes, so no global load waits inside the loop. Iteration p waits
// for plane p, passes the iteration's one __syncthreads, issues plane
// p + STAGES - 1 into the slot of plane p-R-1 (last read in iteration p-1),
// shifts plane p into the rings, and updates plane p - R: x-neighbours from
// the rings, y/z neighbours and prev from shared memory by pairs (8-byte
// loads in f32, 4 in bf16: at R = 6, 10.5 a cell where one cell at a time
// took 26), a pair's z-neighbours from one window of 2R+2 values. Shared
// memory (smem(); ops/stencil_step.py:smem_bytes) is 40-220 KB. The
// registers bound the column: a block whose column fits pairs(R, 2) per
// thread takes at most 128 registers, so that two blocks share an SM
// (MB = 2); a larger column takes one block of up to 255 (MB = 1; the
// order-12 paths run so, 5 pairs a thread). The launch picks MB from the
// block shape. The rings start at zero: read before their first plane in
// the shift, uninitialised, they let nvcc compute wrong x-neighbours.
//
// Storage: cur, prev and target share one type T, f32 or bf16 (the TPU
// kernels store in the dtype of their inputs). A bf16 value is widened to
// f32 where it is read, all arithmetic is f32, and the result is rounded
// once on the store. m stays f32. Offsets of planes are 64-bit: a [1032]^3
// level passes 2^31 elements.
//
// Arithmetic follows the oracle term for term (openacc.cpp:102-107): tx,
// ty, tz summed separately from d = R down to 1, then dt2 * (r2 tx + r3 ty
// + r4 tz - (neg2r1 u + r1 prev) m) / m. nvcc contracts a*b+c into FMAs,
// so results differ from the plain version by a few ulp; a cell's value
// does not depend on the block or the shard that computes it.
#pragma once

#include "fdtd_common.cuh"

namespace step {

constexpr int STAGES = 4;         // planes in flight + 1
constexpr int THREADS = 256;      // threads per block
constexpr int REG_OVERHEAD = 72;  // registers per thread besides the cells'

// Pairs of z-neighbouring cells per thread at radius R with MB blocks per
// SM: each takes two rings of 2R+1 registers, its two offsets, and four
// more that leave ptxas room to keep the pair's shared loads in flight.
__host__ __device__ constexpr int pairs(int R, int MB) {
  return ((MB == 2 ? 128 : 240) - REG_OVERHEAD) / (4 * R + 6);
}

// Blocks per SM of the instantiation a TY x TZ column takes: 2 where the
// column fits pairs(R, 2) per thread, else 1.
__host__ __device__ constexpr int blocks_for(int R, int ty, int tz) {
  return ty * tz <= 2 * pairs(R, 2) * THREADS ? 2 : 1;
}

// Row pitch of every staged plane, in elements of the storage type: the
// column's TZ + 2R cells padded to a 16-byte multiple, plus 16 bytes for a
// row's aligned superset (and a pair's z window reaching one cell further).
__host__ __device__ constexpr int pitch(int R, int tz, int esz) {
  return (tz + 2 * R + 16 / esz - 1) / (16 / esz) * (16 / esz) + 16 / esz;
}

// Dynamic shared memory of one block: STAGES + R planes of cur over TY + 2R
// rows, STAGES of prev over TY rows in the storage type and, with a
// per-point m, STAGES of m over TY rows in f32, all at pitch();
// ops/stencil_step.py:smem_bytes states the same expression.
inline size_t smem(int R, int ty, int tz, int esz, bool pm) {
  const size_t sp = pitch(R, tz, esz);
  return ((STAGES + R) * (ty + 2 * R) + STAGES * ty) * sp * esz + (pm ? STAGES * ty * sp * 4 : 0);
}

struct Geom {
  int nx, ny, nz, halo;  // interior extents, halo H
  int ty, tz, xc;        // the block's column (TZ even) and x-planes
  int vb;                // bytes per staging copy of cur and prev: 16, 8, 4, or 2 (plain)
  int vbm;               // the same for m
  int vst;               // nonzero: a pair's two cells are stored as one word
};

// Two neighbouring values at an even element offset, widened to f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const bf16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __halves2bfloat162(from_f32<bf16>(a), from_f32<bf16>(b));
}

// The oracle's update of one cell from its three sums, its value u, prev
// and m (openacc.cpp:102-107).
__device__ __forceinline__ float leap(float tx, float ty, float tz, float u, float up, float mm,
                                      const Coeffs& c) {
  return c.dt2 * (c.r2 * tx + c.r3 * ty + c.r4 * tz - (c.neg2r1 * u + c.r1 * up) * mm) / mm;
}

template <int R, typename T, int MB>
__global__ void __launch_bounds__(THREADS, MB)
leapfrog_xsweep(const T* __restrict__ cur, const T* __restrict__ prev,
                const float* __restrict__ m, T* __restrict__ target, Geom g, Coeffs c) {
  constexpr int L = 2 * R + 1, C = pairs(R, MB), NS = STAGES + R;
  constexpr int S = R & 1, NW = R + 1 + S;  // a pair's z window: NW loads of two from z - R - S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H = g.halo, NT = blockDim.x;
  const int nzp = g.nz + 2 * H;
  const int64_t sx = (int64_t)(g.ny + 2 * H) * nzp;
  const int SP = pitch(R, g.tz, (int)sizeof(T)), SS = (g.ty + 2 * R) * SP, SC = g.ty * SP;
  T* stage = reinterpret_cast<T*>(smem_raw);  // cur: NS planes of SS
  T* pring = stage + NS * SS;                  // prev: STAGES planes of SC
  float* mring = reinterpret_cast<float*>(pring + STAGES * SC);  // m: STAGES planes of SC
  const int np = g.tz / 2, npc = g.ty * np;  // pairs per row, in the column

  // the column's origin (padded coordinates, z0 even) and its extent in the
  // interior
  const int y0 = H + (int)blockIdx.y * g.ty, z0 = H + (int)blockIdx.x * g.tz;
  const int nyb = min(g.ty, H + g.ny - y0), nzb = min(g.tz, H + g.nz - z0);
  // staged rows of cur: padded rows [y0 - R, y0 + nyb + R), each as the
  // aligned superset [zA, zB) of its columns [z0 - R, z0 + nzb + R), at
  // staging column z - zA (zA even, so that a pair's cells stay a pair of
  // an aligned word); prev and m: rows [y0, y0 + nyb) as the aligned
  // superset of [z0, z0 + nzb), at the same staging column
  const int ve = max(1, g.vb / (int)sizeof(T)), va = max(2, ve), vem = g.vbm / 4;
  const int zA = (z0 - R) / va * va, zB = (z0 + nzb + R + ve - 1) / ve * ve;
  const int nrow = nyb + 2 * R, nch = (zB - zA) / ve;
  const int zP = z0 / ve * ve, nchp = ((z0 + nzb + ve - 1) / ve * ve - zP) / ve;
  const int zM = vem ? z0 / vem * vem : 0;
  const int nchm = vem ? ((z0 + nzb + vem - 1) / vem * vem - zM) / vem : 0;
  // output planes [xs, xe); input planes [xs - R, xe + R), one per iteration
  const int xs = H + (int)blockIdx.z * g.xc, xe = min(xs + g.xc, H + g.nx);
  const int p0 = xs - R, pend = xe + R;

  // the pairs of this thread, fixed for the sweep: pair i holds the cells
  // at z and z + 1 of one row
  int so[C], gof[C];   // offset of its first cell in a staged plane of cur, in a padded plane
  unsigned long long live = 0;  // bit 2i + k: cell k of pair i lies in the interior
#pragma unroll
  for (int i = 0; i < C; ++i) {
    const int idx = threadIdx.x + i * NT;
    const int r = idx / np, col = 2 * (idx - r * np);
    const bool in = idx < npc && r < nyb && col < nzb;
    so[i] = in ? (r + R) * SP + z0 + col - zA : 0;
    gof[i] = in ? (y0 + r) * nzp + z0 + col : 0;
    if (in) live |= (col + 1 < nzb ? 3ull : 1ull) << (2 * i);
  }

  const T* src = cur + (int64_t)(y0 - R) * nzp + zA;
  const T* srcp = prev + (int64_t)y0 * nzp + zP;
  const float* srcm = m ? m + (int64_t)y0 * nzp + zM : nullptr;
  auto copy = [&](auto* dst, const auto* from, int rows, int chunks, int vb) {
    switch (vb) {
      case 16: copy_rows<16>(dst, SP, from, nzp, rows, chunks); break;
      case 8: copy_rows<8>(dst, SP, from, nzp, rows, chunks); break;
      case 4: copy_rows<4>(dst, SP, from, nzp, rows, chunks); break;
      default: copy_rows<2>(dst, SP, from, nzp, rows, chunks); break;
    }
  };
  // the copies of input plane x into cur's slot s and, where plane x - R
  // is updated, of its prev (and m) into their slot ps, as one commit group
  // (empty past the input planes)
  auto issue = [&](int x, int s, int ps) {
    if (x < pend) copy(stage + s * SS, src + (int64_t)x * sx, nrow, nch, g.vb);
    const int xp = x - R;
    if (xp >= xs && xp < xe) {
      copy(pring + ps * SC + (zP - zA), srcp + (int64_t)xp * sx, nyb, nchp, g.vb);
      if (m) copy(mring + ps * SC + (zM - zA), srcm + (int64_t)xp * sx, nyb, nchm, g.vbm);
    }
    __pipeline_commit();
  };
#pragma unroll
  for (int d = 0; d < STAGES - 1; ++d) issue(p0 + d, d, d);

  // cur at plane p - 2R + k in qa[i][k] (the pair's first cell) and qb[i][k]
  // (its second): k = 2R the newest
  float qa[C][L] = {}, qb[C][L] = {};
  int slot = 0;  // cur's staging slot of plane p
  int ps = 0;    // prev's and m's slot of plane p - R
  for (int p = p0; p < pend; ++p) {
    __pipeline_wait_prior(STAGES - 2);
    __syncthreads();  // plane p has landed; iteration p-1 is over
    issue(p + STAGES - 1, slot + STAGES - 1 < NS ? slot + STAGES - 1 : slot + STAGES - 1 - NS,
          ps == 0 ? STAGES - 1 : ps - 1);
    const T* sp = stage + slot * SS;
#pragma unroll
    for (int i = 0; i < C; ++i) {
      if (i * NT < npc) {
#pragma unroll
        for (int k = 0; k < L - 1; ++k) {
          qa[i][k] = qa[i][k + 1];
          qb[i][k] = qb[i][k + 1];
        }
        const float2 v = load2(sp + so[i]);
        qa[i][L - 1] = v.x;
        qb[i][L - 1] = v.y;
      }
    }
    const int x = p - R;  // the plane updated in this iteration
    if (x >= xs) {
      const T* u = stage + (slot >= R ? slot - R : slot + NS - R) * SS;  // plane x
      const T* pp = pring + ps * SC - R * SP;
      const float* mp = mring + ps * SC - R * SP;
      T* out = target + (int64_t)x * sx;
#pragma unroll
      for (int i = 0; i < C; ++i) {
        const unsigned lv = (unsigned)(live >> (2 * i)) & 3u;
        if (!lv) continue;
        const int o = so[i];
        const float ua = qa[i][R], ub = qb[i][R];
        const float ra = c.w[0] * ua, rb = c.w[0] * ub;
        float txa = ra, tya = ra, tza = ra, txb = rb, tyb = rb, tzb = rb;
        float zw[2 * NW];  // the pair's z window: z - R - S + k in zw[k]
#pragma unroll
        for (int k = 0; k < NW; ++k) {
          const float2 v = load2(u + o - R - S + 2 * k);
          zw[2 * k] = v.x;
          zw[2 * k + 1] = v.y;
        }
#pragma unroll
        for (int d = R; d >= 1; --d) {
          const float2 ym = load2(u + o - d * SP), yp = load2(u + o + d * SP);
          txa = txa + c.w[d] * (qa[i][R - d] + qa[i][R + d]);
          tya = tya + c.w[d] * (ym.x + yp.x);
          tza = tza + c.w[d] * (zw[S + R - d] + zw[S + R + d]);
          txb = txb + c.w[d] * (qb[i][R - d] + qb[i][R + d]);
          tyb = tyb + c.w[d] * (ym.y + yp.y);
          tzb = tzb + c.w[d] * (zw[S + R + 1 - d] + zw[S + R + 1 + d]);
        }
        const float2 up = load2(pp + o);
        const float2 mm = m ? *reinterpret_cast<const float2*>(mp + o) : make_float2(c.m, c.m);
        const float va_ = leap(txa, tya, tza, ua, up.x, mm.x, c);
        const float vb_ = leap(txb, tyb, tzb, ub, up.y, mm.y, c);
        if (lv == 3u && g.vst) {
          store2(out + gof[i], va_, vb_);
        } else {
          out[gof[i]] = from_f32<T>(va_);
          if (lv == 3u) out[gof[i] + 1] = from_f32<T>(vb_);
        }
      }
    }
    slot = slot == NS - 1 ? 0 : slot + 1;
    ps = ps == STAGES - 1 ? 0 : ps + 1;
  }
}

template <int R, typename T, int MB>
int launch_mb(const T* cur, const T* prev, const float* m, T* target, Geom g, const Coeffs& c,
              cudaStream_t stream) {
  const size_t bytes = smem(R, g.ty, g.tz, (int)sizeof(T), m != nullptr);
  cudaError_t e = cudaFuncSetAttribute(leapfrog_xsweep<R, T, MB>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) {
    cudaGetLastError();  // reset, so that the next launch does not report it
    return static_cast<int>(e);
  }
  const int nzp = g.nz + 2 * g.halo;
  g.vb = min(copy_bytes<T>(cur, nzp), copy_bytes<T>(prev, nzp));
  // m's chunks start at staging columns aligned to cur's copies: no wider
  g.vbm = m ? min(copy_bytes<float>(m, nzp), 4 * max(1, g.vb / (int)sizeof(T))) : 0;
  // a pair's first cell sits at an even offset from the target's start
  g.vst = nzp % 2 == 0 && reinterpret_cast<uintptr_t>(target) % (2 * sizeof(T)) == 0;
  const dim3 grid((g.nz + g.tz - 1) / g.tz, (g.ny + g.ty - 1) / g.ty, (g.nx + g.xc - 1) / g.xc);
  leapfrog_xsweep<R, T, MB><<<grid, THREADS, bytes, stream>>>(cur, prev, m, target, g, c);
  return static_cast<int>(cudaGetLastError());
}

template <int R, typename T>
int launch_r(const T* cur, const T* prev, const float* m, T* target, Geom g, const Coeffs& c,
             cudaStream_t s) {
  if (g.ty < 1 || g.tz < 2 || g.tz % 2 || g.xc < 1 || g.ty * g.tz > 2 * pairs(R, 1) * THREADS)
    return (int)cudaErrorInvalidValue;
  return blocks_for(R, g.ty, g.tz) == 2 ? launch_mb<R, T, 2>(cur, prev, m, target, g, c, s)
                                        : launch_mb<R, T, 1>(cur, prev, m, target, g, c, s);
}

// Kernel A in storage T at radius RLO..RHI; 1000 + radius for a radius not
// built here.
template <typename T, int RLO, int RHI>
int launch_mode(const T* cur, const T* prev, const float* m, T* target, Geom g, int radius,
                const Coeffs& c, cudaStream_t s) {
  if constexpr (RLO <= RHI) {
    if (radius == RLO) return launch_r<RLO, T>(cur, prev, m, target, g, c, s);
    return launch_mode<T, RLO + 1, RHI>(cur, prev, m, target, g, radius, c, s);
  } else {
    return 1000 + radius;
  }
}

}  // namespace step

// Kernel A's storage types at radius 1-3 and 4-6, one translation unit
// each so that nvcc builds them in parallel (stencil_step_<storage>_r<radii>
// .cu); arguments as tpufdtd_leapfrog_step (stencil_step.cu).
#define TPUFDTD_STEP_MODE(name, T)                                                         \
  int name(const T* cur, const T* prev, const float* m, T* target, step::Geom g, int radius, \
           const Coeffs& c, cudaStream_t s)
TPUFDTD_STEP_MODE(step_f32_r13, float);
TPUFDTD_STEP_MODE(step_f32_r46, float);
TPUFDTD_STEP_MODE(step_bf16_r13, bf16);
TPUFDTD_STEP_MODE(step_bf16_r46, bf16);
