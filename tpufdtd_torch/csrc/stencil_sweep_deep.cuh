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
// Bound: device memory moves 16 B per point a call in f32 (8 in bf16, + 4
// for w), the same at every depth, so the deeper K the less it bounds. What
// bounds these kernels is shared memory: every level lives there, and a
// cell-stage reads its 2R x-, 2R y- and 2R z-neighbours, its centre and
// its level two steps back from it and stores its new value.
//
// Design: a block sweeps x over segments of at most XC planes of a TY x TZ
// output column, each plus 2KR planes of pipeline fill: one segment a
// block (one block per column and x-chunk), or, where the last of those
// blocks' rounds of one block an SM would be mostly empty (416 blocks at
// 16 x 40: 3.15 rounds of 132), one block an SM each taking an equal run
// of the columns' planes (launch_k picks). Level j (u_{n+j}, j = 0..K-1)
// lives in a shared-memory ring of P = 2R+1
// f32 planes over its region, (TY + 2(K-j)R) x (TZ + 2(K-j)R) cells at
// (jR, jR) of level 0's; stage j = 1..K computes level j at plane p - jR of
// iteration p from level j-1's planes p-(j+1)R .. p-(j-1)R and level j-2's
// plane p - jR, one barrier after each stage but the last. The integer
// work of a cell-stage is kept out of the loop:
//   * the tile (TY, TZ) is a template parameter (Shape): every row pitch,
//     plane size and ring offset is a constant;
//   * every ring has P slots and the x loop is unrolled by P, so every ring
//     slot is a constant (plane y of every level sits at slot (y - p0) % P);
//   * each thread owns fixed z pairs of each stage, computed once before the
//     x loop with their interior masks; a plane tests only whether it lies in
//     the interior, uniformly for the block;
//   * a pair's loads are 8 bytes: R + 1 + (R & 1) for the z window of its
//     centre row (both cells' z-neighbours), 2R for its x-neighbours, 2R for
//     its y-neighbours, one for the level two steps back, and it stores 8
//     bytes. Stage j's pairs run over whole rows of level j-1 (the pairs of
//     its 2R-column band do nothing), so a warp's loads are contiguous and
//     free of bank conflicts. Where jR is odd, level j's rows start one
//     column in (a pad column each side), so that a pair's cells stay an
//     aligned word in every level;
//   * u_n and u_{n-1} are staged by cp.async (16 bytes where the row pitch
//     and pointer allow) into one plane each, in the storage dtype: plane p
//     of u_n over level 0's region and plane p - R of u_{n-1} over stage 1's.
//     Stage 1 moves u_n's plane into level 0's f32 ring (the pairs of the
//     R rows above and below its region are extra work items) and reads
//     u_{n-1} there; the copies of the next planes are issued after stage 1
//     and land while stages 2..K run. Cells beyond the array hold whatever
//     the staging planes held; no interior cell reads them.
// w mode reads w per cell-stage from device memory through the read-only
// cache: a block's stages touch the same planes within (K-1)R iterations,
// so L2 serves the repeats, and a w ring would not fit beside the levels.
// Shared memory (Shape::smem; ops/stencil_sweep.py:deep_smem_bytes) is up
// to 227 KB, so one block of threads() threads runs on an SM.
//
// Arithmetic: the register form's leap (the TPU sweep's isotropic form, the
// oracle's exact form, the w form), term for term.
#pragma once

#include <type_traits>

#include "stencil_sweep.cuh"

namespace sweep_deep {

// Threads per block, one block an SM: 512 (128 registers each), but 384
// (168) at R = 1, whose many rounds of short pairs ptxas interleaved until
// a few words spilled at 128, and for the exact form with a scalar m at
// R = 2, whose IEEE division (a call on its slow path) needs more than 128
// around it.
__host__ __device__ constexpr int threads(int R, bool iso, bool wm) {
  return R == 1 || (!iso && !wm && R == 2) ? 384 : 512;
}

// The (R, K) of the deep form (ops/stencil_sweep.py:DEEP_TILES): the depths
// of the TPU sweep (K <= 6 at R <= 2, K <= 4 at R = 3) that the register
// form does not build.
__host__ __device__ constexpr bool built(int R, int K) {
  return (R >= 1 && R <= 2 && K >= 5 && K <= 6) || (R == 3 && K >= 3 && K <= 4);
}

// Every instantiated (R, K, TY, TZ): the tile of DEEP_TILES and the others
// harness/tile_probe.py times (ops/stencil_sweep.py:DEEP_SHAPES lists the
// same). tpufdtd_sweep refuses any other tile (3000).
#define TPUFDTD_DEEP_SHAPES(X)                                                      \
  X(1, 5, 40, 64) X(1, 5, 48, 48) X(1, 6, 32, 64) X(1, 6, 40, 48)                   \
  X(2, 5, 32, 32) X(2, 5, 24, 40) X(2, 6, 16, 40) X(2, 6, 16, 32)                   \
  X(3, 3, 16, 64) X(3, 3, 32, 40) X(3, 4, 16, 40) X(3, 4, 16, 32)

// The block's layout at (R, K, TY, TZ). Level j = 0..K-1, and j = K for the
// output column: rows(j) x width(j) cells at (jR, jR) of level 0's region;
// its rows start shift(j) cells in (jR odd) and are pitch(j) floats apart,
// npair(j) pairs; ring(j) is its ring's offset, in floats. Stage j's pairs
// are level j-1's rows R .. rows(j-1) - R - 1, whole: pairs(j) of them in
// rounds(j) of nt, of which level j-1's pair q is level j's pair
// q - dq(j); first(j) numbers its first round among all stages'. Level 0's
// R rows above and below stage 1's rows are bpairs() more pairs.
struct Shape {
  int R, K, ty, tz, nt;  // nt: threads per block
  __host__ __device__ constexpr int P() const { return 2 * R + 1; }
  __host__ __device__ constexpr int G() const { return K * R; }
  __host__ __device__ constexpr int rows(int j) const { return ty + 2 * (K - j) * R; }
  __host__ __device__ constexpr int width(int j) const { return tz + 2 * (K - j) * R; }
  __host__ __device__ constexpr int shift(int j) const { return (j * R) & 1; }
  __host__ __device__ constexpr int pitch(int j) const { return width(j) + 2 * shift(j); }
  __host__ __device__ constexpr int npair(int j) const { return pitch(j) / 2; }
  __host__ __device__ constexpr int plane(int j) const { return rows(j) * pitch(j); }
  __host__ __device__ constexpr int ring(int j) const {
    int o = 0;
    for (int i = 0; i < j; ++i) o += P() * plane(i);
    return o;
  }
  __host__ __device__ constexpr int pairs(int j) const { return rows(j) * npair(j - 1); }
  __host__ __device__ constexpr int rounds(int j) const {
    return (pairs(j) + nt - 1) / nt;
  }
  __host__ __device__ constexpr int first(int j) const {
    int o = 0;
    for (int i = 1; i < j; ++i) o += rounds(i);
    return o;
  }
  __host__ __device__ constexpr int dq(int j) const {
    return (R + shift(j - 1) - shift(j)) / 2;
  }
  __host__ __device__ constexpr int bpairs() const { return 2 * R * npair(0); }
  __host__ __device__ constexpr int brounds() const {
    return (bpairs() + nt - 1) / nt;
  }
  // a staged plane's row pitch in elements of esz bytes: level 0's width
  // padded to 16 bytes, plus 16 for a row's aligned superset; 32 bytes of
  // guard before each staged plane take the reads of the cells left of the
  // array in the first block column
  __host__ __device__ constexpr int spitch(int esz) const {
    return (width(0) + 16 / esz - 1) / (16 / esz) * (16 / esz) + 16 / esz;
  }
  __host__ __device__ constexpr int sguard(int esz) const { return 32 / esz; }
  // dynamic shared memory of one block (ops/stencil_sweep.py:
  // deep_smem_bytes): the two staged planes with their guards, then the
  // level rings
  __host__ __device__ constexpr long long smem(int esz) const {
    return 2LL * (32 + rows(0) * spitch(esz) * esz) + 4LL * ring(K);
  }
};

__host__ __device__ constexpr int mod(int a, int m) { return (a % m + m) % m; }

// f(std::integral_constant<int, J>) for J = J0..J1, in order
template <int J0, int J1, typename F>
__device__ __forceinline__ void unroll(F&& f) {
  if constexpr (J0 <= J1) {
    f(std::integral_constant<int, J0>{});
    unroll<J0 + 1, J1>(f);
  }
}

__device__ __forceinline__ float2 ld2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ void st2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// The register form's leap with the neighbours as values: xn[d] = the
// level at plane x-R+d (xn[R] the centre), ym[d] / yp[d] at rows y -+ d,
// zc[-d] / zc[d] at columns z -+ d of the centre row.
template <int R, bool ISO, bool WM>
__device__ __forceinline__ float leap(const float (&xn)[2 * R + 1], const float (&ym)[R + 1],
                                      const float (&yp)[R + 1], const float* zc, float up,
                                      const Coeffs& c, float wv) {
  const float uc = xn[R];
  if constexpr (ISO) {
    float acc = c.w0x3 * uc;
#pragma unroll
    for (int d = R; d >= 1; --d) {
      float nb = xn[R - d] + xn[R + d];
      nb = nb + ym[d];
      nb = nb + yp[d];
      nb = nb + zc[d];
      nb = nb + zc[-d];
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
      ty = ty + c.w[d] * (ym[d] + yp[d]);
      tz = tz + c.w[d] * (zc[-d] + zc[d]);
    }
    if constexpr (WM) {
      return wv * (c.r2 * tx + c.r3 * ty + c.r4 * tz) + (2.0f * uc - up);
    } else {
      return c.dt2 * (c.r2 * tx + c.r3 * ty + c.r4 * tz - (c.neg2r1 * uc + c.r1 * up) * c.m) /
             c.m;
    }
  }
}

template <int R, int K, int TY, int TZ, bool ISO, typename T, bool WM>
__global__ void __launch_bounds__(threads(R, ISO, WM), 1)
kernel(const T* __restrict__ uin, T* __restrict__ uout, const float* __restrict__ wgt,
       sweep::Geom g, Coeffs c) {
  constexpr int NT = threads(R, ISO, WM);
  constexpr Shape L{R, K, TY, TZ, NT};
  constexpr int P = L.P(), G = L.G(), PY = L.rows(0), PZ = L.width(0);
  constexpr int SP = L.spitch((int)sizeof(T)), GS = L.sguard((int)sizeof(T));
  constexpr int NR = L.first(K + 1), NB = L.brounds(), W0 = L.pitch(0), PL0 = L.plane(0);
  constexpr int SW = R & 1, NW = R + 1 + SW;  // a pair's z window: NW words from z - R - SW
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* su = reinterpret_cast<T*>(smem_raw) + GS;            // u_n's staged plane
  T* sv = su + PY * SP + GS;                              // u_{n-1}'s
  float* lev = reinterpret_cast<float*>(sv + PY * SP);    // the level rings
  const int H = g.halo, tid = threadIdx.x;
  const int nxp = g.nx + 2 * H, nyp = g.ny + 2 * H, nzp = g.nz + 2 * H;
  const int64_t gsx = (int64_t)g.nypa * nzp, lvl = (int64_t)g.nxpa * gsx;

  // The work: the column x plane pairs, columns (TY x TZ, z fastest) one
  // after another, swept in segments of at most XC planes of one column.
  // With a grid of one block per column and x-chunk of XC planes, block b
  // takes chunk b / ncol of column b % ncol; else each block takes a run of
  // about 1/gridDim.x of them (launch_k picks).
  const int ncz = (g.nz + TZ - 1) / TZ, ncol = ncz * ((g.ny + TY - 1) / TY);
  const int nchk = (g.nx + g.xc - 1) / g.xc, b = (int)blockIdx.x;
  const int total = ncol * g.nx;  // < 2^31 (launch_k)
  int u, uend;
  if ((int)gridDim.x == ncol * nchk) {
    u = b % ncol * g.nx + b / ncol * g.xc;
    uend = u + min(g.xc, g.nx - b / ncol * g.xc);
  } else {
    const int per = (total + (int)gridDim.x - 1) / (int)gridDim.x;
    u = (int)min((long long)total, (long long)b * per);
    uend = (int)min((long long)total, ((long long)b + 1) * per);
  }
  while (u < uend) {
    const int col = u / g.nx, x0 = u - col * g.nx;
    const int len = min(min(g.nx - x0, g.xc), uend - u);
    u += len;
    const int bcz = col % ncz, bcy = col / ncz;
    // level 0's origin (padded coordinates), and its part in the array
    const int y0 = H + bcy * TY - G, z0 = H + bcz * TZ - G;
    const int ya = max(0, -y0), yb = min(PY, nyp - y0);
    const int za = max(0, -z0), zb = min(PZ, nzp - z0);
    // staged rows: the aligned superset [zA, zB) of the columns in the array
    // (u_n), and of those of stage 1's region (u_{n-1}), at staging column
    // z - zA, so the cell (r, col) of level 0's region lies at r * SP + col + zo
    const int ve = max(1, g.vb / (int)sizeof(T));
    const int zA = (z0 + za) / ve * ve, zB = (z0 + zb + ve - 1) / ve * ve, zo = z0 - zA;
    const int nrow = max(0, yb - ya), nch = zb > za ? (zB - zA) / ve : 0;
    const int e1 = R * (K - 1);
    const int ya1 = max(ya, G - e1), yb1 = min(yb, G + TY + e1);
    const int za1 = max(za, G - e1), zb1 = min(zb, G + TZ + e1);
    const int zA1 = (z0 + za1) / ve * ve;
    const int nrow1 = max(0, yb1 - ya1);
    const int nch1 = zb1 > za1 ? ((z0 + zb1 + ve - 1) / ve * ve - zA1) / ve : 0;
    // output planes [xs, xe); input planes [p0, p1); iterations [p0, pend)
    const int xs = H + x0, xe = xs + len;
    const int p0 = max(0, xs - G), p1 = min(nxp, xe + G), pend = xe + G;

    // this thread's pairs, fixed for the segment, two stage rounds a word:
    // round I in bits 16 (I % 2) .. 16 (I % 2) + 15 of mp[I / 2], its first
    // cell's offset in a plane of level j-1 (bits 0-11; its row there is the
    // offset over the pitch) and the flags exists (12), in stage j's region
    // (13), cell a / b updated (14 / 15: in the region and the interior)
    unsigned mp[(NR + 1) / 2];
#pragma unroll
    for (int i = 0; i < (NR + 1) / 2; ++i) mp[i] = 0u;
    unroll<1, K>([&](auto jc) {
      constexpr int J = decltype(jc)::value;
      // layout constants bound as such: a constexpr function called at run
      // time need not be folded, and one that was not ran 2.7 times slower
      constexpr int NP1 = L.npair(J - 1), W1 = L.pitch(J - 1), NPJ = L.npair(J);
      constexpr int NPS = L.pairs(J), DQ = L.dq(J), SH = L.shift(J), WJ = L.width(J);
      static_assert(L.plane(J - 1) <= 4096, "a pair's offset takes 12 bits");
      unroll<0, L.rounds(J) - 1>([&](auto nc) {
        constexpr int I = L.first(J) + decltype(nc)::value;
        const int i = tid + decltype(nc)::value * NT;
        const int rw = i / NP1, q = i - rw * NP1;
        const bool exists = i < NPS;
        const bool valid = exists && q >= DQ && q < DQ + NPJ;
        const int ca = 2 * (q - DQ) - SH;  // cell a's column in stage J's region
        const int gy = y0 + J * R + rw, gz = z0 + J * R + ca;
        const bool yin = valid && gy >= H && gy < H + g.ny;
        const bool ua = yin && ca >= 0 && ca < WJ && gz >= H && gz < H + g.nz;
        const bool ub = yin && ca + 1 >= 0 && ca + 1 < WJ && gz + 1 >= H && gz + 1 < H + g.nz;
        const unsigned o = exists ? (unsigned)((rw + R) * W1 + 2 * q) : 0u;
        mp[I / 2] |= (o | (unsigned)(exists | valid << 1 | ua << 2 | ub << 3) << 12)
                     << (16 * (I % 2));
      });
    });
    // the band pairs of level 0: offset in level 0's plane (bits 0-30; the
    // row is the offset over the pitch) and exists (31)
    unsigned bm[NB];
    unroll<0, NB - 1>([&](auto nc) {
      constexpr int N = decltype(nc)::value, NP0 = L.npair(0), BPS = L.bpairs();
      const int i = tid + N * NT, br = i / NP0, q = i - br * NP0;
      const int row = br < R ? br : br + PY - 2 * R;
      bm[N] = i < BPS ? (unsigned)(row * W0 + 2 * q) | 1u << 31 : 0u;
    });
    auto word = [&](auto ic) {
      constexpr int I = decltype(ic)::value;
      return (mp[I / 2] >> (16 * (I % 2))) & 0xffffu;
    };
    auto flag = [&](auto ic, int bit) { return ((word(ic) >> (12 + bit)) & 1u) != 0u; };
    auto off = [&](auto ic) { return (int)(word(ic) & 0xfffu); };

    const T* src0 = uin + lvl + (int64_t)(y0 + ya) * nzp + zA;
    const T* src1 = uin + (int64_t)(y0 + ya1) * nzp + zA1;
    auto copy = [&](T* dst, const T* from, int rows, int chunks) {
      switch (g.vb) {
        case 16: copy_rows<16>(dst, SP, from, nzp, rows, chunks); break;
        case 8: copy_rows<8>(dst, SP, from, nzp, rows, chunks); break;
        case 4: copy_rows<4>(dst, SP, from, nzp, rows, chunks); break;
        default: copy_rows<2>(dst, SP, from, nzp, rows, chunks); break;
      }
    };
    // u_n's plane q and u_{n-1}'s plane q - R (read by stage 1 at iteration
    // q), one commit group, empty past the input planes
    auto issue = [&](int q) {
      if (q < p1 && nrow > 0 && nch > 0) copy(su + ya * SP, src0 + (int64_t)q * gsx, nrow, nch);
      const int x = q - R;
      if (x >= max(0, xs - e1) && x < min(nxp, xe + e1) && nrow1 > 0 && nch1 > 0)
        copy(sv + ya1 * SP + (zA1 - zA), src1 + (int64_t)x * gsx, nrow1, nch1);
      __pipeline_commit();
    };

    // stage J's pair I at plane x, in the interior's planes, its ring slot
    // SX; level J-1 at plane x + R in xr (stage 1: u_n's plane, just staged)
    auto update = [&](auto jc, auto sxc, auto ic, int x, float xra, float xrb) {
      constexpr int J = decltype(jc)::value, SX = decltype(sxc)::value;
      constexpr int W1 = L.pitch(J - 1), PL = L.plane(J - 1), RG1 = L.ring(J - 1);
      constexpr int WJ = L.pitch(J), PJ = L.plane(J), RGJ = L.ring(J);
      constexpr int W2 = J >= 2 ? L.pitch(J - 2) : 0, P2 = J >= 2 ? L.plane(J - 2) : 0;
      constexpr int RG2 = J >= 2 ? L.ring(J - 2) : 0;
      // the pair's offset in level J-2 at (rw, o) of level J-1, in level J,
      // and in the padded array (less its row and plane terms)
      constexpr int UPC = 2 * R * W2 - R * W1 + R + (J >= 2 ? L.shift(J - 2) : 0) - L.shift(J - 1);
      constexpr int STC = -R * W1 - 2 * L.dq(J), GC = J * R - L.shift(J - 1) - R - R * W1;
      const int o = off(ic), rw = o / W1 - R;
      const float* l1 = lev + RG1;
      const float* ctr = l1 + SX * PL + o;
      float zw[2 * NW];
  #pragma unroll
      for (int k = 0; k < NW; ++k) {
        const float2 t = ld2(ctr - R - SW + 2 * k);
        zw[2 * k] = t.x;
        zw[2 * k + 1] = t.y;
      }
      float xa[P], xb[P], yma[R + 1], ypa[R + 1], ymb[R + 1], ypb[R + 1];
      xa[R] = zw[R + SW];
      xb[R] = zw[R + SW + 1];
      unroll<1, R>([&](auto ec) {
        constexpr int E = decltype(ec)::value;
        const float2 m = ld2(l1 + mod(SX - E, P) * PL + o);
        xa[R - E] = m.x;
        xb[R - E] = m.y;
        if constexpr (J == 1 && E == R) {
          xa[2 * R] = xra;
          xb[2 * R] = xrb;
        } else {
          const float2 t = ld2(l1 + mod(SX + E, P) * PL + o);
          xa[R + E] = t.x;
          xb[R + E] = t.y;
        }
        const float2 ym = ld2(ctr - E * W1), yp = ld2(ctr + E * W1);
        yma[E] = ym.x;
        ymb[E] = ym.y;
        ypa[E] = yp.x;
        ypb[E] = yp.y;
      });
      float upa, upb;  // level J-2 at plane x
      if constexpr (J == 1) {
        const T* s = sv + o + (rw + R) * (SP - W0) + zo;
        upa = to_f32(s[0]);
        upb = to_f32(s[1]);
      } else {
        const float2 t = ld2(lev + RG2 + SX * P2 + o + rw * (W2 - W1) + UPC);
        upa = t.x;
        upb = t.y;
      }
      const bool ua = flag(ic, 2), ub = flag(ic, 3);
      // cell a in the padded array: x * gsx + go
      const int go = rw * (nzp - W1) + o + (y0 + J * R) * nzp + z0 + GC;
      const int64_t gx = (int64_t)x * gsx;
      float wa = 0.0f, wb = 0.0f;
      if constexpr (WM) {
        if (ua) wa = __ldg(wgt + gx + go);
        if (ub) wb = __ldg(wgt + gx + go + 1);
      }
      float va = leap<R, ISO, WM>(xa, yma, ypa, zw + R + SW, upa, c, wa);
      float vb = leap<R, ISO, WM>(xb, ymb, ypb, zw + R + SW + 1, upb, c, wb);
      if constexpr (J < K) {
        va = ua ? va : xa[R];
        vb = ub ? vb : xb[R];
        st2(lev + RGJ + SX * PJ + o - rw * (W1 - WJ) + STC, va, vb);
      } else {
        if (ua) {
          uout[gx + go] = from_f32<T>(xa[R]);
          uout[lvl + gx + go] = from_f32<T>(va);
        }
        if (ub) {
          uout[gx + go + 1] = from_f32<T>(xb[R]);
          uout[lvl + gx + go + 1] = from_f32<T>(vb);
        }
      }
    };
    // stage J < K's pair I at a rim plane: level J-1's value carried
    auto carry = [&](auto jc, auto sxc, auto ic) {
      constexpr int J = decltype(jc)::value, SX = decltype(sxc)::value;
      constexpr int W1 = L.pitch(J - 1), PL = L.plane(J - 1), RG1 = L.ring(J - 1);
      constexpr int WJ = L.pitch(J), PJ = L.plane(J), RGJ = L.ring(J);
      constexpr int STC = -R * W1 - 2 * L.dq(J);
      const int o = off(ic), rw = o / W1 - R;
      const float2 t = ld2(lev + RG1 + SX * PL + o);
      st2(lev + RGJ + SX * PJ + o - rw * (W1 - WJ) + STC, t.x, t.y);
    };

    issue(p0);
    for (int pb = p0; pb < pend; pb += P) {
      // iteration p = pb + S: plane y of every level at slot (y - p0) % P
      unroll<0, P - 1>([&](auto sc) {
        constexpr int S = decltype(sc)::value;
        const int p = pb + S;
        if (p >= pend) return;
        __pipeline_wait_prior(0);
        __syncthreads();  // plane p has landed; the last iteration's reads are done
        // the pair map, opaque to the compiler in every iteration: else it
        // keeps each round's addresses in registers across the x loop, and
        // ptxas spills at 128 registers
        unroll<0, (NR - 1) / 2>([&](auto ic) { asm volatile("" : "+r"(mp[decltype(ic)::value])); });
        {  // stage 1, and u_n's plane p into level 0 at slot S
          constexpr int SX = mod(S - R, P);
          const int x = p - R;
          const bool act = x >= max(0, xs - e1) && x < min(nxp, xe + e1);
          const bool xin = act && x >= H && x < H + g.nx, conv = p < p1;
          float* l0 = lev + S * PL0;
          unroll<0, L.rounds(1) - 1>([&](auto ic) {
            if (!flag(ic, 0)) return;
            const int o = off(ic), r0 = o / W0;  // its row in level 0
            float na = 0.0f, nb = 0.0f;
            if (conv) {
              const T* s = su + o + r0 * (SP - W0) + zo;
              na = to_f32(s[0]);
              nb = to_f32(s[1]);
              st2(l0 + o, na, nb);
            }
            if (!flag(ic, 1)) return;
            if (xin) {
              update(std::integral_constant<int, 1>{}, std::integral_constant<int, SX>{}, ic, x,
                     na, nb);
            } else if (act) {
              carry(std::integral_constant<int, 1>{}, std::integral_constant<int, SX>{}, ic);
            }
          });
          if (conv) {
            unroll<0, NB - 1>([&](auto nc) {
              constexpr int N = decltype(nc)::value;
              if (!(bm[N] >> 31)) return;
              const int o = (int)(bm[N] & 0x7fffffffu), r0 = o / W0;
              const T* s = su + o + r0 * (SP - W0) + zo;
              st2(l0 + o, to_f32(s[0]), to_f32(s[1]));
            });
          }
        }
        __syncthreads();  // stage 1's plane is written; the staged planes are read
        issue(p + 1);
        unroll<2, K>([&](auto jc) {
          constexpr int J = decltype(jc)::value, SX = mod(S - J * R, P);
          const int e = R * (K - J), x = p - J * R;
          if (x >= max(0, xs - e) && x < min(nxp, xe + e)) {
            const bool xin = x >= H && x < H + g.nx;
            if (xin || J < K) {
              unroll<L.first(J), L.first(J) + L.rounds(J) - 1>([&](auto ic) {
                if (!flag(ic, 1)) return;
                if (xin) {
                  update(jc, std::integral_constant<int, SX>{}, ic, x, 0.0f, 0.0f);
                } else if constexpr (J < K) {
                  carry(jc, std::integral_constant<int, SX>{}, ic);
                }
              });
            }
          }
          if constexpr (J < K) __syncthreads();  // stage J's plane is written
        });
      });
    }
    __syncthreads();  // the segment's reads are done
  }
}

template <int R, int K, int TY, int TZ, bool ISO, typename T, bool WM>
int launch_k(const T* uin, T* uout, const float* w, sweep::Geom g, const Coeffs& c,
             cudaStream_t stream) {
  constexpr Shape L{R, K, TY, TZ, threads(R, ISO, WM)};
  constexpr long long bytes = L.smem((int)sizeof(T));
  static_assert(bytes <= 232448, "a deep tile must fit 227 KB of shared memory");
  // qualified here and below: sweep::Geom brings the register form's
  // kernel and launch_* in by argument-dependent lookup
  cudaError_t e = cudaFuncSetAttribute(sweep_deep::kernel<R, K, TY, TZ, ISO, T, WM>,
                                       cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (e != cudaSuccess) return static_cast<int>(e);
  g.vb = copy_bytes<T>(uin, g.nz + 2 * g.halo);
  g.vbw = 0;
  int dev = 0, sms = 0;
  e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return static_cast<int>(e);
  // the block's work counter is 32-bit
  const long long ncol = (long long)((g.nz + TZ - 1) / TZ) * ((g.ny + TY - 1) / TY);
  if (ncol * g.nx >= (1LL << 31)) return static_cast<int>(cudaErrorInvalidValue);
  // One block per column and x-chunk runs in rounds of one block an SM; where
  // the last round is mostly empty (3.15 rounds at 16 x 40), one block an SM,
  // each a run of 1/sms of the planes in segments, is faster, though each
  // segment pays 2KR planes of pipeline fill and the blocks then sweep other
  // planes at a time (their halos meet less in L2): the iterations a block
  // runs, each way, and 5 % for the latter
  const long long xc = min(g.xc, g.nx), blocks = ncol * ((g.nx + g.xc - 1) / g.xc);
  const long long rounds = (blocks + sms - 1) / sms, per = (ncol * g.nx + sms - 1) / sms;
  const long long one = rounds * (xc + 2 * K * R);
  const long long run = per + 2 * K * R * ((per + xc - 1) / xc + 1);
  const dim3 grid((unsigned)(100 * one <= 105 * run ? blocks : sms));
  sweep_deep::kernel<R, K, TY, TZ, ISO, T, WM><<<grid, L.nt, (size_t)bytes, stream>>>(
      uin, uout, w, g, c);
  return static_cast<int>(cudaGetLastError());
}

// The deep form in one mode (storage T, medium WM) at radius RR; 2000 + k
// for an (R, K) it does not build, 3000 for a tile (ty, tz) not built at
// a built (R, K).
template <typename T, bool WM, int RR>
int launch_mode(const T* uin, T* uout, const float* w, sweep::Geom g, int radius, int k,
                bool iso, const Coeffs& c, cudaStream_t s) {
#define TPUFDTD_DEEP_CASE(R_, K_, TY_, TZ_)                                                    \
  if constexpr (R_ == RR) {                                                                    \
    if (radius == R_ && k == K_ && g.ty == TY_ && g.tz == TZ_)                                 \
      return iso ? sweep_deep::launch_k<R_, K_, TY_, TZ_, true, T, WM>(uin, uout, w, g, c, s)  \
                 : sweep_deep::launch_k<R_, K_, TY_, TZ_, false, T, WM>(uin, uout, w, g, c, s); \
  }
  TPUFDTD_DEEP_SHAPES(TPUFDTD_DEEP_CASE)
#undef TPUFDTD_DEEP_CASE
  return built(radius, k) ? 3000 : 2000 + k;
}

// Dynamic shared memory of one block at a tile (Shape::smem).
inline long long smem(int R, int K, int ty, int tz, int esz) {
  return Shape{R, K, ty, tz, 512}.smem(esz);
}

}  // namespace sweep_deep

// The four modes at each radius, one translation unit each so that nvcc
// builds them in parallel (stencil_sweep_deep_<storage>_<medium>_r<R>.cu);
// arguments as tpufdtd_sweep (stencil_sweep.cu).
TPUFDTD_SWEEP_MODE(sweep_deep_f32_m_r1, float);
TPUFDTD_SWEEP_MODE(sweep_deep_f32_m_r2, float);
TPUFDTD_SWEEP_MODE(sweep_deep_f32_m_r3, float);
TPUFDTD_SWEEP_MODE(sweep_deep_f32_w_r1, float);
TPUFDTD_SWEEP_MODE(sweep_deep_f32_w_r2, float);
TPUFDTD_SWEEP_MODE(sweep_deep_f32_w_r3, float);
TPUFDTD_SWEEP_MODE(sweep_deep_bf16_m_r1, bf16);
TPUFDTD_SWEEP_MODE(sweep_deep_bf16_m_r2, bf16);
TPUFDTD_SWEEP_MODE(sweep_deep_bf16_m_r3, bf16);
TPUFDTD_SWEEP_MODE(sweep_deep_bf16_w_r1, bf16);
TPUFDTD_SWEEP_MODE(sweep_deep_bf16_w_r2, bf16);
TPUFDTD_SWEEP_MODE(sweep_deep_bf16_w_r3, bf16);
