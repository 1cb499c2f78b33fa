// The kernels of K1b (sra_attention_bwd.cu), in a header so that the
// attention half-block backward (attn_block_bwd.cu) launches the same
// dk/dv kernel on its own q and dout. See sra_attention_bwd.cu for what they
// compute and how.
#pragma once

#include <type_traits>

#include "common.cuh"

namespace {

constexpr int BQ = 64;        // rows the block owns (queries for dq, keys for dk/dv)
constexpr int BT = 64;        // rows of the tiles it walks (keys for dq, queries for dk/dv)
constexpr int THREADS = 128;
constexpr int SM_TARGET = 264;  // dk/dv blocks wanted: two per SM
constexpr float LOG2E = 1.4426950408889634f;

// ---------------------------------------------------------------- float32: FMAs
namespace f32 {

template <int D>
struct Dims {
  static constexpr int LD = D + 4;    // padded rows: conflict-free float4 reads
  static constexpr int PLD = BT + 4;
  static constexpr int TILE = 64 * LD;
  static constexpr int PTILE = 64 * PLD;
};

// rows [row0, row0 + 64) of a (rows, H, D) head slice, scaled, zero at and past `limit`
template <int D>
__device__ __forceinline__ void load_tile(const float* src, int row0, int limit, long pitch,
                                          float scale, float* dst) {
  constexpr int CHUNKS = D / 4;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    const int r = idx / CHUNKS;
    const int c4 = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) {
      val = load4(src + (long)(row0 + r) * pitch + c4);
      val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * Dims<D>::LD + c4) = val;
  }
}

// s[i][j] = A[rg*4 + i] . Bm[cg + 8j] over D (rows of two 64-row tiles)
template <int D>
__device__ __forceinline__ void dot_tile(const float* A, const float* Bm, int rg, int cg,
                                         float (&s)[4][8]) {
  constexpr int LD = Dims<D>::LD;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 av[4], bv[8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(A + (rg * 4 + i) * LD + d);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bm + (cg + 8 * j) * LD + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j)
        s[i][j] += av[i].x * bv[j].x + av[i].y * bv[j].y + av[i].z * bv[j].z +
                   av[i].w * bv[j].w;
  }
}

// acc[i][c] += sum_kk P[rg*4 + i][kk] * X[kk][cg*4 + 32c .. +3], kk < kmax (a multiple of 4)
template <int D>
__device__ __forceinline__ void acc_tile(const float* P, const float* X, int rg, int cg,
                                         int kmax, float4 (&acc)[4][D / 32]) {
  constexpr int LD = Dims<D>::LD, PLD = Dims<D>::PLD;
  for (int kk = 0; kk < kmax; kk += 4) {
    float4 pv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      pv[i] = *reinterpret_cast<const float4*>(P + (rg * 4 + i) * PLD + kk);
#pragma unroll
    for (int u = 0; u < 4; ++u) {
#pragma unroll
      for (int c = 0; c < D / 32; ++c) {
        const float4 xv = *reinterpret_cast<const float4*>(X + (kk + u) * LD + cg * 4 + 32 * c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
          fma4(acc[i][c], p, xv);
        }
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const float* __restrict__ q, const float* __restrict__ k, const float* __restrict__ v,
          const float* __restrict__ o, const float* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta, float* __restrict__ dq,
          int N, int M, int H, float qscale, float scale) {
  using S = Dims<D>;
  constexpr int DC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;            // q rows, pre-scaled by scale * log2(e)
  float* Os = Qs + S::TILE;    // dout rows
  float* Ks = Os + S::TILE;
  float* Vs = Ks + S::TILE;
  float* Ps = Vs + S::TILE;    // ds of the key tile

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg*4 .. rg*4+3
  const int cg = tid & 7;   // key columns cg + 8j, output columns cg*4 + 32c (+0..3)
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const long pitch = (long)H * D;
  const long qoff = (long)b * N * pitch + (long)h * D;
  const long koff = (long)b * M * pitch + (long)h * D;

  load_tile<D>(q + qoff, q0, N, pitch, qscale, Qs);
  load_tile<D>(dout + qoff, q0, N, pitch, 1.f, Os);

  // delta = rowsum(dout * o), from the 8 lanes of a row group
  float lrow[4], drow[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + rg * 4 + i;
    float part = 0.f;
    if (n < N)
      for (int d = cg; d < D; d += 8)
        part += dout[qoff + (long)n * pitch + d] * o[qoff + (long)n * pitch + d];
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    drow[i] = part;
    lrow[i] = n < N ? lse[(long)bh * N + n] : 0.f;
    if (cg == 0 && n < N) delta[(long)bh * N + n] = part;
  }

  float4 acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int k0 = 0; k0 < M; k0 += BT) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<D>(k + koff, k0, M, pitch, 1.f, Ks);
    load_tile<D>(v + koff, k0, M, pitch, 1.f, Vs);
    __syncthreads();
    float s[4][8], dp[4][8];
    dot_tile<D>(Qs, Ks, rg, cg, s);
    dot_tile<D>(Os, Vs, rg, cg, dp);
    const int valid = M - k0;
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cg + 8 * j;
        const float p = col < valid ? exp2f(s[i][j] - lrow[i]) : 0.f;
        Ps[(rg * 4 + i) * S::PLD + col] = p * (dp[i][j] - drow[i]);
      }
    __syncthreads();
    acc_tile<D>(Ps, Ks, rg, cg, (min(BT, valid) + 3) & ~3, acc);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + rg * 4 + i;
    if (n >= N) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      float4 r = acc[i][c];
      r.x *= scale; r.y *= scale; r.z *= scale; r.w *= scale;
      store4(dq + qoff + (long)n * pitch + cg * 4 + 32 * c, r);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lse, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int N, int M, int H, float qscale,
            float scale, int q_per_split) {
  using S = Dims<D>;
  constexpr int DC = D / 32;
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;             // key rows, pre-scaled by scale * log2(e)
  float* Vs = Ks + S::TILE;
  float* Qs = Vs + S::TILE;     // query rows of the current tile
  float* Os = Qs + S::TILE;     // their dout rows
  float* P1 = Os + S::TILE;     // p^T  [key][query]
  float* P2 = P1 + S::PTILE;    // ds^T [key][query]
  float* Ls = P2 + S::PTILE;    // lse of the tile's queries (+inf past the chunk)
  float* Ds = Ls + BT;          // delta of the tile's queries

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // keys rg*4 .. rg*4+3
  const int cg = tid & 7;   // query columns cg + 8j, output columns cg*4 + 32c
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BQ;
  const int qbeg = blockIdx.z * q_per_split;
  const int qend = min(N, qbeg + q_per_split);
  const long pitch = (long)H * D;
  const long qoff = (long)b * N * pitch + (long)h * D;
  const long koff = (long)b * M * pitch + (long)h * D;

  load_tile<D>(k + koff, k0, M, pitch, qscale, Ks);
  load_tile<D>(v + koff, k0, M, pitch, 1.f, Vs);

  float4 acc_k[4][DC], acc_v[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      acc_k[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
      acc_v[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
    }

  for (int n0 = qbeg; n0 < qend; n0 += BT) {
    __syncthreads();
    load_tile<D>(q + qoff, n0, qend, pitch, 1.f, Qs);
    load_tile<D>(dout + qoff, n0, qend, pitch, 1.f, Os);
    for (int idx = tid; idx < BT; idx += THREADS) {
      const int n = n0 + idx;
      Ls[idx] = n < qend ? lse[(long)bh * N + n] : INFINITY;
      Ds[idx] = n < qend ? delta[(long)bh * N + n] : 0.f;
    }
    __syncthreads();
    float st[4][8], dpt[4][8];
    dot_tile<D>(Ks, Qs, rg, cg, st);
    dot_tile<D>(Vs, Os, rg, cg, dpt);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = cg + 8 * j;
        const float p = exp2f(st[i][j] - Ls[col]);  // 0 past the chunk
        P1[(rg * 4 + i) * S::PLD + col] = p;
        P2[(rg * 4 + i) * S::PLD + col] = p * (dpt[i][j] - Ds[col]);
      }
    __syncthreads();
    const int kmax = (min(BT, qend - n0) + 3) & ~3;
    acc_tile<D>(P1, Os, rg, cg, kmax, acc_v);
    acc_tile<D>(P2, Qs, rg, cg, kmax, acc_k);
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + rg * 4 + i;
    if (key >= M) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const long at = koff + (long)key * pitch + cg * 4 + 32 * c;
      atomicAdd(dk + at + 0, acc_k[i][c].x * scale);
      atomicAdd(dk + at + 1, acc_k[i][c].y * scale);
      atomicAdd(dk + at + 2, acc_k[i][c].z * scale);
      atomicAdd(dk + at + 3, acc_k[i][c].w * scale);
      atomicAdd(dv + at + 0, acc_v[i][c].x);
      atomicAdd(dv + at + 1, acc_v[i][c].y);
      atomicAdd(dv + at + 2, acc_v[i][c].z);
      atomicAdd(dv + at + 3, acc_v[i][c].w);
    }
  }
}

template <int D>
constexpr int dq_bytes() { return (4 * Dims<D>::TILE + Dims<D>::PTILE) * 4; }
template <int D>
constexpr int dkdv_bytes() { return (4 * Dims<D>::TILE + 2 * Dims<D>::PTILE + 2 * BT) * 4; }

}  // namespace f32

// ---------------------------------------------------------------- bfloat16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;

template <int D>
struct Dims {
  static constexpr int LD = D + 8;    // [row][d] tiles, padded by 16 bytes
  static constexpr int TLD = BT + 8;  // transposed [d][row] tiles
  static constexpr int TILE = 64 * LD;
  static constexpr int TTILE = D * TLD;
};

// rows [row0, row0 + 64) of a (rows, H, D) head slice, zero at and past
// `limit`, to dst[r * ld + d] or, transposed, to dst[d * ld + r]
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void load_rows(const bf16* src, int row0, int limit, long pitch,
                                          bf16* dst, int ld) {
  constexpr int VECS = D / 8;
  for (int idx = threadIdx.x; idx < 64 * VECS; idx += THREADS) {
    const int r = idx / VECS;
    const int c = (idx % VECS) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) v = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * pitch + c);
    if (TRANSPOSE) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[(c + i) * ld + r] = e[i];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  }
}

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// the A fragments of the warp's 16 rows of a [row][d] tile
template <int D>
__device__ __forceinline__ void a_frags(const bf16* tile, int warp, int g, int t,
                                        uint32_t (&a)[D / 16][4]) {
  const bf16* w = tile + warp * 16 * Dims<D>::LD;
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc) {
    a[kc][0] = ld32(w + g * Dims<D>::LD + kc * 16 + 2 * t);
    a[kc][1] = ld32(w + (g + 8) * Dims<D>::LD + kc * 16 + 2 * t);
    a[kc][2] = ld32(w + g * Dims<D>::LD + kc * 16 + 8 + 2 * t);
    a[kc][3] = ld32(w + (g + 8) * Dims<D>::LD + kc * 16 + 8 + 2 * t);
  }
}

// out[nt] = A (16 x D, fragments) . rows nt*8.. of a [row][d] tile, for the
// 8 column tiles of a 64-row tile
template <int D>
__device__ __forceinline__ void scores(const uint32_t (&a)[D / 16][4], const bf16* tile, int g,
                                       int t, float (&out)[BT / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < BT / 8; ++nt) {
    out[nt][0] = out[nt][1] = out[nt][2] = out[nt][3] = 0.f;
    const bf16* r = tile + (nt * 8 + g) * Dims<D>::LD + 2 * t;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc) mma_bf16_16816(out[nt], a[kc], ld32(r + kc * 16), ld32(r + kc * 16 + 8));
  }
}

// acc += X (16 x 64, score registers re-packed as A) . T^T where T is a
// transposed [d][row] tile: contraction over the 64 walked rows
template <int D>
__device__ __forceinline__ void accumulate(const float (&x)[BT / 8][4], const bf16* tt, int g,
                                           int t, float (&acc)[D / 8][4]) {
#pragma unroll
  for (int kc = 0; kc < BT / 16; ++kc) {
    const uint32_t pa[4] = {pack_bf16(x[2 * kc][0], x[2 * kc][1]),
                            pack_bf16(x[2 * kc][2], x[2 * kc][3]),
                            pack_bf16(x[2 * kc + 1][0], x[2 * kc + 1][1]),
                            pack_bf16(x[2 * kc + 1][2], x[2 * kc + 1][3])};
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const bf16* r = tt + (nt * 8 + g) * Dims<D>::TLD + kc * 16 + 2 * t;
      mma_bf16_16816(acc[nt], pa, ld32(r), ld32(r + 8));
    }
  }
}

// Each warp owns 16 query rows: its q and dout fragments, scores, dP, dS and
// the 16 x D dq accumulator stay in registers; K arrives twice per tile, as
// [key][d] for S = q k^T and transposed for dq += dS k.
template <int D>
__global__ void __launch_bounds__(THREADS)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
          const bf16* __restrict__ o, const bf16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ delta, bf16* __restrict__ dq,
          int N, int M, int H, float qscale, float scale) {
  using S = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc);
  bf16* Os = Qs + S::TILE;
  bf16* Ks = Os + S::TILE;
  bf16* Vs = Ks + S::TILE;
  bf16* Kt = Vs + S::TILE;
  float* Ll = reinterpret_cast<float*>(Kt + S::TTILE);
  float* Dl = Ll + BQ;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const long pitch = (long)H * D;
  const long qoff = (long)b * N * pitch + (long)h * D;
  const long koff = (long)b * M * pitch + (long)h * D;

  load_rows<D, false>(q + qoff, q0, N, pitch, Qs, S::LD);
  load_rows<D, false>(dout + qoff, q0, N, pitch, Os, S::LD);
  {  // delta = rowsum(dout * o) and lse of the block's rows, two threads a row
    const int r = tid >> 1, half = tid & 1;
    const int n = q0 + r;
    float part = 0.f;
    if (n < N) {
      const bf16* orow = o + qoff + (long)n * pitch + half * (D / 2);
      const bf16* grow = dout + qoff + (long)n * pitch + half * (D / 2);
#pragma unroll 4
      for (int d = 0; d < D / 2; d += 4) {
        const float4 a = load4(orow + d), c = load4(grow + d);
        part += a.x * c.x + a.y * c.y + a.z * c.z + a.w * c.w;
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      Dl[r] = part;
      Ll[r] = n < N ? lse[(long)bh * N + n] : 0.f;
      if (n < N) delta[(long)bh * N + n] = part;
    }
  }
  __syncthreads();
  uint32_t qa[D / 16][4], oa[D / 16][4];
  a_frags<D>(Qs, warp, g, t, qa);
  a_frags<D>(Os, warp, g, t, oa);
  const float L0 = Ll[warp * 16 + g], L1 = Ll[warp * 16 + g + 8];
  const float D0 = Dl[warp * 16 + g], D1 = Dl[warp * 16 + g + 8];

  float acc[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int k0 = 0; k0 < M; k0 += BT) {
    __syncthreads();
    load_rows<D, false>(k + koff, k0, M, pitch, Ks, S::LD);
    load_rows<D, false>(v + koff, k0, M, pitch, Vs, S::LD);
    load_rows<D, true>(k + koff, k0, M, pitch, Kt, S::TLD);
    __syncthreads();
    float s[BT / 8][4], dp[BT / 8][4];
    scores<D>(qa, Ks, g, t, s);
    scores<D>(oa, Vs, g, t, dp);
    const int valid = M - k0;
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = nt * 8 + 2 * t + e < valid;
        const float p0 = in ? exp2f(s[nt][e] * qscale - L0) : 0.f;
        const float p1 = in ? exp2f(s[nt][2 + e] * qscale - L1) : 0.f;
        s[nt][e] = p0 * (dp[nt][e] - D0);  // ds
        s[nt][2 + e] = p1 * (dp[nt][2 + e] - D1);
      }
    accumulate<D>(s, Kt, g, t, acc);
  }

  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dq + qoff + (long)r0 * pitch + col) =
          pack_bf16(acc[nt][0] * scale, acc[nt][1] * scale);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(dq + qoff + (long)r1 * pitch + col) =
          pack_bf16(acc[nt][2] * scale, acc[nt][3] * scale);
  }
}

// Each warp owns 16 keys: their k and v fragments, S^T, dP^T, dS^T and the
// two 16 x D accumulators stay in registers; a query tile arrives as [q][d]
// for the scores and transposed for the two accumulations.
template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
            const bf16* __restrict__ dout, const float* __restrict__ lse,
            const float* __restrict__ delta, float* __restrict__ dk, float* __restrict__ dv,
            int N, int M, int H, float qscale, float scale, int q_per_split) {
  using S = Dims<D>;
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc);
  bf16* Vs = Ks + S::TILE;
  bf16* Qs = Vs + S::TILE;
  bf16* Os = Qs + S::TILE;
  bf16* Qt = Os + S::TILE;
  bf16* Ot = Qt + S::TTILE;
  float* Ls = reinterpret_cast<float*>(Ot + S::TTILE);
  float* Ds = Ls + BT;

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BQ;
  const int qbeg = blockIdx.z * q_per_split;
  const int qend = min(N, qbeg + q_per_split);
  const long pitch = (long)H * D;
  const long qoff = (long)b * N * pitch + (long)h * D;
  const long koff = (long)b * M * pitch + (long)h * D;

  load_rows<D, false>(k + koff, k0, M, pitch, Ks, S::LD);
  load_rows<D, false>(v + koff, k0, M, pitch, Vs, S::LD);
  __syncthreads();
  uint32_t ka[D / 16][4], va[D / 16][4];
  a_frags<D>(Ks, warp, g, t, ka);
  a_frags<D>(Vs, warp, g, t, va);

  float acc_k[D / 8][4], acc_v[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[nt][e] = acc_v[nt][e] = 0.f;

  for (int n0 = qbeg; n0 < qend; n0 += BT) {
    __syncthreads();
    load_rows<D, false>(q + qoff, n0, qend, pitch, Qs, S::LD);
    load_rows<D, false>(dout + qoff, n0, qend, pitch, Os, S::LD);
    load_rows<D, true>(q + qoff, n0, qend, pitch, Qt, S::TLD);
    load_rows<D, true>(dout + qoff, n0, qend, pitch, Ot, S::TLD);
    for (int idx = tid; idx < BT; idx += THREADS) {
      const int n = n0 + idx;
      Ls[idx] = n < qend ? lse[(long)bh * N + n] : INFINITY;
      Ds[idx] = n < qend ? delta[(long)bh * N + n] : 0.f;
    }
    __syncthreads();
    float st[BT / 8][4], dpt[BT / 8][4];
    scores<D>(ka, Qs, g, t, st);
    scores<D>(va, Os, g, t, dpt);
#pragma unroll
    for (int nt = 0; nt < BT / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = nt * 8 + 2 * t + e;
        const float lq = Ls[col], dq_ = Ds[col];
        const float p0 = exp2f(st[nt][e] * qscale - lq);  // 0 past the chunk
        const float p1 = exp2f(st[nt][2 + e] * qscale - lq);
        st[nt][e] = p0;
        st[nt][2 + e] = p1;
        dpt[nt][e] = p0 * (dpt[nt][e] - dq_);  // ds^T
        dpt[nt][2 + e] = p1 * (dpt[nt][2 + e] - dq_);
      }
    accumulate<D>(st, Ot, g, t, acc_v);
    accumulate<D>(dpt, Qt, g, t, acc_k);
  }

  const int key0 = k0 + warp * 16 + g;
  const int key1 = key0 + 8;
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (key0 < M) {
      const long at = koff + (long)key0 * pitch + col;
      atomicAdd(dk + at, acc_k[nt][0] * scale);
      atomicAdd(dk + at + 1, acc_k[nt][1] * scale);
      atomicAdd(dv + at, acc_v[nt][0]);
      atomicAdd(dv + at + 1, acc_v[nt][1]);
    }
    if (key1 < M) {
      const long at = koff + (long)key1 * pitch + col;
      atomicAdd(dk + at, acc_k[nt][2] * scale);
      atomicAdd(dk + at + 1, acc_k[nt][3] * scale);
      atomicAdd(dv + at, acc_v[nt][2]);
      atomicAdd(dv + at + 1, acc_v[nt][3]);
    }
  }
}

template <int D>
constexpr int dq_bytes() { return (4 * Dims<D>::TILE + Dims<D>::TTILE) * 2 + 2 * BQ * 4; }
template <int D>
constexpr int dkdv_bytes() { return (4 * Dims<D>::TILE + 2 * Dims<D>::TTILE) * 2 + 2 * BT * 4; }

}  // namespace tc

// query rows per dk/dv block: a multiple of BT, few enough chunks that the
// (key tiles x B*H x chunks) grid covers the SMs twice
int rows_per_split(int N, int M, int BH) {
  const int key_blocks = ((M + BQ - 1) / BQ) * BH;
  const int tiles = (N + BT - 1) / BT;
  int split = (SM_TARGET + key_blocks - 1) / key_blocks;
  split = max(1, min(split, tiles));
  return ((tiles + split - 1) / split) * BT;
}

template <int D, bool BF>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, void* dq, float* dk, float* dv, int B, int N,
                   int M, int H, float scale, cudaStream_t stream) {
  using T = typename std::conditional<BF, __nv_bfloat16, float>::type;
  const float qscale = scale * LOG2E;
  const int BH = B * H;
  const int per = rows_per_split(N, M, BH);
  const dim3 grid_dq((N + BQ - 1) / BQ, BH);
  const dim3 grid_kv((M + BQ - 1) / BQ, BH, (N + per - 1) / per);
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* to = static_cast<const T*>(o);
  const T* tg = static_cast<const T*>(dout);
  cudaError_t err;
  if constexpr (BF) {
    auto kdq = tc::dq_kernel<D>;
    auto kkv = tc::dkdv_kernel<D>;
    constexpr int b1 = tc::dq_bytes<D>(), b2 = tc::dkdv_bytes<D>();
    if ((err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, b1))) return err;
    if ((err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, b2))) return err;
    kdq<<<grid_dq, THREADS, b1, stream>>>(tq, tk, tv, to, tg, lse, delta, static_cast<T*>(dq),
                                          N, M, H, qscale, scale);
    if ((err = cudaGetLastError())) return err;
    kkv<<<grid_kv, THREADS, b2, stream>>>(tq, tk, tv, tg, lse, delta, dk, dv, N, M, H, qscale,
                                          scale, per);
  } else {
    auto kdq = f32::dq_kernel<D>;
    auto kkv = f32::dkdv_kernel<D>;
    constexpr int b1 = f32::dq_bytes<D>(), b2 = f32::dkdv_bytes<D>();
    if ((err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, b1))) return err;
    if ((err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, b2))) return err;
    kdq<<<grid_dq, THREADS, b1, stream>>>(tq, tk, tv, to, tg, lse, delta, static_cast<T*>(dq),
                                          N, M, H, qscale, scale);
    if ((err = cudaGetLastError())) return err;
    kkv<<<grid_kv, THREADS, b2, stream>>>(tq, tk, tv, tg, lse, delta, dk, dv, N, M, H, qscale,
                                          scale, per);
  }
  return cudaGetLastError();
}

}  // namespace
