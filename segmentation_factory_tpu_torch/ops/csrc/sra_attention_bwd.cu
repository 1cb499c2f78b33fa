// K1b: spatial-reduction attention backward. Given q (B, N, H, D), k and v
// (B, M, H, D), the forward output o, its cotangent dout (both like q) and
// the forward's per-row log2-domain log-sum-exp lse (B, H, N), writes
// dq (like q) and accumulates dk, dv into zeroed float32 (B, M, H, D)
// buffers. With s = q k^T * scale and p = softmax(s):
//   delta = rowsum(dout * o), dp = dout v^T, ds = p * (dp - delta),
//   dq = ds k * scale, dk = ds^T q * scale, dv = p^T dout,
// and, where asked, the column sums of dq (the attention half-block's dbq,
// ops/block.py, which runs this core on its own q, o and dout).
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_attention.py
// `_backward` (:164, body `_bwd_kernel` :120), which recomputes p for a
// q-tile with one exact softmax over all of M in VMEM, writes dq and
// accumulates dk/dv across the sequential q-tile grid.
//
// What bounds it on the H100: operations (five N x M x D products against
// q/k/v/o/dout read once). Hopper has no sequential grid, so this is
// FlashAttention-2's split into two kernels, both reading p back from the
// forward's lse instead of re-running the softmax:
// - dq: a block owns 64 query rows. It writes their delta and lse, padded
//   to a multiple of 64 rows (0 and +inf, so p = 0 there and no tile loop
//   checks rows), for the dk/dv kernel, walks K/V in 64-key tiles (S, dP,
//   dS, dQ += dS K), then adds the column sums of its dq rows to dbq;
// - dk/dv: a block owns 64 keys and walks a chunk of the query rows (S^T,
//   dP^T, dV += P^T dout, dK += dS^T q). At stage 1 a block per key tile
//   gives only B*H*M/64 = 32 blocks, so N is split into chunks, as many as
//   fill the card's resident blocks in the fewest waves (rows_per_split);
//   the chunks' partial dk/dv meet through float32 atomicAdd (one per
//   element per chunk) in the zeroed buffers.
// - bfloat16 (the training path): Hopper's wgmma and TMA, laid out as K1f
//   (sra_attention.cu): a producer warp loads the block's own tiles once
//   and the walked tiles into a two-stage ring (TMA, mbarriers; dk/dv's
//   lse and delta rows by bulk copy), one consumer warpgroup owns the 64
//   rows. The score-like products (S and dP, or S^T and dP^T) run on wgmma
//   with both operands K-major in shared memory; p and ds are formed in the
//   accumulator registers and re-packed as wgmma's register A operand for
//   dQ += dS K, dV += P^T dout and dK += dS^T q, whose B operand (K, dout
//   or q as loaded) is read MN-major through the transpose bit: no tile is
//   stored twice or transposed element-wise. p and ds are rounded to
//   bfloat16 as A operands; every sum is float32.
// - float32 (the check path): plain FMAs from shared memory, the forward's
//   float32 layout.
#include "common.cuh"
#include "sm90.cuh"

namespace {

constexpr int BQ = 64;          // rows the block owns (queries for dq, keys for dk/dv)
constexpr int BT = 64;          // rows of the tiles it walks (keys for dq, queries for dk/dv)
constexpr int THREADS = 128;    // float32 kernels
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
          const float* __restrict__ lse, float* __restrict__ lsep, float* __restrict__ delta,
          float* __restrict__ dq, float* __restrict__ dbq, int N, int npad, int M, int H,
          float qscale, float scale) {
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
  // delta = rowsum(dout * o) from the 8 lanes of a row group; with the lse
  // written for the dk/dv kernel (rows past N: 0 and +inf, so p = 0)
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
    lrow[i] = n < N ? lse[(long)bh * N + n] : INFINITY;
    if (cg == 0) {
      delta[(long)bh * npad + n] = part;
      lsep[(long)bh * npad + n] = lrow[i];
    }
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
  for (int c = 0; c < DC; ++c) {
    float4 cs = make_float4(0.f, 0.f, 0.f, 0.f);  // column sums of the rows (zero past N)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float4 r = acc[i][c];
      r.x *= scale; r.y *= scale; r.z *= scale; r.w *= scale;
      cs.x += r.x; cs.y += r.y; cs.z += r.z; cs.w += r.w;
      const int n = q0 + rg * 4 + i;
      if (n < N) store4(dq + qoff + (long)n * pitch + cg * 4 + 32 * c, r);
    }
    if (dbq == nullptr) continue;
    // the warp's 4 row groups are lanes cg, cg + 8, cg + 16, cg + 24
#pragma unroll
    for (int m = 8; m < 32; m <<= 1) {
      cs.x += __shfl_xor_sync(0xffffffffu, cs.x, m);
      cs.y += __shfl_xor_sync(0xffffffffu, cs.y, m);
      cs.z += __shfl_xor_sync(0xffffffffu, cs.z, m);
      cs.w += __shfl_xor_sync(0xffffffffu, cs.w, m);
    }
    if ((tid & 31) < 8) {
      float* at = dbq + h * D + cg * 4 + 32 * c;
      atomicAdd(at, cs.x);
      atomicAdd(at + 1, cs.y);
      atomicAdd(at + 2, cs.z);
      atomicAdd(at + 3, cs.w);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(THREADS)
dkdv_kernel(const float* __restrict__ q, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ dout,
            const float* __restrict__ lsep, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int N, int npad, int M, int H,
            float qscale, float scale, int q_per_split) {
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
      Ls[idx] = n < qend ? lsep[(long)bh * npad + n] : INFINITY;
      Ds[idx] = n < qend ? delta[(long)bh * npad + n] : 0.f;
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

// The blocks of `kern` that the card holds at once.
template <typename Kern>
int resident_blocks(Kern kern, int threads, int smem) {
  int dev = 0, sms = 132, per_sm = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  return max(per_sm, 1) * sms;
}

// Query rows per dk/dv block, a multiple of BT: the chunk length whose
// grid (key tiles x B*H x chunks) takes the fewest block-tile steps, counted
// as waves of `places` resident blocks times the tiles each block walks plus
// one for its prologue and epilogue.
int rows_per_split(long places, int N, int M, int BH) {
  const long key_blocks = (long)sm90::cdiv(M, BQ) * BH;
  const int tiles = sm90::cdiv(N, BT);
  int best = tiles;
  long best_cost = -1;
  for (int split = 1; split <= tiles; ++split) {
    const int per = sm90::cdiv(tiles, split);
    const long blocks = key_blocks * sm90::cdiv(tiles, per);
    const long cost = (blocks + places - 1) / places * (per + 1);
    if (best_cost < 0 || cost < best_cost) {
      best_cost = cost;
      best = per;
    }
  }
  return best * BT;
}

// ---------------------------------------------------------------- bfloat16: wgmma + TMA
namespace wg {

using bf16 = __nv_bfloat16;
using namespace sm90;
constexpr int STAGES = 2;                // walked tiles in flight
constexpr int CONSUMERS = 128;           // one warpgroup: 16 of the block's rows per warp
constexpr int WG_THREADS = CONSUMERS + 32;  // + the producer warp

template <int D>
struct Tiles {
  static constexpr int ROW = D * 2;      // bytes per row = the swizzle (128 or 64)
  static constexpr int TILE = 64 * ROW;
};

// dq: Q and dO once, K and V per stage; the dbq partials of the 4 warps
template <int D>
struct DqLayout : Tiles<D> {
  static constexpr int T = Tiles<D>::TILE;
  static constexpr int Q = 0, DO = T, K = 2 * T, V = K + STAGES * T;
  static constexpr int RED = V + STAGES * T;             // float [4][D]
  static constexpr int BAR = RED + 4 * D * 4;            // full[STAGES], empty[STAGES], q
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// dk/dv: K and V once, Q, dO and 64 rows' lse and delta per stage
template <int D>
struct KvLayout : Tiles<D> {
  static constexpr int T = Tiles<D>::TILE;
  static constexpr int K = 0, V = T, Q = 2 * T, DO = Q + STAGES * T;
  static constexpr int ROWS = DO + STAGES * T;           // per stage: lse[64], delta[64]
  static constexpr int BAR = ROWS + STAGES * 2 * BT * 4;  // full[STAGES], empty[STAGES], kv
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;
};

// The (kc)-th 16-wide slice of a 64-row tile as a K-major operand (its D
// columns contiguous) and as an MN-major one (16 rows of it, the contraction
// over rows).
template <int D>
__device__ __forceinline__ uint64_t kmajor(const uint8_t* tile, int kc) {
  return make_desc(tile + kc * 32, Tiles<D>::ROW, false);
}
template <int D>
__device__ __forceinline__ uint64_t mnmajor(const uint8_t* tile, int kc) {
  return make_desc(tile + kc * 16 * Tiles<D>::ROW, Tiles<D>::ROW, true);
}

// acc (64 x D) += A (64 x 64, register fragments) . tile (64 rows x D) over
// the tile's rows
template <int D>
__device__ __forceinline__ void rows_product(float (&acc)[D / 2], const uint32_t (&a)[4][4],
                                             const uint8_t* tile) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc) {
    if constexpr (D == 64) wgmma_rs_m64n64<1>(acc, a[kc], mnmajor<D>(tile, kc));
    else wgmma_rs_m64n32<1>(acc, a[kc], mnmajor<D>(tile, kc));
  }
}

// x (64 x 64) = A (64 rows of a tile) . B (64 rows of another)^T over D,
// both K-major in shared memory (issued, not committed)
template <int D>
__device__ __forceinline__ void scores(float (&x)[32], const uint8_t* a, const uint8_t* b) {
#pragma unroll
  for (int kc = 0; kc < D / 16; ++kc)
    wgmma_ss_m64n64<0, 0>(x, kmajor<D>(a, kc), kmajor<D>(b, kc), kc > 0);
}

// a 64 x 64 accumulator tile as four 16-column A fragments, rounded to bf16
__device__ __forceinline__ void pack_a(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kc = 0; kc < 4; ++kc)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[kc][r] = pack_bf16(x[8 * kc + 2 * r], x[8 * kc + 2 * r + 1]);
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

// One block owns 64 query rows of one (batch, head); accumulator layout of
// warp w, lane 4 g + t: x[4 j + 2 hh + e] = X[16 w + g + 8 hh][8 j + 2 t + e].
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
dq_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
          const bf16* __restrict__ o, const bf16* __restrict__ dout,
          const float* __restrict__ lse, float* __restrict__ lsep, float* __restrict__ delta,
          bf16* __restrict__ dq, float* __restrict__ dbq, int N, int npad, int M, int H,
          float qscale, float scale) {
  using L = DqLayout<D>;
  extern __shared__ uint8_t dq_smem[];
  uint8_t* base = align_1024(dq_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 64;
  const int ntiles = cdiv(M, 64);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_init(qbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer
    if ((tid & 31) == 0) {
      mbar_expect_tx(qbar, 2 * L::T);
      tma_load_4d(base + L::Q, &tq, qbar, 0, h, q0, b);
      tma_load_4d(base + L::DO, &tdo, qbar, 0, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * L::T);
        tma_load_4d(base + L::K + s * L::T, &tk, full + s, 0, h, t * 64, b);
        tma_load_4d(base + L::V + s * L::T, &tv, full + s, 0, h, t * 64, b);
      }
    }
    return;
  }

  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  const int r0 = q0 + warp * 16 + g, r1 = r0 + 8;  // the lane's rows
  const long pitch = (long)H * D;
  const long qoff = (long)b * N * pitch + (long)h * D;
  // delta = rowsum(dout * o), a quarter of each row per lane of the quad,
  // and the lse; both written for the dk/dv kernel (rows past N: 0 and
  // +inf, so p = 0), while the producer's first loads are in flight
  auto row = [&](int r, float& l, float& d) {
    d = 0.f;
    l = INFINITY;
    if (r < N) {
      const long at = qoff + (long)r * pitch + t4 * (D / 4);
#pragma unroll
      for (int c = 0; c < D / 4; c += 4) {
        const float4 a = load4(o + at + c), gg = load4(dout + at + c);
        d += a.x * gg.x + a.y * gg.y + a.z * gg.z + a.w * gg.w;
      }
      l = lse[(long)bh * N + r];
    }
    d += __shfl_xor_sync(0xffffffffu, d, 1);
    d += __shfl_xor_sync(0xffffffffu, d, 2);
    if (t4 == 0) {
      delta[(long)bh * npad + r] = d;
      lsep[(long)bh * npad + r] = l;
    }
  };
  float L0, L1, D0, D1;
  row(r0, L0, D0);
  row(r1, L1, D1);
  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  float sc[32], dp[32];
  uint32_t da[4][4];
  mbar_wait(qbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(full + s, (t / STAGES) & 1);
    const uint8_t* ks = base + L::K + s * L::T;
    fence_regs(sc);
    fence_regs(dp);
    wgmma_fence();
    scores<D>(sc, base + L::Q, ks);
    scores<D>(dp, base + L::DO, base + L::V + s * L::T);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(sc);
    fence_regs(dp);
    // p = 2^(s * qscale - lse), ds = p (dp - delta); keys past M (zero rows
    // of K, only in the last tile) get p = 0
    const int valid = M - t * 64;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool in = j * 8 + 2 * t4 + e < valid;
        const float p0 = in ? fast_exp2(fmaf(sc[4 * j + e], qscale, -L0)) : 0.f;
        const float p1 = in ? fast_exp2(fmaf(sc[4 * j + 2 + e], qscale, -L1)) : 0.f;
        dp[4 * j + e] = p0 * (dp[4 * j + e] - D0);
        dp[4 * j + 2 + e] = p1 * (dp[4 * j + 2 + e] - D1);
      }
    pack_a(dp, da);
    wgmma_fence();
    rows_product<D>(acc, da, ks);  // dQ += dS K
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    fence_regs(da);
    mbar_arrive(empty + s);
  }

  // dq rounded to bf16; rows past N hold zeros (p = 0) and are not stored
  bf16* dqb = dq + qoff;
  float cs[D / 4];  // the lane's column sums of its two rows
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int col = j * 8 + 2 * t4;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[4 * j + e] = round_bf16(acc[4 * j + e] * scale);
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(dqb + (long)r0 * pitch + col) =
          pack_bf16(acc[4 * j], acc[4 * j + 1]);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(dqb + (long)r1 * pitch + col) =
          pack_bf16(acc[4 * j + 2], acc[4 * j + 3]);
    cs[2 * j] = acc[4 * j] + acc[4 * j + 2];
    cs[2 * j + 1] = acc[4 * j + 1] + acc[4 * j + 3];
  }
  if (dbq == nullptr) return;
  float* red = reinterpret_cast<float*>(base + L::RED);
#pragma unroll
  for (int i = 0; i < D / 4; ++i) {
#pragma unroll
    for (int m = 4; m < 32; m <<= 1) cs[i] += __shfl_xor_sync(0xffffffffu, cs[i], m);
    if (g == 0) red[warp * D + (i >> 1) * 8 + 2 * t4 + (i & 1)] = cs[i];
  }
  bar_sync(1, CONSUMERS);
  if (tid < D) atomicAdd(dbq + h * D + tid, red[tid] + red[D + tid] + red[2 * D + tid] + red[3 * D + tid]);
}

// One block owns 64 keys of one (batch, head) and walks the query tiles of
// its chunk; rows are keys, columns queries (S^T, dP^T).
template <int D>
__global__ void __launch_bounds__(WG_THREADS)
dkdv_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv, const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lsep, const float* __restrict__ delta,
            float* __restrict__ dk, float* __restrict__ dv, int N, int npad, int M, int H,
            float qscale, float scale, int q_per_split) {
  using L = KvLayout<D>;
  extern __shared__ uint8_t kv_smem[];
  uint8_t* base = align_1024(kv_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* kvbar = empty + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * 64;
  const int qbeg = blockIdx.z * q_per_split;
  const int ntiles = cdiv(min(N, qbeg + q_per_split) - qbeg, 64);
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    mbar_init(kvbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer
    if ((tid & 31) == 0) {
      mbar_expect_tx(kvbar, 2 * L::T);
      tma_load_4d(base + L::K, &tk, kvbar, 0, h, k0, b);
      tma_load_4d(base + L::V, &tv, kvbar, 0, h, k0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES, n0 = qbeg + t * 64;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * L::T + 2 * BT * 4);
        tma_load_4d(base + L::Q + s * L::T, &tq, full + s, 0, h, n0, b);
        tma_load_4d(base + L::DO + s * L::T, &tdo, full + s, 0, h, n0, b);
        float* rows = reinterpret_cast<float*>(base + L::ROWS) + s * 2 * BT;
        bulk_load(rows, lsep + (long)bh * npad + n0, BT * 4, full + s);
        bulk_load(rows + BT, delta + (long)bh * npad + n0, BT * 4, full + s);
      }
    }
    return;
  }

  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  float acc_k[D / 2], acc_v[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  float st[32], dpt[32];
  uint32_t pa[4][4], da[4][4];
  mbar_wait(kvbar, 0);
  for (int t = 0; t < ntiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(full + s, (t / STAGES) & 1);
    const uint8_t* qs = base + L::Q + s * L::T;
    const uint8_t* dos = base + L::DO + s * L::T;
    fence_regs(st);
    fence_regs(dpt);
    wgmma_fence();
    scores<D>(st, base + L::K, qs);
    scores<D>(dpt, base + L::V, dos);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(st);
    fence_regs(dpt);
    // p^T = 2^(s^T * qscale - lse), ds^T = p^T (dp^T - delta) per query
    // column; queries past N have lse +inf (p = 0)
    const float* lr = reinterpret_cast<const float*>(base + L::ROWS) + s * 2 * BT;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l = *reinterpret_cast<const float2*>(lr + j * 8 + 2 * t4);
      const float2 d = *reinterpret_cast<const float2*>(lr + BT + j * 8 + 2 * t4);
#pragma unroll
      for (int i = 4 * j; i < 4 * j + 4; i += 2) {
        st[i] = fast_exp2(fmaf(st[i], qscale, -l.x));
        st[i + 1] = fast_exp2(fmaf(st[i + 1], qscale, -l.y));
        dpt[i] = st[i] * (dpt[i] - d.x);
        dpt[i + 1] = st[i + 1] * (dpt[i + 1] - d.y);
      }
    }
    pack_a(st, pa);
    pack_a(dpt, da);
    wgmma_fence();
    rows_product<D>(acc_v, pa, dos);  // dV += P^T dO
    rows_product<D>(acc_k, da, qs);   // dK += dS^T Q
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc_v);
    fence_regs(acc_k);
    fence_regs(pa);
    fence_regs(da);
    mbar_arrive(empty + s);
  }

  const int key0 = k0 + warp * 16 + g;
  const long pitch = (long)H * D;
  const long koff = (long)b * M * pitch + (long)h * D;
#pragma unroll
  for (int j = 0; j < D / 8; ++j)
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int key = key0 + 8 * hh;
      if (key >= M) continue;
      const long at = koff + (long)key * pitch + j * 8 + 2 * t4;
      const int i = 4 * j + 2 * hh;
      // one vector atomic per column pair (sm_90)
      atomicAdd(reinterpret_cast<float2*>(dk + at),
                make_float2(acc_k[i] * scale, acc_k[i + 1] * scale));
      atomicAdd(reinterpret_cast<float2*>(dv + at), make_float2(acc_v[i], acc_v[i + 1]));
    }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, const float* lse, float* lsep, float* delta, void* dq,
                   float* dk, float* dv, float* dbq, int B, int N, int npad, int M, int H,
                   float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv, tdo;
  cudaError_t err = head_map(&tq, q, B, N, H, D);
  if (err == cudaSuccess) err = head_map(&tk, k, B, M, H, D);
  if (err == cudaSuccess) err = head_map(&tv, v, B, M, H, D);
  if (err == cudaSuccess) err = head_map(&tdo, dout, B, N, H, D);
  if (err != cudaSuccess) return err;
  auto kdq = dq_kernel<D>;
  auto kkv = dkdv_kernel<D>;
  constexpr int b1 = DqLayout<D>::BYTES, b2 = KvLayout<D>::BYTES;
  if ((err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, b1))) return err;
  if ((err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, b2))) return err;
  const float qscale = scale * LOG2E;
  static const int places = resident_blocks(kkv, WG_THREADS, b2);
  const int per = rows_per_split(places, N, M, B * H);
  kdq<<<dim3(npad / 64, B * H), WG_THREADS, b1, stream>>>(
      tq, tk, tv, tdo, static_cast<const bf16*>(o), static_cast<const bf16*>(dout), lse, lsep,
      delta, static_cast<bf16*>(dq), dbq, N, npad, M, H, qscale, scale);
  if ((err = cudaGetLastError())) return err;
  kkv<<<dim3(cdiv(M, 64), B * H, cdiv(N, per)), WG_THREADS, b2, stream>>>(
      tq, tk, tv, tdo, lsep, delta, dk, dv, N, npad, M, H, qscale, scale, per);
  return cudaGetLastError();
}

}  // namespace wg

template <int D, bool BF>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   const float* lse, float* delta, float* lsep, void* dq, float* dk, float* dv,
                   float* dbq, int B, int N, int M, int H, float scale, cudaStream_t stream) {
  const int npad = (N + BT - 1) / BT * BT;
  if constexpr (BF) {
    return wg::launch<D>(q, k, v, o, dout, lse, lsep, delta, dq, dk, dv, dbq, B, N, npad, M, H,
                         scale, stream);
  }
  const float qscale = scale * LOG2E;
  const float* tq = static_cast<const float*>(q);
  const float* tk = static_cast<const float*>(k);
  const float* tv = static_cast<const float*>(v);
  const float* tg = static_cast<const float*>(dout);
  auto kdq = f32::dq_kernel<D>;
  auto kkv = f32::dkdv_kernel<D>;
  constexpr int b1 = f32::dq_bytes<D>(), b2 = f32::dkdv_bytes<D>();
  cudaError_t err;
  if ((err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, b1))) return err;
  if ((err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, b2))) return err;
  static const int places = resident_blocks(kkv, THREADS, b2);
  const int per = rows_per_split(places, N, M, B * H);
  kdq<<<dim3(npad / BQ, B * H), THREADS, b1, stream>>>(
      tq, tk, tv, static_cast<const float*>(o), tg, lse, lsep, delta, static_cast<float*>(dq),
      dbq, N, npad, M, H, qscale, scale);
  if ((err = cudaGetLastError())) return err;
  kkv<<<dim3((M + BQ - 1) / BQ, B * H, (N + per - 1) / per), THREADS, b2, stream>>>(
      tq, tk, tv, tg, lsep, delta, dk, dv, N, npad, M, H, qscale, scale, per);
  return cudaGetLastError();
}

}  // namespace

// lse: the forward's (B, H, N) float32 log-sum-exps. delta, lsep: (B, H,
// npad) float32, npad = N rounded up to 64: the dq kernel writes delta =
// rowsum(dout * o) and the lse there, padded, for the dk/dv kernel. dk, dv: zeroed (B, M, H, D) float32. dbq: null, or a
// zeroed (H * D) float32 to which the column sums of dq are added.
SFT_EXPORT int sft_sra_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* delta, void* lsep,
                                     void* dq, void* dk, void* dv, void* dbq, int B, int N, int M,
                                     int H, int D, float scale, int dtype, void* stream) {
  if (B < 1 || N < 1 || M < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  auto f = [](void* p) { return static_cast<float*>(p); };
  const bool bf = dtype == SFT_BF16;
  if (!bf && dtype != SFT_F32) return cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return bf ? launch<32, true>(q, k, v, o, dout, l, f(delta), f(lsep), dq, f(dk), f(dv),
                                   f(dbq), B, N, M, H, scale, st)
                : launch<32, false>(q, k, v, o, dout, l, f(delta), f(lsep), dq, f(dk), f(dv),
                                    f(dbq), B, N, M, H, scale, st);
    case 64:
      return bf ? launch<64, true>(q, k, v, o, dout, l, f(delta), f(lsep), dq, f(dk), f(dv),
                                   f(dbq), B, N, M, H, scale, st)
                : launch<64, false>(q, k, v, o, dout, l, f(delta), f(lsep), dq, f(dk), f(dv),
                                    f(dbq), B, N, M, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
