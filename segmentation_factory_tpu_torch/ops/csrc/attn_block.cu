// K3f: the attention half-block of a MiT block, forward,
//   out = x + fac[b] * (attn(LN1(x) Wq^T + bq, K, V) Wo^T + bo)
// for tokens x (B, N, C), K and V (B, M, C) from the kv Linear (head h at
// columns h*D ..), Wq and Wo (C, C) as (out, in), LN1's scale and bias
// float32, and the per-image drop-path factor fac (B,) float32.
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_block.py
// `_attn_forward` (:268, body `_attn_fwd_kernel` :97), which normalises a row
// tile in VMEM, projects q per head, takes one exact softmax over all of M,
// and adds the out projection and the drop-path residual before the single
// write of the tile.
//
// What bounds it on the H100: operations. Per token 4*M*C flops of attention
// and 4*C*C of projections against 2*C elements of x and out, far above the
// card's ~295 bf16 flops per byte. The activation is read once and written
// once, as on the TPU; q, the scores and the attention output stay on chip.
// The TPU kernel's one exact softmax over M becomes an online softmax over
// 64-key tiles (running max and sum in float32, exp2 of log2e-scaled
// scores): the same function.
// - bfloat16 (the serving and training path; namespace k3 below): one
//   launch, a block of one producer warp and one consumer warpgroup owning
//   64 tokens of one image and all its heads; every product on wgmma, every
//   weight and K/V tile brought by TMA into rings of swizzled shared memory,
//   the attention itself K1f's core (attn_fwd_core.cuh).
// - float32 (the check path; attn_block_kernel): a block of 128 threads,
//   each warp 16 of the 64 tokens, on FMAs through mma.sync's fragment
//   layout (frag.cuh): LN1 into shared memory; per head q_h in registers,
//   K/V in 64-key tiles with the online softmax, the head's output into a
//   64 x C tile; then the out projection, 32 columns at a time, + bo, times
//   fac, + x.
// In training the kernel also writes the attention output (B, N, C) and each
// row's log2-domain log-sum-exp per head (B, H, N), which K3b reads instead
// of re-running the softmax.
#include "attn_fwd_core.cuh"
#include "frag.cuh"

// Layouts: tokens x (B, N, C) and k, v (B, M, C) in the kv Linear's layout,
// head h at columns h*D .. h*D + D - 1, so no transpose is needed; weights as
// (out, in) row-major.
namespace ab {

constexpr int BQ = 64;        // token rows a block owns: 16 per warp
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 320;    // MiT stages 1-3 (the fused configuration's widths)
constexpr float LOG2E = 1.4426950408889634f;

// LayerNorm of rows row0 .. row0 + 63 of x (rows, C), flax's math in float32
// (fast variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6), rounded to T into
// dst[r * ld + c]; rows at and past `nvalid` are zero.
template <typename T>
__device__ void ln_rows(const T* __restrict__ x, long row0, int nvalid, int C,
                        const float* __restrict__ lg, const float* __restrict__ lb, T* dst,
                        int ld) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BQ; r += WARPS) {
    T* d = dst + r * ld;
    if (r >= nvalid) {
      for (int c = lane; c < C; c += 32) d[c] = from_f32<T>(0.f);
      continue;
    }
    const T* xr = x + (row0 + r) * C;
    const float2 st = warp_ln_stats(xr, C);
    for (int c = lane; c < C; c += 32)
      d[c] = from_f32<T>((to_f32(xr[c]) - st.x) * st.y * lg[c] + lb[c]);
  }
}

// rows row0 .. row0 + 63 of a head slice (row stride `pitch`), zero at and
// past `limit`, to dst[r * ld + d] or, transposed, to dst[d * ld + r]
template <typename T, int D, bool TRANSPOSE>
__device__ __forceinline__ void load_rows(const T* __restrict__ src, int row0, int limit,
                                          int pitch, T* dst, int ld) {
  constexpr int VE = 16 / sizeof(T);  // elements per 16-byte vector
  constexpr int VECS = D / VE;
  for (int idx = threadIdx.x; idx < 64 * VECS; idx += THREADS) {
    const int r = idx / VECS;
    const int c = (idx % VECS) * VE;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < limit) v = *reinterpret_cast<const uint4*>(src + (long)(row0 + r) * pitch + c);
    if (TRANSPOSE) {
      const T* e = reinterpret_cast<const T*>(&v);
#pragma unroll
      for (int i = 0; i < VE; ++i) dst[(c + i) * ld + r] = e[i];
    } else {
      *reinterpret_cast<uint4*>(dst + r * ld + c) = v;
    }
  }
}

// out[nt] = A (the warp's 16 rows, D wide, as fragments) . rows 8 nt .. of a
// [row][d] tile: the 8 score tiles of a 64-row tile
template <typename T, int D>
__device__ __forceinline__ void scores(const typename Frag<T>::pair (&a)[D / 16][4], const T* tile,
                                       int ld, float (&out)[BK / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int nt = 0; nt < BK / 8; ++nt) {
    out[nt][0] = out[nt][1] = out[nt][2] = out[nt][3] = 0.f;
    const T* r = tile + (nt * 8 + g) * ld + 2 * t;
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      Frag<T>::mma(out[nt], a[kc], Frag<T>::load(r + kc * 16), Frag<T>::load(r + kc * 16 + 8));
  }
}

// acc += X (16 x 64 score registers, rounded to T as the A operand) . T^T
// for a transposed [d][row] tile: the contraction over the 64 walked rows
template <typename T, int D>
__device__ __forceinline__ void accumulate(const float (&x)[BK / 8][4], const T* tt, int ld,
                                           float (&acc)[D / 8][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  typename Frag<T>::pair pa[BK / 16][4];
  repack<T, BK / 16>(x, pa);
#pragma unroll
  for (int kc = 0; kc < BK / 16; ++kc) {
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const T* r = tt + (nt * 8 + g) * ld + kc * 16 + 2 * t;
      Frag<T>::mma(acc[nt], pa[kc], Frag<T>::load(r), Frag<T>::load(r + 8));
    }
  }
}

// q_h = LN rows (16 of the warp, in shared memory) . Wq_h^T + bq_h, rounded
// to T as A fragments
template <typename T, int D>
__device__ __forceinline__ void project_q(const T* lw, int ld, const T* __restrict__ wq,
                                          const T* __restrict__ bq, int C, int h,
                                          typename Frag<T>::pair (&qa)[D / 16][4]) {
  const int t = threadIdx.x & 3;
  float acc[D / 8][4];
  zero_acc(acc);
  rowmm<T, D / 8>(lw, ld, wq, C, h * D, acc);
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    const int col = h * D + nt * 8 + 2 * t;
    const float b0 = to_f32(bq[col]), b1 = to_f32(bq[col + 1]);
    acc[nt][0] += b0;
    acc[nt][1] += b1;
    acc[nt][2] += b0;
    acc[nt][3] += b1;
  }
  repack<T, D / 16>(acc, qa);
}

}  // namespace ab

namespace {

using namespace ab;

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_block_kernel(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ v,
                  const float* __restrict__ lg, const float* __restrict__ lb,
                  const T* __restrict__ wq, const T* __restrict__ bq, const T* __restrict__ wo,
                  const T* __restrict__ bo, const float* __restrict__ fac, T* __restrict__ out,
                  T* __restrict__ o_save, float* __restrict__ lse, int N, int M, int C,
                  float qscale) {
  using F = Frag<T>;
  const int H = C / D;
  const int LD = C + 8, KLD = D + 8, VLD = BK + 8;
  extern __shared__ __align__(16) unsigned char smem_ab[];
  T* Ls = reinterpret_cast<T*>(smem_ab);  // LN1 rows [row][c]
  T* Os = Ls + BQ * LD;                    // attention output rows [row][c]
  T* Ks = Os + BQ * LD;                    // K tile [key][d]
  T* Vt = Ks + BK * KLD;                   // V tile transposed [d][key]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const T* xb = x + (long)b * N * C;
  ln_rows<T>(xb, q0, min(BQ, N - q0), C, lg, lb, Ls, LD);
  __syncthreads();

  const T* Lw = Ls + warp * 16 * LD;
  T* Ow = Os + warp * 16 * LD;
  const int r0 = q0 + warp * 16 + g;  // this lane's rows r0 and r0 + 8
  const int r1 = r0 + 8;
  for (int h = 0; h < H; ++h) {
    typename F::pair qa[D / 16][4];
    project_q<T, D>(Lw, LD, wq, bq, C, h, qa);
    const T* kh = k + (long)b * M * C + h * D;
    const T* vh = v + (long)b * M * C + h * D;
    float acc[D / 8][4];
    zero_acc(acc);
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;
    for (int k0 = 0; k0 < M; k0 += BK) {
      __syncthreads();  // the previous tile's readers are done
      load_rows<T, D, false>(kh, k0, M, C, Ks, KLD);
      load_rows<T, D, true>(vh, k0, M, C, Vt, VLD);
      __syncthreads();
      float s[BK / 8][4];
      scores<T, D>(qa, Ks, KLD, s);
      // online softmax on log2e-scaled scores; keys past M get -inf (key 0
      // of a tile is always valid)
      const int valid = M - k0;
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = nt * 8 + 2 * t + e < valid;
          s[nt][e] = in ? s[nt][e] * qscale : -INFINITY;
          s[nt][2 + e] = in ? s[nt][2 + e] * qscale : -INFINITY;
          mx0 = fmaxf(mx0, s[nt][e]);
          mx1 = fmaxf(mx1, s[nt][2 + e]);
        }
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float n0 = fmaxf(m0, mx0), n1 = fmaxf(m1, mx1);
      const float c0 = exp2f(m0 - n0), c1 = exp2f(m1 - n1);
      m0 = n0;
      m1 = n1;
      float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt) {
        s[nt][0] = exp2f(s[nt][0] - n0);
        s[nt][1] = exp2f(s[nt][1] - n0);
        s[nt][2] = exp2f(s[nt][2] - n1);
        s[nt][3] = exp2f(s[nt][3] - n1);
        ps0 += s[nt][0] + s[nt][1];
        ps1 += s[nt][2] + s[nt][3];
      }
      l0 = l0 * c0 + ps0;  // this lane's share of the row sums
      l1 = l1 * c1 + ps1;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt) {
        acc[nt][0] *= c0;
        acc[nt][1] *= c0;
        acc[nt][2] *= c1;
        acc[nt][3] *= c1;
      }
      accumulate<T, D>(s, Vt, VLD, acc);
    }
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    if (lse != nullptr && t == 0) {
      float* lh = lse + ((long)b * H + h) * N;
      if (r0 < N) lh[r0] = m0 + log2f(l0);
      if (r1 < N) lh[r1] = m1 + log2f(l1);
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = h * D + nt * 8 + 2 * t;
      F::store(Ow + g * LD + col, acc[nt][0] * inv0, acc[nt][1] * inv0);
      F::store(Ow + (g + 8) * LD + col, acc[nt][2] * inv1, acc[nt][3] * inv1);
      if (o_save != nullptr) {
        T* ob = o_save + (long)b * N * C + col;
        if (r0 < N) F::store(ob + (long)r0 * C, acc[nt][0] * inv0, acc[nt][1] * inv0);
        if (r1 < N) F::store(ob + (long)r1 * C, acc[nt][2] * inv1, acc[nt][3] * inv1);
      }
    }
  }
  __syncwarp();

  // out projection over all heads, 32 columns at a time, and the residual
  const float f = fac[b];
  T* outb = out + (long)b * N * C;
  for (int n0 = 0; n0 < C; n0 += 32) {
    float z[4][4];
    zero_acc(z);
    rowmm<T, 4>(Ow, LD, wo, C, n0, z);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      const float bo0 = to_f32(bo[col]), bo1 = to_f32(bo[col + 1]);
      if (r0 < N) {
        const T* xr = xb + (long)r0 * C + col;
        F::store(outb + (long)r0 * C + col, to_f32(xr[0]) + f * (z[nt][0] + bo0),
                 to_f32(xr[1]) + f * (z[nt][1] + bo1));
      }
      if (r1 < N) {
        const T* xr = xb + (long)r1 * C + col;
        F::store(outb + (long)r1 * C + col, to_f32(xr[0]) + f * (z[nt][2] + bo0),
                 to_f32(xr[1]) + f * (z[nt][3] + bo1));
      }
    }
  }
}

template <int D>
cudaError_t launch_f32(const void* x, const void* k, const void* v, const float* lg,
                       const float* lb, const void* wq, const void* bq, const void* wo,
                       const void* bo, const float* fac, void* out, void* o_save, float* lse,
                       int B, int N, int M, int C, float scale, cudaStream_t stream) {
  const int bytes = (2 * BQ * (C + 8) + BK * (D + 8) + D * (BK + 8)) * (int)sizeof(float);
  auto kern = attn_block_kernel<float, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(k), static_cast<const float*>(v),
      lg, lb, static_cast<const float*>(wq), static_cast<const float*>(bq),
      static_cast<const float*>(wo), static_cast<const float*>(bo), fac,
      static_cast<float*>(out), static_cast<float*>(o_save), lse, N, M, C, scale * LOG2E);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bfloat16: wgmma + TMA
//
// One block owns ROWS = 64 tokens of one image and walks all its heads: a
// producer warp and one consumer warpgroup. Shared memory (1024-aligned,
// 128-byte swizzle, C padded with zero columns to CB 64-column blocks):
// the LN1 tile and the attention-output tile (64 x C each), a two-stage
// ring of weight tiles (Wq_h: D rows x C; then Wo in 64-row chunks), the
// Q tile and the two-stage K/V ring of attn_fwd_core.cuh. The producer streams, in
// order, the block's rows of x into the LN tile, Wq_0, Wq_1, head 0's K/V
// tiles, Wq_2, head 1's, ..., then Wo's chunks; the consumers:
// 1. LN1 of the rows in place, in float32, rounded (sm90.cuh ln_tile);
// 2. per head, q_h = LN Wq_h^T (wgmma, both operands K-major) + bq_h,
//    rounded to bfloat16 into a swizzled Q tile; the attention core over
//    the head's K/V tiles; the normalised output,
//    rounded, to the head's columns of the O tile (and to o_save), the
//    row log-sum-exps to lse;
// 3. per 64 output columns, out = O Wo^T (wgmma) + bo, times fac, + x in
//    float32, rounded once.
namespace k3 {

using bf16 = __nv_bfloat16;
using namespace sm90;
using attn_fwd::STAGES;
constexpr int ROWS = 64;
constexpr int CONSUMERS = 128;
constexpr int THREADS3 = CONSUMERS + 32;
constexpr int WSTAGES = 2;  // weight tiles in flight
constexpr int BLK = 64 * 128;  // one 64-row x 64-column block of a 128B-swizzled tile

struct Layout {
  int cb, ln, o, w, w_stage, q, k, v, tile, bar, bytes;
  __host__ __device__ Layout(int C, int D) {
    cb = (C + 63) / 64;
    tile = 64 * D * 2;
    ln = 0;
    o = ln + cb * BLK;
    w_stage = cb * BLK;  // a Wo chunk; Wq_h takes cb * D * 128 of it
    w = o + cb * BLK;
    q = w + WSTAGES * w_stage;
    k = q + tile;
    v = k + STAGES * tile;
    bar = v + STAGES * tile;  // full, empty (K/V), wfull, wempty, x's
    bytes = bar + (4 * STAGES + 1) * 8 + 1024;  // + alignment slack
  }
};

// CB: the 64-column blocks of C, ceil(C / 64): the contraction of both
// projections, unrolled
template <int D, int CB>
__global__ void __launch_bounds__(THREADS3, 2)
attn_block_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                        const __grid_constant__ CUtensorMap tk,
                        const __grid_constant__ CUtensorMap tv,
                        const __grid_constant__ CUtensorMap twq,
                        const __grid_constant__ CUtensorMap two, const bf16* __restrict__ x,
                        const float* __restrict__ lg, const float* __restrict__ lb,
                        const bf16* __restrict__ bq, const bf16* __restrict__ bo,
                        const float* __restrict__ fac, bf16* __restrict__ out,
                        bf16* __restrict__ o_save, float* __restrict__ lse, int N, int M, int C,
                        float qscale) {
  constexpr int ROW = D * 2;  // K/V rows: the swizzle (128 or 64 bytes)
  const Layout L(C, D);
  const int H = C / D, ntiles = (M + 63) / 64, nw = H + CB;
  extern __shared__ uint8_t ab_smem[];
  uint8_t* base = align_1024(ab_smem);
  uint8_t* lns = base + L.ln;
  uint8_t* os = base + L.o;
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L.bar);
  uint64_t* empty = full + STAGES;
  uint64_t* wfull = empty + STAGES;
  uint64_t* wempty = wfull + WSTAGES;
  uint64_t* xbar = wempty + WSTAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.y, q0 = blockIdx.x * ROWS;
  if (tid == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, CONSUMERS);
    }
    for (int s = 0; s < WSTAGES; ++s) {
      mbar_init(wfull + s, 1);
      mbar_init(wempty + s, CONSUMERS);
    }
    mbar_init(xbar, 1);
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == CONSUMERS / 32) {  // producer: one lane issues the loads
    if (lane == 0) {
      // the block's rows of x, one box a 64-column block, into the LN1 tile
      // (zeros past N and past C)
      mbar_expect_tx(xbar, CB * BLK);
      for (int kb = 0; kb < CB; ++kb) tma_load_3d(lns + kb * BLK, &tx, xbar, 64 * kb, q0, b);
      auto load_w = [&](int j) {  // weight tile j: Wq_j for j < H, else Wo chunk j - H
        const int s = j % WSTAGES;
        uint8_t* dst = base + L.w + s * L.w_stage;
        mbar_wait(wempty + s, ((j / WSTAGES) & 1) ^ 1);
        if (j < H) {
          mbar_expect_tx(wfull + s, L.cb * D * 128);
          for (int kb = 0; kb < L.cb; ++kb)
            tma_load_2d(dst + kb * D * 128, &twq, wfull + s, 64 * kb, j * D);
        } else {
          mbar_expect_tx(wfull + s, L.cb * BLK);
          for (int kb = 0; kb < L.cb; ++kb)
            tma_load_2d(dst + kb * BLK, &two, wfull + s, 64 * kb, 64 * (j - H));
        }
      };
      for (int j = 0; j < WSTAGES && j < nw; ++j) load_w(j);
      for (int h = 0; h < H; ++h) {
        for (int t = 0; t < ntiles; ++t) {
          const int T = h * ntiles + t, s = T % STAGES;
          mbar_wait(empty + s, ((T / STAGES) & 1) ^ 1);
          mbar_expect_tx(full + s, 2 * L.tile);
          tma_load_4d(base + L.k + s * L.tile, &tk, full + s, 0, h, t * 64, b);
          tma_load_4d(base + L.v + s * L.tile, &tv, full + s, 0, h, t * 64, b);
        }
        if (h + WSTAGES < nw) load_w(h + WSTAGES);
      }
      for (int j = H + WSTAGES; j < nw; ++j) load_w(j);
    }
    return;
  }

  const int g = lane >> 2, t4 = lane & 3;
  const int nvalid = min(ROWS, N - q0);
  const bf16* xb = x + (long)b * N * C;

  // 1. LN1 in place
  mbar_wait(xbar, 0);
  ln_tile<4, CB <= 4 ? 1 : 2>(lns, BLK, warp, CONSUMERS / 32, ROWS, C, lg, lb);
  fence_proxy_async();
  bar_sync(1, CONSUMERS);

  // 2. the heads
  for (int h = 0; h < H; ++h) {
    const int ws = h % WSTAGES;
    const uint8_t* wt = base + L.w + ws * L.w_stage;
    mbar_wait(wfull + ws, (h / WSTAGES) & 1);
    float qacc[D / 2];
    fence_regs(qacc);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CB * 4; ++ks) {
      const uint64_t da = make_desc(lns + (ks >> 2) * BLK + (ks & 3) * 32, 128, false);
      const uint64_t db = make_desc(wt + (ks >> 2) * D * 128 + (ks & 3) * 32, 128, false);
      if constexpr (D == 64) wgmma_ss_m64n64<0, 0>(qacc, da, db, ks > 0);
      else wgmma_ss_m64n32<0, 0>(qacc, da, db, ks > 0);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(qacc);
    mbar_arrive(wempty + ws);
    // q_h + bq_h, rounded, into the Q tile the core reads (once the last
    // head's S products, which read it, are done in every warp)
    const int r0 = warp * 16 + g, r1 = r0 + 8;  // rows of the tile
    bar_sync(1, CONSUMERS);
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = h * D + 8 * nt + 2 * t4;
      const float b0 = __bfloat162float(bq[col]), b1 = __bfloat162float(bq[col + 1]);
      *reinterpret_cast<uint32_t*>(base + L.q + swz(r0, nt, ROW) + 4 * t4) =
          pack_bf16(qacc[4 * nt] + b0, qacc[4 * nt + 1] + b1);
      *reinterpret_cast<uint32_t*>(base + L.q + swz(r1, nt, ROW) + 4 * t4) =
          pack_bf16(qacc[4 * nt + 2] + b0, qacc[4 * nt + 3] + b1);
    }
    fence_proxy_async();
    bar_sync(1, CONSUMERS);
    attn_fwd::State<D> st;
    attn_fwd::run<D, ROW, false>(base + L.q, base + L.k, base + L.v, L.tile, full, empty,
                                 h * ntiles, ntiles, M, qscale, st);
    float inv0, inv1, lse0, lse1;
    attn_fwd::finish(st, inv0, inv1, lse0, lse1);
    if (lse != nullptr && t4 == 0) {
      float* lh = lse + ((long)b * H + h) * N + q0;
      if (r0 < nvalid) lh[r0] = lse0;
      if (r1 < nvalid) lh[r1] = lse1;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = h * D + nt * 8 + 2 * t4;
      const uint32_t p0 = pack_bf16(st.acc[4 * nt] * inv0, st.acc[4 * nt + 1] * inv0);
      const uint32_t p1 = pack_bf16(st.acc[4 * nt + 2] * inv1, st.acc[4 * nt + 3] * inv1);
      uint8_t* blk = os + (col >> 6) * BLK + 4 * t4;
      *reinterpret_cast<uint32_t*>(blk + swz(r0, (col & 63) >> 3, 128)) = p0;
      *reinterpret_cast<uint32_t*>(blk + swz(r1, (col & 63) >> 3, 128)) = p1;
      if (o_save != nullptr) {
        bf16* ob = o_save + ((long)b * N + q0) * C + col;
        if (r0 < nvalid) *reinterpret_cast<uint32_t*>(ob + (long)r0 * C) = p0;
        if (r1 < nvalid) *reinterpret_cast<uint32_t*>(ob + (long)r1 * C) = p1;
      }
    }
  }
  // no head writes the O tile's columns past C: zero them (Wo's rows there
  // arrive as zeros, but 0 times stale memory may be NaN)
  for (int i = tid; i < ROWS * (L.cb * 8 - C / 8); i += CONSUMERS) {
    const int r = i % ROWS, ch = C / 8 + i / ROWS;
    *reinterpret_cast<uint4*>(os + (ch >> 3) * BLK + swz(r, ch & 7, 128)) =
        make_uint4(0u, 0u, 0u, 0u);
  }
  fence_proxy_async();
  bar_sync(1, CONSUMERS);

  // 3. the out projection and the residual, 64 output columns at a time
  const float f = fac[b];
  bf16* outb = out + ((long)b * N + q0) * C;
  const bf16* xr = xb + (long)q0 * C;
  for (int nc = 0; nc < CB; ++nc) {
    const int j = H + nc, ws = j % WSTAGES;
    const uint8_t* wt = base + L.w + ws * L.w_stage;
    mbar_wait(wfull + ws, (j / WSTAGES) & 1);
    float z[32];
    fence_regs(z);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < CB * 4; ++ks)
      wgmma_ss_m64n64<0, 0>(z, make_desc(os + (ks >> 2) * BLK + (ks & 3) * 32, 128, false),
                            make_desc(wt + (ks >> 2) * BLK + (ks & 3) * 32, 128, false),
                            ks > 0);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(z);
    mbar_arrive(wempty + ws);
#pragma unroll
    for (int jn = 0; jn < 8; ++jn) {
      const int col = 64 * nc + 8 * jn + 2 * t4;
      if (col >= C) continue;
      const float bo0 = __bfloat162float(bo[col]), bo1 = __bfloat162float(bo[col + 1]);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const int r = warp * 16 + g + 8 * hh;
        if (r >= nvalid) continue;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(xr + (long)r * C + col));
        *reinterpret_cast<uint32_t*>(outb + (long)r * C + col) =
            pack_bf16(xv.x + f * (z[4 * jn + 2 * hh] + bo0),
                      xv.y + f * (z[4 * jn + 2 * hh + 1] + bo1));
      }
    }
  }
}

template <int D, int CB>
cudaError_t launch(const void* x, const void* k, const void* v, const float* lg, const float* lb,
                   const void* wq, const void* bq, const void* wo, const void* bo,
                   const float* fac, void* out, void* o_save, float* lse, int B, int N, int M,
                   int C, float scale, cudaStream_t stream) {
  const Layout L(C, D);
  if (L.bytes > 232448) return cudaErrorInvalidValue;
  const int H = C / D;
  CUtensorMap tx, tk, tv, twq, two;
  // weights (C out, C in) row-major: Wq_h's boxes D rows x 64 columns, Wo's 64 x 64
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(C)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(C) * 2};
  const cuuint32_t box_q[2] = {64, static_cast<cuuint32_t>(D)}, box_o[2] = {64, 64};
  // x (B, N, C) as {C, N, B}: a block's rows are one box a 64-column block
  const cuuint64_t dx[3] = {static_cast<cuuint64_t>(C), static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(B)};
  const cuuint64_t sx[2] = {dx[0] * 2, dx[0] * dx[1] * 2};
  const cuuint32_t box_x[3] = {64, ROWS, 1};
  cudaError_t err = sm90::make_map(&tx, x, 3, dx, sx, box_x);
  if (err == cudaSuccess) err = sm90::head_map(&tk, k, B, M, H, D);
  if (err == cudaSuccess) err = sm90::head_map(&tv, v, B, M, H, D);
  if (err == cudaSuccess) err = sm90::make_map(&twq, wq, 2, dims, strides, box_q);
  if (err == cudaSuccess) err = sm90::make_map(&two, wo, 2, dims, strides, box_o);
  if (err != cudaSuccess) return err;
  auto kern = attn_block_wgmma_kernel<D, CB>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + ROWS - 1) / ROWS, B);
  kern<<<grid, THREADS3, L.bytes, stream>>>(
      tx, tk, tv, twq, two, static_cast<const bf16*>(x), lg, lb, static_cast<const bf16*>(bq),
      static_cast<const bf16*>(bo), fac, static_cast<bf16*>(out), static_cast<bf16*>(o_save),
      lse, N, M, C, scale * LOG2E);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_d(const void* x, const void* k, const void* v, const float* lg, const float* lb,
                     const void* wq, const void* bq, const void* wo, const void* bo,
                     const float* fac, void* out, void* o_save, float* lse, int B, int N, int M,
                     int C, float scale, cudaStream_t stream) {
  switch ((C + 63) / 64) {
#define K3_CASE(CB)                                                                       \
  case CB:                                                                                \
    return launch<D, CB>(x, k, v, lg, lb, wq, bq, wo, bo, fac, out, o_save, lse, B, N, M, C, \
                         scale, stream);
    K3_CASE(1) K3_CASE(2) K3_CASE(3) K3_CASE(4) K3_CASE(5)
#undef K3_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k3

}  // namespace

// o_save (B, N, C) and lse (B, H, N) float32: optional outputs for K3b (the
// attention output before the out projection, and the row log-sum-exps).
SFT_EXPORT int sft_attn_block(const void* x, const void* k, const void* v, const void* lg,
                              const void* lb, const void* wq, const void* bq, const void* wo,
                              const void* bo, const void* fac, void* out, void* o_save, void* lse,
                              int B, int N, int M, int C, int D, float scale, int dtype,
                              void* stream) {
  if (B < 1 || N < 1 || M < 1 || C % 32 || C > MAX_C || C % D || (D != 32 && D != 64))
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(lg);
  const float* bb = static_cast<const float*>(lb);
  const float* f = static_cast<const float*>(fac);
  float* l = static_cast<float*>(lse);
  if (dtype == SFT_F32)
    return D == 32 ? launch_f32<32>(x, k, v, g, bb, wq, bq, wo, bo, f, out, o_save, l, B, N, M, C,
                                    scale, st)
                   : launch_f32<64>(x, k, v, g, bb, wq, bq, wo, bo, f, out, o_save, l, B, N, M, C,
                                    scale, st);
  if (dtype == SFT_BF16)
    return D == 32 ? k3::launch_d<32>(x, k, v, g, bb, wq, bq, wo, bo, f, out, o_save, l, B, N,
                                      M, C, scale, st)
                   : k3::launch_d<64>(x, k, v, g, bb, wq, bq, wo, bo, f, out, o_save, l, B, N,
                                      M, C, scale, st);
  return cudaErrorInvalidValue;
}
