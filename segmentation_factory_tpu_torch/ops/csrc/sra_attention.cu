// K1: spatial-reduction attention forward, o = softmax(q k^T * scale) v for
// every (batch, head), q (B, N, H, D), k and v (B, M, H, D), o like q.
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_attention.py
// `_forward` (:77, body `_kernel` :60), which holds a whole (tile, M) float32
// score block in VMEM and takes one exact softmax over all of M.
//
// What bounds it on the H100: operations. At the MiT stages N = M * sr^2 and
// M <= 1024, so the 4*N*M*D flops outweigh the q/k/v/o bytes by ~M/2 flops
// per byte, far above the card's ~295 bf16 flops per byte of memory.
// Design: a (tile, M) float32 score block does not fit one block's 227 KB of
// shared memory at M = 1024, so a block walks K/V in 64-row tiles with an
// online softmax (running max and sum in float32) and accumulates P.V in
// float32; the scores never reach device memory and q/k/v/o are read or
// written once per block. One block owns 64 query rows of one (batch, head).
// - bfloat16 (the serving and training path): Hopper's wgmma and TMA, shaped
//   like FlashAttention-3's forward: a producer warp keeps TMA loads of
//   K/V tiles in flight into a two-stage ring of swizzled shared memory
//   (mbarrier completion), one consumer warpgroup owns the block's 64 query
//   rows, S = Q K^T and O += P V run on wgmma (P from registers, V through
//   the transpose bit), and the softmax state stays in registers: the
//   attention-forward core that K3f shares (attn_fwd_core.cuh). Q, K and
//   V are read through tensor maps encoded per call for the strided
//   (B, rows, H, D) view; rows past N or M arrive as zeros.
// - float32: plain FMAs from shared memory, each thread owning 4 rows x 8
//   key columns of a score tile and 4 rows x D/8 output columns.
// Both can also write each row's log2-domain log-sum-exp (m + log2 l of the
// online softmax), which the backward (sra_attention_bwd.cu) reads to
// regenerate p.
#include <type_traits>

#include "attn_fwd_core.cuh"
#include "common.cuh"

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // key rows per K/V tile
constexpr int THREADS = 128;  // 16 row groups x 8 column groups
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct Smem {
  static constexpr int QK_STRIDE = D + 4;   // padded rows: conflict-free float4 reads
  static constexpr int P_STRIDE = BK + 4;
  static constexpr int Q_OFF = 0;
  static constexpr int K_OFF = Q_OFF + BQ * QK_STRIDE;
  static constexpr int V_OFF = K_OFF + BK * QK_STRIDE;
  static constexpr int P_OFF = V_OFF + BK * D;
  static constexpr int FLOATS = P_OFF + BQ * P_STRIDE;
  static constexpr int BYTES = FLOATS * 4;
};

// rows [row0, row0 + nrows) of a (rows, H, D) head slice -> dst[r * stride + d],
// scaled, zero past `limit`
template <typename T, int D>
__device__ __forceinline__ void load_tile(const T* src, int row0, int limit, long row_pitch,
                                          float scale, float* dst, int stride) {
  constexpr int CHUNKS = D / 4;
  for (int idx = threadIdx.x; idx < 64 * CHUNKS; idx += THREADS) {
    int r = idx / CHUNKS;
    int c4 = (idx % CHUNKS) * 4;
    float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
    if (row0 + r < limit) {
      val = load4(src + (long)(row0 + r) * row_pitch + c4);
      val.x *= scale; val.y *= scale; val.z *= scale; val.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * stride + c4) = val;
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
sra_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse, int N,
                     int M, int H, float qscale) {
  using S = Smem<D>;
  constexpr int DC = D / 32;  // float4 output chunks per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem + S::Q_OFF;
  float* Ks = smem + S::K_OFF;
  float* Vs = smem + S::V_OFF;
  float* Ps = smem + S::P_OFF;

  const int tid = threadIdx.x;
  const int rg = tid >> 3;  // rows rg*4 .. rg*4+3
  const int cg = tid & 7;   // score columns cg + 8j, output columns cg*4 + 32c (+0..3)
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const long pitch = (long)H * D;
  const T* qb = q + (long)b * N * pitch + (long)h * D;
  const T* kb = k + (long)b * M * pitch + (long)h * D;
  const T* vb = v + (long)b * M * pitch + (long)h * D;
  T* ob = o + (long)b * N * pitch + (long)h * D;

  // q pre-scaled by scale * log2(e): the softmax runs on exp2
  load_tile<T, D>(qb, q0, N, pitch, qscale, Qs, S::QK_STRIDE);

  float m_run[4], l_run[4];
  float4 acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m_run[i] = -INFINITY;
    l_run[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();  // previous tile's K/V/P reads are done
    load_tile<T, D>(kb, k0, M, pitch, 1.f, Ks, S::QK_STRIDE);
    load_tile<T, D>(vb, k0, M, pitch, 1.f, Vs, D);
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(Qs + (rg * 4 + i) * S::QK_STRIDE + d);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        kv[j] = *reinterpret_cast<const float4*>(Ks + (cg + 8 * j) * S::QK_STRIDE + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j)
          s[i][j] += qv[i].x * kv[j].x + qv[i].y * kv[j].y + qv[i].z * kv[j].z +
                     qv[i].w * kv[j].w;
    }

    const int valid = M - k0;  // columns >= valid are padding
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (cg + 8 * j >= valid) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 8 threads of a row group are 8 consecutive lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 4));
      const float m_new = fmaxf(m_run[i], mx);  // finite: column 0 of a tile is valid
      const float corr = exp2f(m_run[i] - m_new);
      m_run[i] = m_new;
      float psum = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float p = exp2f(s[i][j] - m_new);
        psum += p;
        Ps[(rg * 4 + i) * S::P_STRIDE + cg + 8 * j] = p;
      }
      l_run[i] = l_run[i] * corr + psum;  // this thread's share of the row sum
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        acc[i][c].x *= corr; acc[i][c].y *= corr; acc[i][c].z *= corr; acc[i][c].w *= corr;
      }
    }
    __syncthreads();

    const int kmax = min(BK, valid);
    for (int kk = 0; kk < kmax; kk += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(Ps + (rg * 4 + i) * S::P_STRIDE + kk);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float4 vv = *reinterpret_cast<const float4*>(Vs + (kk + u) * D + cg * 4 + 32 * c);
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float p = u == 0 ? pv[i].x : u == 1 ? pv[i].y : u == 2 ? pv[i].z : pv[i].w;
            fma4(acc[i][c], p, vv);
          }
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float l = l_run[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    l += __shfl_xor_sync(0xffffffffu, l, 4);
    const float inv = 1.f / l;
    const int n = q0 + rg * 4 + i;
    if (lse != nullptr && cg == 0 && n < N) lse[(long)bh * N + n] = m_run[i] + log2f(l);
    if (n < N) {
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        float4 r = acc[i][c];
        r.x *= inv; r.y *= inv; r.z *= inv; r.w *= inv;
        store4(ob + (long)n * pitch + cg * 4 + 32 * c, r);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                   int N, int M, int H, float scale, cudaStream_t stream) {
  auto kern = sra_attention_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Smem<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, Smem<D>::BYTES, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lse, N, M, H, scale * LOG2E);
  return cudaGetLastError();
}


// ---------------------------------------------------------------- bfloat16: wgmma + TMA
namespace wg {

using bf16 = __nv_bfloat16;
using namespace sm90;
using attn_fwd::STAGES;
constexpr int CONSUMERS = 128;          // one warpgroup: 16 query rows per warp
constexpr int THREADS = CONSUMERS + 32; // + the producer warp

template <int D>
struct Layout {
  static constexpr int ROW = D * 2;     // bytes per row = the swizzle (128 or 64)
  static constexpr int TILE = 64 * ROW;
  static constexpr int Q = 0;
  static constexpr int K = Q + TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;  // full[STAGES], empty[STAGES], q
  static constexpr int BYTES = BAR + (2 * STAGES + 1) * 8 + 1024;  // + alignment slack
};

// One block owns 64 query rows of one (batch, head). The producer warp
// loads the Q tile once and K/V tiles into a ring of STAGES buffers (TMA,
// swizzled rows, zero past the edges), each completing on its `full`
// mbarrier; the consumer warpgroup frees a buffer on its `empty` mbarrier
// once the products that read it are done. The consumer runs the shared
// attention-forward core (attn_fwd_core.cuh).
template <int D>
__global__ void __launch_bounds__(THREADS)
sra_attention_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv, bf16* __restrict__ o,
                           float* __restrict__ lse, int N, int M, int H, float qscale) {
  using L = Layout<D>;
  constexpr int NO = D / 8;  // 8-column output tiles
  extern __shared__ uint8_t attn_smem[];
  uint8_t* base = align_1024(attn_smem);
  uint64_t* full = reinterpret_cast<uint64_t*>(base + L::BAR);
  uint64_t* empty = full + STAGES;
  uint64_t* qbar = empty + STAGES;
  const int tid = threadIdx.x, warp = tid >> 5;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * 64;
  const int ntiles = (M + 63) / 64;
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
      mbar_expect_tx(qbar, L::TILE);
      tma_load_4d(base + L::Q, &tq, qbar, 0, h, q0, b);
      for (int t = 0; t < ntiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(empty + s, ((t / STAGES) & 1) ^ 1);
        mbar_expect_tx(full + s, 2 * L::TILE);
        tma_load_4d(base + L::K + s * L::TILE, &tk, full + s, 0, h, t * 64, b);
        tma_load_4d(base + L::V + s * L::TILE, &tv, full + s, 0, h, t * 64, b);
      }
    }
    return;
  }

  const int lane = tid & 31, g = lane >> 2, t4 = lane & 3;
  attn_fwd::State<D> st;
  mbar_wait(qbar, 0);
  attn_fwd::run<D, L::ROW, true>(base + L::Q, base + L::K, base + L::V, L::TILE, full, empty,
                                 0, ntiles, M, qscale, st);

  float inv0, inv1, lse0, lse1;
  attn_fwd::finish(st, inv0, inv1, lse0, lse1);
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  if (lse != nullptr && t4 == 0) {
    if (r0 < N) lse[(long)bh * N + r0] = lse0;
    if (r1 < N) lse[(long)bh * N + r1] = lse1;
  }
  const long pitch = (long)H * D;
  bf16* ob = o + (long)b * N * pitch + (long)h * D;
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    const int col = nt * 8 + 2 * t4;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + (long)r0 * pitch + col) =
          pack_bf16(st.acc[4 * nt] * inv0, st.acc[4 * nt + 1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + (long)r1 * pitch + col) =
          pack_bf16(st.acc[4 * nt + 2] * inv1, st.acc[4 * nt + 3] * inv1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int N,
                   int M, int H, float scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  cudaError_t err = head_map(&tq, q, B, N, H, D);
  if (err == cudaSuccess) err = head_map(&tk, k, B, M, H, D);
  if (err == cudaSuccess) err = head_map(&tv, v, B, M, H, D);
  if (err != cudaSuccess) return err;
  auto kern = sra_attention_wgmma_kernel<D>;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((N + 63) / 64, B * H);
  kern<<<grid, THREADS, Layout<D>::BYTES, stream>>>(tq, tk, tv, static_cast<bf16*>(o), lse, N, M,
                                                    H, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace wg

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int N, int M, int H, int D, float scale, cudaStream_t stream) {
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  switch (D) {
    case 32:
      return bf ? wg::launch<32>(q, k, v, o, lse, B, N, M, H, scale, stream)
                : launch<float, 32>(q, k, v, o, lse, B, N, M, H, scale, stream);
    case 64:
      return bf ? wg::launch<64>(q, k, v, o, lse, B, N, M, H, scale, stream)
                : launch<float, 64>(q, k, v, o, lse, B, N, M, H, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// lse: optional (B, H, N) float32 output, the log2-domain log-sum-exp of each
// row's scaled scores (m + log2 l of the online softmax), which the backward
// (sra_attention_bwd.cu) reads to regenerate p without a second pass.
SFT_EXPORT int sft_sra_attention(const void* q, const void* k, const void* v, void* o,
                                 void* lse, int B, int N, int M, int H, int D, float scale,
                                 int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(lse);
  if (dtype == SFT_F32) return dispatch_d<float>(q, k, v, o, l, B, N, M, H, D, scale, st);
  if (dtype == SFT_BF16)
    return dispatch_d<__nv_bfloat16>(q, k, v, o, l, B, N, M, H, D, scale, st);
  return cudaErrorInvalidValue;
}
