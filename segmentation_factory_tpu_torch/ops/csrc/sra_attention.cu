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
// written once per block. One block of 128 threads owns 64 query rows of
// one (batch, head).
// - bfloat16 (the serving path): Q.K^T and P.V run on the tensor cores
//   (mma.sync m16n8k16, float32 accumulation); each warp owns 16 query rows
//   and keeps its scores, softmax state and output in registers; P is
//   rounded to bfloat16 as the A operand of P.V.
// - float32: plain FMAs from shared memory, each thread owning 4 rows x 8
//   key columns of a score tile and 4 rows x D/8 output columns.
// Both can also write each row's log2-domain log-sum-exp (m + log2 l of the
// online softmax), which the backward (sra_attention_bwd.cu) reads to
// regenerate p.
#include <type_traits>

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


// ---------------------------------------------------------------- bfloat16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = THREADS / 32;  // 16 query rows each

// shared memory: q and k tiles [row][d], the v tile transposed [d][key];
// rows padded by 16 bytes, so the fragment loads are free of bank conflicts
template <int D>
struct Layout {
  static constexpr int LD = D + 8;
  static constexpr int VLD = BK + 8;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LD * 2;
  static constexpr int V = K + BK * LD * 2;
  static constexpr int BYTES = V + D * VLD * 2;
};

// rows [row0, row0 + 64) of a (rows, H, D) head slice, zero past `limit`,
// to dst[r * ld + d] or, transposed, to dst[d * ld + r]
template <int D, bool TRANSPOSE>
__device__ __forceinline__ void load_rows(const bf16* src, int row0, int limit, long pitch,
                                          bf16* dst, int ld) {
  constexpr int VECS = D / 8;  // 16-byte vectors per row
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

// Each warp owns 16 query rows. Its Q fragments, the 16 x 64 score tile,
// the softmax and the 16 x D output accumulator stay in registers (the
// layout of mma_bf16_16816): a thread holds rows g and g+8 of each 8-column
// tile, so a row's max and sum combine over the 4 lanes of a quad, and the
// score registers are re-packed as the P operand of P.V without a trip
// through shared memory.
template <int D>
__global__ void __launch_bounds__(THREADS)
sra_attention_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                        const bf16* __restrict__ v, bf16* __restrict__ o,
                        float* __restrict__ lse, int N, int M, int H, float qscale) {
  using L = Layout<D>;
  constexpr int KT = D / 16;  // 16-wide chunks of the Q.K^T contraction
  constexpr int NS = BK / 8;  // 8-key score tiles per K/V tile
  constexpr int NO = D / 8;   // 8-column output tiles
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_tc + L::Q);
  bf16* Ks = reinterpret_cast<bf16*>(smem_tc + L::K);
  bf16* Vt = reinterpret_cast<bf16*>(smem_tc + L::V);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const long pitch = (long)H * D;
  const bf16* qb = q + (long)b * N * pitch + (long)h * D;
  const bf16* kb = k + (long)b * M * pitch + (long)h * D;
  const bf16* vb = v + (long)b * M * pitch + (long)h * D;
  bf16* ob = o + (long)b * N * pitch + (long)h * D;

  load_rows<D, false>(qb, q0, N, pitch, Qs, L::LD);
  __syncthreads();
  uint32_t qa[KT][4];
  const bf16* qw = Qs + warp * 16 * L::LD;
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    qa[kc][0] = ld32(qw + g * L::LD + kc * 16 + 2 * t);
    qa[kc][1] = ld32(qw + (g + 8) * L::LD + kc * 16 + 2 * t);
    qa[kc][2] = ld32(qw + g * L::LD + kc * 16 + 8 + 2 * t);
    qa[kc][3] = ld32(qw + (g + 8) * L::LD + kc * 16 + 8 + 2 * t);
  }

  float acc[NO][4];
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;  // rows g, g + 8

  for (int k0 = 0; k0 < M; k0 += BK) {
    __syncthreads();  // previous tile's K/V reads are done
    load_rows<D, false>(kb, k0, M, pitch, Ks, L::LD);
    load_rows<D, true>(vb, k0, M, pitch, Vt, L::VLD);
    __syncthreads();

    float s[NS][4];
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
      const bf16* kr = Ks + (nt * 8 + g) * L::LD + 2 * t;
#pragma unroll
      for (int kc = 0; kc < KT; ++kc)
        mma_bf16_16816(s[nt], qa[kc], ld32(kr + kc * 16), ld32(kr + kc * 16 + 8));
    }

    // online softmax in exp2 of the log2e-scaled scores; padding keys past
    // M get -inf, and key 0 of a tile is always valid
    const int valid = M - k0;
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NS; ++nt) {
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
    for (int nt = 0; nt < NS; ++nt) {
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
    for (int nt = 0; nt < NO; ++nt) {
      acc[nt][0] *= c0;
      acc[nt][1] *= c0;
      acc[nt][2] *= c1;
      acc[nt][3] *= c1;
    }

    // O += P V over 16-key chunks; P's A fragment is two score tiles re-packed
#pragma unroll
    for (int kc = 0; kc < BK / 16; ++kc) {
      const uint32_t pa[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int nt = 0; nt < NO; ++nt) {
        const bf16* vr = Vt + (nt * 8 + g) * L::VLD + kc * 16 + 2 * t;
        mma_bf16_16816(acc[nt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + g;
  const int r1 = r0 + 8;
  if (lse != nullptr && t == 0) {
    if (r0 < N) lse[(long)bh * N + r0] = m0 + log2f(l0);
    if (r1 < N) lse[(long)bh * N + r1] = m1 + log2f(l1);
  }
#pragma unroll
  for (int nt = 0; nt < NO; ++nt) {
    const int col = nt * 8 + 2 * t;
    if (r0 < N)
      *reinterpret_cast<uint32_t*>(ob + (long)r0 * pitch + col) =
          pack_bf16(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (r1 < N)
      *reinterpret_cast<uint32_t*>(ob + (long)r1 * pitch + col) =
          pack_bf16(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse, int B, int N,
                   int M, int H, float scale, cudaStream_t stream) {
  auto kern = sra_attention_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         Layout<D>::BYTES);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B * H);
  kern<<<grid, THREADS, Layout<D>::BYTES, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<bf16*>(o), lse, N, M, H, scale * LOG2E);
  return cudaGetLastError();
}

}  // namespace tc

template <typename T>
cudaError_t dispatch_d(const void* q, const void* k, const void* v, void* o, float* lse, int B,
                       int N, int M, int H, int D, float scale, cudaStream_t stream) {
  constexpr bool bf = std::is_same<T, __nv_bfloat16>::value;
  switch (D) {
    case 32:
      return bf ? tc::launch<32>(q, k, v, o, lse, B, N, M, H, scale, stream)
                : launch<float, 32>(q, k, v, o, lse, B, N, M, H, scale, stream);
    case 64:
      return bf ? tc::launch<64>(q, k, v, o, lse, B, N, M, H, scale, stream)
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
