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
// Design: one block of 128 threads owns 64 tokens of one image; each warp 16
// of them.
// 1. LN1 of the 64 rows in float32, rounded to the compute type, into shared
//    memory (ln_rows).
// 2. Per head: q_h = ln Wq_h^T + bq_h on the tensor cores (float32 sum,
//    rounded as the TPU kernel rounds it), kept in registers as the A
//    operand; then K1f's loop: K/V in 64-key tiles, online softmax in
//    float32 (running max and sum, exp2 of log2e-scaled scores), P.V into a
//    float32 accumulator. The TPU kernel's one exact softmax over M gives the
//    same function. The head's output, rounded to the compute type, goes to
//    a 64 x C tile in shared memory.
// 3. The out projection from that tile, 32 output columns at a time: the
//    sum over all heads in float32, + bo, times fac, + x in float32, rounded
//    once and written.
// In training the kernel also writes the attention output (B, N, C) and each
// row's log2-domain log-sum-exp per head (B, H, N), which K3b reads instead
// of re-running the softmax. bfloat16 on mma.sync m16n8k16; float32 on FMAs
// through the same fragment layout (frag.cuh). Shared memory: two 64 x C
// tiles and one K and one transposed V tile, 102 KB (bf16) / 205 KB (float32)
// at C = 320.
#include "frag.cuh"

// Layouts: tokens x (B, N, C) and k, v (B, M, C) in the kv Linear's layout,
// head h at columns h*D .. h*D + D - 1, so no transpose is needed; weights as
// (out, in) row-major. The helpers below work on Frag<T> (frag.cuh), so that
// one body serves bfloat16 (tensor cores) and float32 (FMAs).
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

template <typename T, int D>
cudaError_t launch(const void* x, const void* k, const void* v, const float* lg, const float* lb,
                   const void* wq, const void* bq, const void* wo, const void* bo,
                   const float* fac, void* out, void* o_save, float* lse, int B, int N, int M,
                   int C, float scale, cudaStream_t stream) {
  const int bytes = (2 * BQ * (C + 8) + BK * (D + 8) + D * (BK + 8)) * (int)sizeof(T);
  auto kern = attn_block_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((N + BQ - 1) / BQ, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(x), static_cast<const T*>(k), static_cast<const T*>(v), lg, lb,
      static_cast<const T*>(wq), static_cast<const T*>(bq), static_cast<const T*>(wo),
      static_cast<const T*>(bo), fac, static_cast<T*>(out), static_cast<T*>(o_save), lse, N, M,
      C, scale * LOG2E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const void* x, const void* k, const void* v, const float* lg,
                     const float* lb, const void* wq, const void* bq, const void* wo,
                     const void* bo, const float* fac, void* out, void* o_save, float* lse, int B,
                     int N, int M, int C, int D, float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(x, k, v, lg, lb, wq, bq, wo, bo, fac, out, o_save, lse, B, N, M, C,
                           scale, st);
    case 64:
      return launch<T, 64>(x, k, v, lg, lb, wq, bq, wo, bo, fac, out, o_save, lse, B, N, M, C,
                           scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// o_save (B, N, C) and lse (B, H, N) float32: optional outputs for K3b (the
// attention output before the out projection, and the row log-sum-exps).
SFT_EXPORT int sft_attn_block(const void* x, const void* k, const void* v, const void* lg,
                              const void* lb, const void* wq, const void* bq, const void* wo,
                              const void* bo, const void* fac, void* out, void* o_save, void* lse,
                              int B, int N, int M, int C, int D, float scale, int dtype,
                              void* stream) {
  if (B < 1 || N < 1 || M < 1 || C % 32 || C > MAX_C || C % D) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(lg);
  const float* bb = static_cast<const float*>(lb);
  const float* f = static_cast<const float*>(fac);
  float* l = static_cast<float*>(lse);
  if (dtype == SFT_F32)
    return dispatch<float>(x, k, v, g, bb, wq, bq, wo, bo, f, out, o_save, l, B, N, M, C, D,
                           scale, st);
  if (dtype == SFT_BF16)
    return dispatch<__nv_bfloat16>(x, k, v, g, bb, wq, bq, wo, bo, f, out, o_save, l, B, N, M, C,
                                   D, scale, st);
  return cudaErrorInvalidValue;
}
