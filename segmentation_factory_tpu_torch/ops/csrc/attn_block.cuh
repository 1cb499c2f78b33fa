// Device code shared by the attention half-block kernels, attn_block.cu (K3f)
// and attn_block_bwd.cu (K3b): the float32 LayerNorm of a 64-row tile into
// shared memory, K/V head tiles, and the score and accumulation products of
// one warp's 16 rows, all on Frag<T> (frag.cuh) so that one body serves
// bfloat16 (tensor cores) and float32 (FMAs).
//
// Layouts: tokens x (B, N, C) and k, v (B, M, C) in the kv Linear's layout,
// head h at columns h*D .. h*D + D - 1, so no transpose is needed; weights as
// (out, in) row-major unless a kernel says otherwise.
#pragma once

#include "frag.cuh"

namespace ab {

constexpr int BQ = 64;        // token rows a block owns: 16 per warp
constexpr int BK = 64;        // keys per K/V tile
constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_C = 320;    // MiT stages 1-3 (the fused configuration's widths)
constexpr float LOG2E = 1.4426950408889634f;

template <typename T>
__device__ __forceinline__ float rnd(float v) {  // v rounded to T, as float
  return to_f32(from_f32<T>(v));
}

// LayerNorm of rows row0 .. row0 + 63 of x (rows, C), flax's math in float32
// (fast variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6), rounded to T into
// dst[r * ld + c]; rows at and past `nvalid` are zero. Each row's mean and
// 1 / sigma go to mu / rs, and the rounded row to copy (rows, C), where given.
template <typename T>
__device__ void ln_rows(const T* __restrict__ x, long row0, int nvalid, int C,
                        const float* __restrict__ lg, const float* __restrict__ lb, T* dst, int ld,
                        float* mu, float* rs, T* __restrict__ copy) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  for (int r = warp; r < BQ; r += WARPS) {
    T* d = dst + r * ld;
    if (r >= nvalid) {
      for (int c = lane; c < C; c += 32) d[c] = from_f32<T>(0.f);
      continue;
    }
    const T* xr = x + (row0 + r) * C;
    const float2 st = warp_ln_stats(xr, C);
    const float m = st.x, rsig = st.y;
    for (int c = lane; c < C; c += 32) {
      const T y = from_f32<T>((to_f32(xr[c]) - m) * rsig * lg[c] + lb[c]);
      d[c] = y;
      if (copy != nullptr) copy[(row0 + r) * C + c] = y;
    }
    if (lane == 0 && mu != nullptr) {
      mu[r] = m;
      rs[r] = rsig;
    }
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
// to T as A fragments; the rounded values also to q_out (rows r0, r0 + 8 of a
// (rows, C) array) where given
template <typename T, int D>
__device__ __forceinline__ void project_q(const T* lw, int ld, const T* __restrict__ wq,
                                          const T* __restrict__ bq, int C, int h, T* q_out, int r0,
                                          int nrows, typename Frag<T>::pair (&qa)[D / 16][4]) {
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
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
    if (q_out != nullptr) {
      if (r0 + g < nrows) Frag<T>::store(q_out + (long)(r0 + g) * C + col, acc[nt][0], acc[nt][1]);
      if (r0 + g + 8 < nrows)
        Frag<T>::store(q_out + (long)(r0 + g + 8) * C + col, acc[nt][2], acc[nt][3]);
    }
  }
  repack<T, D / 16>(acc, qa);
}

}  // namespace ab
