// The register fragments of one m16n8k16 tensor-core product (mma.sync's
// layout), run on float32 FMAs by exchanging operands between the lanes by
// shuffles: the float32 check path of K3f (attn_block.cu) keeps the tensor
// cores' dataflow, exact to float32 rounding, at a fraction of their rate.
//
// Layout (g = lane / 4, t = lane % 4):
// a[0] = A[g][2t..2t+1], a[1] = A[g+8][2t..], a[2] = A[g][2t+8..], a[3] = A[g+8][2t+8..];
// b0 = B[2t..2t+1][g], b1 = B[2t+8..2t+9][g]; d[0..1] = D[g][2t..], d[2..3] = D[g+8][2t..].
#pragma once

#include "common.cuh"

template <typename T>
struct Frag;

template <>
struct Frag<float> {
  using pair = float2;
  static __device__ __forceinline__ pair load(const float* p) {
    return *reinterpret_cast<const float2*>(p);
  }
  static __device__ __forceinline__ pair pack(float lo, float hi) { return make_float2(lo, hi); }
  static __device__ __forceinline__ void store(float* p, float lo, float hi) {
    *reinterpret_cast<float2*>(p) = make_float2(lo, hi);
  }
  // D[g][n] += sum_k A[g][k] B[k][n] for n = 2t, 2t+1 (and row g+8): lane
  // 4g+s holds A's k = 2s, 2s+1, 2s+8, 2s+9 of rows g and g+8; lane 4n+s holds
  // B's same k of column n.
  static __device__ __forceinline__ void mma(float (&d)[4], const pair (&a)[4], pair b0, pair b1) {
    const int lane = threadIdx.x & 31;
    const int g = lane >> 2, t = lane & 3;
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int la = 4 * g + s, lb0 = 8 * t + s, lb1 = 8 * t + 4 + s;
      const float2 a0 = sh(a[0], la), a1 = sh(a[1], la), a2 = sh(a[2], la), a3 = sh(a[3], la);
      const float2 p0 = sh(b0, lb0), q0 = sh(b1, lb0);  // column 2t
      const float2 p1 = sh(b0, lb1), q1 = sh(b1, lb1);  // column 2t + 1
      d[0] += a0.x * p0.x + a0.y * p0.y + a2.x * q0.x + a2.y * q0.y;
      d[1] += a0.x * p1.x + a0.y * p1.y + a2.x * q1.x + a2.y * q1.y;
      d[2] += a1.x * p0.x + a1.y * p0.y + a3.x * q0.x + a3.y * q0.y;
      d[3] += a1.x * p1.x + a1.y * p1.y + a3.x * q1.x + a3.y * q1.y;
    }
  }
  static __device__ __forceinline__ float2 sh(float2 v, int src) {
    return make_float2(__shfl_sync(0xffffffffu, v.x, src), __shfl_sync(0xffffffffu, v.y, src));
  }
};

// The A fragments of a 16-row x (16 * KT)-column tile held as float32
// accumulators (the D layout of 2 * KT 8-column tiles), rounded to T: a
// product's output becomes the next product's A operand without leaving the
// registers.
template <typename T, int KT>
__device__ __forceinline__ void repack(const float (&acc)[2 * KT][4],
                                       typename Frag<T>::pair (&a)[KT][4]) {
#pragma unroll
  for (int kc = 0; kc < KT; ++kc) {
    a[kc][0] = Frag<T>::pack(acc[2 * kc][0], acc[2 * kc][1]);
    a[kc][1] = Frag<T>::pack(acc[2 * kc][2], acc[2 * kc][3]);
    a[kc][2] = Frag<T>::pack(acc[2 * kc + 1][0], acc[2 * kc + 1][1]);
    a[kc][3] = Frag<T>::pack(acc[2 * kc + 1][2], acc[2 * kc + 1][3]);
  }
}

// acc[nt] += A . W^T for one warp: A is 16 rows (row stride lda, row 0 at
// `a`, in shared or device memory) by K columns, W is (n, K) row-major in
// device memory; the output columns are n0 + 8 nt .. + 7. K a multiple of 16.
template <typename T, int NT>
__device__ __forceinline__ void rowmm(const T* a, int lda, const T* __restrict__ w, int K, int n0,
                                      float (&acc)[NT][4]) {
  using F = Frag<T>;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  for (int kc = 0; kc < K; kc += 16) {
    const typename F::pair af[4] = {
        F::load(a + g * lda + kc + 2 * t), F::load(a + (g + 8) * lda + kc + 2 * t),
        F::load(a + g * lda + kc + 8 + 2 * t), F::load(a + (g + 8) * lda + kc + 8 + 2 * t)};
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const T* wr = w + (long)(n0 + nt * 8 + g) * K + kc + 2 * t;
      F::mma(acc[nt], af, F::load(wr), F::load(wr + 8));
    }
  }
}

template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
}
