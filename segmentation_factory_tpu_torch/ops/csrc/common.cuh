// Shared helpers of the serving-path kernels: dtype codes, float32
// conversion, 4-wide vector loads and stores, and the error string export.
// Every kernel computes in float32 whatever its storage type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define SFT_EXPORT extern "C" __attribute__((visibility("default")))

// dtype codes, as ops/_build.py DTYPE_CODE
enum SftDtype { SFT_F32 = 0, SFT_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even
}

// four consecutive elements at p (16-byte aligned for float, 8 for bf16)
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  uint2 raw = *reinterpret_cast<const uint2*>(p);
  float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
  float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}

__device__ __forceinline__ void store4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, float4 v) {
  __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y);
  __nv_bfloat162 hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 raw;
  raw.x = *reinterpret_cast<uint32_t*>(&lo);
  raw.y = *reinterpret_cast<uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = raw;
}

__device__ __forceinline__ void fma4(float4& acc, float a, float4 b) {
  acc.x = fmaf(a, b.x, acc.x);
  acc.y = fmaf(a, b.y, acc.y);
  acc.z = fmaf(a, b.z, acc.z);
  acc.w = fmaf(a, b.w, acc.w);
}

// two floats -> one register of two bf16, `lo` in the low half
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// LayerNorm as flax computes it (models/layers ln_apply): float32 statistics,
// the fast variance E[x^2] - E[x]^2 clipped at 0, eps 1e-6.
constexpr float LN_EPS = 1e-6f;

// mean and 1 / sigma of the C values at `row`, by one warp (every lane gets
// them); a null row (outside the image) gives (0, 0)
template <typename T>
__device__ __forceinline__ float2 warp_ln_stats(const T* row, int C) {
  if (row == nullptr) return make_float2(0.f, 0.f);
  float s = 0.f, q = 0.f;
  for (int c = threadIdx.x & 31; c < C; c += 32) {
    const float v = to_f32(row[c]);
    s += v;
    q += v * v;
  }
  s = warp_sum(s);
  q = warp_sum(q);
  const float m = s / C;
  return make_float2(m, rsqrtf(fmaxf(q / C - m * m, 0.f) + LN_EPS));
}

// (x - mu) * rs * g + b of four channels from c, rounded to the compute
// type T as the LN output that feeds a product
template <typename T>
__device__ __forceinline__ float4 ln4(float4 v, float2 st, const float* g, const float* b, int c) {
  const float m = st.x, r = st.y;
  return make_float4(to_f32(from_f32<T>((v.x - m) * r * g[c] + b[c])),
                     to_f32(from_f32<T>((v.y - m) * r * g[c + 1] + b[c + 1])),
                     to_f32(from_f32<T>((v.z - m) * r * g[c + 2] + b[c + 2])),
                     to_f32(from_f32<T>((v.w - m) * r * g[c + 3] + b[c + 3])));
}

// The Mix-FFN's exact GELU, x * Phi(x), Phi the normal CDF by erf
__device__ __forceinline__ float erf_cdf(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}
__device__ __forceinline__ float gelu_erf(float x) { return x * erf_cdf(x); }

// The 3x3 depthwise conv at one output: bias + sum over the taps (ty, tx),
// row by row, of w[3 ty + tx] * h(ty, tx), h the input at the tap (zero
// outside the image). The one order of these sums for K2f's stencil and
// K2b / K4b's tile kernel (its forward and its transposed taps).
template <typename F>
__device__ __forceinline__ float dw_taps(const float (&w)[9], float bias, F&& h) {
  float v = bias;
#pragma unroll
  for (int ty = 0; ty < 3; ++ty)
#pragma unroll
    for (int tx = 0; tx < 3; ++tx) v = fmaf(w[ty * 3 + tx], h(ty, tx), v);
  return v;
}

// Half-pixel bilinear sample position (align_corners=False) of output
// index `dst` on an axis of n_in source and n_out output samples, clamped
// to the edge: source indices i0, i1 and the weight f of i1.
__device__ __forceinline__ void bilinear_tap(int dst, int n_in, int n_out, int& i0,
                                             int& i1, float& f) {
  float pos = ((float)dst + 0.5f) * ((float)n_in / (float)n_out) - 0.5f;
  pos = fmaxf(pos, 0.0f);
  i0 = min((int)pos, n_in - 1);
  i1 = min(i0 + 1, n_in - 1);
  f = pos - (float)i0;
}

SFT_EXPORT const char* sft_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
