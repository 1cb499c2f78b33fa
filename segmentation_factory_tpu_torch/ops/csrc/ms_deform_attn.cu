// K9f / K9b: multi-scale deformable attention (MSDeformAttn's core).
//
// value (B, S, M, D) float32 or bf16, S = sum_l H_l * W_l (the levels'
// maps flattened row-major, level l from start_l); locations (B, Q, M, L,
// P, 2) float32 in x, y order, normalised to [0, 1]; weights (B, Q, M, L,
// P) float32. K9f: out (B, Q, M * D) float32, out[b, q, m, :] = sum over
// l, p of weight * the bilinear sample of level l at (x W_l - 0.5,
// y H_l - 0.5) (align_corners=False), a corner outside the map adding zero.
// K9b: for the float32 cotangent g (B, Q, M * D), d(value) as an atomic
// col2im into a float32 (B, S, M, D) buffer the wrapper zeroes and casts to
// value's dtype afterwards; d(loc) (B, Q, M, L, P, 2) = weight * (dtx W,
// dty H) and d(weights) (B, Q, M, L, P) = blend . g, float32.
//
// Replaces segmentation_factory_tpu/ops/msdeform.py `ms_deform_attn_fast`
// (:181) and its custom VJP `_msda_sf` (:205-338): not a Pallas kernel (the
// TPU could not gather inside one, :20-26) but XLA patch gathers with a
// sort / prefix-sum d(value), because the TPU has no scatter. The reference
// is its own CUDA extension (ms_deform_im2col_cuda.cuh :238-300 forward,
// :302-921 backward), whose col2im this backward follows.
//
// What bounds it on the H100: bytes. K9f reads each location, weight and
// output once and value at most 4 L P times per (b, q, m); at the main
// path's shapes (value 33 MB in bf16) value stays in the 50 MB L2, so the
// bound is the locations, weights and output once. K9b adds g once and its
// three outputs, and d(value)'s float32 atomics resolve in L2.
//
// Design (a first, simple kernel): LP lanes own one (b, q, m) item, each
// lane 4 consecutive channels (K groups of 4 when D > 128), LP = 8, 16 or
// 32 after D / 4. Each lane reads the item's L x P locations and weights
// (the same addresses across the item's lanes: one transaction a warp) and
// the 4-channel slices of the in-bounds corners, accumulating in float32.
// K9b dots each corner's values with g per lane, reduces the four dots over
// the item's lanes by shuffles, and lane 0 writes d(loc) and d(weight); the
// d(value) rows go out by float32 atomicAdd. Atomics make d(value)'s
// summation order, and so its last bits, vary from run to run: it is held
// to the plain version by a tolerance, not bit for bit.
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;  // ops/msdeform.py MAX_LEVELS
constexpr int THREADS = 256;

struct Levels {
  int n;
  int h[MAX_LEVELS], w[MAX_LEVELS], start[MAX_LEVELS];
};

// The sample point of one level: top-left corner (x0, y0), kept within
// [-2, W] x [-2, H] so that far-away points stay outside without int
// overflow, and the fractions (tx, ty). Products and differences rounded
// as the plain version's separate float32 operations (no contraction).
struct Point {
  int x0, y0;
  float tx, ty;
};

__device__ __forceinline__ Point sample_point(float lx, float ly, int h, int w) {
  const float x = __fsub_rn(__fmul_rn(lx, static_cast<float>(w)), 0.5f);
  const float y = __fsub_rn(__fmul_rn(ly, static_cast<float>(h)), 0.5f);
  const float xf = floorf(x), yf = floorf(y);
  Point pt;
  pt.tx = __fsub_rn(x, xf);
  pt.ty = __fsub_rn(y, yf);
  pt.x0 = static_cast<int>(fminf(fmaxf(xf, -2.f), static_cast<float>(w)));
  pt.y0 = static_cast<int>(fminf(fmaxf(yf, -2.f), static_cast<float>(h)));
  return pt;
}

__device__ __forceinline__ float dot4(float4 a, float4 b) {
  return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

// grid: ceil(items / (THREADS / LP)) blocks; item = (b * Q + q) * M + m
template <typename T, int LP, int K>
__global__ void __launch_bounds__(THREADS)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, float* __restrict__ out, Levels lv, int B,
                int S, int Q, int M, int D, int P) {
  const long long item = static_cast<long long>(blockIdx.x) * (THREADS / LP) + threadIdx.x / LP;
  if (item >= static_cast<long long>(B) * Q * M) return;
  const int lane = threadIdx.x % LP;
  const int m = static_cast<int>(item % M);
  const long long b = item / M / Q;
  const int groups = D >> 2;
  const int LPn = lv.n * P;
  const float* lp = loc + item * LPn * 2;
  const float* ap = attn + item * LPn;
  const long long row = static_cast<long long>(M) * D;  // one pixel of value
  const T* vb = value + b * S * row + static_cast<long long>(m) * D;
  float4 acc[K];
#pragma unroll
  for (int k = 0; k < K; ++k) acc[k] = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l = 0; l < lv.n; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const T* vl = vb + static_cast<long long>(lv.start[l]) * row;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float a = ap[i];
      const Point pt = sample_point(lp[2 * i], lp[2 * i + 1], h, w);
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
        const int y = pt.y0 + dy;
        if (y < 0 || y >= h) continue;
        const float wy = dy ? pt.ty : 1.f - pt.ty;
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          const int x = pt.x0 + dx;
          if (x < 0 || x >= w) continue;
          const float cw = a * (wy * (dx ? pt.tx : 1.f - pt.tx));
          const T* vp = vl + static_cast<long long>(y * w + x) * row;
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int j = lane + k * LP;
            if (j < groups) fma4(acc[k], cw, load4(vp + 4 * j));
          }
        }
      }
    }
  }
  float* op = out + item * D;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * LP;
    if (j < groups) store4(op + 4 * j, acc[k]);
  }
}

template <int LP>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, LP);
  return v;
}

// The same items and lanes as the forward. Every lane of a warp takes part
// in the shuffles: an item past the end computes on zeros and writes nothing.
template <typename T, int LP, int K>
__global__ void __launch_bounds__(THREADS)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, const float* __restrict__ g,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ dattn, Levels lv, int B, int S, int Q, int M, int D,
                int P) {
  const long long items = static_cast<long long>(B) * Q * M;
  long long item = static_cast<long long>(blockIdx.x) * (THREADS / LP) + threadIdx.x / LP;
  const bool live = item < items;
  if (!live) item = items - 1;  // read in bounds, write nothing
  const int lane = threadIdx.x % LP;
  const int m = static_cast<int>(item % M);
  const long long b = item / M / Q;
  const int groups = D >> 2;
  const int LPn = lv.n * P;
  const float* lp = loc + item * LPn * 2;
  const float* ap = attn + item * LPn;
  const long long row = static_cast<long long>(M) * D;
  const long long vofs = b * S * row + static_cast<long long>(m) * D;
  float4 gg[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int j = lane + k * LP;
    gg[k] = (live && j < groups) ? load4(g + item * D + 4 * j) : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int l = 0; l < lv.n; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const long long lofs = vofs + static_cast<long long>(lv.start[l]) * row;
    for (int p = 0; p < P; ++p) {
      const int i = l * P + p;
      const float a = ap[i];
      const Point pt = sample_point(lp[2 * i], lp[2 * i + 1], h, w);
      const float wy[2] = {1.f - pt.ty, pt.ty}, wx[2] = {1.f - pt.tx, pt.tx};
      float s[2][2];  // each corner's values . g over this lane's channels
#pragma unroll
      for (int dy = 0; dy < 2; ++dy) {
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) {
          s[dy][dx] = 0.f;
          const int y = pt.y0 + dy, x = pt.x0 + dx;
          if (!live || y < 0 || y >= h || x < 0 || x >= w) continue;
          const long long ofs = lofs + static_cast<long long>(y * w + x) * row;
          const float cw = a * (wy[dy] * wx[dx]);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int j = lane + k * LP;
            if (j >= groups) continue;
            s[dy][dx] += dot4(load4(value + ofs + 4 * j), gg[k]);
            float* dv = dvalue + ofs + 4 * j;
            atomicAdd(dv, cw * gg[k].x);
            atomicAdd(dv + 1, cw * gg[k].y);
            atomicAdd(dv + 2, cw * gg[k].z);
            atomicAdd(dv + 3, cw * gg[k].w);
          }
        }
      }
#pragma unroll
      for (int dy = 0; dy < 2; ++dy)
#pragma unroll
        for (int dx = 0; dx < 2; ++dx) s[dy][dx] = group_sum<LP>(s[dy][dx]);
      if (live && lane == 0) {
        const float blend = wy[0] * (wx[0] * s[0][0] + wx[1] * s[0][1]) +
                            wy[1] * (wx[0] * s[1][0] + wx[1] * s[1][1]);
        const float dtx = wy[0] * (s[0][1] - s[0][0]) + wy[1] * (s[1][1] - s[1][0]);
        const float dty = wx[0] * (s[1][0] - s[0][0]) + wx[1] * (s[1][1] - s[0][1]);
        dattn[item * LPn + i] = blend;
        dloc[(item * LPn + i) * 2] = a * dtx * static_cast<float>(w);
        dloc[(item * LPn + i) * 2 + 1] = a * dty * static_cast<float>(h);
      }
    }
  }
}

bool read_levels(const int* levels, int L, Levels& lv) {
  if (L < 1 || L > MAX_LEVELS) return false;
  lv.n = L;
  for (int l = 0; l < L; ++l) {
    lv.h[l] = levels[3 * l];
    lv.w[l] = levels[3 * l + 1];
    lv.start[l] = levels[3 * l + 2];
  }
  return true;
}

// LP lanes an item and K channel groups a lane for head dim D (a multiple
// of 8 up to 256): the fewest lanes of 8, 16 or 32 that hold D / 4 groups,
// then a second group a lane above 128 channels
template <typename F>
cudaError_t dispatch(int D, F&& f) {
  if (D < 8 || D % 8 || D > 256) return cudaErrorInvalidValue;
  const int groups = D / 4;
  if (groups <= 8) return f(std::integral_constant<int, 8>{}, std::integral_constant<int, 1>{});
  if (groups <= 16) return f(std::integral_constant<int, 16>{}, std::integral_constant<int, 1>{});
  if (groups <= 32) return f(std::integral_constant<int, 32>{}, std::integral_constant<int, 1>{});
  return f(std::integral_constant<int, 32>{}, std::integral_constant<int, 2>{});
}

}  // namespace

SFT_EXPORT int sft_ms_deform_attn_fwd(const void* value, const void* loc, const void* attn,
                                      void* out, const int* levels, int L, int B, int S, int Q,
                                      int M, int D, int P, int dtype, void* stream) {
  Levels lv;
  if (!read_levels(levels, L, lv) || B < 1 || Q < 1 || M < 1 || P < 1) return cudaErrorInvalidValue;
  const long long items = static_cast<long long>(B) * Q * M;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(D, [&](auto lp_c, auto k_c) -> cudaError_t {
    constexpr int LP = decltype(lp_c)::value, K = decltype(k_c)::value;
    const dim3 grid(static_cast<unsigned>((items + THREADS / LP - 1) / (THREADS / LP)));
    const auto* lf = static_cast<const float*>(loc);
    const auto* af = static_cast<const float*>(attn);
    auto* o = static_cast<float*>(out);
    if (dtype == SFT_BF16)
      msda_fwd_kernel<__nv_bfloat16, LP, K><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(value), lf, af, o, lv, B, S, Q, M, D, P);
    else
      msda_fwd_kernel<float, LP, K><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(value), lf, af, o, lv, B, S, Q, M, D, P);
    return cudaGetLastError();
  });
}

SFT_EXPORT int sft_ms_deform_attn_bwd(const void* value, const void* loc, const void* attn,
                                      const void* g, void* dvalue, void* dloc, void* dattn,
                                      const int* levels, int L, int B, int S, int Q, int M,
                                      int D, int P, int dtype, void* stream) {
  Levels lv;
  if (!read_levels(levels, L, lv) || B < 1 || Q < 1 || M < 1 || P < 1) return cudaErrorInvalidValue;
  const long long items = static_cast<long long>(B) * Q * M;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(D, [&](auto lp_c, auto k_c) -> cudaError_t {
    constexpr int LP = decltype(lp_c)::value, K = decltype(k_c)::value;
    const dim3 grid(static_cast<unsigned>((items + THREADS / LP - 1) / (THREADS / LP)));
    const auto* lf = static_cast<const float*>(loc);
    const auto* af = static_cast<const float*>(attn);
    const auto* gf = static_cast<const float*>(g);
    auto* dv = static_cast<float*>(dvalue);
    auto* dl = static_cast<float*>(dloc);
    auto* da = static_cast<float*>(dattn);
    if (dtype == SFT_BF16)
      msda_bwd_kernel<__nv_bfloat16, LP, K><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(value), lf, af, gf, dv, dl, da, lv, B, S, Q, M, D,
          P);
    else
      msda_bwd_kernel<float, LP, K><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(value), lf, af, gf, dv, dl, da, lv, B, S, Q, M, D, P);
    return cudaGetLastError();
  });
}
