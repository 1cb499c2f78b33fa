// K5b: backward of K5 for the levels smaller than the output. Given the
// cotangent g (B, H, W, E) of out = sum_l upsample(z_l), writes each smaller
// level's dz_l (B, h_l, w_l, E) = the exact transpose of its bilinear
// upsample applied to g, accumulated in float32, in g's dtype. (A level of
// the output's size gets g itself; the wrapper hands it back.)
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_resize_sum.py
// `_backward` (:239, body `_bwd_kernel` :191), a polyphase transpose of
// dyadic pyramids with per-tile halo rows folded back by XLA.
//
// What bounds it on the H100: bytes (g is read once per level from device
// memory, a few flops per element). Design: a gather, so no atomics. One
// thread owns one low-resolution pixel and 4 channels; it visits the fine
// rows and columns whose bilinear taps can include it, recomputes each
// fine pixel's taps with the forward's formula ((dst + 0.5) * (h/H) - 0.5,
// clamped at the edge) and adds g times the weight the forward gave this
// pixel. The same loop covers every ratio, dyadic or not, and the edge
// clamp (where both taps are one source pixel, its weights add up to 1).
// Neighbouring threads take neighbouring channels, so the loads of g are
// coalesced; the ~4 readers of each fine pixel share it through L2.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;

struct Levels {
  void* dst[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  long begin[MAX_LEVELS + 1];  // first thread of each level
  int n;
};

// weight of source index `src` in the sample of output index `dst`
__device__ __forceinline__ float tap_weight(int dst, int n_in, int n_out, int src) {
  int i0, i1;
  float f;
  bilinear_tap(dst, n_in, n_out, i0, i1, f);
  return (i0 == src ? 1.f - f : 0.f) + (i1 == src ? f : 0.f);
}

// the output indices whose taps may include source index `src`, with a margin
__device__ __forceinline__ void footprint(int src, int n_in, int n_out, int& lo, int& hi) {
  const float r = (float)n_out / (float)n_in;
  lo = max(0, (int)floorf((src - 0.5f) * r - 0.5f) - 1);
  hi = min(n_out - 1, (int)ceilf((src + 1.5f) * r - 0.5f) + 1);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
resize_sum_bwd_kernel(const T* __restrict__ g, Levels lv, int H, int W, int E) {
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lv.begin[lv.n]) return;
  int l = 0;
  while (idx >= lv.begin[l + 1]) ++l;
  const int h = lv.h[l], w = lv.w[l];
  const int eq = E / 4;
  const long local = idx - lv.begin[l];
  const int e4 = (int)(local % eq) * 4;
  const long pix = local / eq;
  const int x = (int)(pix % w);
  const int y = (int)((pix / w) % h);
  const int b = (int)(pix / ((long)w * h));

  int ylo, yhi, xlo, xhi;
  footprint(y, h, H, ylo, yhi);
  footprint(x, w, W, xlo, xhi);
  const T* gb = g + (long)b * H * W * E + e4;
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int Y = ylo; Y <= yhi; ++Y) {
    const float wy = tap_weight(Y, h, H, y);
    if (wy == 0.f) continue;
    for (int X = xlo; X <= xhi; ++X) {
      const float wx = tap_weight(X, w, W, x);
      if (wx == 0.f) continue;
      const float wt = wy * wx;
      fma4(acc, wt, load4(gb + ((long)Y * W + X) * E));
    }
  }
  T* dst = static_cast<T*>(lv.dst[l]);
  store4(dst + pix * E + e4, acc);
}

}  // namespace

// dsts/hs/ws: the n smaller levels' outputs (B, h, w, E) and their sizes.
SFT_EXPORT int sft_resize_sum_bwd(const void* g, void* const* dsts, const int* hs,
                                  const int* ws, int n, int B, int H, int W, int E, int dtype,
                                  void* stream) {
  if (n < 1 || n > MAX_LEVELS || E % 4 || B < 1) return cudaErrorInvalidValue;
  Levels lv;
  lv.n = n;
  lv.begin[0] = 0;
  for (int i = 0; i < n; ++i) {
    lv.dst[i] = dsts[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
    lv.begin[i + 1] = lv.begin[i] + (long)B * hs[i] * ws[i] * (E / 4);
  }
  const long blocks = (lv.begin[n] + THREADS - 1) / THREADS;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32)
    resize_sum_bwd_kernel<float><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const float*>(g), lv, H, W, E);
  else if (dtype == SFT_BF16)
    resize_sum_bwd_kernel<__nv_bfloat16><<<(unsigned)blocks, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(g), lv, H, W, E);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}
