// K5: out = sum over levels of the bilinear upsample of each level to the
// largest level's (H, W); levels NHWC (B, h_l, w_l, E) of one dtype, the
// full-size levels first. Accumulates in float32, writes the input dtype.
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_resize_sum.py
// `_forward` (:109, body `_kernel` :85), a polyphase upsample of dyadic
// pyramids in VMEM behind shape gates.
//
// What bounds it on the H100: bytes (a few flops per element). Design: one
// thread per output pixel and 4 channels. It reads the full-size levels once
// and, for every smaller level, the 2x2 taps at source coordinate
// (dst + 0.5) * (h_l / H) - 0.5 clamped at the edge, sums in float32 and
// writes once; the upsampled levels never reach device memory. Neighbouring
// threads take neighbouring channels, so every load and the store are
// coalesced, and the small levels' taps are served from L2. The one formula
// covers dyadic and non-dyadic pyramids alike.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;

struct Levels {
  const void* src[MAX_LEVELS];
  int h[MAX_LEVELS];
  int w[MAX_LEVELS];
  int n;
};

template <typename T>
__global__ void __launch_bounds__(THREADS)
resize_sum_kernel(Levels lv, T* __restrict__ out, int B, int H, int W, int E) {
  const int eq = E / 4;
  const long total = (long)B * H * W * eq;
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int e4 = (int)(idx % eq) * 4;
  const long pix = idx / eq;
  const int x = (int)(pix % W);
  const int y = (int)((pix / W) % H);
  const int b = (int)(pix / ((long)W * H));

  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int l = 0; l < lv.n; ++l) {
    const T* src = static_cast<const T*>(lv.src[l]);
    const int h = lv.h[l], w = lv.w[l];
    const T* img = src + (long)b * h * w * E + e4;
    if (h == H && w == W) {
      const float4 v = load4(img + ((long)y * w + x) * E);
      acc.x += v.x; acc.y += v.y; acc.z += v.z; acc.w += v.w;
      continue;
    }
    int y0, y1, x0, x1;
    float fy, fx;
    bilinear_tap(y, h, H, y0, y1, fy);
    bilinear_tap(x, w, W, x0, x1, fx);
    const float4 a = load4(img + ((long)y0 * w + x0) * E);
    const float4 c = load4(img + ((long)y1 * w + x0) * E);
    const float4 bb = load4(img + ((long)y0 * w + x1) * E);
    const float4 d = load4(img + ((long)y1 * w + x1) * E);
    // rows first, then columns, as the plain version
    const float gy = 1.f - fy, gx = 1.f - fx;
    acc.x += gx * (gy * a.x + fy * c.x) + fx * (gy * bb.x + fy * d.x);
    acc.y += gx * (gy * a.y + fy * c.y) + fx * (gy * bb.y + fy * d.y);
    acc.z += gx * (gy * a.z + fy * c.z) + fx * (gy * bb.z + fy * d.z);
    acc.w += gx * (gy * a.w + fy * c.w) + fx * (gy * bb.w + fy * d.w);
  }
  store4(out + pix * E + e4, acc);
}

template <typename T>
cudaError_t launch(const Levels& lv, void* out, int B, int H, int W, int E,
                   cudaStream_t stream) {
  const long total = (long)B * H * W * (E / 4);
  const long blocks = (total + THREADS - 1) / THREADS;
  resize_sum_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(lv, static_cast<T*>(out),
                                                                 B, H, W, E);
  return cudaGetLastError();
}

}  // namespace

SFT_EXPORT int sft_resize_sum(const void* const* srcs, const int* hs, const int* ws, int n,
                              void* out, int B, int H, int W, int E, int dtype,
                              void* stream) {
  if (n < 1 || n > MAX_LEVELS || E % 4) return cudaErrorInvalidValue;
  Levels lv;
  lv.n = n;
  for (int i = 0; i < n; ++i) {
    lv.src[i] = srcs[i];
    lv.h[i] = hs[i];
    lv.w[i] = ws[i];
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32) return launch<float>(lv, out, B, H, W, E, st);
  if (dtype == SFT_BF16) return launch<__nv_bfloat16>(lv, out, B, H, W, E, st);
  return cudaErrorInvalidValue;
}
