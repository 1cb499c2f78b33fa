// K8: label map = argmax over channels of the bilinear upsample of NHWC
// logits lo (B, hl, wl, C) to (B, H, W), int32, first index on ties; the
// upsample is computed in float32 whatever lo's dtype.
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_loss.py
// `resize_argmax_to` (:377, body `_argmax_kernel` :338), a polyphase upsample
// of dyadic scales in VMEM behind a shape gate.
//
// What bounds it on the H100: bytes (the int32 map written once; the
// low-resolution logits are 1/s^2 of the full-resolution ones). Design: one
// thread per output pixel computes its 2x2 taps once, then walks the C
// channels (contiguous in NHWC) keeping a running max, so the full-resolution
// logits never exist anywhere; neighbouring threads share taps through L1/L2.
// Any output size works, which is why no shape gate is carried over.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(THREADS)
resize_argmax_kernel(const T* __restrict__ lo, int* __restrict__ out, int B, int hl, int wl,
                     int C, int H, int W) {
  const long total = (long)B * H * W;
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= total) return;
  const int x = (int)(idx % W);
  const int y = (int)((idx / W) % H);
  const int b = (int)(idx / ((long)W * H));
  int y0, y1, x0, x1;
  float fy, fx;
  bilinear_tap(y, hl, H, y0, y1, fy);
  bilinear_tap(x, wl, W, x0, x1, fx);
  const T* img = lo + (long)b * hl * wl * C;
  const T* pa = img + ((long)y0 * wl + x0) * C;
  const T* pc = img + ((long)y1 * wl + x0) * C;
  const T* pb = img + ((long)y0 * wl + x1) * C;
  const T* pd = img + ((long)y1 * wl + x1) * C;
  const float gy = 1.f - fy, gx = 1.f - fx;
  float best = -INFINITY;
  int arg = 0;
  for (int c = 0; c < C; ++c) {
    // rows first, then columns, as the plain version
    const float v = gx * (gy * to_f32(pa[c]) + fy * to_f32(pc[c])) +
                    fx * (gy * to_f32(pb[c]) + fy * to_f32(pd[c]));
    if (v > best) {  // strict: the first index wins a tie
      best = v;
      arg = c;
    }
  }
  out[idx] = arg;
}

template <typename T>
cudaError_t launch(const void* lo, int* out, int B, int hl, int wl, int C, int H, int W,
                   cudaStream_t stream) {
  const long total = (long)B * H * W;
  const long blocks = (total + THREADS - 1) / THREADS;
  resize_argmax_kernel<T><<<(unsigned)blocks, THREADS, 0, stream>>>(
      static_cast<const T*>(lo), out, B, hl, wl, C, H, W);
  return cudaGetLastError();
}

}  // namespace

SFT_EXPORT int sft_resize_argmax(const void* lo, void* out, int B, int hl, int wl, int C,
                                 int H, int W, int dtype, void* stream) {
  if (B < 1 || hl < 1 || wl < 1 || C < 1 || H < 1 || W < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int* o = static_cast<int*>(out);
  if (dtype == SFT_F32) return launch<float>(lo, o, B, hl, wl, C, H, W, st);
  if (dtype == SFT_BF16) return launch<__nv_bfloat16>(lo, o, B, hl, wl, C, H, W, st);
  return cudaErrorInvalidValue;
}
