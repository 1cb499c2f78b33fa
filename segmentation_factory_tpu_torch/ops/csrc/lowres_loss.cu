// K7f / K7b: cross-entropy and dice on the bilinear upsample of low-resolution
// logits lo (B, hl, wl, C) to the labels' (B, H, W), without the
// full-resolution logits ever existing. labels are int32; `ignore` marks
// void pixels; a label outside [0, C) that is not `ignore` is valid with an
// all-zero one-hot row (as jax.nn.one_hot gives).
//
// Replaces the TPU kernels segmentation_factory_tpu/ops/pallas_loss.py
// `_forward` (:261, body `_fwd_kernel` :120) and `_backward` (:292, body
// `_bwd_kernel` :151), which upsample polyphase in VMEM for dyadic scales.
//
// K7f writes, per fine pixel, the CE loss lse - logit[label] (float32,
// (B, H, W)), and adds per image and class the dice partials
// inter = sum p*y, psum = sum p, ysum = sum y over valid pixels into a
// zeroed (B, 3, C) float32 buffer. The OHEM keep-set and the scalars stay in
// the caller's glue, as in the JAX package.
// K7b regenerates each fine pixel's softmax and writes the low-resolution
// cotangent (B, hl, wl, C) float32 of
//   dhi_c = wmap * (p_c - y_c) + p_c * (q_c - sum_k q_k p_k),
//   q_c = valid * (dI_c * y_c + dP_c),
// where wmap (B, H, W) is the per-pixel CE weight (OHEM keep / weight sum)
// and dcoef (B, 2, C) holds dL/dI and dL/dP of the dice term; the caller
// multiplies by the scalar's cotangent.
//
// What bounds them on the H100: bytes (labels and the loss map at full
// resolution, the logits at 1/s^2 of it; ~10 flops and one exp per class
// and fine pixel). Design:
// - K7f: one thread per fine pixel computes its 2x2 taps once and walks the
//   C channels three times (max, sum of exp, then p for the dice sums),
//   reading the 4 tap rows from L1/L2; the dice partials are warp-reduced,
//   then block-reduced in shared memory and added to the global buffer with
//   one atomicAdd per block and value. A block never straddles two images.
// - K7b is a gather, no atomics: one thread per low-resolution pixel visits
//   every fine pixel whose taps can include it (the footprint of K5b),
//   recomputes that pixel's softmax into registers and adds the tap weight
//   times dhi to C accumulators in registers. Each fine pixel is recomputed
//   by the ~4 low-resolution pixels it samples.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;

struct Taps {
  long a, b, c, d;  // element offsets of the (y0,x0), (y0,x1), (y1,x0), (y1,x1) rows
  float gy, fy, gx, fx;
};

__device__ __forceinline__ Taps taps(int Y, int X, int hl, int wl, int H, int W, int C) {
  int y0, y1, x0, x1;
  float fy, fx;
  bilinear_tap(Y, hl, H, y0, y1, fy);
  bilinear_tap(X, wl, W, x0, x1, fx);
  Taps t;
  t.a = ((long)y0 * wl + x0) * C;
  t.b = ((long)y0 * wl + x1) * C;
  t.c = ((long)y1 * wl + x0) * C;
  t.d = ((long)y1 * wl + x1) * C;
  t.gy = 1.f - fy; t.fy = fy; t.gx = 1.f - fx; t.fx = fx;
  return t;
}

// the upsampled logit of channel c: rows first, then columns, as resize()
template <typename T>
__device__ __forceinline__ float sample(const T* img, const Taps& t, int c) {
  return t.gx * (t.gy * to_f32(img[t.a + c]) + t.fy * to_f32(img[t.c + c])) +
         t.fx * (t.gy * to_f32(img[t.b + c]) + t.fy * to_f32(img[t.d + c]));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// grid (ceil(H*W / THREADS), B); shared memory 3*C floats
template <typename T>
__global__ void __launch_bounds__(THREADS)
loss_fwd_kernel(const T* __restrict__ lo, const int* __restrict__ lab, float* __restrict__ loss,
                float* __restrict__ parts, int hl, int wl, int C, int H, int W, int ignore) {
  extern __shared__ float red[];  // inter[C], psum[C], ysum[C]
  for (int i = threadIdx.x; i < 3 * C; i += THREADS) red[i] = 0.f;
  __syncthreads();
  const int b = blockIdx.y;
  const long pix = (long)blockIdx.x * THREADS + threadIdx.x;
  const bool here = pix < (long)H * W;
  const long at = (long)b * H * W + pix;
  const T* img = lo + (long)b * hl * wl * C;
  int label = ignore;
  Taps t{};
  float m = -INFINITY, se = 0.f;
  if (here) {
    label = lab[at];
    t = taps((int)(pix / W), (int)(pix % W), hl, wl, H, W, C);
    for (int c = 0; c < C; ++c) m = fmaxf(m, sample(img, t, c));
    float picked = 0.f;
    for (int c = 0; c < C; ++c) {
      const float v = sample(img, t, c);
      se += expf(v - m);
      if (c == label && label != ignore) picked = v;
    }
    loss[at] = m + logf(se) - picked;
  }
  const bool valid = here && label != ignore;
  const bool onehot = valid && label >= 0 && label < C;
  const float inv = valid ? 1.f / se : 0.f;
  const int lane = threadIdx.x & 31;
  for (int c = 0; c < C; ++c) {
    const float p = valid ? expf(sample(img, t, c) - m) * inv : 0.f;
    const float ps = warp_sum(p);
    if (lane == 0 && ps != 0.f) atomicAdd(red + C + c, ps);
    if (onehot && c == label) atomicAdd(red + c, p);
  }
  if (onehot) atomicAdd(red + 2 * C + label, 1.f);
  __syncthreads();
  for (int i = threadIdx.x; i < 3 * C; i += THREADS)
    if (red[i] != 0.f) atomicAdd(parts + (long)b * 3 * C + i, red[i]);
}

// grid ceil(B*hl*wl / THREADS); C <= MAXC
template <typename T, int MAXC>
__global__ void __launch_bounds__(THREADS)
loss_bwd_kernel(const T* __restrict__ lo, const int* __restrict__ lab,
                const float* __restrict__ wmap, const float* __restrict__ dcoef,
                float* __restrict__ dlo, int B, int hl, int wl, int C, int H, int W,
                int ignore) {
  const long idx = (long)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= (long)B * hl * wl) return;
  const int x = (int)(idx % wl);
  const int y = (int)((idx / wl) % hl);
  const int b = (int)(idx / ((long)wl * hl));
  const T* img = lo + (long)b * hl * wl * C;
  const float* di = dcoef + (long)b * 2 * C;
  const float* dp = di + C;
  // fine rows / columns whose taps may include (y, x), with a margin
  const float ry = (float)H / hl, rx = (float)W / wl;
  const int ylo = max(0, (int)floorf((y - 0.5f) * ry - 0.5f) - 1);
  const int yhi = min(H - 1, (int)ceilf((y + 1.5f) * ry - 0.5f) + 1);
  const int xlo = max(0, (int)floorf((x - 0.5f) * rx - 0.5f) - 1);
  const int xhi = min(W - 1, (int)ceilf((x + 1.5f) * rx - 0.5f) + 1);

  float acc[MAXC], v[MAXC];
#pragma unroll
  for (int c = 0; c < MAXC; ++c) acc[c] = 0.f;
  for (int Y = ylo; Y <= yhi; ++Y) {
    int y0, y1;
    float fy;
    bilinear_tap(Y, hl, H, y0, y1, fy);
    const float wy = (y0 == y ? 1.f - fy : 0.f) + (y1 == y ? fy : 0.f);
    if (wy == 0.f) continue;
    for (int X = xlo; X <= xhi; ++X) {
      int x0, x1;
      float fx;
      bilinear_tap(X, wl, W, x0, x1, fx);
      const float wx = (x0 == x ? 1.f - fx : 0.f) + (x1 == x ? fx : 0.f);
      if (wx == 0.f) continue;
      const long at = ((long)b * H + Y) * W + X;
      const int label = lab[at];
      const bool valid = label != ignore;
      const Taps t = taps(Y, X, hl, wl, H, W, C);
      float m = -INFINITY;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) {
          v[c] = sample(img, t, c);
          m = fmaxf(m, v[c]);
        }
      float se = 0.f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) {
          v[c] = expf(v[c] - m);
          se += v[c];
        }
      const float inv = 1.f / se;
      float inner = 0.f;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) {
          v[c] *= inv;  // p
          if (valid) inner += v[c] * ((c == label ? di[c] : 0.f) + dp[c]);
        }
      const float wce = wmap[at];
      const float wt = wy * wx;
#pragma unroll
      for (int c = 0; c < MAXC; ++c)
        if (c < C) {
          const float yc = valid && c == label ? 1.f : 0.f;
          const float q = valid ? di[c] * yc + dp[c] : 0.f;
          acc[c] = fmaf(wt, wce * (v[c] - yc) + v[c] * (q - inner), acc[c]);
        }
    }
  }
  float* out = dlo + idx * C;
#pragma unroll
  for (int c = 0; c < MAXC; ++c)
    if (c < C) out[c] = acc[c];
}

template <typename T>
cudaError_t launch_fwd(const void* lo, const int* lab, float* loss, float* parts, int B, int hl,
                       int wl, int C, int H, int W, int ignore, cudaStream_t stream) {
  const dim3 grid((unsigned)(((long)H * W + THREADS - 1) / THREADS), B);
  loss_fwd_kernel<T><<<grid, THREADS, 3 * C * sizeof(float), stream>>>(
      static_cast<const T*>(lo), lab, loss, parts, hl, wl, C, H, W, ignore);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_bwd(const void* lo, const int* lab, const float* wmap, const float* dcoef,
                       float* dlo, int B, int hl, int wl, int C, int H, int W, int ignore,
                       cudaStream_t stream) {
  const long blocks = ((long)B * hl * wl + THREADS - 1) / THREADS;
  const T* l = static_cast<const T*>(lo);
  if (C <= 32)
    loss_bwd_kernel<T, 32><<<(unsigned)blocks, THREADS, 0, stream>>>(l, lab, wmap, dcoef, dlo, B,
                                                                     hl, wl, C, H, W, ignore);
  else if (C <= 256)
    loss_bwd_kernel<T, 256><<<(unsigned)blocks, THREADS, 0, stream>>>(l, lab, wmap, dcoef, dlo,
                                                                      B, hl, wl, C, H, W, ignore);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

bool bad_shape(int B, int hl, int wl, int C, int H, int W) {
  return B < 1 || hl < 1 || wl < 1 || C < 1 || H < 1 || W < 1 || 3 * C * 4 > 48 * 1024;
}

}  // namespace

// loss: (B, H, W) float32 out; parts: zeroed (B, 3, C) float32.
SFT_EXPORT int sft_lowres_loss_fwd(const void* lo, const void* labels, void* loss, void* parts,
                                   int B, int hl, int wl, int C, int H, int W, int ignore,
                                   int dtype, void* stream) {
  if (bad_shape(B, hl, wl, C, H, W)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  float* l = static_cast<float*>(loss);
  float* p = static_cast<float*>(parts);
  if (dtype == SFT_F32) return launch_fwd<float>(lo, lab, l, p, B, hl, wl, C, H, W, ignore, st);
  if (dtype == SFT_BF16)
    return launch_fwd<__nv_bfloat16>(lo, lab, l, p, B, hl, wl, C, H, W, ignore, st);
  return cudaErrorInvalidValue;
}

// wmap: (B, H, W) float32; dcoef: (B, 2, C) float32; dlo: (B, hl, wl, C) float32 out.
SFT_EXPORT int sft_lowres_loss_bwd(const void* lo, const void* labels, const void* wmap,
                                   const void* dcoef, void* dlo, int B, int hl, int wl, int C,
                                   int H, int W, int ignore, int dtype, void* stream) {
  if (bad_shape(B, hl, wl, C, H, W)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* wm = static_cast<const float*>(wmap);
  const float* dc = static_cast<const float*>(dcoef);
  float* out = static_cast<float*>(dlo);
  if (dtype == SFT_F32)
    return launch_bwd<float>(lo, lab, wm, dc, out, B, hl, wl, C, H, W, ignore, st);
  if (dtype == SFT_BF16)
    return launch_bwd<__nv_bfloat16>(lo, lab, wm, dc, out, B, hl, wl, C, H, W, ignore, st);
  return cudaErrorInvalidValue;
}
