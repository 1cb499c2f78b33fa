// K2b: Mix-FFN backward. For out = fc2(GELU(dw3x3(fc1(y)))) on an NHWC map
// (the layouts of mixffn.cu) and its cotangent g (B, H, W, C), writes dy
// (like y) and accumulates the six parameter gradients into zeroed float32
// buffers dw1 (C, HC), db1 (HC), ddw (3, 3, 1, HC), ddb (HC), dw2 (HC, C),
// db2 (C).
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_ffn.py
// `_bwd_rule` (:351, body `_bwd_kernel` :119), which recomputes the 4C
// hidden activation per row tile with a two-row halo and accumulates the
// weight gradients across a sequential grid. The JAX package sends
// C = 512-like shapes to an XLA recompute-VJP because VMEM is too small;
// this kernel takes every MiT stage.
//
// What bounds it on the H100: operations (fc1, g W2^T, dW2, dW1 and dy:
// five C x HC products per pixel against y, g and dy moved once). The
// hidden activation and its gradient never reach device memory.
// Design: one block of 256 threads owns a TH x 8 tile of pixels of one image
// and walks the hidden channels in chunks of 32. Per chunk:
// 1. fc1 (+ b1, zero outside the image) on the tile and a 2-pixel ring, and
//    dhg = g W2^T on the tile and a 1-pixel ring (g zero outside the image),
//    both from C-slices of y, g, W1 and W2 staged in shared memory;
// 2. hd = dwconv(h1) + db on the 1-ring; dhd = dhg * GELU'(hd) there and
//    hg = GELU(hd) on the tile;
// 3. dh1 = the transposed 3x3 taps of dhd on the tile (zero outside);
// 4. the chunk's slices of ddw, ddb, db1 (reduced in shared memory), dW2 =
//    hg^T g and dW1 = y^T dh1, added to the float32 buffers with atomicAdd
//    (every block adds its partial: no second pass, no scratch);
// 5. dy += dh1 W1^T into float32 accumulators in registers, stored once.
// - bfloat16 (the training path): the five products on the tensor cores
//   (WMMA 16x16x16, float32 accumulation). The tile's y and g (all of C)
//   and the chunk's W1 and W2 stay in shared memory; the 2-ring y and the
//   1-ring g come in 32-channel slices. hg and dh1 are rounded to bfloat16
//   as the products' operands, as the TPU kernel does; h1 and dhd stay
//   float32. A warp stages each 16x16 weight-gradient tile in shared memory
//   and adds it with 16-byte atomicAdd(float4). The launcher lowers TH until the shared
//   memory fits (TH = 16/16/6/4 need 183-201 KB at C = 64..512).
// - float32: the same dataflow on float32 FMAs from shared memory, exact to
//   the float32 rounding of the plain version; atomics reorder the weight
//   sums.
//
// K4b, the FFN half-block backward, is the same kernel with BLOCK set, for
// out = x + fac[b] * ffn(LN2(x)) (mixffn.cu's K4f): it writes dx and adds
// dlg, dlb (C) to two more zeroed float32 buffers. It replaces the TPU kernel
// segmentation_factory_tpu/ops/pallas_block.py `_ffn_bwd_rule` (:691, body
// `_ffn_bwd_kernel` :468). Three additions: LN2 recomputed on the 2-pixel
// ring (float32 mean and 1/sigma per pixel from one warp, applied and
// rounded as y is staged); the branch cotangent g * fac, rounded, wherever g
// is staged (the 1-ring, the tile, db2); and the LN backward epilogue: the
// float32 dy accumulators (dln, every pixel's full C) are staged in shared
// memory, a warp per pixel forms dx = g + rs * (gl - mean(gl) - xhat *
// mean(gl * xhat)) with gl = dln * scale, and the tile's column sums of
// dln * xhat and dln go to dlg and dlb with float32 atomics. The JAX
// package's exit to an XLA recompute-VJP for wide shapes has no counterpart.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HCH = 32;     // hidden channels per chunk
constexpr int KC = 32;      // C slice staged at a time
constexpr int YS = KC + 1;  // padded strides: conflict-free scalar column reads
constexpr int GS = HCH + 1;
constexpr int NE1 = 8;      // fc1 (pixel, 4-channel) items per thread: 2-ring <= 256 pixels
constexpr int NE2 = 6;      // dhg items per thread: 1-ring <= 192 pixels
constexpr int NACC = 16;    // dy pixels per thread
constexpr int MAXU = 16;    // float4 column groups per thread in dW1/dW2: C <= 512
constexpr int NRED = 11;    // 9 taps + ddb + db1

struct Geometry {
  int TH, TW, P, W1r, R1, W2r, R2, C;
  int ys, gs, w1s, w2s, h1, dhd, hg, dh1, red, w1t, wld, floats, st, total;
  __host__ __device__ Geometry(int th, int tw, int c) {
    TH = th; TW = tw; C = c;
    P = th * tw;
    W1r = tw + 2; R1 = (th + 2) * W1r;
    W2r = tw + 4; R2 = (th + 4) * W2r;
    wld = c + 4;
    ys = 0;
    gs = ys + R2 * YS;
    w1s = (gs + R1 * YS + 3) & ~3;  // float4-aligned from here on
    w2s = w1s + KC * HCH;
    h1 = w2s + KC * HCH;
    dhd = h1 + R2 * HCH;
    hg = dhd + R1 * HCH;
    dh1 = hg + P * GS;
    red = dh1 + P * GS;
    w1t = (red + 8 * NRED * HCH + 3) & ~3;
    floats = w1t + HCH * wld;
    // K4b: dy staged over the dead buffers (P x wld from 0), LN2 stats after
    st = ((floats > P * wld ? floats : P * wld) + 1) & ~1;
    total = st + 2 * R2;
  }
};

// K4b's epilogue for one tile: dln of its P pixels in os (row stride ld,
// float32) -> dx = g + LN2'(x)^T dln at the pixels inside the image, and the
// tile's column sums of dln * xhat and dln added to dlg, dlb. st holds each
// 2-ring pixel's LN2 (mean, 1/sigma); xb, gb, dxb are the image's base.
template <typename T>
__device__ void ln_bwd_tile(const float* os, int ld, const float2* st, const T* __restrict__ xb,
                            const T* __restrict__ gb, T* __restrict__ dxb,
                            const float* __restrict__ lg, float* __restrict__ dlg,
                            float* __restrict__ dlb, int P, int TW, int y0, int x0, int H, int W,
                            int C) {
  const int lane = threadIdx.x & 31;
  const int w2r = TW + 4;
  for (int p = threadIdx.x >> 5; p < P; p += THREADS / 32) {
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const float2 s = st[(p / TW + 2) * w2r + p % TW + 2];
    const long at = ((long)gy * W + gx) * C;
    float s1 = 0.f, s2 = 0.f;
    for (int c = lane; c < C; c += 32) {
      const float gl = os[p * ld + c] * lg[c];
      s1 += gl;
      s2 += gl * (to_f32(xb[at + c]) - s.x) * s.y;
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
    for (int c = lane; c < C; c += 32) {
      const float gl = os[p * ld + c] * lg[c];
      const float xh = (to_f32(xb[at + c]) - s.x) * s.y;
      dxb[at + c] = from_f32<T>(to_f32(gb[at + c]) + s.y * (gl - s1 - xh * s2));
    }
  }
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float sg = 0.f, sb = 0.f;
    for (int p = 0; p < P; ++p) {
      const int gy = y0 + p / TW, gx = x0 + p % TW;
      if (gy >= H || gx >= W) continue;
      const float2 s = st[(p / TW + 2) * w2r + p % TW + 2];
      const float dl = os[p * ld + c];
      sg += dl * (to_f32(xb[((long)gy * W + gx) * C + c]) - s.x) * s.y;
      sb += dl;
    }
    atomicAdd(dlg + c, sg);
    atomicAdd(dlb + c, sb);
  }
}

// LN2 statistics of every pixel of the 2-ring around a tile, a warp per pixel
template <typename T>
__device__ void ring_stats(const T* __restrict__ xb, float2* st, int R2, int w2r, int y0, int x0,
                           int H, int W, int C) {
  for (int p = threadIdx.x >> 5; p < R2; p += THREADS / 32) {
    const int gy = y0 + p / w2r - 2, gx = x0 + p % w2r - 2;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float2 v = warp_ln_stats(in ? xb + ((long)gy * W + gx) * C : nullptr, C);
    if ((threadIdx.x & 31) == 0) st[p] = v;
  }
}

template <typename T>
__device__ __forceinline__ float4 scale4(float4 v, float f) {  // g * fac, rounded to T
  return make_float4(to_f32(from_f32<T>(v.x * f)), to_f32(from_f32<T>(v.y * f)),
                     to_f32(from_f32<T>(v.z * f)), to_f32(from_f32<T>(v.w * f)));
}

__device__ __forceinline__ float erf_cdf(float x) {
  return 0.5f * (1.0f + erff(x * 0.70710678118654752f));
}

// BLOCK: K4b, y is the raw x and dy is dx (unread otherwise: lg, lb, fac, dlg, dlb)
template <typename T, bool BLOCK>
__global__ void __launch_bounds__(THREADS, 1)
mixffn_bwd_kernel(const T* __restrict__ y, const T* __restrict__ w1, const T* __restrict__ b1,
                  const T* __restrict__ dw, const T* __restrict__ db, const T* __restrict__ w2,
                  const T* __restrict__ g, T* __restrict__ dy, float* __restrict__ dw1,
                  float* __restrict__ db1, float* __restrict__ ddw, float* __restrict__ ddb,
                  float* __restrict__ dw2, float* __restrict__ db2, const float* __restrict__ lg,
                  const float* __restrict__ lb, const float* __restrict__ fac,
                  float* __restrict__ dlg, float* __restrict__ dlb, int H, int W, int C, int HC,
                  int TH, int TW) {
  const Geometry G(TH, TW, C);
  extern __shared__ __align__(16) float smem[];
  float* ys = smem + G.ys;
  float* gs = smem + G.gs;
  float* w1s = smem + G.w1s;
  float* w2s = smem + G.w2s;
  float* h1 = smem + G.h1;
  float* dhd = smem + G.dhd;
  float* hg = smem + G.hg;
  float* dh1 = smem + G.dh1;
  float* red = smem + G.red;
  float* w1t = smem + G.w1t;
  float2* st = reinterpret_cast<float2*>(smem + G.st);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const long img = (long)b * H * W * C;
  const T* yb = y + img;
  const T* gb = g + img;
  const float f = BLOCK ? fac[b] : 1.f;
  if (BLOCK) {
    ring_stats(yb, st, G.R2, G.W2r, y0, x0, H, W, C);
    __syncthreads();
  }
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };
  auto tile_px = [&](int p, int& gy, int& gx) {
    gy = y0 + p / TW;
    gx = x0 + p % TW;
    return gy < H && gx < W;
  };

  // db2: the tile's column sums of g, once
  for (int c = tid; c < C; c += THREADS) {
    float s = 0.f;
    for (int p = 0; p < G.P; ++p) {
      int gy, gx;
      if (tile_px(p, gy, gx)) {
        const float gv = to_f32(gb[((long)gy * W + gx) * C + c]);
        s += BLOCK ? to_f32(from_f32<T>(gv * f)) : gv;
      }
    }
    atomicAdd(db2 + c, s);
  }

  // dy ownership (as mixffn.cu's fc2): channel group cq, pixels pg + npg*u
  const int cqn = C / 4;
  const int npg = THREADS / cqn;
  const bool active = tid < npg * cqn;
  const int cq = tid % cqn;
  const int pgy = tid / cqn;
  float4 acc[NACC];
#pragma unroll
  for (int u = 0; u < NACC; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  // weight-gradient ownership: hidden channel jj, column groups cw*4 + 32u
  const int jj = tid & 31;
  const int cw = tid >> 5;
  const int nu = C / 32;

  for (int j0 = 0; j0 < HC; j0 += HCH) {
    __syncthreads();  // the previous chunk's readers are done
    // the chunk of W1 transposed, for dy += dh1 W1^T
    for (int idx = tid; idx < C * (HCH / 4); idx += THREADS) {
      const int c = idx / (HCH / 4);
      const int j4 = (idx % (HCH / 4)) * 4;
      const float4 v = load4(w1 + (long)c * HC + j0 + j4);
      w1t[(j4 + 0) * G.wld + c] = v.x;
      w1t[(j4 + 1) * G.wld + c] = v.y;
      w1t[(j4 + 2) * G.wld + c] = v.z;
      w1t[(j4 + 3) * G.wld + c] = v.w;
    }

    // ---- 1. fc1 on the 2-ring and dhg = g W2^T on the 1-ring, over C slices
    float4 ha[NE1], ga[NE2];
#pragma unroll
    for (int u = 0; u < NE1; ++u) ha[u] = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int u = 0; u < NE2; ++u) ga[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < C; k0 += KC) {
      __syncthreads();
      for (int idx = tid; idx < G.R2 * (KC / 4); idx += THREADS) {
        const int p = idx / (KC / 4);
        const int c4 = (idx % (KC / 4)) * 4;
        const int gy = y0 + p / G.W2r - 2, gx = x0 + p % G.W2r - 2;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + c4 < C && inside(gy, gx)) {
          v = load4(yb + ((long)gy * W + gx) * C + k0 + c4);
          if (BLOCK) v = ln4<T>(v, st[p], lg, lb, k0 + c4);
        }
        float* d = ys + p * YS + c4;
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      }
      for (int idx = tid; idx < G.R1 * (KC / 4); idx += THREADS) {
        const int p = idx / (KC / 4);
        const int c4 = (idx % (KC / 4)) * 4;
        const int gy = y0 + p / G.W1r - 1, gx = x0 + p % G.W1r - 1;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + c4 < C && inside(gy, gx)) {
          v = load4(gb + ((long)gy * W + gx) * C + k0 + c4);
          if (BLOCK) v = scale4<T>(v, f);
        }
        float* d = gs + p * YS + c4;
        d[0] = v.x; d[1] = v.y; d[2] = v.z; d[3] = v.w;
      }
      for (int idx = tid; idx < KC * (HCH / 4); idx += THREADS) {
        const int kk = idx / (HCH / 4);
        const int j4 = (idx % (HCH / 4)) * 4;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k0 + kk < C) v = load4(w1 + (long)(k0 + kk) * HC + j0 + j4);
        *reinterpret_cast<float4*>(w1s + kk * HCH + j4) = v;
      }
      for (int idx = tid; idx < KC * HCH; idx += THREADS) {
        const int kk = idx / HCH;
        const int j = idx % HCH;
        w2s[kk * HCH + j] = k0 + kk < C ? to_f32(w2[(long)(j0 + j) * C + k0 + kk]) : 0.f;
      }
      __syncthreads();
      const int kc = min(KC, C - k0);
#pragma unroll
      for (int u = 0; u < NE1; ++u) {
        const int e = tid + THREADS * u;
        if (e < G.R2 * (HCH / 4)) {
          const float* row = ys + (e >> 3) * YS;
          const float* col = w1s + (e & 7) * 4;
          for (int kk = 0; kk < kc; ++kk)
            fma4(ha[u], row[kk], *reinterpret_cast<const float4*>(col + kk * HCH));
        }
      }
#pragma unroll
      for (int u = 0; u < NE2; ++u) {
        const int e = tid + THREADS * u;
        if (e < G.R1 * (HCH / 4)) {
          const float* row = gs + (e >> 3) * YS;
          const float* col = w2s + (e & 7) * 4;
          for (int kk = 0; kk < kc; ++kk)
            fma4(ga[u], row[kk], *reinterpret_cast<const float4*>(col + kk * HCH));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NE1; ++u) {
      const int e = tid + THREADS * u;
      if (e < G.R2 * (HCH / 4)) {
        const int p = e >> 3, j4 = (e & 7) * 4;
        const int gy = y0 + p / G.W2r - 2, gx = x0 + p % G.W2r - 2;
        float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
        if (inside(gy, gx)) {
          const float4 bias = load4(b1 + j0 + j4);
          v = make_float4(ha[u].x + bias.x, ha[u].y + bias.y, ha[u].z + bias.z, ha[u].w + bias.w);
        }
        *reinterpret_cast<float4*>(h1 + p * HCH + j4) = v;
      }
    }
    __syncthreads();

    // ---- 2. hd on the 1-ring: dhd = dhg * GELU'(hd); hg = GELU(hd) on the tile
#pragma unroll
    for (int u = 0; u < NE2; ++u) {
      const int e = tid + THREADS * u;
      if (e < G.R1 * (HCH / 4)) {
        const int p = e >> 3, j4 = (e & 7) * 4;
        const int py = p / G.W1r, px = p % G.W1r;  // 2-ring coords of the centre: +1
        float hd[4], gv[4] = {ga[u].x, ga[u].y, ga[u].z, ga[u].w};
#pragma unroll
        for (int i = 0; i < 4; ++i) hd[i] = to_f32(db[j0 + j4 + i]);
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int tx = 0; tx < 3; ++tx) {
            const float4 hv =
                *reinterpret_cast<const float4*>(h1 + ((py + ty) * G.W2r + px + tx) * HCH + j4);
            const float4 wv = load4(dw + (ty * 3 + tx) * HC + j0 + j4);
            hd[0] = fmaf(wv.x, hv.x, hd[0]);
            hd[1] = fmaf(wv.y, hv.y, hd[1]);
            hd[2] = fmaf(wv.z, hv.z, hd[2]);
            hd[3] = fmaf(wv.w, hv.w, hd[3]);
          }
        float out[4], act[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float cdf = erf_cdf(hd[i]);
          const float pdf = expf(-0.5f * hd[i] * hd[i]) * 0.3989422804014327f;
          out[i] = gv[i] * (cdf + hd[i] * pdf);
          act[i] = hd[i] * cdf;
        }
        *reinterpret_cast<float4*>(dhd + p * HCH + j4) = make_float4(out[0], out[1], out[2], out[3]);
        if (py >= 1 && py <= TH && px >= 1 && px <= TW) {
          float* d = hg + ((py - 1) * TW + px - 1) * GS + j4;
          d[0] = act[0]; d[1] = act[1]; d[2] = act[2]; d[3] = act[3];
        }
      }
    }
    __syncthreads();

    // ---- 3. dh1 on the tile: the transposed taps of dhd, zero outside the image
    for (int idx = tid; idx < G.P * HCH; idx += THREADS) {
      const int p = idx / HCH, j = idx % HCH;
      const int py = p / TW, px = p % TW;
      int gy, gx;
      float v = 0.f;
      if (tile_px(p, gy, gx)) {
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int tx = 0; tx < 3; ++tx)
            v = fmaf(to_f32(dw[(ty * 3 + tx) * HC + j0 + j]),
                     dhd[((py + 2 - ty) * G.W1r + px + 2 - tx) * HCH + j], v);
      }
      dh1[p * GS + j] = v;
    }
    __syncthreads();

    // ---- 4a. ddw, ddb, db1 partials over the tile, reduced in shared memory
    {
      float part[NRED];
#pragma unroll
      for (int r = 0; r < NRED; ++r) part[r] = 0.f;
      for (int p = cw; p < G.P; p += 8) {
        int gy, gx;
        if (!tile_px(p, gy, gx)) continue;
        const int py = p / TW, px = p % TW;
        const float d = dhd[((py + 1) * G.W1r + px + 1) * HCH + jj];
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int tx = 0; tx < 3; ++tx)
            part[ty * 3 + tx] = fmaf(h1[((py + 1 + ty) * G.W2r + px + 1 + tx) * HCH + jj], d,
                                     part[ty * 3 + tx]);
        part[9] += d;
        part[10] += dh1[p * GS + jj];
      }
#pragma unroll
      for (int r = 0; r < NRED; ++r) red[(cw * NRED + r) * HCH + jj] = part[r];
    }
    __syncthreads();
    for (int idx = tid; idx < NRED * HCH; idx += THREADS) {
      const int r = idx / HCH, j = idx % HCH;
      float s = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) s += red[(w * NRED + r) * HCH + j];
      if (r < 9) atomicAdd(ddw + r * HC + j0 + j, s);
      else if (r == 9) atomicAdd(ddb + j0 + j, s);
      else atomicAdd(db1 + j0 + j, s);
    }

    // ---- 4b. dW2 = hg^T g (pass 0) and dW1 = y^T dh1 (pass 1) over the tile
    for (int pass = 0; pass < 2; ++pass) {
      const float* lhs = pass == 0 ? hg : dh1;
      const T* rhs = pass == 0 ? gb : yb;
      float4 a[MAXU];
#pragma unroll
      for (int u = 0; u < MAXU; ++u) a[u] = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int p = 0; p < G.P; ++p) {
        int gy, gx;
        if (!tile_px(p, gy, gx)) continue;
        const T* row = rhs + ((long)gy * W + gx) * C;
        const float s = lhs[p * GS + jj];
        const float2 sp = BLOCK ? st[(p / TW + 2) * G.W2r + p % TW + 2] : make_float2(0.f, 0.f);
#pragma unroll
        for (int u = 0; u < MAXU; ++u) {
          if (u >= nu) continue;
          float4 r = load4(row + cw * 4 + 32 * u);
          if (BLOCK) r = pass == 0 ? scale4<T>(r, f) : ln4<T>(r, sp, lg, lb, cw * 4 + 32 * u);
          fma4(a[u], s, r);
        }
      }
#pragma unroll
      for (int u = 0; u < MAXU; ++u) {
        if (u >= nu) continue;
        const int c = cw * 4 + 32 * u;
        if (pass == 0) {
          float* o = dw2 + (long)(j0 + jj) * C + c;
          atomicAdd(o + 0, a[u].x);
          atomicAdd(o + 1, a[u].y);
          atomicAdd(o + 2, a[u].z);
          atomicAdd(o + 3, a[u].w);
        } else {
          float* o = dw1 + (long)c * HC + j0 + jj;
          atomicAdd(o, a[u].x);
          atomicAdd(o + HC, a[u].y);
          atomicAdd(o + 2 * HC, a[u].z);
          atomicAdd(o + 3 * HC, a[u].w);
        }
      }
    }

    // ---- 5. dy += dh1 W1^T
    if (active) {
      for (int j = 0; j < HCH; ++j) {
        const float4 wv = *reinterpret_cast<const float4*>(w1t + j * G.wld + cq * 4);
#pragma unroll
        for (int u = 0; u < NACC; ++u) {
          const int p = pgy + npg * u;
          if (p < G.P) fma4(acc[u], dh1[p * GS + j], wv);
        }
      }
    }
  }

  if (BLOCK) {  // dy is dln: stage it over the dead buffers, then the LN backward
    __syncthreads();
    float* os = smem;
    if (active) {
#pragma unroll
      for (int u = 0; u < NACC; ++u) {
        const int p = pgy + npg * u;
        if (p < G.P) *reinterpret_cast<float4*>(os + p * G.wld + cq * 4) = acc[u];
      }
    }
    __syncthreads();
    ln_bwd_tile<T>(os, G.wld, st, yb, gb, dy + img, lg, dlg, dlb, G.P, TW, y0, x0, H, W, C);
    return;
  }
  if (!active) return;
#pragma unroll
  for (int u = 0; u < NACC; ++u) {
    const int p = pgy + npg * u;
    if (p >= G.P) continue;
    int gy, gx;
    if (!tile_px(p, gy, gx)) continue;
    store4(dy + img + ((long)gy * W + gx) * C + cq * 4, acc[u]);
  }
}

template <typename T, bool BLOCK>
cudaError_t launch(const void* y, const void* w1, const void* b1, const void* dw,
                   const void* db, const void* w2, const void* g, void* dy, float* dw1,
                   float* db1, float* ddw, float* ddb, float* dw2, float* db2, const float* lg,
                   const float* lb, const float* fac, float* dlg, float* dlb, int B, int H,
                   int W, int C, int HC, int TH, int TW, cudaStream_t stream) {
  const Geometry G(TH, TW, C);
  const int npg = C >= 4 && C / 4 <= THREADS ? THREADS / (C / 4) : 0;
  const size_t bytes = (size_t)(BLOCK ? G.total : G.floats) * 4;
  if (C % 32 || C > 32 * MAXU || HC % HCH || npg == 0 || G.P > npg * NACC ||
      G.R2 * (HCH / 4) > THREADS * NE1 || G.R1 * (HCH / 4) > THREADS * NE2 || bytes > 232448)
    return cudaErrorInvalidValue;
  auto kern = mixffn_bwd_kernel<T, BLOCK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(dw), static_cast<const T*>(db), static_cast<const T*>(w2),
      static_cast<const T*>(g), static_cast<T*>(dy), dw1, db1, ddw, ddb, dw2, db2, lg, lb, fac,
      dlg, dlb, H, W, C, HC, TH, TW);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- bfloat16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
constexpr int WARPS = THREADS / 32;
constexpr int KS = 32;         // C slice of the ring tiles
constexpr int SLD = KS + 8;    // bf16 strides padded by 16 bytes
constexpr int JLD = HCH + 8;
constexpr int FLD = HCH + 4;   // float strides
constexpr int MAXF1 = 4;       // fc1 tiles per warp: 2-ring <= 256 pixels
constexpr int MAXF2 = 3;       // dhg tiles per warp: 1-ring <= 192 pixels
constexpr int MAXF = 8;        // dy tiles per warp: P * C <= 8 * 8 * 256

using FragA = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major>;
using FragAt = wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::col_major>;
using FragB = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major>;
using FragBt = wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major>;
using FragC = wmma::fragment<wmma::accumulator, 16, 16, 16, float>;

__host__ __device__ inline int take(int& at, int bytes) {
  const int here = at;
  at = (at + bytes + 127) & ~127;
  return here;
}

// shared-memory regions, 128-byte aligned
struct Layout {
  int P, W1r, R1, R1p, W2r, R2, R2p, CL;
  int yt, gt, w1c, w2c, y2s, g1s, h1, dhd, hg, dh1, red, scr, st, bytes;
  __host__ __device__ Layout(int th, int tw, int c) {
    P = th * tw;
    W1r = tw + 2; R1 = (th + 2) * W1r; R1p = (R1 + 15) / 16 * 16;
    W2r = tw + 4; R2 = (th + 4) * W2r; R2p = (R2 + 15) / 16 * 16;
    CL = c + 8;
    int at = 0;
    yt = take(at, P * CL * 2);        // the tile's y, all channels
    gt = take(at, P * CL * 2);        // the tile's g
    w1c = take(at, c * JLD * 2);      // W1[:, chunk]  [c][j]
    w2c = take(at, HCH * CL * 2);     // W2[chunk, :]  [j][c]
    y2s = take(at, R2p * SLD * 2);    // slice of y on the 2-ring
    g1s = take(at, R1p * SLD * 2);    // slice of g on the 1-ring
    h1 = take(at, R2p * FLD * 4);     // fc1 + b1, float
    dhd = take(at, R1p * FLD * 4);    // dhg, then dhd in place, float
    hg = take(at, P * JLD * 2);       // GELU(hd) on the tile
    dh1 = take(at, P * JLD * 2);      // dh1 on the tile
    red = take(at, 8 * NRED * HCH * 4);
    scr = take(at, WARPS * 256 * 4);  // one 16x16 float tile per warp
    const int out = P * (c + 4) * 4;  // dy staging, over the dead buffers
    st = ((at > out ? at : out) + 15) & ~15;  // LN2 stats of the 2-ring (K4b)
    bytes = st + R2p * 8;
  }
};

template <bool BLOCK>
__global__ void __launch_bounds__(THREADS, 1)
mixffn_bwd_tc_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w1,
                     const bf16* __restrict__ b1, const bf16* __restrict__ dw,
                     const bf16* __restrict__ db, const bf16* __restrict__ w2,
                     const bf16* __restrict__ g, bf16* __restrict__ dy, float* __restrict__ dw1,
                     float* __restrict__ db1, float* __restrict__ ddw, float* __restrict__ ddb,
                     float* __restrict__ dw2, float* __restrict__ db2,
                     const float* __restrict__ lg, const float* __restrict__ lb,
                     const float* __restrict__ fac, float* __restrict__ dlg,
                     float* __restrict__ dlb, int H, int W, int C, int HC, int TH, int TW) {
  const Layout L(TH, TW, C);
  extern __shared__ __align__(128) unsigned char sm[];
  bf16* Yt = reinterpret_cast<bf16*>(sm + L.yt);
  bf16* Gt = reinterpret_cast<bf16*>(sm + L.gt);
  bf16* W1c = reinterpret_cast<bf16*>(sm + L.w1c);
  bf16* W2c = reinterpret_cast<bf16*>(sm + L.w2c);
  bf16* Y2s = reinterpret_cast<bf16*>(sm + L.y2s);
  bf16* G1s = reinterpret_cast<bf16*>(sm + L.g1s);
  float* H1 = reinterpret_cast<float*>(sm + L.h1);
  float* DHD = reinterpret_cast<float*>(sm + L.dhd);
  bf16* HG = reinterpret_cast<bf16*>(sm + L.hg);
  bf16* DH1 = reinterpret_cast<bf16*>(sm + L.dh1);
  float* red = reinterpret_cast<float*>(sm + L.red);
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  float* scr = reinterpret_cast<float*>(sm + L.scr) + warp * 256;
  float* Os = reinterpret_cast<float*>(sm);
  float2* St = reinterpret_cast<float2*>(sm + L.st);

  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const long img = (long)b * H * W * C;
  const bf16* yb = y + img;
  const bf16* gb = g + img;
  const float f = BLOCK ? fac[b] : 1.f;
  if (BLOCK) {
    ring_stats(yb, St, L.R2, L.W2r, y0, x0, H, W, C);
    __syncthreads();
  }
  const int CL = L.CL, c8n = C / 8, ntn = C / 16;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };
  auto tile_px = [&](int p, int& gy, int& gx) {
    gy = y0 + p / TW;
    gx = x0 + p % TW;
    return gy < H && gx < W;
  };

  // the tile's y and g, all channels, zero outside the image
  for (int idx = tid; idx < L.P * c8n; idx += THREADS) {
    const int p = idx / c8n, c = (idx % c8n) * 8;
    int gy, gx;
    uint4 vy = make_uint4(0u, 0u, 0u, 0u), vg = vy;
    if (tile_px(p, gy, gx)) {
      vy = *reinterpret_cast<const uint4*>(yb + ((long)gy * W + gx) * C + c);
      vg = *reinterpret_cast<const uint4*>(gb + ((long)gy * W + gx) * C + c);
      if (BLOCK) {
        vy = ln8_bf16(vy, St[(p / TW + 2) * L.W2r + p % TW + 2], lg, lb, c);
        vg = scale8_bf16(vg, f);
      }
    }
    *reinterpret_cast<uint4*>(Yt + p * CL + c) = vy;
    *reinterpret_cast<uint4*>(Gt + p * CL + c) = vg;
  }
  __syncthreads();
  for (int c = tid; c < C; c += THREADS) {  // db2: the tile's column sums of g
    float sum = 0.f;
    for (int p = 0; p < L.P; ++p) sum += __bfloat162float(Gt[p * CL + c]);
    atomicAdd(db2 + c, sum);
  }

  const int nfrag = (L.P / 16) * ntn;
  const int n1 = (L.R2p / 16) * 2, n2 = (L.R1p / 16) * 2;
  const int jj = tid & 31, cw = tid >> 5;
  FragC acc[MAXF];
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int j0 = 0; j0 < HC; j0 += HCH) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < C * (HCH / 8); idx += THREADS) {
      const int c = idx / (HCH / 8), j = (idx % (HCH / 8)) * 8;
      *reinterpret_cast<uint4*>(W1c + c * JLD + j) =
          *reinterpret_cast<const uint4*>(w1 + (long)c * HC + j0 + j);
    }
    for (int idx = tid; idx < HCH * c8n; idx += THREADS) {
      const int j = idx / c8n, c = (idx % c8n) * 8;
      *reinterpret_cast<uint4*>(W2c + j * CL + c) =
          *reinterpret_cast<const uint4*>(w2 + (long)(j0 + j) * C + c);
    }

    // ---- 1. fc1 on the 2-ring and dhg = g W2^T on the 1-ring, C in slices
    FragC f1[MAXF1], f2[MAXF2];
#pragma unroll
    for (int i = 0; i < MAXF1; ++i) wmma::fill_fragment(f1[i], 0.f);
#pragma unroll
    for (int i = 0; i < MAXF2; ++i) wmma::fill_fragment(f2[i], 0.f);
    for (int k0 = 0; k0 < C; k0 += KS) {
      __syncthreads();
      for (int idx = tid; idx < L.R2p * (KS / 8); idx += THREADS) {
        const int p = idx / (KS / 8), c = (idx % (KS / 8)) * 8;
        const int gy = y0 + p / L.W2r - 2, gx = x0 + p % L.W2r - 2;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (p < L.R2 && inside(gy, gx)) {
          v = *reinterpret_cast<const uint4*>(yb + ((long)gy * W + gx) * C + k0 + c);
          if (BLOCK) v = ln8_bf16(v, St[p], lg, lb, k0 + c);
        }
        *reinterpret_cast<uint4*>(Y2s + p * SLD + c) = v;
      }
      for (int idx = tid; idx < L.R1p * (KS / 8); idx += THREADS) {
        const int p = idx / (KS / 8), c = (idx % (KS / 8)) * 8;
        const int gy = y0 + p / L.W1r - 1, gx = x0 + p % L.W1r - 1;
        uint4 v = make_uint4(0u, 0u, 0u, 0u);
        if (p < L.R1 && inside(gy, gx)) {
          v = *reinterpret_cast<const uint4*>(gb + ((long)gy * W + gx) * C + k0 + c);
          if (BLOCK) v = scale8_bf16(v, f);
        }
        *reinterpret_cast<uint4*>(G1s + p * SLD + c) = v;
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < MAXF1; ++i) {
        const int f = warp + WARPS * i;
        if (f >= n1) continue;
        const int mi = f >> 1, ni = f & 1;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
          FragA a;
          FragB bm;
          wmma::load_matrix_sync(a, Y2s + mi * 16 * SLD + kk, SLD);
          wmma::load_matrix_sync(bm, W1c + (k0 + kk) * JLD + ni * 16, JLD);
          wmma::mma_sync(f1[i], a, bm, f1[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < MAXF2; ++i) {
        const int f = warp + WARPS * i;
        if (f >= n2) continue;
        const int mi = f >> 1, ni = f & 1;
#pragma unroll
        for (int kk = 0; kk < KS; kk += 16) {
          FragA a;
          FragBt bm;  // (k = c, n = j) at W2c[j * CL + c]
          wmma::load_matrix_sync(a, G1s + mi * 16 * SLD + kk, SLD);
          wmma::load_matrix_sync(bm, W2c + ni * 16 * CL + k0 + kk, CL);
          wmma::mma_sync(f2[i], a, bm, f2[i]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MAXF1; ++i) {
      const int f = warp + WARPS * i;
      if (f < n1)
        wmma::store_matrix_sync(H1 + (f >> 1) * 16 * FLD + (f & 1) * 16, f1[i], FLD,
                                wmma::mem_row_major);
    }
#pragma unroll
    for (int i = 0; i < MAXF2; ++i) {
      const int f = warp + WARPS * i;
      if (f < n2)
        wmma::store_matrix_sync(DHD + (f >> 1) * 16 * FLD + (f & 1) * 16, f2[i], FLD,
                                wmma::mem_row_major);
    }
    __syncthreads();
    for (int idx = tid; idx < L.R2 * HCH; idx += THREADS) {  // + b1, zero outside
      const int p = idx / HCH, j = idx % HCH;
      const int gy = y0 + p / L.W2r - 2, gx = x0 + p % L.W2r - 2;
      H1[p * FLD + j] = inside(gy, gx) ? H1[p * FLD + j] + __bfloat162float(b1[j0 + j]) : 0.f;
    }
    __syncthreads();

    // ---- 2. hd on the 1-ring: dhd = dhg * GELU'(hd) in place; hg on the tile
    for (int idx = tid; idx < L.R1 * HCH; idx += THREADS) {
      const int p = idx / HCH, j = idx % HCH;
      const int py = p / L.W1r, px = p % L.W1r;
      float hd = __bfloat162float(db[j0 + j]);
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int tx = 0; tx < 3; ++tx)
          hd = fmaf(__bfloat162float(dw[(ty * 3 + tx) * HC + j0 + j]),
                    H1[((py + ty) * L.W2r + px + tx) * FLD + j], hd);
      const float cdf = erf_cdf(hd);
      const float pdf = expf(-0.5f * hd * hd) * 0.3989422804014327f;
      DHD[p * FLD + j] *= cdf + hd * pdf;
      if (py >= 1 && py <= TH && px >= 1 && px <= TW)
        HG[((py - 1) * TW + px - 1) * JLD + j] = __float2bfloat16(hd * cdf);
    }
    __syncthreads();

    // ---- 3. dh1 on the tile (zero outside the image); db1 from its float values
    float part[NRED];
#pragma unroll
    for (int r = 0; r < NRED; ++r) part[r] = 0.f;
    for (int idx = tid; idx < L.P * HCH; idx += THREADS) {  // p = cw + 8k, j = jj
      const int p = idx / HCH, j = idx % HCH;
      const int py = p / TW, px = p % TW;
      int gy, gx;
      float v = 0.f;
      if (tile_px(p, gy, gx)) {
#pragma unroll
        for (int ty = 0; ty < 3; ++ty)
#pragma unroll
          for (int tx = 0; tx < 3; ++tx)
            v = fmaf(__bfloat162float(dw[(ty * 3 + tx) * HC + j0 + j]),
                     DHD[((py + 2 - ty) * L.W1r + px + 2 - tx) * FLD + j], v);
      }
      DH1[p * JLD + j] = __float2bfloat16(v);
      part[10] += v;
    }

    // ---- 4a. ddw, ddb over the tile, reduced in shared memory with db1
    for (int p = cw; p < L.P; p += 8) {
      int gy, gx;
      if (!tile_px(p, gy, gx)) continue;
      const int py = p / TW, px = p % TW;
      const float d = DHD[((py + 1) * L.W1r + px + 1) * FLD + jj];
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int tx = 0; tx < 3; ++tx)
          part[ty * 3 + tx] =
              fmaf(H1[((py + 1 + ty) * L.W2r + px + 1 + tx) * FLD + jj], d, part[ty * 3 + tx]);
      part[9] += d;
    }
#pragma unroll
    for (int r = 0; r < NRED; ++r) red[(cw * NRED + r) * HCH + jj] = part[r];
    __syncthreads();
    for (int idx = tid; idx < NRED * HCH; idx += THREADS) {
      const int r = idx / HCH, j = idx % HCH;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < 8; ++w) sum += red[(w * NRED + r) * HCH + j];
      if (r < 9) atomicAdd(ddw + r * HC + j0 + j, sum);
      else if (r == 9) atomicAdd(ddb + j0 + j, sum);
      else atomicAdd(db1 + j0 + j, sum);
    }

    // ---- 4b. dW2 = hg^T g and dW1 = y^T dh1, a 16x16 tile per warp at a time
    for (int f = warp; f < 4 * ntn; f += WARPS) {
      const bool second = f >= 2 * ntn;  // dW1 tiles after the dW2 ones
      const int ff = second ? f - 2 * ntn : f;
      FragC t;
      wmma::fill_fragment(t, 0.f);
      int row0, col0;
      if (!second) {  // (j, c) of dW2 (HC, C)
        const int mi = ff / ntn, ni = ff % ntn;
        for (int k = 0; k < L.P; k += 16) {
          FragAt a;  // (m = j, k = p) at HG[p * JLD + j]
          FragB bm;
          wmma::load_matrix_sync(a, HG + k * JLD + mi * 16, JLD);
          wmma::load_matrix_sync(bm, Gt + k * CL + ni * 16, CL);
          wmma::mma_sync(t, a, bm, t);
        }
        row0 = j0 + mi * 16;
        col0 = ni * 16;
      } else {  // (c, j) of dW1 (C, HC)
        const int mi = ff >> 1, ni = ff & 1;
        for (int k = 0; k < L.P; k += 16) {
          FragAt a;  // (m = c, k = p) at Yt[p * CL + c]
          FragB bm;
          wmma::load_matrix_sync(a, Yt + k * CL + mi * 16, CL);
          wmma::load_matrix_sync(bm, DH1 + k * JLD + ni * 16, JLD);
          wmma::mma_sync(t, a, bm, t);
        }
        row0 = mi * 16;
        col0 = j0 + ni * 16;
      }
      wmma::store_matrix_sync(scr, t, 16, wmma::mem_row_major);
      __syncwarp();
      float* out = second ? dw1 : dw2;
      const int ld = second ? HC : C;
      for (int e = lane * 4; e < 256; e += 128)  // 16-byte vector atomics (sm_90)
        atomicAdd(reinterpret_cast<float4*>(out + (long)(row0 + e / 16) * ld + col0 + e % 16),
                  *reinterpret_cast<const float4*>(scr + e));
      __syncwarp();
    }

    // ---- 5. dy += dh1 W1^T
#pragma unroll
    for (int i = 0; i < MAXF; ++i) {
      const int f = warp + WARPS * i;
      if (f >= nfrag) continue;
      const int mi = f / ntn, ni = f % ntn;
#pragma unroll
      for (int kk = 0; kk < HCH; kk += 16) {
        FragA a;
        FragBt bm;  // (k = j, n = c) at W1c[c * JLD + j]
        wmma::load_matrix_sync(a, DH1 + mi * 16 * JLD + kk, JLD);
        wmma::load_matrix_sync(bm, W1c + ni * 16 * JLD + kk, JLD);
        wmma::mma_sync(acc[i], a, bm, acc[i]);
      }
    }
  }

  __syncthreads();  // every buffer is dead: stage dy over them
  const int old = C + 4;
#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int f = warp + WARPS * i;
    if (f < nfrag)
      wmma::store_matrix_sync(Os + (f / ntn) * 16 * old + (f % ntn) * 16, acc[i], old,
                              wmma::mem_row_major);
  }
  __syncthreads();
  if (BLOCK) {  // dy is dln: the LN backward
    ln_bwd_tile<bf16>(Os, old, St, yb, gb, dy + img, lg, dlg, dlb, L.P, TW, y0, x0, H, W, C);
    return;
  }
  for (int idx = tid; idx < L.P * (C / 4); idx += THREADS) {
    const int p = idx / (C / 4), c = (idx % (C / 4)) * 4;
    int gy, gx;
    if (!tile_px(p, gy, gx)) continue;
    store4(dy + img + ((long)gy * W + gx) * C + c,
           *reinterpret_cast<const float4*>(Os + p * old + c));
  }
}

template <bool BLOCK>
cudaError_t launch(const void* y, const void* w1, const void* b1, const void* dw,
                   const void* db, const void* w2, const void* g, void* dy, float* dw1,
                   float* db1, float* ddw, float* ddb, float* dw2, float* db2, const float* lg,
                   const float* lb, const float* fac, float* dlg, float* dlb, int B, int H,
                   int W, int C, int HC, int TH, int TW, cudaStream_t stream) {
  // TH is the forward's tile: lower it (by row pairs) until the buffers fit
  while (TH > 2 && Layout(TH, TW, C).bytes > 232448) TH -= 2;
  const Layout L(TH, TW, C);
  if (C % 32 || HC % HCH || TW != 8 || TH % 2 || L.bytes > 232448 ||
      (L.P / 16) * (C / 16) > MAXF * WARPS || (L.R2p / 16) * 2 > MAXF1 * WARPS ||
      (L.R1p / 16) * 2 > MAXF2 * WARPS)
    return cudaErrorInvalidValue;
  auto kern = mixffn_bwd_tc_kernel<BLOCK>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, THREADS, L.bytes, stream>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(dw), static_cast<const bf16*>(db), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(g), static_cast<bf16*>(dy), dw1, db1, ddw, ddb, dw2, db2, lg, lb,
      fac, dlg, dlb, H, W, C, HC, TH, TW);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

// dw1 .. db2: zeroed float32 buffers the kernel adds into.
SFT_EXPORT int sft_mixffn_bwd(const void* y, const void* w1, const void* b1, const void* dw,
                              const void* db, const void* w2, const void* g, void* dy,
                              void* dw1, void* db1, void* ddw, void* ddb, void* dw2, void* db2,
                              int B, int H, int W, int C, int HC, int TH, int TW, int dtype,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* f[6] = {static_cast<float*>(dw1), static_cast<float*>(db1), static_cast<float*>(ddw),
                 static_cast<float*>(ddb), static_cast<float*>(dw2), static_cast<float*>(db2)};
  if (dtype == SFT_F32)
    return launch<float, false>(y, w1, b1, dw, db, w2, g, dy, f[0], f[1], f[2], f[3], f[4], f[5],
                                nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, C, HC, TH,
                                TW, st);
  if (dtype == SFT_BF16)
    return tc::launch<false>(y, w1, b1, dw, db, w2, g, dy, f[0], f[1], f[2], f[3], f[4], f[5],
                             nullptr, nullptr, nullptr, nullptr, nullptr, B, H, W, C, HC, TH, TW,
                             st);
  return cudaErrorInvalidValue;
}

// K4b: x the raw block input, g the cotangent of the half-block's output,
// dx like x; lg, lb, fac as K4f's; dlg .. db2: zeroed float32 buffers.
SFT_EXPORT int sft_ffn_block_bwd(const void* x, const void* lg, const void* lb, const void* w1,
                                 const void* b1, const void* dw, const void* db, const void* w2,
                                 const void* fac, const void* g, void* dx, void* dlg, void* dlb,
                                 void* dw1, void* db1, void* ddw, void* ddb, void* dw2, void* db2,
                                 int B, int H, int W, int C, int HC, int TH, int TW, int dtype,
                                 void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fw = [](void* p) { return static_cast<float*>(p); };
  const float* g1 = static_cast<const float*>(lg);
  const float* b1f = static_cast<const float*>(lb);
  const float* fc = static_cast<const float*>(fac);
  if (dtype == SFT_F32)
    return launch<float, true>(x, w1, b1, dw, db, w2, g, dx, fw(dw1), fw(db1), fw(ddw), fw(ddb),
                               fw(dw2), fw(db2), g1, b1f, fc, fw(dlg), fw(dlb), B, H, W, C, HC,
                               TH, TW, st);
  if (dtype == SFT_BF16)
    return tc::launch<true>(x, w1, b1, dw, db, w2, g, dx, fw(dw1), fw(db1), fw(ddw), fw(ddb),
                            fw(dw2), fw(db2), g1, b1f, fc, fw(dlg), fw(dlb), B, H, W, C, HC, TH,
                            TW, st);
  return cudaErrorInvalidValue;
}
