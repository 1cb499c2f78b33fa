// K2: Mix-FFN forward, out = fc2(GELU(dwconv3x3(fc1(y)))) on an NHWC map,
// y (B, H, W, C), w1 (C, HC), b1 (HC), dw (3, 3, 1, HC), db (HC), w2 (HC, C),
// b2 (C); the depthwise conv zero-pads its input (SAME), GELU is exact (erf).
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_ffn.py
// `_forward` (:304, body `_fwd_kernel` :85), which keeps the 4C-wide hidden
// activation of a row tile in VMEM.
//
// What bounds it on the H100: operations (4*C*HC flops per pixel against
// 2*C elements of y and out). Keeping the hidden activation out of device
// memory is the point: it is 4x the size of y and would be written and read
// three times by an unfused composition.
// Design, both paths: one block of 256 threads owns a TH x 8 tile of output
// pixels of one image and walks the hidden channels in chunks of 32: fc1 of
// the chunk for the tile plus its 1-pixel halo into shared memory (zero
// outside the image, which is the conv's zero padding), then the 9 taps,
// bias and GELU, then the chunk's share of fc2 into float32 accumulators in
// registers. Only y, the weights and out touch device memory. The halo costs
// (TH+2)*10/(TH*8) times the fc1 work.
// - bfloat16 (the serving path): fc1 and fc2 run on the tensor cores through
//   WMMA 16x16x16 tiles with float32 accumulation; the halo tile of y is
//   staged in shared memory once per block, each chunk's w1/w2 slices once
//   per chunk; the GELU output is rounded to bfloat16 as the A operand of fc2.
// - float32: the same dataflow on float32 FMAs from shared memory (each
//   thread owns one 4-channel group of C for up to 16 pixels), exact to the
//   float32 rounding of the plain version.
//
// K4f, the FFN half-block of a MiT block, is the same kernel with BLOCK set:
//   out = x + fac[b] * fc2(GELU(dwconv3x3(fc1(LN2(x)))))
// for the raw block input x, LN2's float32 scale and bias and the per-image
// drop-path factor fac (B,) float32. It replaces the TPU kernel
// segmentation_factory_tpu/ops/pallas_block.py `_ffn_forward` (:641, body
// `_ffn_fwd_kernel` :431). Two additions: an LN2 prologue (each pixel of
// the tile and of its 1-pixel halo gets its float32 mean and 1/sigma from
// one warp before staging, and is normalised, rounded to the compute type,
// as it is staged: fc1 of a halo pixel needs that pixel's LN), and the
// residual epilogue (x + fac * (fc2 + b2) in float32, rounded once). The
// activation is read once (plus the halo) and written once, as on the TPU.
#include <mma.h>

#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int HCH = 32;     // hidden channels per chunk
constexpr int KC = 32;      // fc1 reduction (C) slice staged at a time
constexpr int NACC = 16;    // pixels per thread in fc2
constexpr int NE = 6;       // fc1 (pixel, 4-channel) groups per thread: halo <= 192 pixels
constexpr int YS = KC + 1;  // padded strides: conflict-free column reads
constexpr int GS = HCH + 1;

struct Geometry {
  int TH, TW, P, PW, PH;
  __host__ __device__ Geometry(int th, int tw)
      : TH(th), TW(tw), P(th * tw), PW(tw + 2), PH((th + 2) * (tw + 2)) {}
  __host__ __device__ int ys_off() const { return 0; }
  __host__ __device__ int w1_off() const { return (PH * YS + 3) & ~3; }  // float4-aligned
  __host__ __device__ int hs_off() const { return w1_off() + KC * HCH; }
  __host__ __device__ int gs_off() const { return hs_off() + PH * HCH; }
  __host__ __device__ int st_off() const { return gs_off() + P * GS; }  // LN stats (K4f)
  __host__ __device__ int floats() const { return st_off() + 2 * PH; }
};

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752f));
}

// BLOCK: K4f, y is the raw x; lg, lb, fac as above (unread otherwise)
template <typename T, bool BLOCK>
__global__ void __launch_bounds__(THREADS, 1)
mixffn_kernel(const T* __restrict__ y, const T* __restrict__ w1, const T* __restrict__ b1,
              const T* __restrict__ dw, const T* __restrict__ db, const T* __restrict__ w2,
              const T* __restrict__ b2, const float* __restrict__ lg,
              const float* __restrict__ lb, const float* __restrict__ fac, T* __restrict__ out,
              int H, int W, int C, int HC, int TH, int TW) {
  const Geometry g(TH, TW);
  extern __shared__ __align__(16) float smem[];
  float* ys = smem + g.ys_off();
  float* w1s = smem + g.w1_off();
  float* hs = smem + g.hs_off();
  float* gs = smem + g.gs_off();
  float2* st = reinterpret_cast<float2*>(smem + g.st_off());

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const T* yb = y + (long)b * H * W * C;
  if (BLOCK) {  // LN2 statistics of the tile and its halo, a warp per pixel
    for (int p = tid >> 5; p < g.PH; p += THREADS / 32) {
      const int gy = y0 + p / g.PW - 1, gx = x0 + p % g.PW - 1;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float2 v = warp_ln_stats(in ? yb + ((long)gy * W + gx) * C : nullptr, C);
      if ((tid & 31) == 0) st[p] = v;
    }
  }

  // fc2 ownership: channel group cq, pixels pg + npg*u
  const int cqn = C / 4;
  const int npg = THREADS / cqn;
  const bool active = tid < npg * cqn;
  const int cq = tid % cqn;
  const int pg = tid / cqn;

  float4 acc[NACC];
#pragma unroll
  for (int u = 0; u < NACC; ++u) acc[u] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j0 = 0; j0 < HC; j0 += HCH) {
    // ---- fc1 of the chunk on the tile and its halo
    float4 ha[NE];
#pragma unroll
    for (int u = 0; u < NE; ++u) ha[u] = make_float4(0.f, 0.f, 0.f, 0.f);
    for (int k0 = 0; k0 < C; k0 += KC) {
      const int kc = min(KC, C - k0);
      __syncthreads();  // earlier readers of ys / w1s / hs / gs are done
      for (int idx = tid; idx < g.PH * (KC / 4); idx += THREADS) {
        const int p = idx / (KC / 4);
        const int c4 = (idx % (KC / 4)) * 4;
        const int gy = y0 + p / g.PW - 1;
        const int gx = x0 + p % g.PW - 1;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (c4 < kc && gy >= 0 && gy < H && gx >= 0 && gx < W) {
          val = load4(yb + ((long)gy * W + gx) * C + k0 + c4);
          if (BLOCK) val = ln4<T>(val, st[p], lg, lb, k0 + c4);
        }
        float* dst = ys + p * YS + c4;
        dst[0] = val.x; dst[1] = val.y; dst[2] = val.z; dst[3] = val.w;
      }
      for (int idx = tid; idx < KC * (HCH / 4); idx += THREADS) {
        const int kk = idx / (HCH / 4);
        const int j4 = (idx % (HCH / 4)) * 4;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (kk < kc) val = load4(w1 + (long)(k0 + kk) * HC + j0 + j4);
        *reinterpret_cast<float4*>(w1s + kk * HCH + j4) = val;
      }
      __syncthreads();
#pragma unroll
      for (int u = 0; u < NE; ++u) {
        const int e = tid + THREADS * u;
        if (e < g.PH * (HCH / 4)) {
          const float* yrow = ys + (e >> 3) * YS;
          const float* wcol = w1s + (e & 7) * 4;
          for (int kk = 0; kk < kc; ++kk)
            fma4(ha[u], yrow[kk], *reinterpret_cast<const float4*>(wcol + kk * HCH));
        }
      }
    }
#pragma unroll
    for (int u = 0; u < NE; ++u) {
      const int e = tid + THREADS * u;
      if (e < g.PH * (HCH / 4)) {
        const int p = e >> 3;
        const int j4 = (e & 7) * 4;
        const int gy = y0 + p / g.PW - 1;
        const int gx = x0 + p % g.PW - 1;
        float4 val = make_float4(0.f, 0.f, 0.f, 0.f);
        if (gy >= 0 && gy < H && gx >= 0 && gx < W) {
          const float4 bias = load4(b1 + j0 + j4);
          val = make_float4(ha[u].x + bias.x, ha[u].y + bias.y, ha[u].z + bias.z,
                            ha[u].w + bias.w);
        }
        *reinterpret_cast<float4*>(hs + p * HCH + j4) = val;
      }
    }
    __syncthreads();

    // ---- 3x3 depthwise taps, bias, exact GELU on the tile
    for (int idx = tid; idx < g.P * HCH; idx += THREADS) {
      const int p = idx / HCH;
      const int j = idx % HCH;
      const int py = p / g.TW;
      const int px = p % g.TW;
      float v = to_f32(db[j0 + j]);
#pragma unroll
      for (int ty = 0; ty < 3; ++ty)
#pragma unroll
        for (int tx = 0; tx < 3; ++tx)
          v = fmaf(to_f32(dw[(ty * 3 + tx) * HC + j0 + j]),
                   hs[((py + ty) * g.PW + px + tx) * HCH + j], v);
      gs[p * GS + j] = gelu_erf(v);
    }
    __syncthreads();

    // ---- the chunk's share of fc2
    if (active) {
      for (int j = 0; j < HCH; ++j) {
        const float4 wv = load4(w2 + (long)(j0 + j) * C + cq * 4);
#pragma unroll
        for (int u = 0; u < NACC; ++u) {
          const int p = pg + npg * u;
          if (p < g.P) fma4(acc[u], gs[p * GS + j], wv);
        }
      }
    }
  }

  if (!active) return;
  const float4 bias = load4(b2 + cq * 4);
#pragma unroll
  for (int u = 0; u < NACC; ++u) {
    const int p = pg + npg * u;
    if (p >= g.P) continue;
    const int gy = y0 + p / g.TW;
    const int gx = x0 + p % g.TW;
    if (gy >= H || gx >= W) continue;
    float4 r = make_float4(acc[u].x + bias.x, acc[u].y + bias.y, acc[u].z + bias.z,
                           acc[u].w + bias.w);
    const long at = (((long)b * H + gy) * W + gx) * C + cq * 4;
    if (BLOCK) {  // the drop-path residual in float32
      const float f = fac[b];
      const float4 xv = load4(y + at);
      r = make_float4(xv.x + f * r.x, xv.y + f * r.y, xv.z + f * r.z, xv.w + f * r.w);
    }
    store4(out + at, r);
  }
}

template <typename T, bool BLOCK>
cudaError_t launch(const void* y, const void* w1, const void* b1, const void* dw,
                   const void* db, const void* w2, const void* b2, const float* lg,
                   const float* lb, const float* fac, void* out, int B, int H, int W, int C,
                   int HC, int TH, int TW, cudaStream_t stream) {
  const Geometry g(TH, TW);
  const int npg = C >= 4 && C / 4 <= THREADS ? THREADS / (C / 4) : 0;
  if (C % 4 || HC % HCH || npg == 0 || g.P > npg * NACC || g.PH * (HCH / 4) > THREADS * NE)
    return cudaErrorInvalidValue;
  const size_t bytes = (size_t)g.floats() * 4;
  auto kern = mixffn_kernel<T, BLOCK>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(y), static_cast<const T*>(w1), static_cast<const T*>(b1),
      static_cast<const T*>(dw), static_cast<const T*>(db), static_cast<const T*>(w2),
      static_cast<const T*>(b2), lg, lb, fac, static_cast<T*>(out), H, W, C, HC, TH, TW);
  return cudaGetLastError();
}


// ---------------------------------------------------------------- bfloat16: tensor cores
namespace tc {

using bf16 = __nv_bfloat16;
using namespace nvcuda;
constexpr int WARPS = THREADS / 32;
constexpr int MAXF = 8;  // fc2 accumulator tiles per warp: P * C <= 8 * 8 * 256

// shared-memory layout; leading dimensions padded by 16 bytes against bank
// conflicts, every WMMA tile 32-byte aligned
struct Layout {
  int P, PW, PH, PHp, ys_ld, w1_ld, w2_ld, hs_ld, gs_ld, os_ld;
  int ys, w1, w2, hs, gs, st, bytes;
  __host__ __device__ Layout(int th, int tw, int c) {
    P = th * tw;
    PW = tw + 2;
    PH = (th + 2) * (tw + 2);
    PHp = (PH + 15) / 16 * 16;
    ys_ld = c + 8; w1_ld = HCH + 8; w2_ld = c + 8; hs_ld = HCH + 4; gs_ld = HCH + 8; os_ld = c + 4;
    ys = 0;
    w1 = ys + PHp * ys_ld * 2;
    w2 = w1 + c * w1_ld * 2;
    hs = w2 + HCH * w2_ld * 2;
    gs = hs + PHp * hs_ld * 4;
    const int loop_bytes = gs + P * gs_ld * 2;
    const int os_bytes = P * os_ld * 4;  // epilogue staging, over the dead loop buffers
    st = ((loop_bytes > os_bytes ? loop_bytes : os_bytes) + 15) & ~15;  // LN stats (K4f)
    bytes = st + PHp * 8;
  }
};

template <bool BLOCK>
__global__ void __launch_bounds__(THREADS, 1)
mixffn_tc_kernel(const bf16* __restrict__ y, const bf16* __restrict__ w1,
                 const bf16* __restrict__ b1, const bf16* __restrict__ dw,
                 const bf16* __restrict__ db, const bf16* __restrict__ w2,
                 const bf16* __restrict__ b2, const float* __restrict__ lg,
                 const float* __restrict__ lb, const float* __restrict__ fac,
                 bf16* __restrict__ out, int H, int W, int C, int HC, int TH, int TW) {
  const Layout L(TH, TW, C);
  extern __shared__ __align__(128) unsigned char smem_tc[];
  bf16* Ys = reinterpret_cast<bf16*>(smem_tc + L.ys);
  bf16* W1c = reinterpret_cast<bf16*>(smem_tc + L.w1);
  bf16* W2c = reinterpret_cast<bf16*>(smem_tc + L.w2);
  float* Hs = reinterpret_cast<float*>(smem_tc + L.hs);
  bf16* Gs = reinterpret_cast<bf16*>(smem_tc + L.gs);
  float* Os = reinterpret_cast<float*>(smem_tc);
  float2* St = reinterpret_cast<float2*>(smem_tc + L.st);

  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TH;
  const int x0 = blockIdx.x * TW;
  const bf16* yb = y + (long)b * H * W * C;
  const int c8 = C / 8;  // 16-byte vectors per row
  if (BLOCK) {  // LN2 statistics of the tile and its halo, a warp per pixel
    for (int p = warp; p < L.PH; p += WARPS) {
      const int gy = y0 + p / L.PW - 1, gx = x0 + p % L.PW - 1;
      const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
      const float2 v = warp_ln_stats(in ? yb + ((long)gy * W + gx) * C : nullptr, C);
      if ((tid & 31) == 0) St[p] = v;
    }
    __syncthreads();
  }

  // the halo tile of y, once: rows past the halo and pixels outside the image are 0
  for (int idx = tid; idx < L.PHp * c8; idx += THREADS) {
    const int p = idx / c8;
    const int c = (idx % c8) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    const int gy = y0 + p / L.PW - 1;
    const int gx = x0 + p % L.PW - 1;
    if (p < L.PH && gy >= 0 && gy < H && gx >= 0 && gx < W) {
      v = *reinterpret_cast<const uint4*>(yb + ((long)gy * W + gx) * C + c);
      if (BLOCK) v = ln8_bf16(v, St[p], lg, lb, c);
    }
    *reinterpret_cast<uint4*>(Ys + p * L.ys_ld + c) = v;
  }

  const int ntn = C / 16;
  const int nfrag = (L.P / 16) * ntn;
  const int n1 = (L.PHp / 16) * (HCH / 16);
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[MAXF];
#pragma unroll
  for (int i = 0; i < MAXF; ++i) wmma::fill_fragment(acc[i], 0.f);

  for (int j0 = 0; j0 < HC; j0 += HCH) {
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = tid; idx < C * (HCH / 8); idx += THREADS) {
      const int k = idx / (HCH / 8);
      const int j = (idx % (HCH / 8)) * 8;
      *reinterpret_cast<uint4*>(W1c + k * L.w1_ld + j) =
          *reinterpret_cast<const uint4*>(w1 + (long)k * HC + j0 + j);
    }
    for (int idx = tid; idx < HCH * c8; idx += THREADS) {
      const int j = idx / c8;
      const int c = (idx % c8) * 8;
      *reinterpret_cast<uint4*>(W2c + j * L.w2_ld + c) =
          *reinterpret_cast<const uint4*>(w2 + (long)(j0 + j) * C + c);
    }
    __syncthreads();

    // fc1 of the chunk on the halo tile: (PHp x C) @ (C x 32) -> Hs, float32
    for (int f = warp; f < n1; f += WARPS) {
      const int mi = f / (HCH / 16);
      const int ni = f % (HCH / 16);
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> h;
      wmma::fill_fragment(h, 0.f);
      for (int k = 0; k < C; k += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
        wmma::load_matrix_sync(a, Ys + mi * 16 * L.ys_ld + k, L.ys_ld);
        wmma::load_matrix_sync(bm, W1c + k * L.w1_ld + ni * 16, L.w1_ld);
        wmma::mma_sync(h, a, bm, h);
      }
      wmma::store_matrix_sync(Hs + mi * 16 * L.hs_ld + ni * 16, h, L.hs_ld,
                              wmma::mem_row_major);
    }
    __syncthreads();

    // fc1 bias (0 outside the image), 3x3 taps, bias, exact GELU -> Gs, bfloat16
    for (int idx = tid; idx < L.P * HCH; idx += THREADS) {
      const int p = idx / HCH;
      const int j = idx % HCH;
      const int py = p / TW;
      const int px = p % TW;
      const float bias1 = to_f32(b1[j0 + j]);
      float v = to_f32(db[j0 + j]);
#pragma unroll
      for (int ty = 0; ty < 3; ++ty) {
        const int gy = y0 + py + ty - 1;
#pragma unroll
        for (int tx = 0; tx < 3; ++tx) {
          const int gx = x0 + px + tx - 1;
          const float hv = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                               ? Hs[((py + ty) * L.PW + px + tx) * L.hs_ld + j] + bias1
                               : 0.f;
          v = fmaf(to_f32(dw[(ty * 3 + tx) * HC + j0 + j]), hv, v);
        }
      }
      Gs[p * L.gs_ld + j] = __float2bfloat16(gelu_erf(v));
    }
    __syncthreads();

    // the chunk's share of fc2: (P x 32) @ (32 x C) into the accumulators
#pragma unroll
    for (int i = 0; i < MAXF; ++i) {
      const int f = warp + WARPS * i;
      if (f < nfrag) {
        const int mi = f / ntn;
        const int ni = f % ntn;
#pragma unroll
        for (int k = 0; k < HCH; k += 16) {
          wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> a;
          wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bm;
          wmma::load_matrix_sync(a, Gs + mi * 16 * L.gs_ld + k, L.gs_ld);
          wmma::load_matrix_sync(bm, W2c + k * L.w2_ld + ni * 16, L.w2_ld);
          wmma::mma_sync(acc[i], a, bm, acc[i]);
        }
      }
    }
  }

  __syncthreads();  // the loop buffers are dead: stage the output over them
#pragma unroll
  for (int i = 0; i < MAXF; ++i) {
    const int f = warp + WARPS * i;
    if (f < nfrag)
      wmma::store_matrix_sync(Os + (f / ntn) * 16 * L.os_ld + (f % ntn) * 16, acc[i], L.os_ld,
                              wmma::mem_row_major);
  }
  __syncthreads();
  const int c4n = C / 4;
  for (int idx = tid; idx < L.P * c4n; idx += THREADS) {
    const int p = idx / c4n;
    const int c = (idx % c4n) * 4;
    const int gy = y0 + p / TW;
    const int gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const float4 o = *reinterpret_cast<const float4*>(Os + p * L.os_ld + c);
    const float4 bias = load4(b2 + c);
    const long at = (((long)b * H + gy) * W + gx) * C + c;
    float4 r = make_float4(o.x + bias.x, o.y + bias.y, o.z + bias.z, o.w + bias.w);
    if (BLOCK) {  // the drop-path residual in float32
      const float f = fac[b];
      const float4 xv = load4(y + at);
      r = make_float4(xv.x + f * r.x, xv.y + f * r.y, xv.z + f * r.z, xv.w + f * r.w);
    }
    store4(out + at, r);
  }
}

template <bool BLOCK>
cudaError_t launch(const void* y, const void* w1, const void* b1, const void* dw,
                   const void* db, const void* w2, const void* b2, const float* lg,
                   const float* lb, const float* fac, void* out, int B, int H, int W, int C,
                   int HC, int TH, int TW, cudaStream_t stream) {
  const Layout L(TH, TW, C);
  if (C % 16 || HC % HCH || (TH * TW) % 16 || (TH * TW / 16) * (C / 16) > MAXF * WARPS ||
      L.bytes > 232448)
    return cudaErrorInvalidValue;
  auto kern = mixffn_tc_kernel<BLOCK>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, THREADS, L.bytes, stream>>>(
      static_cast<const bf16*>(y), static_cast<const bf16*>(w1), static_cast<const bf16*>(b1),
      static_cast<const bf16*>(dw), static_cast<const bf16*>(db), static_cast<const bf16*>(w2),
      static_cast<const bf16*>(b2), lg, lb, fac, static_cast<bf16*>(out), H, W, C, HC, TH, TW);
  return cudaGetLastError();
}

}  // namespace tc

}  // namespace

SFT_EXPORT int sft_mixffn(const void* y, const void* w1, const void* b1, const void* dw,
                          const void* db, const void* w2, const void* b2, void* out, int B,
                          int H, int W, int C, int HC, int TH, int TW, int dtype,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32)
    return launch<float, false>(y, w1, b1, dw, db, w2, b2, nullptr, nullptr, nullptr, out, B, H,
                                W, C, HC, TH, TW, st);
  if (dtype == SFT_BF16)
    return tc::launch<false>(y, w1, b1, dw, db, w2, b2, nullptr, nullptr, nullptr, out, B, H, W,
                             C, HC, TH, TW, st);
  return cudaErrorInvalidValue;
}

// K4f: x the raw block input (B, H, W, C); lg, lb (C) and fac (B) float32.
SFT_EXPORT int sft_ffn_block(const void* x, const void* lg, const void* lb, const void* w1,
                             const void* b1, const void* dw, const void* db, const void* w2,
                             const void* b2, const void* fac, void* out, int B, int H, int W,
                             int C, int HC, int TH, int TW, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(lg);
  const float* bb = static_cast<const float*>(lb);
  const float* f = static_cast<const float*>(fac);
  if (dtype == SFT_F32)
    return launch<float, true>(x, w1, b1, dw, db, w2, b2, g, bb, f, out, B, H, W, C, HC, TH, TW,
                               st);
  if (dtype == SFT_BF16)
    return tc::launch<true>(x, w1, b1, dw, db, w2, b2, g, bb, f, out, B, H, W, C, HC, TH, TW,
                            st);
  return cudaErrorInvalidValue;
}
