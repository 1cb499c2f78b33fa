// K2b: Mix-FFN backward. For out = fc2(GELU(dw3x3(fc1(y)))) on an NHWC map
// (the layouts of mixffn.cu) and its cotangent g (B, H, W, C): dy (like y)
// and the six parameter gradients dw1 (C, HC), db1 (HC), ddw (3, 3, 1, HC),
// ddb (HC), dw2 (HC, C), db2 (C), added into zeroed float32 buffers.
// K4b, the FFN half-block backward for out = x + fac[b] * ffn(LN2(x))
// (mixffn.cu's K4f), is the same dataflow with BLOCK set: it recomputes LN2,
// scales g by the drop-path factor, and ends in the LN backward, writing dx
// and adding dlg, dlb (C). The attention half-block backward K3b
// (ops/block.py) runs the prep, GEMM and LN-backward phases too, around
// K1b's attention core (sra_attention_bwd.cu).
//
// Replaces the TPU kernels segmentation_factory_tpu/ops/pallas_ffn.py
// `_bwd_rule` (:351, body `_bwd_kernel` :119) and
// segmentation_factory_tpu/ops/pallas_block.py `_ffn_bwd_rule` (:691, body
// `_ffn_bwd_kernel` :468), which recompute the 4C hidden activation per row
// tile with a two-row halo and accumulate the weight gradients across a
// sequential grid. The JAX package's exit to an XLA recompute-VJP for wide
// shapes has no counterpart: these kernels take every MiT stage.
//
// What bounds it on the H100: operations — five C x HC products per pixel
// (fc1 recomputed, g W2^T, dW2, dW1, dln) against y, g and dy moved once.
// Design: the work per pixel is separated from the sums over pixels, so
// that every product is one large GEMM on wgmma (sm90.cuh) and the blocks
// fill the card at every stage. The wrapper (ops/mixffn.py) runs the phases
// in turn, the intermediates in scratch it allocates:
// 1. prep (K4b): per pixel LN2 statistics, yhat = LN2(x) and gs = g * fac,
//    both rounded to the compute type; every path: db2 = column sums of gs
//    (one atomic per entry per block);
// 2. h1 = yhat W1 + b1 and dhg = gs W2^T, float32, for every pixel (GEMM,
//    NN and NT forms: the weights in their own layouts);
// 3. tile: one block per (8 x 16 pixel tile, 32 hidden channels) stages h1
//    on the 2-pixel ring and dhg on the 1-pixel ring (zero outside the
//    image), forms hd = dwconv(h1) + db and dhd = dhg * GELU'(hd) on the
//    1-ring, hg = GELU(hd) and dh1 = the transposed taps of dhd on the
//    tile, stores hg and dh1 rounded to the compute type (as the products'
//    operands), and adds the slice's ddw, ddb and db1 column sums (from the
//    float32 values) with one atomic per entry per block;
// 4. dW1 = yhat^T dh1 and dW2 = hg^T gs (GEMM, TN form: the pixels split
//    over the grid, one float32 atomic per element per split);
// 5. dln = dh1 W1^T (GEMM, NT form): K2b stores it as dy; K4b stores it in
//    float32 and
// 6. (K4b) the LN backward, a warp per pixel: dx = g + rs * (gl - mean(gl) -
//    xhat * mean(gl * xhat)) with gl = dln * lg, and the column sums of
//    dln * xhat and dln into dlg, dlb.
// The intermediates rounded are those the earlier fused kernel rounded
// (yhat, gs, hg, dh1); h1, dhg, hd and dhd stay float32. float32 inputs run
// the same phases with the GEMM on FMAs (the check path).
#include "common.cuh"
#include "sm90.cuh"

namespace {

using sm90::store2;

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int TH = 8, TW = 16;           // tile kernel: TH x TW pixels
constexpr int HS = 32;                   // hidden channels per tile block, a lane each
constexpr int R1H = TH + 2, R1W = TW + 2, R2H = TH + 4, R2W = TW + 4;  // the rings
constexpr int NRED = 11;                 // 9 taps + ddb + db1
// h1 on the 2-ring and dhd on the 1-ring; the partial sums reuse h1's room
constexpr int TILE_SMEM = (R2H * R2W + R1H * R1W) * HS * 4;
static_assert(WARPS * NRED <= R2H * R2W, "the partial sums fit over h1");
constexpr int ROWS = 64;                 // prep / LN kernels: pixels per block
constexpr int MAXC = 512;                // their C: NP <= 8 channel pairs per lane

__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// add the block's per-warp column partials part[k] (channels 2 (lane + 32 k)
// and the next) to out
template <int NP>
__device__ __forceinline__ void add_columns(float (*red)[MAXC], const float2 (&part)[NP],
                                            float* __restrict__ out, int C) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    const int c = 2 * (lane + 32 * k);
    if (c < C) *reinterpret_cast<float2*>(&red[warp][c]) = part[k];
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += THREADS) {
    float s = 0.f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][c];
    atomicAdd(out + c, s);
  }
}

// Phase 1. BLOCK: st[p] = (mean, 1/sigma) of LN2, yhat = LN2(x), gs = g * fac
// (rounded to T); db2 += column sums of gs (of g without BLOCK).
template <typename T, bool BLOCK, int NP>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_prep_kernel(const T* __restrict__ x, const T* __restrict__ g,
                    const float* __restrict__ lg, const float* __restrict__ lb,
                    const float* __restrict__ fac, T* __restrict__ yhat, T* __restrict__ gs,
                    float2* __restrict__ st, float* __restrict__ db2, int P, int HW, int C) {
  __shared__ float red[WARPS][MAXC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2 part[NP] = {};
  const int p1 = min(P, (int)(blockIdx.x + 1) * ROWS);
  for (int p = blockIdx.x * ROWS + warp; p < p1; p += WARPS) {
    const long at = (long)p * C;
    float2 xv[NP], gv[NP];
    float sx = 0.f, sq = 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = 2 * (lane + 32 * k);
      xv[k] = gv[k] = make_float2(0.f, 0.f);
      if (c >= C) continue;
      gv[k] = load2(g + at + c);
      if (BLOCK) {
        xv[k] = load2(x + at + c);
        sx += xv[k].x + xv[k].y;
        sq += xv[k].x * xv[k].x + xv[k].y * xv[k].y;
      }
    }
    float mu = 0.f, rs = 0.f, f = 1.f;
    if (BLOCK) {  // LN2's statistics as warp_ln_stats takes them
      mu = warp_sum(sx) / C;
      rs = rsqrtf(fmaxf(warp_sum(sq) / C - mu * mu, 0.f) + LN_EPS);
      f = fac[p / HW];
      if (lane == 0) st[p] = make_float2(mu, rs);
    }
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = 2 * (lane + 32 * k);
      if (c >= C) continue;
      if (BLOCK) {
        const T g0 = from_f32<T>(gv[k].x * f), g1 = from_f32<T>(gv[k].y * f);
        gv[k] = make_float2(to_f32(g0), to_f32(g1));
        store2(gs + at + c, gv[k].x, gv[k].y);
        store2(yhat + at + c, (xv[k].x - mu) * rs * lg[c] + lb[c],
               (xv[k].y - mu) * rs * lg[c + 1] + lb[c + 1]);
      }
      part[k].x += gv[k].x;
      part[k].y += gv[k].y;
    }
  }
  add_columns(red, part, db2, C);
}

// Phase 3: one block per (TH x TW tile of one image, HS hidden channels)
template <typename T>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_tile_kernel(const float* __restrict__ h1, const float* __restrict__ dhg,
                    const T* __restrict__ dw, const T* __restrict__ db, T* __restrict__ hg,
                    T* __restrict__ dh1, float* __restrict__ ddw, float* __restrict__ ddb,
                    float* __restrict__ db1, int H, int W, int HC) {
  extern __shared__ float tile_smem[];
  float* hs = tile_smem;              // h1 on the 2-ring  [R2H * R2W][HS]
  float* ds = hs + R2H * R2W * HS;    // dhg, then dhd, on the 1-ring  [R1H * R1W][HS]
  float* red = tile_smem;             // then the partial sums [WARPS][NRED][HS]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j = blockIdx.y * HS + lane;
  const int tiles_x = (W + TW - 1) / TW, tiles_y = (H + TH - 1) / TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int y0 = (blockIdx.x / tiles_x % tiles_y) * TH;
  const long img = (long)(blockIdx.x / (tiles_x * tiles_y)) * H * W;
  auto inside = [&](int gy, int gx) { return gy >= 0 && gy < H && gx >= 0 && gx < W; };
  float w[9];
#pragma unroll
  for (int i = 0; i < 9; ++i) w[i] = to_f32(dw[i * HC + j]);
  const float bias = to_f32(db[j]);

  // stage the rings in 16-byte pieces, several in flight per thread
  const int j0 = blockIdx.y * HS;
  constexpr int Q = HS / 4;  // float4 pieces per pixel
#pragma unroll 4
  for (int idx = tid; idx < R2H * R2W * Q; idx += THREADS) {
    const int p = idx / Q, q = idx % Q;
    const int gy = y0 + p / R2W - 2, gx = x0 + p % R2W - 2;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (inside(gy, gx)) v = load4(h1 + (img + (long)gy * W + gx) * HC + j0 + 4 * q);
    *reinterpret_cast<float4*>(hs + p * HS + 4 * q) = v;
  }
#pragma unroll 4
  for (int idx = tid; idx < R1H * R1W * Q; idx += THREADS) {
    const int p = idx / Q, q = idx % Q;
    const int gy = y0 + p / R1W - 1, gx = x0 + p % R1W - 1;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (inside(gy, gx)) v = load4(dhg + (img + (long)gy * W + gx) * HC + j0 + 4 * q);
    *reinterpret_cast<float4*>(ds + p * HS + 4 * q) = v;
  }
  __syncthreads();

  // hd on the 1-ring: dhd = dhg * GELU'(hd) in place; hg = GELU(hd) on the tile
#pragma unroll 2
  for (int p = warp; p < R1H * R1W; p += WARPS) {
    const int py = p / R1W, px = p % R1W;
    const float hd = dw_taps(
        w, bias, [&](int ty, int tx) { return hs[((py + ty) * R2W + px + tx) * HS + lane]; });
    const float cdf = erf_cdf(hd);
    const float pdf = expf(-0.5f * hd * hd) * 0.3989422804014327f;
    ds[p * HS + lane] *= cdf + hd * pdf;
    const int gy = y0 + py - 1, gx = x0 + px - 1;
    if (py >= 1 && py <= TH && px >= 1 && px <= TW && gy < H && gx < W)
      hg[(img + (long)gy * W + gx) * HC + j] = from_f32<T>(hd * cdf);
  }
  __syncthreads();

  // dh1 on the tile (the transposed taps of dhd); ddw, ddb, db1 partials
  float part[NRED] = {};
#pragma unroll 2
  for (int p = warp; p < TH * TW; p += WARPS) {
    const int py = p / TW, px = p % TW;
    const int gy = y0 + py, gx = x0 + px;
    if (gy >= H || gx >= W) continue;
    // the transposed taps: output (py, px) of dh1 gathers dhd at (py + 1 - ty, px + 1 - tx)
    const float v = dw_taps(w, 0.f, [&](int ty, int tx) {
      return ds[((py + 2 - ty) * R1W + px + 2 - tx) * HS + lane];
    });
    dh1[(img + (long)gy * W + gx) * HC + j] = from_f32<T>(v);
    part[10] += v;
    const float d = ds[((py + 1) * R1W + px + 1) * HS + lane];
#pragma unroll
    for (int ty = 0; ty < 3; ++ty)
#pragma unroll
      for (int tx = 0; tx < 3; ++tx)
        part[ty * 3 + tx] = fmaf(hs[((py + 1 + ty) * R2W + px + 1 + tx) * HS + lane], d,
                                 part[ty * 3 + tx]);
    part[9] += d;
  }
  __syncthreads();  // h1 is dead: its room takes the partial sums
#pragma unroll
  for (int r = 0; r < NRED; ++r) red[(warp * NRED + r) * HS + lane] = part[r];
  __syncthreads();
  for (int idx = tid; idx < NRED * HS; idx += THREADS) {
    const int r = idx / HS, jj = blockIdx.y * HS + idx % HS;
    float s = 0.f;
#pragma unroll
    for (int w8 = 0; w8 < WARPS; ++w8) s += red[(w8 * NRED + r) * HS + idx % HS];
    if (r < 9) atomicAdd(ddw + r * HC + jj, s);
    else if (r == 9) atomicAdd(ddb + jj, s);
    else atomicAdd(db1 + jj, s);
  }
}

// Phase 6 (K4b): the LN backward from dln (P, C) float32, a warp per pixel
template <typename T, int NP>
__global__ void __launch_bounds__(THREADS)
ffn_bwd_ln_kernel(const float* __restrict__ dln, const T* __restrict__ x, const T* __restrict__ g,
                  const float2* __restrict__ st, const float* __restrict__ lg, T* __restrict__ dx,
                  float* __restrict__ dlg, float* __restrict__ dlb, int P, int C) {
  __shared__ float red[WARPS][MAXC];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float2 pg[NP] = {}, pb[NP] = {};
  const int p1 = min(P, (int)(blockIdx.x + 1) * ROWS);
  for (int p = blockIdx.x * ROWS + warp; p < p1; p += WARPS) {
    const long at = (long)p * C;
    const float2 s = st[p];
    float2 gl[NP], xh[NP], gv[NP];
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = 2 * (lane + 32 * k);
      gl[k] = xh[k] = gv[k] = make_float2(0.f, 0.f);
      if (c >= C) continue;
      const float2 d = load2(dln + at + c), xv = load2(x + at + c);
      gv[k] = load2(g + at + c);
      gl[k] = make_float2(d.x * lg[c], d.y * lg[c + 1]);
      xh[k] = make_float2((xv.x - s.x) * s.y, (xv.y - s.x) * s.y);
      s1 += gl[k].x + gl[k].y;
      s2 += gl[k].x * xh[k].x + gl[k].y * xh[k].y;
      pg[k].x += d.x * xh[k].x;
      pg[k].y += d.y * xh[k].y;
      pb[k].x += d.x;
      pb[k].y += d.y;
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int k = 0; k < NP; ++k) {
      const int c = 2 * (lane + 32 * k);
      if (c < C)
        store2(dx + at + c, gv[k].x + s.y * (gl[k].x - s1 - xh[k].x * s2),
               gv[k].y + s.y * (gl[k].y - s1 - xh[k].y * s2));
    }
  }
  add_columns(red, pg, dlg, C);
  __syncthreads();
  add_columns(red, pb, dlb, C);
}

// f(std::integral_constant<int, NP>) for the fewest channel pairs per lane,
// NP, that cover C: the kernels' registers follow C, not its maximum
template <typename F>
auto pair_count(int C, F f) {
  using std::integral_constant;
  return C <= 64 ? f(integral_constant<int, 1>()) : C <= 128 ? f(integral_constant<int, 2>())
         : C <= 256 ? f(integral_constant<int, 4>()) : f(integral_constant<int, 8>());
}

template <typename T>
cudaError_t prep(const void* x, const void* g, const float* lg, const float* lb, const float* fac,
                 void* yhat, void* gs, void* st, float* db2, int P, int HW, int C, bool block,
                 cudaStream_t stream) {
  const dim3 grid((P + ROWS - 1) / ROWS);
  auto pick = [&](auto np) {
    constexpr int N = decltype(np)::value;
    return block ? ffn_bwd_prep_kernel<T, true, N> : ffn_bwd_prep_kernel<T, false, N>;
  };
  auto kern = pair_count(C, pick);
  kern<<<grid, THREADS, 0, stream>>>(static_cast<const T*>(x), static_cast<const T*>(g), lg, lb,
                                     fac, static_cast<T*>(yhat), static_cast<T*>(gs),
                                     static_cast<float2*>(st), db2, P, HW, C);
  return cudaGetLastError();
}

template <typename T>
cudaError_t tile(const float* h1, const float* dhg, const void* dw, const void* db, void* hg,
                 void* dh1, float* ddw, float* ddb, float* db1, int B, int H, int W, int HC,
                 cudaStream_t stream) {
  auto kern = ffn_bwd_tile_kernel<T>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, TILE_SMEM);
  if (err != cudaSuccess) return err;
  const dim3 grid(B * ((H + TH - 1) / TH) * ((W + TW - 1) / TW), HC / HS);
  kern<<<grid, THREADS, TILE_SMEM, stream>>>(h1, dhg, static_cast<const T*>(dw),
                                             static_cast<const T*>(db), static_cast<T*>(hg),
                                             static_cast<T*>(dh1), ddw, ddb, db1, H, W, HC);
  return cudaGetLastError();
}

template <typename T>
cudaError_t ln(const float* dln, const void* x, const void* g, const void* st, const float* lg,
               void* dx, float* dlg, float* dlb, int P, int C, cudaStream_t stream) {
  auto kern = pair_count(C, [](auto np) { return ffn_bwd_ln_kernel<T, decltype(np)::value>; });
  kern<<<(P + ROWS - 1) / ROWS, THREADS, 0, stream>>>(
      dln, static_cast<const T*>(x), static_cast<const T*>(g), static_cast<const float2*>(st), lg,
      static_cast<T*>(dx), dlg, dlb, P, C);
  return cudaGetLastError();
}

}  // namespace

// Phase 1: x, g (P, C) with P = B * HW pixels; block: LN2's lg, lb, the (B,)
// drop-path factors, and the outputs yhat, gs (like x) and st (P, 2)
// float32 (null without block); db2 a zeroed (C,) float32 buffer.
SFT_EXPORT int sft_ffn_bwd_prep(const void* x, const void* g, const void* lg, const void* lb,
                                const void* fac, void* yhat, void* gs, void* st, void* db2, int P,
                                int HW, int C, int block, int dtype, void* stream) {
  if (C % 32 || C > MAXC || P < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  if (dtype == SFT_F32)
    return prep<float>(x, g, f(lg), f(lb), f(fac), yhat, gs, st, static_cast<float*>(db2), P, HW,
                       C, block, s);
  if (dtype == SFT_BF16)
    return prep<__nv_bfloat16>(x, g, f(lg), f(lb), f(fac), yhat, gs, st, static_cast<float*>(db2),
                               P, HW, C, block, s);
  return cudaErrorInvalidValue;
}

// Phase 3: h1, dhg (B, H, W, HC) float32; dw (3, 3, 1, HC), db (HC) in the
// compute type; hg, dh1 (B, H, W, HC) out in the compute type; ddw, ddb,
// db1 zeroed float32 buffers.
SFT_EXPORT int sft_ffn_bwd_tile(const void* h1, const void* dhg, const void* dw, const void* db,
                                void* hg, void* dh1, void* ddw, void* ddb, void* db1, int B,
                                int H, int W, int HC, int dtype, void* stream) {
  if (HC % HS) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  auto o = [](void* p) { return static_cast<float*>(p); };
  if (dtype == SFT_F32)
    return tile<float>(f(h1), f(dhg), dw, db, hg, dh1, o(ddw), o(ddb), o(db1), B, H, W, HC, s);
  if (dtype == SFT_BF16)
    return tile<__nv_bfloat16>(f(h1), f(dhg), dw, db, hg, dh1, o(ddw), o(ddb), o(db1), B, H, W,
                               HC, s);
  return cudaErrorInvalidValue;
}

// Phase 6: dln (P, C) float32; x, g, dx (P, C) in the compute type; st
// from phase 1; dlg, dlb zeroed (C,) float32 buffers.
SFT_EXPORT int sft_ffn_bwd_ln(const void* dln, const void* x, const void* g, const void* st,
                              const void* lg, void* dx, void* dlg, void* dlb, int P, int C,
                              int dtype, void* stream) {
  if (C % 32 || C > MAXC || P < 1) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* d = static_cast<const float*>(dln);
  const float* l = static_cast<const float*>(lg);
  float* a = static_cast<float*>(dlg);
  float* b = static_cast<float*>(dlb);
  if (dtype == SFT_F32) return ln<float>(d, x, g, st, l, dx, a, b, P, C, s);
  if (dtype == SFT_BF16) return ln<__nv_bfloat16>(d, x, g, st, l, dx, a, b, P, C, s);
  return cudaErrorInvalidValue;
}

// Phases 2, 4, 5 (and K2f's fc1 and fc2, ops/mixffn.py): the GEMM of
// sm90.cuh. form NT (0): out (M, N) = a (M, K) . b (N, K)^T (+ bias (N,)),
// into out_f (float32) or out_t (the operands' type); NN (2): the same with
// b (K, N); TN (1): out_f (M, N), or (N, M) with trans, += a (K, M)^T . b
// (K, N).
SFT_EXPORT int sft_gemm(const void* a, const void* b, void* out_f, void* out_t, const void* bias,
                        int M, int N, int K, int form, int trans, int dtype, void* stream) {
  // every operand's rows a multiple of 16 bytes (TMA's strides)
  const bool rows_ok = form == sm90::TN ? M % 8 == 0 && N % 8 == 0
                       : form == sm90::NN ? K % 8 == 0 && N % 8 == 0
                                          : K % 8 == 0;
  if (M < 1 || N < 1 || K < 1 || N % 2 || !rows_ok) return cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const sm90::GemmEpi epi{static_cast<float*>(out_f), out_t, bias, trans};
  if (dtype == SFT_F32)
    return sm90::gemm(static_cast<const float*>(a), static_cast<const float*>(b), epi, M, N, K,
                      form, s);
  if (dtype == SFT_BF16)
    return sm90::gemm(static_cast<const __nv_bfloat16*>(a), static_cast<const __nv_bfloat16*>(b),
                      epi, M, N, K, form, s);
  return cudaErrorInvalidValue;
}
