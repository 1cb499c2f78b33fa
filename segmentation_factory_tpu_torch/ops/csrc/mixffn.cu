// K2f's stencil and K4f, the Mix-FFN forwards, on an NHWC map: y (B, H, W,
// C), w1 (C, HC), b1 (HC), dw (3, 3, 1, HC), db (HC), w2 (HC, C), b2 (C);
// the depthwise conv zero-pads its input (SAME), GELU is exact (erf).
//
// K2f, out = fc2(GELU(dwconv3x3(fc1(y)))), replaces the TPU kernel
// segmentation_factory_tpu/ops/pallas_ffn.py `_forward` (:304, body
// `_fwd_kernel` :85), which keeps the 4C-wide hidden activation of a row
// tile in VMEM. Here it is three phases, composed by ops/mixffn.py
// `ffn_fwd` and rounded where the TPU kernel rounds:
// 1. h = round_T(y W1 + b1): the GEMM of sm90.cuh in its NN form (W1 read
//    in its own (C, HC) layout; wgmma + TMA for bfloat16, FMAs for float32),
//    the bias added to the float32 sum and rounded in the epilogue;
// 2. g = round_T(GELU(taps(h) + db)): ffn_stencil_kernel below, the taps
//    and the GELU in float32, h zero outside the image;
// 3. out = round_T(g W2 + b2): the same GEMM (NN), rounded once.
// What bounds it on the H100: operations, 4 C HC flops a pixel against 2 C
// elements of y and out moved. A block of one fused kernel cannot hold the
// widest stage's (C = 512) LN tile, weight rings and fc2 accumulators (227 KB
// of shared memory, 255 registers a thread), and MiT stage 4 has 32 blocks
// of 64 pixels for 132 SMs; as phases each product fills the card on
// wgmma, at the price of writing h and reading it back and the same for g
// (4 HC bytes a pixel each way in bfloat16, which the 50 MB L2 holds at
// stage 4, P HC = 4 M elements, and not at stage 1 of the per-op
// configuration).
//
// K4f, the FFN half-block of a MiT block:
//   out = x + fac[b] * fc2(GELU(dwconv3x3(fc1(LN2(x)))))
// for the raw block input x, LN2's float32 scale and bias and the per-image
// drop-path factor fac (B,) float32. It replaces the TPU kernel
// segmentation_factory_tpu/ops/pallas_block.py `_ffn_forward` (:641, body
// `_ffn_fwd_kernel` :431) and rounds where it rounds: LN2's output, h =
// fc1 + b1, and the GELU output to the compute type; fc2 + b2 and the
// residual in float32, rounded once. The activation is read once (plus the
// halo) and written once, as on the TPU.
// - bfloat16: namespace k4 below, on wgmma with TMA-fed weight rings.
// - float32 (the check path): ffn_block_f32_kernel, one block of 256
//   threads a TH x TW tile of output pixels walking the hidden channels in
//   chunks of 32: LN2 of the tile and its halo (a warp a pixel's float32
//   mean and 1/sigma), fc1 of the chunk on the halo into shared memory (zero
//   outside the image), the taps + db and GELU, the chunk's share of fc2
//   into float32 accumulators (each thread one 4-channel group of C for up
//   to 16 pixels), then the drop-path residual.
#include "common.cuh"
#include "sm90.cuh"

namespace {

// ---------------------------------------------------------------- K2f's stencil
//
// g = round_T(GELU(dwconv3x3(h) + db)) for h (B, H, W, HC) in T: a thread
// owns VEC = 16 / sizeof(T) channels of a column of SR output pixels; it
// reads the column's (SR + 2) x 3 input pixels once, 16 bytes each (zero
// outside the image), its 9 weights and bias once, and writes 16 bytes a
// pixel. Neighbouring threads own neighbouring channels: every access is
// coalesced. Bound by bytes: h read (SR + 2) * 3 / SR times from L1 / L2,
// once from device memory, and g written once. SR = 2 and the channels
// taken one at a time keep a thread under 128 registers, two blocks an SM.
constexpr int SR = 2;

// element e of the VEC values of T packed in a 16-byte vector, as float32
template <typename T>
__device__ __forceinline__ float elem(const uint4& v, int e) {
  const uint32_t u = (&v.x)[sizeof(T) == 4 ? e : e >> 1];
  if constexpr (sizeof(T) == 4) return __uint_as_float(u);
  else return __uint_as_float(e & 1 ? u & 0xffff0000u : u << 16);  // bf16: the high half
}

template <typename T>
__device__ __forceinline__ uint4 pack16(const float (&o)[16 / sizeof(T)]) {
  if constexpr (sizeof(T) == 4)
    return make_uint4(__float_as_uint(o[0]), __float_as_uint(o[1]), __float_as_uint(o[2]),
                      __float_as_uint(o[3]));
  else
    return make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]), pack_bf16(o[4], o[5]),
                      pack_bf16(o[6], o[7]));
}

template <typename T>
__global__ void __launch_bounds__(256, 2)
ffn_stencil_kernel(const T* __restrict__ h, const T* __restrict__ dw, const T* __restrict__ db,
                   T* __restrict__ g, int B, int H, int W, int HC) {
  constexpr int VEC = 16 / sizeof(T);
  const unsigned nq = HC / VEC, rows = (H + SR - 1) / SR;
  unsigned idx = blockIdx.x * blockDim.x + threadIdx.x;  // < 2^31 (stencil())
  if (idx >= B * rows * W * nq) return;
  const int c0 = (idx % nq) * VEC;
  idx /= nq;
  const int x = idx % W;
  idx /= W;
  const int y0 = (idx % rows) * SR;
  const long img = (long)(idx / rows) * H;  // the image's first row
  uint4 wv[9], hv[SR + 2][3];
#pragma unroll
  for (int k = 0; k < 9; ++k) wv[k] = *reinterpret_cast<const uint4*>(dw + k * HC + c0);
  const uint4 bv = *reinterpret_cast<const uint4*>(db + c0);
#pragma unroll
  for (int dy = 0; dy < SR + 2; ++dy)
#pragma unroll
    for (int dx = 0; dx < 3; ++dx) {
      const int gy = y0 + dy - 1, gx = x + dx - 1;
      hv[dy][dx] = gy >= 0 && gy < H && gx >= 0 && gx < W
                       ? *reinterpret_cast<const uint4*>(h + ((img + gy) * W + gx) * HC + c0)
                       : make_uint4(0u, 0u, 0u, 0u);
    }
  float o[SR][VEC];
#pragma unroll
  for (int e = 0; e < VEC; ++e) {
    float w[9];
#pragma unroll
    for (int t = 0; t < 9; ++t) w[t] = elem<T>(wv[t], e);
#pragma unroll
    for (int k = 0; k < SR; ++k)
      o[k][e] = gelu_erf(
          dw_taps(w, elem<T>(bv, e), [&](int ty, int tx) { return elem<T>(hv[k + ty][tx], e); }));
  }
#pragma unroll
  for (int k = 0; k < SR; ++k)
    if (y0 + k < H)
      *reinterpret_cast<uint4*>(g + ((img + y0 + k) * W + x) * HC + c0) = pack16<T>(o[k]);
}

template <typename T>
cudaError_t stencil(const void* h, const void* dw, const void* db, void* g, int B, int H, int W,
                    int HC, cudaStream_t stream) {
  const long threads = (long)B * ((H + SR - 1) / SR) * W * (HC / (16 / sizeof(T)));
  if (HC % (16 / sizeof(T)) || threads >= (1L << 31)) return cudaErrorInvalidValue;
  ffn_stencil_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(
      static_cast<const T*>(h), static_cast<const T*>(dw), static_cast<const T*>(db),
      static_cast<T*>(g), B, H, W, HC);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- K4f, float32

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
  __host__ __device__ int st_off() const { return gs_off() + P * GS; }  // LN stats
  __host__ __device__ int floats() const { return st_off() + 2 * PH; }
};

__global__ void __launch_bounds__(THREADS, 1)
ffn_block_f32_kernel(const float* __restrict__ y, const float* __restrict__ w1,
                     const float* __restrict__ b1, const float* __restrict__ dw,
                     const float* __restrict__ db, const float* __restrict__ w2,
                     const float* __restrict__ b2, const float* __restrict__ lg,
                     const float* __restrict__ lb, const float* __restrict__ fac,
                     float* __restrict__ out, int H, int W, int C, int HC, int TH, int TW) {
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
  const float* yb = y + (long)b * H * W * C;
  // LN2 statistics of the tile and its halo, a warp per pixel
  for (int p = tid >> 5; p < g.PH; p += THREADS / 32) {
    const int gy = y0 + p / g.PW - 1, gx = x0 + p % g.PW - 1;
    const bool in = gy >= 0 && gy < H && gx >= 0 && gx < W;
    const float2 v = warp_ln_stats(in ? yb + ((long)gy * W + gx) * C : nullptr, C);
    if ((tid & 31) == 0) st[p] = v;
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
          val = ln4<float>(load4(yb + ((long)gy * W + gx) * C + k0 + c4), st[p], lg, lb,
                           k0 + c4);
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
      float w[9];
#pragma unroll
      for (int k = 0; k < 9; ++k) w[k] = dw[k * HC + j0 + j];
      const float* hp = hs + (py * g.PW + px) * HCH + j;
      gs[p * GS + j] = gelu_erf(
          dw_taps(w, db[j0 + j], [&](int ty, int tx) { return hp[(ty * g.PW + tx) * HCH]; }));
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
    const float f = fac[b];  // the drop-path residual in float32
    const float4 xv = load4(y + at);
    r = make_float4(xv.x + f * r.x, xv.y + f * r.y, xv.z + f * r.z, xv.w + f * r.w);
    store4(out + at, r);
  }
}

cudaError_t launch_f32(const void* y, const void* w1, const void* b1, const void* dw,
                       const void* db, const void* w2, const void* b2, const float* lg,
                       const float* lb, const float* fac, void* out, int B, int H, int W, int C,
                       int HC, int TH, int TW, cudaStream_t stream) {
  const Geometry g(TH, TW);
  const int npg = C >= 4 && C / 4 <= THREADS ? THREADS / (C / 4) : 0;
  if (C % 4 || HC % HCH || npg == 0 || g.P > npg * NACC || g.PH * (HCH / 4) > THREADS * NE)
    return cudaErrorInvalidValue;
  const size_t bytes = (size_t)g.floats() * 4;
  auto kern = ffn_block_f32_kernel;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  auto f = [](const void* p) { return static_cast<const float*>(p); };
  kern<<<grid, THREADS, bytes, stream>>>(f(y), f(w1), f(b1), f(dw), f(db), f(w2), f(b2), lg, lb,
                                         fac, static_cast<float*>(out), H, W, C, HC, TH, TW);
  return cudaGetLastError();
}


// ---------------------------------------------------------------- K4f, bfloat16: wgmma + TMA
//
// One block owns a TH x TW tile of output pixels of one image (TH * TW =
// 64, TH a multiple of 4; its halo (TH + 2)(TW + 2) <= HR = 128 pixels;
// ops/block.py ffn_geometry picks it): two warpgroups, thread 0 issuing the
// TMA loads between the block's barriers.
// 1. TMA loads the halo tile of x (one box a 64-column block, zeros outside
//    the image and past C) into a 128B-swizzled tile of HR rows, which the
//    warps normalise in place (LN2 in float32, rounded; sm90.cuh ln_tile):
//    fc1's A operand, warpgroup w reading rows 64w ...
// 2. The hidden channels in chunks of HK = 32. Two rings of two stages are
//    filled by TMA (64B swizzle, zeros past the edges): W1's chunk columns
//    (C x 32) and W2's chunk rows (32 x C). Per chunk i, in one loop
//    iteration between two block barriers:
//    - issue fc2 of chunk i - 1 (g tile (64 x 32) x W2 chunk; warpgroup w
//      owns the 32-column blocks w, w + 2, ... of the output, whose float32
//      accumulators live across all chunks) and fc1 of chunk i + 1 (its
//      64 halo rows x W1 chunk), both on wgmma, not waited for;
//    - meanwhile on the CUDA cores, chunk i's 9 taps + db and the exact
//      erf GELU from the bf16 h tile into the bf16 g tile (64B swizzle,
//      fc2's A operand), the chunk's dw, db and b1 brought by 1-D bulk
//      copies (a third ring, of three stages);
//    - wait, then fc1's accumulators + b1, zero outside the image,
//      rounded to bf16 into the other h tile.
//    So the GELU overlaps both products, and each stage is refilled an
//    iteration or more before it is read.
// 3. Epilogue: + b2, x + fac * z in float32, rounded once.
namespace k4 {

using bf16 = __nv_bfloat16;
using namespace sm90;
constexpr int HK = 32;          // hidden channels a chunk
constexpr int HR = 128;         // halo rows: two m64 tiles
constexpr int PMAX = 64;        // output pixels a block
constexpr int HLD = HK + 8;     // h tile row (bf16): 80 bytes, conflict-free
constexpr int THREADS4 = 256;  // two warpgroups
constexpr int LN_BLK = HR * 128;  // one 64-column block of the LN tile
constexpr int G_TILE = PMAX * HK * 2;
constexpr int PRM_STAGE = 1024;  // a chunk's dw (9 rows), db and b1: 64 bytes each
constexpr int PRM_STAGES = 3;
constexpr int PRM_DB = 9 * HK * 2, PRM_B1 = PRM_DB + HK * 2, PRM_BYTES = PRM_B1 + HK * 2;

struct Layout {
  int cb, nb, ln, w1, w1_stage, w2, w2_stage, h, g, prm, bar, bytes;
  __host__ __device__ Layout(int C) {
    cb = (C + 63) / 64;  // 64-column blocks of C (fc1's contraction, padded)
    nb = C / 32;         // 32-column blocks of the output (fc2)
    ln = 0;
    w1 = ln + cb * LN_BLK;
    w1_stage = cb * 64 * HK * 2;  // cb boxes of 64 rows x 32 columns
    w2 = w1 + 2 * w1_stage;
    w2_stage = 2 * cb * HK * 32 * 2;  // nb boxes of 32 rows x 32 columns, zeros to 2 cb
    h = w2 + 2 * w2_stage;
    g = h + ((2 * HR * HLD * 2 + 1023) & ~1023);
    prm = g + 2 * G_TILE;
    bar = prm + PRM_STAGES * PRM_STAGE;  // W1's, W2's and the parameters' stages, x's
    bytes = bar + 8 * 8 + 1024;  // + alignment slack
  }
};

__device__ __forceinline__ bool inside(int gy, int gx, int H, int W) {
  return gy >= 0 && gy < H && gx >= 0 && gx < W;
}

// NBW: the output's 32-column blocks a warpgroup owns, ceil(C / 64), which is
// also the 64-column blocks of fc1's contraction; warpgroup w owns blocks w,
// w + 2, ... of 2 NBW, those past C / 32 zero (so no wgmma is conditional)
template <int NBW>
__global__ void __launch_bounds__(THREADS4, NBW <= 2 ? 2 : 1)
ffn_block_wgmma_kernel(const __grid_constant__ CUtensorMap tx,
                       const __grid_constant__ CUtensorMap tw1,
                       const __grid_constant__ CUtensorMap tw2, const bf16* __restrict__ x,
                       const float* __restrict__ lg, const float* __restrict__ lb,
                       const bf16* __restrict__ b1, const bf16* __restrict__ dw,
                       const bf16* __restrict__ db, const bf16* __restrict__ b2,
                       const float* __restrict__ fac, bf16* __restrict__ out, int H, int W,
                       int C, int HC, int TH, int TW) {
  const Layout L(C);
  const int PW = TW + 2, PH = (TH + 2) * PW, n = HC / HK;
  extern __shared__ uint8_t ffn_smem[];
  uint8_t* base = align_1024(ffn_smem);
  uint8_t* lns = base + L.ln;
  bf16* hs = reinterpret_cast<bf16*>(base + L.h);
  uint8_t* gs = base + L.g;
  uint64_t* full1 = reinterpret_cast<uint64_t*>(base + L.bar);
  uint64_t* full2 = full1 + 2;
  uint64_t* fullp = full2 + 2;
  uint64_t* xbar = fullp + PRM_STAGES;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int b = blockIdx.z, y0 = blockIdx.y * TH, x0 = blockIdx.x * TW;
  const int wg = warp >> 2, wl = warp & 3, g = lane >> 2, t4 = lane & 3;
  const bf16* xb = x + (long)b * H * W * C;

  // Thread 0 issues every load, each where its stage is known to be free:
  // the loop's block barriers order the last reads of a stage before it.
  auto load1 = [&](int i) {  // W1[:, chunk i]: boxes of 64 rows (k) x 32 (j)
    const int s = i & 1;
    mbar_expect_tx(full1 + s, L.w1_stage);
    for (int kb = 0; kb < NBW; ++kb)
      tma_load_2d(base + L.w1 + s * L.w1_stage + kb * 64 * HK * 2, &tw1, full1 + s, i * HK,
                  64 * kb);
  };
  auto load2 = [&](int i) {  // W2[chunk i, :]: boxes of 32 rows (j) x 32 (c)
    const int s = i & 1;
    mbar_expect_tx(full2 + s, L.nb * HK * 64);
    for (int cbk = 0; cbk < L.nb; ++cbk)
      tma_load_2d(base + L.w2 + s * L.w2_stage + cbk * HK * 64, &tw2, full2 + s, 32 * cbk,
                  i * HK);
  };
  auto loadp = [&](int i) {  // the chunk's 9 rows of dw, db and b1, 64 bytes each
    const int s = i % PRM_STAGES;
    uint8_t* dst = base + L.prm + s * PRM_STAGE;
    mbar_expect_tx(fullp + s, PRM_BYTES);
    for (int k = 0; k < 9; ++k)
      bulk_load(dst + k * HK * 2, dw + k * HC + i * HK, HK * 2, fullp + s);
    bulk_load(dst + PRM_DB, db + i * HK, HK * 2, fullp + s);
    bulk_load(dst + PRM_B1, b1 + i * HK, HK * 2, fullp + s);
  };
  if (tid == 0) {
    for (int s = 0; s < 2; ++s) {
      mbar_init(full1 + s, 1);
      mbar_init(full2 + s, 1);
    }
    for (int s = 0; s < PRM_STAGES; ++s) mbar_init(fullp + s, 1);
    mbar_init(xbar, 1);
    mbar_fence_init();
    // the halo tile of x, 64 channels a box, into the LN2 tile (zeros
    // outside the image and past C); then chunks 0 and 1's W1 and
    // parameters
    mbar_expect_tx(xbar, NBW * PH * 128);
    for (int kb = 0; kb < NBW; ++kb)
      tma_load_4d(lns + kb * LN_BLK, &tx, xbar, 64 * kb, x0 - 1, y0 - 1, b);
    for (int i = 0; i < 2 && i < n; ++i) {
      load1(i);
      loadp(i);
    }
  }
  __syncthreads();

  // W2's stages past C / 32 blocks stay zero (nothing loads them)
  for (int i = tid; i < 2 * (2 * NBW - L.nb) * HK * 4; i += THREADS4) {
    const int per = (2 * NBW - L.nb) * HK * 4;  // 16-byte chunks a stage
    *reinterpret_cast<uint4*>(base + L.w2 + (i / per) * L.w2_stage + L.nb * HK * 64 +
                              (i % per) * 16) = make_uint4(0u, 0u, 0u, 0u);
  }

  // 1. LN2 of the halo pixels in place (rows past the halo stay as they
  // are: their fc1 rows are never read)
  mbar_wait(xbar, 0);
  ln_tile<4, NBW <= 4 ? 1 : 2>(lns, LN_BLK, warp, THREADS4 / 32, PH, C, lg, lb);
  fence_proxy_async();
  __syncthreads();

  // this thread's fc1 rows (halo rows of its warpgroup) and whether they lie in the image
  const int hr0 = 64 * wg + 16 * wl + g, hr1 = hr0 + 8;
  const bool hin0 = hr0 < PH && inside(y0 + hr0 / PW - 1, x0 + hr0 % PW - 1, H, W);
  const bool hin1 = hr1 < PH && inside(y0 + hr1 / PW - 1, x0 + hr1 % PW - 1, H, W);
  float acc1[16], acc2[NBW][16];
#pragma unroll
  for (int u = 0; u < NBW; ++u)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc2[u][e] = 0.f;

  auto issue_fc1 = [&](int i) {
    const int s = i & 1;
    mbar_wait(full1 + s, (i >> 1) & 1);
    // descriptors of slice 0, stepped by the slices' byte offsets / 16 (the
    // address field; no carry within shared memory)
    const uint64_t da = make_desc(lns + wg * 64 * 128, 128, false);
    const uint64_t db = make_desc(base + L.w1 + s * L.w1_stage, 64, true);
    fence_regs(acc1);
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < NBW * 4; ++ks)
      wgmma_ss_m64n32<0, 1>(acc1, da + (((ks >> 2) * LN_BLK + (ks & 3) * 32) >> 4),
                            db + ((ks * 16 * 64) >> 4), ks > 0);
    wgmma_commit();
  };
  auto issue_fc2 = [&](int i) {
    const int s = i & 1;
    mbar_wait(full2 + s, (i >> 1) & 1);
    const uint64_t da = make_desc(gs + (i & 1) * G_TILE, 64, false);
    const uint64_t db = make_desc(base + L.w2 + s * L.w2_stage + wg * HK * 64, 64, true);
#pragma unroll
    for (int u = 0; u < NBW; ++u) fence_regs(acc2[u]);
    wgmma_fence();
#pragma unroll
    for (int u = 0; u < NBW; ++u) {
#pragma unroll
      for (int kk = 0; kk < HK / 16; ++kk)  // block 2u + wg of the output's columns
        wgmma_ss_m64n32<0, 1>(acc2[u], da + ((kk * 32) >> 4),
                              db + ((2 * u * HK * 64 + kk * 16 * 64) >> 4));
    }
    wgmma_commit();
  };
  // fc1 of chunk i + b1, zero outside the image, rounded, into h tile i % 2
  auto store_h = [&](int i) {
    bf16* ht = hs + (i & 1) * HR * HLD;
    const uint8_t* prm = base + L.prm + (i % PRM_STAGES) * PRM_STAGE;
    mbar_wait(fullp + i % PRM_STAGES, (i / PRM_STAGES) & 1);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int ch = 8 * j + 2 * t4;
      const float2 bb = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(prm + PRM_B1 + ch * 2));
      *reinterpret_cast<uint32_t*>(ht + hr0 * HLD + ch) =
          hin0 ? pack_bf16(acc1[4 * j] + bb.x, acc1[4 * j + 1] + bb.y) : 0u;
      *reinterpret_cast<uint32_t*>(ht + hr1 * HLD + ch) =
          hin1 ? pack_bf16(acc1[4 * j + 2] + bb.x, acc1[4 * j + 3] + bb.y) : 0u;
    }
  };
  // chunk i's taps + db + GELU: thread pair jp (channels 2jp, 2jp + 1) of
  // a column of 4 pixels (rows py0 .. py0 + 3 at column px), into g tile
  // i % 2; the column's 6 x 3 halo values are each read once, row by row,
  // and added to the outputs whose taps they are (the taps' order per
  // output stays ty, then tx)
  const int jp = tid & 15, pg = tid >> 4;
  const int px = pg % TW, py0 = pg / TW * 4;
  auto taps = [&](int i) {  // the parameters arrived before store_h(i)
    const uint8_t* prm = base + L.prm + (i % PRM_STAGES) * PRM_STAGE + 4 * jp;
    __nv_bfloat162 wt[9];  // converted where used: fewer live registers
#pragma unroll
    for (int k = 0; k < 9; ++k)
      wt[k] = *reinterpret_cast<const __nv_bfloat162*>(prm + k * HK * 2);
    const float2 bias =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(prm + PRM_DB));
    const bf16* ht = hs + (i & 1) * HR * HLD + (py0 * PW + px) * HLD + 2 * jp;
    float2 a[4] = {bias, bias, bias, bias};
#pragma unroll
    for (int dy = 0; dy < 6; ++dy) {
      float2 hv[3];
#pragma unroll
      for (int dx = 0; dx < 3; ++dx)
        hv[dx] = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(ht + (dy * PW + dx) * HLD));
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int ty = dy - k;
        if (ty < 0 || ty > 2) continue;
#pragma unroll
        for (int dx = 0; dx < 3; ++dx) {
          const float2 w = __bfloat1622float2(wt[3 * ty + dx]);
          a[k].x = fmaf(w.x, hv[dx].x, a[k].x);
          a[k].y = fmaf(w.y, hv[dx].y, a[k].y);
        }
      }
    }
    uint8_t* gt = gs + (i & 1) * G_TILE + (jp & 3) * 4;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      *reinterpret_cast<uint32_t*>(gt + swz((py0 + k) * TW + px, jp >> 2, 64)) =
          pack_bf16(gelu_erf(a[k].x), gelu_erf(a[k].y));
  };

  // 2. the chunk loop. At the top of iteration i every read of W1(i),
  // W2(i - 2) and the parameters of chunk i - 1 is done (their products
  // were waited for and a block barrier passed): thread 0 refills those
  // stages with W1(i + 2), W2(i) and the parameters of chunk i + 2.
  issue_fc1(0);
  wgmma_wait_all();
  fence_regs(acc1);
  store_h(0);
  __syncthreads();
  for (int i = 0; i < n; ++i) {
    if (tid == 0) {
      fence_proxy_async();  // the threads' reads of the stages before TMA's writes
      if (i + 2 < n) load1(i + 2);
      load2(i);
      if (i + 2 < n) loadp(i + 2);
    }
    if (i > 0) issue_fc2(i - 1);
    if (i + 1 < n) issue_fc1(i + 1);
    taps(i);
    wgmma_wait_all();
    fence_regs(acc1);
#pragma unroll
    for (int u = 0; u < NBW; ++u) fence_regs(acc2[u]);
    if (i + 1 < n) store_h(i + 1);
    fence_proxy_async();  // g tile i, written by the threads, is read by wgmma
    __syncthreads();
  }
  issue_fc2(n - 1);
  wgmma_wait_all();
#pragma unroll
  for (int u = 0; u < NBW; ++u) fence_regs(acc2[u]);

  // 3. + b2 and the drop-path residual in float32, rounded once
  const float f = fac[b];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int p = 16 * wl + g + 8 * hh;
    const int gy = y0 + p / TW, gx = x0 + p % TW;
    if (gy >= H || gx >= W) continue;
    const long at = (((long)b * H + gy) * W + gx) * C;
#pragma unroll
    for (int u = 0; u < NBW; ++u) {
      const int cbk = 2 * u + wg;
      if (cbk >= L.nb) continue;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 32 * cbk + 8 * j + 2 * t4;
        const float2 bb = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(b2 + c));
        const float2 xv = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(x + at + c));
        *reinterpret_cast<uint32_t*>(out + at + c) =
            pack_bf16(xv.x + f * (acc2[u][4 * j + 2 * hh] + bb.x),
                      xv.y + f * (acc2[u][4 * j + 2 * hh + 1] + bb.y));
      }
    }
  }
}

template <int NBW>
cudaError_t launch_nbw(const CUtensorMap& tx, const CUtensorMap& tw1, const CUtensorMap& tw2,
                       const Layout& L,
                       const void* x, const float* lg, const float* lb, const void* b1,
                       const void* dw, const void* db, const void* b2, const float* fac,
                       void* out, int B, int H, int W, int C, int HC, int TH, int TW,
                       cudaStream_t stream) {
  auto kern = ffn_block_wgmma_kernel<NBW>;
  cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, L.bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, B);
  kern<<<grid, THREADS4, L.bytes, stream>>>(
      tx, tw1, tw2, static_cast<const bf16*>(x), lg, lb, static_cast<const bf16*>(b1),
      static_cast<const bf16*>(dw), static_cast<const bf16*>(db), static_cast<const bf16*>(b2),
      fac, static_cast<bf16*>(out), H, W, C, HC, TH, TW);
  return cudaGetLastError();
}

cudaError_t launch(const void* x, const void* w1, const void* b1, const void* dw, const void* db,
                   const void* w2, const void* b2, const float* lg, const float* lb,
                   const float* fac, void* out, int B, int H, int W, int C, int HC, int TH,
                   int TW, cudaStream_t stream) {
  const Layout L(C);
  if (C % 32 || C > 320 || HC % HK || TH % 4 || TW < 1 || TH * TW != PMAX ||
      (TH + 2) * (TW + 2) > HR || L.bytes > 232448)
    return cudaErrorInvalidValue;
  using u64 = cuuint64_t;
  CUtensorMap tx, tw1, tw2;
  const u64 d1[2] = {static_cast<u64>(HC), static_cast<u64>(C)}, s1[1] = {d1[0] * 2};
  const u64 d2[2] = {static_cast<u64>(C), static_cast<u64>(HC)}, s2[1] = {d2[0] * 2};
  const cuuint32_t box1[2] = {HK, 64}, box2[2] = {32, HK};
  // x (B, H, W, C) as {C, W, H, B}: a block's halo is one box a 64-channel block
  const u64 dx[4] = {static_cast<u64>(C), static_cast<u64>(W), static_cast<u64>(H),
                     static_cast<u64>(B)};
  const u64 sx[3] = {dx[0] * 2, dx[0] * dx[1] * 2, dx[0] * dx[1] * dx[2] * 2};
  const cuuint32_t boxx[4] = {64, static_cast<cuuint32_t>(TW + 2),
                              static_cast<cuuint32_t>(TH + 2), 1};
  cudaError_t err = make_map(&tx, x, 4, dx, sx, boxx);
  if (err == cudaSuccess) err = make_map(&tw1, w1, 2, d1, s1, box1);
  if (err == cudaSuccess) err = make_map(&tw2, w2, 2, d2, s2, box2);
  if (err != cudaSuccess) return err;
  switch ((L.nb + 1) / 2) {
#define K4_CASE(N)                                                                        \
  case N:                                                                                 \
    return launch_nbw<N>(tx, tw1, tw2, L, x, lg, lb, b1, dw, db, b2, fac, out, B, H, W, C, HC, \
                         TH, TW, stream);
    K4_CASE(1) K4_CASE(2) K4_CASE(3) K4_CASE(4) K4_CASE(5)
#undef K4_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace k4

}  // namespace

// K2f's stencil phase: h, g (B, H, W, HC), dw (3, 3, 1, HC), db (HC), all in
// the compute type; HC a multiple of 8 (bfloat16) or 4 (float32).
SFT_EXPORT int sft_ffn_stencil(const void* h, const void* dw, const void* db, void* g, int B,
                               int H, int W, int HC, int dtype, void* stream) {
  if (B < 1 || H < 1 || W < 1 || HC < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32) return stencil<float>(h, dw, db, g, B, H, W, HC, st);
  if (dtype == SFT_BF16) return stencil<__nv_bfloat16>(h, dw, db, g, B, H, W, HC, st);
  return cudaErrorInvalidValue;
}

// K4f: x the raw block input (B, H, W, C); lg, lb (C) and fac (B) float32;
// TH x TW the output tile of a block (bfloat16: ops/block.py ffn_geometry;
// float32: ops/mixffn.py tile_rows x 8).
SFT_EXPORT int sft_ffn_block(const void* x, const void* lg, const void* lb, const void* w1,
                             const void* b1, const void* dw, const void* db, const void* w2,
                             const void* b2, const void* fac, void* out, int B, int H, int W,
                             int C, int HC, int TH, int TW, int dtype, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* g = static_cast<const float*>(lg);
  const float* bb = static_cast<const float*>(lb);
  const float* f = static_cast<const float*>(fac);
  if (dtype == SFT_F32)
    return launch_f32(x, w1, b1, dw, db, w2, b2, g, bb, f, out, B, H, W, C, HC, TH, TW, st);
  if (dtype == SFT_BF16)
    return k4::launch(x, w1, b1, dw, db, w2, b2, g, bb, f, out, B, H, W, C, HC, TH, TW, st);
  return cudaErrorInvalidValue;
}
