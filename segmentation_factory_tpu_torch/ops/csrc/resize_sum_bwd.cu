// K5b: backward of K5 for the levels smaller than the output. Given the
// cotangent g (B, H, W, E) of out = sum_l upsample(z_l), writes each smaller
// level's dz_l (B, h_l, w_l, E) = the exact transpose of its bilinear
// upsample applied to g, accumulated in float32, in g's dtype. (A level of
// the output's size gets g itself; the wrapper hands it back.)
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_resize_sum.py
// `_backward` (:239, body `_bwd_kernel` :191, pallas_call :259), which reads
// g once for every level and transposes separably, columns then rows.
//
// What bounds it on the H100: bytes. g is read from device memory once for
// all levels (201 MB at the main path's 2 x 256 x 256 x 768 bf16) and each
// level written once (67 MB): 0.080 ms at 3.35 TB/s; 6 FMAs an element of g
// for three levels. Design, the transpose taken rows first, then columns:
// - A block owns a band of fine columns (ops/transpose_geometry.py
//   `sum_bwd_geometry`: 64 columns), a group of `quads` x 4 channels and one
//   image; it owns the low-resolution columns of every level whose centre
//   lies in its band, and reads the fine columns those sample: the band
//   and a halo (at s = 8, 4 columns a side between bands: 72 or 68 of 64,
//   read factor 280 / 256 = 1.094 on the main path, `read_factor`). It
//   walks every fine row in order, so no row crosses a block and nothing
//   is folded afterwards.
// - One thread holds one fine column and 4 channels; it loads its 4 values
//   of a row once (8 or 16 bytes, `P` rows ahead in registers) and adds
//   them, for each level, with the row's two weights (a table from the
//   plain version's taps, built once per shape, staged `SEG` rows at a
//   time) into two rolling float32 accumulators: the level's open
//   low-resolution row and the next.
// - When a fine row's first tap passes the open row, that row is complete
//   (in the fine-column domain): the threads put it into the level's next
//   slot in shared memory. Every `EVERY` (8) fine rows one barrier, and each
//   thread gathers its item, one (level, owned low-resolution column,
//   channel group), in every held row of that level: the footprint's
//   columns with the column weights (a table), the output stored once, as
//   g's dtype. Two sets of slots, one barrier a gather: 32 on the main path
//   (4 + 2 + 1 rows of the three levels each), not one a completed row
//   (224); about 16 taps a thread a gather at every level.
// No atomics: each output element is written by the one block that owns it.
// Every ratio, dyadic or not, and the edge clamp take the same tables.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int MAX_THREADS = 384;
constexpr int EVERY = 8;  // fine rows between two gathers; the main loop's unroll
constexpr int SEG = 64;   // fine rows of the row tables staged at a time

struct Level {
  void* dst;
  int h, w;
  int rows;   // word offset of H entries (y0, a, b, 0): weights on rows y0, y0 + 1
  int owned;  // of (xa, xb) a band: the columns it owns
  int foot;   // of (Xlo, n, off, 0) a column: its fine columns and their weights
  int wts;    // of the column weights (float32 bits)
  int cap;    // completed rows held until a gather (slots)
  int slot;   // the level's first slot
  int fs, ws;  // byte offsets in shared memory of the owned columns' footprints, weights
};

struct Geo {
  Level lv[MAX_LEVELS];
  int bands;  // word offset of (FX0, FX1) a band: the fine columns it reads
  int quads;  // groups of 4 channels a block (a power of two)
  int cols;   // fine columns a block (one thread each, per group)
  int slots;  // the levels' slots, each cols * quads float4, twice
};

// 4 channels of a row as loaded (8 or 16 bytes), widened where used, so a
// load in flight is not waited for before its row comes up
template <typename T> struct Raw;
template <> struct Raw<float> { using type = float4; };
template <> struct Raw<__nv_bfloat16> { using type = uint2; };

__device__ __forceinline__ float4 load_raw(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}
__device__ __forceinline__ uint2 load_raw(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint2*>(p));
}
__device__ __forceinline__ float4 widen(float4 v) { return v; }
__device__ __forceinline__ float4 widen(uint2 v) {
  return make_float4(__uint_as_float(v.x << 16), __uint_as_float(v.x & 0xffff0000u),
                     __uint_as_float(v.y << 16), __uint_as_float(v.y & 0xffff0000u));
}

// shared memory before the footprints: the slots of completed rows (two
// sets), the row tables of SEG rows, each level's owned columns (xa, n)
inline size_t smem_head(int nq, int slots, int nl) {
  return 2 * (size_t)slots * nq * sizeof(float4) + (size_t)nl * SEG * sizeof(int4) +
         ((size_t)nl * sizeof(int2) + 15) / 16 * 16;
}

// grid (E / 4 / quads, bands, B); shared memory: smem_head, then each
// level's owned footprints ((Xlo - FX0) * quads, n, local offset) and weights
template <typename T, int NL, int P>
__global__ void __launch_bounds__(MAX_THREADS, 2)
resize_sum_bwd_kernel(const T* __restrict__ g, const int* __restrict__ tab, Geo p, int H, int W,
                      int E) {
  using R = typename Raw<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const float* tabf = reinterpret_cast<const float*>(tab);
  const int band = blockIdx.y, b = blockIdx.z, t = threadIdx.x, nthr = blockDim.x;
  const int2 fx = *reinterpret_cast<const int2*>(tab + p.bands + 2 * band);
  if (fx.y < fx.x) return;  // the band owns no column of any level
  const int quads = p.quads, qshift = __ffs(quads) - 1, nq = p.cols * quads;
  float4* slots = reinterpret_cast<float4*>(smem);
  int4* rt = reinterpret_cast<int4*>(slots + 2 * p.slots * nq);
  int2* own_s = reinterpret_cast<int2*>(rt + NL * SEG);
  // each level's owned columns, their footprints and weights, into shared
  // memory once (visible after the first row tables' barrier); `first`: the
  // gather items (owned column, group) of the levels before each level
  int first[NL + 1];
  first[0] = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    const Level L = p.lv[l];
    const int2 own = __ldg(reinterpret_cast<const int2*>(tab + L.owned) + band);
    const int n = own.y - own.x;
    first[l + 1] = first[l] + n * quads;
    if (t == 0) own_s[l] = make_int2(own.x, n);
    if (n <= 0) continue;
    const int base = __ldg(reinterpret_cast<const int4*>(tab + L.foot) + own.x).z;
    const int4 last = __ldg(reinterpret_cast<const int4*>(tab + L.foot) + own.y - 1);
    int4* fs = reinterpret_cast<int4*>(smem + L.fs);
    float* ws = reinterpret_cast<float*>(smem + L.ws);
    for (int i = t; i < n; i += nthr) {
      const int4 f = __ldg(reinterpret_cast<const int4*>(tab + L.foot) + own.x + i);
      fs[i] = make_int4((f.x - fx.x) * quads, f.y, f.z - base, 0);
    }
    for (int i = t; i < last.z + last.y - base; i += nthr) ws[i] = __ldg(tabf + L.wts + base + i);
  }
  const int q = t & (quads - 1), X = fx.x + (t >> qshift);
  const bool live = t < nq && X <= fx.y;
  const int e0 = blockIdx.x * quads * 4;  // the block's first channel
  const T* src = g + ((long)b * H * W + (live ? X : fx.x)) * E + e0 + 4 * q;
  const long row = (long)W * E;
  const T* next = src + P * row;  // the row P ahead, advanced a row at a time

  // per level: the open low-resolution row and the next (rolling, float32),
  // the open row's index and the completed rows waiting in the slots
  float4 acc0[NL], acc1[NL];
  int open[NL], held[NL];
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    acc0[l] = acc1[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    open[l] = held[l] = 0;
  }
  int half = 0;  // the set of slots being filled

  // the held rows are complete: each gather item (level, owned column,
  // group; about one a thread) gathers its footprint in each held row of
  // its level and stores the output once. Two sets of slots: one barrier.
  auto gather = [&]() {
    __syncthreads();
    const float4* set = slots + half * p.slots * nq;
    for (int it = t; it < first[NL]; it += nthr) {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (it < first[l] || it >= first[l + 1]) continue;
        const Level L = p.lv[l];
        const int i = it - first[l], xi = i >> qshift, qq = i & (quads - 1);
        const int4 f = reinterpret_cast<const int4*>(smem + L.fs)[xi];
        const float* w = reinterpret_cast<const float*>(smem + L.ws) + f.z;
        const int y0 = open[l] - held[l];
        T* dst = static_cast<T*>(L.dst) +
                 ((long)(b * L.h + y0) * L.w + own_s[l].x + xi) * E + e0 + 4 * qq;
        const long step = (long)L.w * E;
        for (int k = 0; k < held[l]; ++k, dst += step) {
          const float4* col = set + (L.slot + k) * nq + f.x + qq;
          float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
          for (int m = 0; m < f.y; ++m) fma4(s, w[m], col[m * quads]);
          store4(dst, s);
        }
      }
    }
#pragma unroll
    for (int l = 0; l < NL; ++l) held[l] = 0;
    half ^= 1;
  };
  // row open[l] of level l is complete: into the level's next slot
  auto complete = [&](int l) {
    if (t < nq) slots[(half * p.slots + p.lv[l].slot + held[l]) * nq + t] = acc0[l];
    acc0[l] = acc1[l];
    acc1[l] = make_float4(0.f, 0.f, 0.f, 0.f);
    ++open[l];
    ++held[l];
  };

  R ring[P];  // the next P rows of this thread's column and channels
#pragma unroll
  for (int i = 0; i < P; ++i) ring[i] = (live && i < H) ? load_raw(src + i * row) : R{};
  for (int Y0 = 0; Y0 < H; Y0 += EVERY) {
#pragma unroll
    for (int i = 0; i < EVERY; ++i) {
      const int Y = Y0 + i;
      if (Y >= H) break;
      if (Y % SEG == 0) {  // the next SEG rows' weights of every level
        __syncthreads();
#pragma unroll
        for (int l = 0; l < NL; ++l) {
          const int4* rows = reinterpret_cast<const int4*>(tab + p.lv[l].rows);
          for (int j = t; j < SEG && Y + j < H; j += nthr) rt[l * SEG + j] = __ldg(rows + Y + j);
        }
        __syncthreads();
      }
      const float4 v = widen(ring[i % P]);
      if (live && Y + P < H) ring[i % P] = load_raw(next);
      next += row;
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        const int4 r = rt[l * SEG + Y % SEG];
        while (r.x > open[l]) complete(l);  // at most `cap` rows a window (the table's)
        fma4(acc0[l], __int_as_float(r.y), v);
        fma4(acc1[l], __int_as_float(r.z), v);
      }
      if (i == EVERY - 1) gather();
    }
  }
  // the rows no fine row passed: complete, gathered whenever a level's
  // slots are full
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    while (open[l] < p.lv[l].h) {
      if (held[l] == p.lv[l].cap) gather();
      complete(l);
    }
  }
  gather();
}

template <typename T, int NL>
cudaError_t launch(const void* g, const int* tab, Geo geo, const int* own_max, const int* wts_max,
                   int B, int H, int W, int E, int bands, int threads, cudaStream_t st) {
  constexpr int P = sizeof(T) == 2 ? 8 : 4;  // rows in flight: 16 registers a thread
  const dim3 grid((unsigned)(E / 4 / geo.quads), (unsigned)bands, (unsigned)B);
  size_t smem = smem_head(geo.cols * geo.quads, geo.slots, NL);
  for (int l = 0; l < NL; ++l) {  // each level's owned footprints, then their weights
    geo.lv[l].fs = (int)smem;
    smem += (size_t)own_max[l] * sizeof(int4);
    geo.lv[l].ws = (int)smem;
    smem += ((size_t)wts_max[l] * sizeof(float) + 15) / 16 * 16;
  }
  auto kern = resize_sum_bwd_kernel<T, NL, P>;
  static size_t allowed = 48 * 1024;  // the instance's dynamic shared memory limit so far
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  kern<<<grid, threads, smem, st>>>(static_cast<const T*>(g), tab, geo, H, W, E);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int n, const void* g, const int* tab, const Geo& geo, const int* own_max,
                     const int* wts_max, int B, int H, int W, int E, int bands, int threads,
                     cudaStream_t st) {
#define SFT_LEVELS(N)                                                                    \
  case N:                                                                                \
    return launch<T, N>(g, tab, geo, own_max, wts_max, B, H, W, E, bands, threads, st);
  switch (n) {
    SFT_LEVELS(1) SFT_LEVELS(2) SFT_LEVELS(3) SFT_LEVELS(4)
    SFT_LEVELS(5) SFT_LEVELS(6) SFT_LEVELS(7) SFT_LEVELS(8)
  }
#undef SFT_LEVELS
  return cudaErrorInvalidValue;
}

}  // namespace

// tab: the geometry table on the device; dsts/hs/ws: the n smaller levels'
// outputs (B, h, w, E) and sizes; offs: the table's word offsets (bands,
// then of each level rows, owned, foot, wts, the most columns and weights a
// band owns, and its slots); layout: bands, cols, quads, threads, the fine
// rows between two gathers (ops/transpose_geometry.py SumBwdGeometry).
SFT_EXPORT int sft_resize_sum_bwd(const void* g, const void* tab, void* const* dsts, const int* hs,
                                  const int* ws, const int* offs, const int* layout, int n, int B,
                                  int H, int W, int E, int dtype, void* stream) {
  const int bands = layout[0], cols = layout[1], quads = layout[2], threads = layout[3];
  if (n < 1 || n > MAX_LEVELS || E % 4 || B < 1 || quads < 1 || (quads & (quads - 1)) ||
      (E / 4) % quads || threads < cols * quads || threads > MAX_THREADS || bands < 1 ||
      layout[4] != EVERY)
    return cudaErrorInvalidValue;
  Geo geo;
  geo.bands = offs[0];
  geo.quads = quads;
  geo.cols = cols;
  geo.slots = 0;
  int own_max[MAX_LEVELS], wts_max[MAX_LEVELS];
  for (int i = 0; i < n; ++i) {
    Level& L = geo.lv[i];
    const int* o = offs + 1 + 7 * i;
    L.dst = dsts[i];
    L.h = hs[i];
    L.w = ws[i];
    L.rows = o[0];
    L.owned = o[1];
    L.foot = o[2];
    L.wts = o[3];
    own_max[i] = o[4];
    wts_max[i] = o[5];
    L.cap = o[6];
    if (L.cap < 1) return cudaErrorInvalidValue;
    L.slot = geo.slots;
    geo.slots += L.cap;
  }
  const int* t = static_cast<const int*>(tab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32)
    return dispatch<float>(n, g, t, geo, own_max, wts_max, B, H, W, E, bands, threads, st);
  if (dtype == SFT_BF16)
    return dispatch<__nv_bfloat16>(n, g, t, geo, own_max, wts_max, B, H, W, E, bands, threads,
                                   st);
  return cudaErrorInvalidValue;
}
