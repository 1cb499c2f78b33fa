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
// What bounds it on the H100: bytes. Counted once, K9f reads value, the
// locations and weights and writes its output; K9b adds g and its three
// outputs. But every (b, q, m) item gathers 4 L P corner rows of D values:
// at the Mask2Former slice's shapes (value (4, 5376, 8, 96) bf16, 3 levels,
// 4 points) that is 8.26 M rows of 192 B, 1.59 GB a launch, 48 times
// value's 33 MB, which stays in the 50 MB L2. So the gathers run at L2's
// rate, not device memory's. K9b's d(value), as an atomic col2im, is
// 6.99 M in-bounds row additions into 172,032 rows (2.68 GB of float32
// reductions resolved by L2's atomic units): with scalar atomics it took
// 3.79 ms on an H100, and with 16-byte vector reductions alone 2.45 ms.
//
// Design. LP lanes own one (b, q, m) item, each lane CPL consecutive
// channels, LP * CPL = D exactly (ops/msdeform.py LANES: 4 lanes of 8 at
// D = 32, of 24 at D = 96, 8 of 32 at D = 256), so no lane idles and every
// value load is 16 bytes (8 bf16 or 4 float32). The item's locations and
// weights are read once a level, four points at a time as 16-byte vectors
// when P is a multiple of 4. The points of a group of four are unrolled:
// each point's four corner rows are loaded together from addresses clamped
// into the map, a corner outside it weighted 0 (its value never reaches
// the output, as the plain version's mask). K9f: 256-thread blocks of
// consecutive items. K9b: a block owns one (b, m) and 128 queries (at
// LP = 4); it dots each corner's row with g per lane and reduces blend,
// dtx and dty over the item's lanes by log2(LP) shuffles for d(loc) and
// d(weight). d(value) goes through a window of each level: the corners
// inside it are sorted by pixel in shared memory (integer atomics and a
// scan: a first window that summed the float rows there by shared-memory
// atomics ran slower than no window at all) and each window pixel's sum
// of coefficient * g rows, taken from the block's g rows in shared memory,
// is added into d(value) once with sm_90's 16-byte vector reduction
// (atomicAdd on float4). At the slice's shapes nearly every in-bounds row
// takes a window and the reductions fall from 167.7 M to about 35 M
// (chip_smoke.py phase m2f reports the routes' shares); a corner outside
// its window (a far offset) is added straight, also by 16-byte reductions. Atomics make d(value)'s summation order, and so its
// last bits, vary from run to run: it is held to the plain version by a
// tolerance, not bit for bit.
#include <climits>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;  // ops/msdeform.py MAX_LEVELS
constexpr int THREADS = 256;      // K9f
constexpr int BWD_THREADS = 512;  // K9b: one block an SM
constexpr int WINDOW_PIXELS = 2048;  // K9b: a window's pixels at most
constexpr int GROUP = 4;  // points unrolled together

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

// A point's four corners in the order (y0, x0), (y0, x0 + 1), (y0 + 1, x0),
// (y0 + 1, x0 + 1): the pixel within its level (clamped into the map, so
// that every load is in bounds), whether it lies inside, and the bilinear
// weights wy, wx of the two rows and columns.
struct Corners {
  int pix[4], x[4], y[4];
  bool in[4];
  float wy[2], wx[2];
};

__device__ __forceinline__ Corners corners(float lx, float ly, int h, int w) {
  const Point pt = sample_point(lx, ly, h, w);
  Corners c;
  c.wy[0] = 1.f - pt.ty;
  c.wy[1] = pt.ty;
  c.wx[0] = 1.f - pt.tx;
  c.wx[1] = pt.tx;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int y = pt.y0 + (k >> 1), x = pt.x0 + (k & 1);
    c.x[k] = x, c.y[k] = y;
    c.in[k] = y >= 0 && y < h && x >= 0 && x < w;
    c.pix[k] = min(max(y, 0), h - 1) * w + min(max(x, 0), w - 1);
  }
  return c;
}

// CPL consecutive channels of one row as 16-byte words, read as float32
template <typename T, int CPL>
struct Row {
  static constexpr int PER = 16 / sizeof(T);  // elements a word
  static_assert(CPL % PER == 0, "a lane's channels are whole 16-byte words");
  uint4 raw[CPL / PER];

  __device__ __forceinline__ void load(const T* p) {
#pragma unroll
    for (int i = 0; i < CPL / PER; ++i) raw[i] = __ldg(reinterpret_cast<const uint4*>(p) + i);
  }
  __device__ __forceinline__ float at(int j) const {
    const uint32_t u = (&raw[0].x)[j * sizeof(T) / 4];
    if constexpr (sizeof(T) == 4) {
      return __uint_as_float(u);
    } else {
      return (j & 1) ? __uint_as_float(u & 0xffff0000u) : __uint_as_float(u << 16);
    }
  }
};

// Points p0 .. p0 + GROUP - 1 of one (item, level) row of P points: x, y
// and weight, read as 16-byte vectors when P is a multiple of 4; a point
// past P lies far outside every map (no corner inside) with weight 0.
struct Group {
  float x[GROUP], y[GROUP], a[GROUP];
};

__device__ __forceinline__ Group load_group(const float* lrow, const float* arow, int p0, int P) {
  Group gp;
  if (P % GROUP == 0) {
    const float4 l0 = __ldg(reinterpret_cast<const float4*>(lrow + 2 * p0));
    const float4 l1 = __ldg(reinterpret_cast<const float4*>(lrow + 2 * p0) + 1);
    const float4 a = __ldg(reinterpret_cast<const float4*>(arow + p0));
    gp.x[0] = l0.x, gp.y[0] = l0.y, gp.x[1] = l0.z, gp.y[1] = l0.w;
    gp.x[2] = l1.x, gp.y[2] = l1.y, gp.x[3] = l1.z, gp.y[3] = l1.w;
    gp.a[0] = a.x, gp.a[1] = a.y, gp.a[2] = a.z, gp.a[3] = a.w;
  } else {
#pragma unroll
    for (int i = 0; i < GROUP; ++i) {
      const bool ok = p0 + i < P;
      gp.x[i] = ok ? __ldg(lrow + 2 * (p0 + i)) : -8.f;
      gp.y[i] = ok ? __ldg(lrow + 2 * (p0 + i) + 1) : -8.f;
      gp.a[i] = ok ? __ldg(arow + p0 + i) : 0.f;
    }
  }
  return gp;
}

// grid: ceil(items / (THREADS / LP)) blocks; item = (b * Q + q) * M + m
template <typename T, int LP, int CPL>
__global__ void __launch_bounds__(THREADS, 2)
msda_fwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, float* __restrict__ out, Levels lv,
                long long items, int S, int Q, int M, int P) {
  constexpr int D = LP * CPL;
  const long long item = static_cast<long long>(blockIdx.x) * (THREADS / LP) + threadIdx.x / LP;
  if (item >= items) return;
  const int lane = threadIdx.x % LP;
  const int m = static_cast<int>(item % M);
  const long long b = item / M / Q;
  const long long row = static_cast<long long>(M) * D;  // one pixel of value
  const T* vb = value + b * S * row + static_cast<long long>(m) * D + lane * CPL;
  float acc[CPL];
#pragma unroll
  for (int j = 0; j < CPL; ++j) acc[j] = 0.f;
  for (int l = 0; l < lv.n; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const T* vl = vb + static_cast<long long>(lv.start[l]) * row;
    const float* lrow = loc + (item * lv.n + l) * P * 2;
    const float* arow = attn + (item * lv.n + l) * P;
    for (int p0 = 0; p0 < P; p0 += GROUP) {
      const Group gp = load_group(lrow, arow, p0, P);
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const Corners c = corners(gp.x[i], gp.y[i], h, w);
        Row<T, CPL> v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k].load(vl + c.pix[k] * row);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float cw = c.in[k] ? gp.a[i] * (c.wy[k >> 1] * c.wx[k & 1]) : 0.f;
#pragma unroll
          for (int j = 0; j < CPL; ++j) acc[j] = fmaf(cw, v[k].at(j), acc[j]);
        }
      }
    }
  }
  float* op = out + item * D + lane * CPL;
#pragma unroll
  for (int j = 0; j < CPL; j += 4)
    store4(op + j, make_float4(acc[j], acc[j + 1], acc[j + 2], acc[j + 3]));
}

template <int LP>
__device__ __forceinline__ float group_sum(float v) {
#pragma unroll
  for (int o = LP / 2; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o, LP);
  return v;
}

// The window's counts cnt[0, n) (n at most WINDOW_PIXELS) scanned in place
// by the whole block into each pixel's list start, and the pixels that
// have a corner listed in order in nz; returns how many they are. One
// exclusive scan of count | (count > 0) << 16 gives both (a window lists
// at most 4 GROUP corners a query, under 2^16). The caller synchronises
// before and after.
__device__ __forceinline__ int window_scan(int* cnt, int n, int* nz, int* warp_sums) {
  constexpr int PER = WINDOW_PIXELS / BWD_THREADS;
  const int t = threadIdx.x, lane = t & 31, warp = t >> 5, base = t * PER;
  int v[PER], sum = 0;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int c = base + i < n ? cnt[base + i] : 0;
    v[i] = c | (c ? 1 << 16 : 0);
    sum += v[i];
  }
  int x = sum;  // inclusive scan over the warp
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_sums[warp] = x;
  __syncthreads();
  if (warp == 0) {
    int ws = lane < BWD_THREADS / 32 ? warp_sums[lane] : 0;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(0xffffffffu, ws, o);
      if (lane >= o) ws += y;
    }
    if (lane < BWD_THREADS / 32) warp_sums[lane] = ws;
  }
  __syncthreads();
  int run = x - sum + (warp ? warp_sums[warp - 1] : 0);
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    if (base + i < n) {
      cnt[base + i] = run & 0xffff;
      if (v[i]) nz[run >> 16] = base + i;
    }
    run += v[i];
  }
  return warp_sums[BWD_THREADS / 32 - 1] >> 16;
}

// K9b's blocks: one (b, m) and QT = BWD_THREADS / LP consecutive queries,
// LP lanes a query as the forward; the block's g rows wait in shared
// memory. Level by level the block takes the box of its in-bounds corners
// and their mean row. If P <= GROUP and the box's width fits the window
// (WINDOW_PIXELS), the window is a band of that width and as many rows as
// fit (the box's own rows if they fit, else a band centred on the mean
// row, within the box). The corners inside the band are counted per
// window pixel (shared-memory integer atomics), the counts scanned into
// list starts, and each corner listed under its pixel (its query and its
// coefficient attn * bilinear weight); then a thread a (pixel, 4
// channels) sums its pixel's corners' coefficient * g rows in registers
// and adds the sum into d(value) with one 16-byte vector reduction. Every
// other in-bounds row (outside the band, in a box too wide, or P > GROUP)
// goes straight into d(value) by 16-byte vector reductions, as each lane
// finds it. The dots for d(loc) and d(attn) are the forward's gathers.
// Every lane takes part in the shuffles and barriers: a query past the
// end computes on zeros and writes nothing. ops/msdeform.py ``bwd_plan``
// mirrors the plan.
template <typename T, int LP, int CPL>
__global__ void __launch_bounds__(BWD_THREADS, 1)
msda_bwd_kernel(const T* __restrict__ value, const float* __restrict__ loc,
                const float* __restrict__ attn, const float* __restrict__ g,
                float* __restrict__ dvalue, float* __restrict__ dloc,
                float* __restrict__ dattn, Levels lv, int S, int Q, int M, int P) {
  constexpr int D = LP * CPL, QT = BWD_THREADS / LP, LIST = QT * GROUP * 4;
  extern __shared__ float4 smem4[];
  float* gs = reinterpret_cast<float*>(smem4);        // [QT][D]: the block's g rows
  int* cnt = reinterpret_cast<int*>(gs + QT * D);     // [WINDOW_PIXELS]: counts, then starts
  int* nz = cnt + WINDOW_PIXELS;                      // [WINDOW_PIXELS]: pixels listed
  int* list_q = nz + WINDOW_PIXELS;                   // [LIST]: each listed corner's query
  float* list_w = reinterpret_cast<float*>(list_q + LIST);  // and its coefficient
  // min x, min y, -max x, -max y of the in-bounds corners; their count and
  // the sum of their rows
  __shared__ int box[6];
  __shared__ int warp_sums[BWD_THREADS / 32];
  const int tiles = (Q + QT - 1) / QT;
  const int tile = blockIdx.x % tiles, bm = blockIdx.x / tiles;
  const int m = bm % M, b = bm / M;
  const int ql = threadIdx.x / LP;  // the query within the block
  int q = tile * QT + ql;
  const bool live = q < Q;
  if (!live) q = Q - 1;  // read in bounds, write nothing
  const long long item = (static_cast<long long>(b) * Q + q) * M + m;
  const int lane = threadIdx.x % LP;
  const long long row = static_cast<long long>(M) * D;
  const long long bofs = static_cast<long long>(b) * S * row + static_cast<long long>(m) * D;
  float gg[CPL];
#pragma unroll
  for (int j = 0; j < CPL; j += 4) {
    const float4 v = live ? load4(g + item * D + lane * CPL + j) : make_float4(0.f, 0.f, 0.f, 0.f);
    gg[j] = v.x, gg[j + 1] = v.y, gg[j + 2] = v.z, gg[j + 3] = v.w;
    store4(gs + ql * D + lane * CPL + j, v);
  }
  for (int l = 0; l < lv.n; ++l) {
    const int h = lv.h[l], w = lv.w[l];
    const long long lofs = bofs + static_cast<long long>(lv.start[l]) * row;
    const float* lrow = loc + (item * lv.n + l) * P * 2;
    const float* arow = attn + (item * lv.n + l) * P;
    float* drow = dloc + (item * lv.n + l) * P * 2;
    float* darow = dattn + (item * lv.n + l) * P;
    // the block's box, count and row sum on this level (a query's lane 0)
    __syncthreads();  // the previous level's box, counts and lists are done with
    if (threadIdx.x < 6) box[threadIdx.x] = threadIdx.x < 4 ? INT_MAX : 0;
    __syncthreads();
    int bx[6] = {INT_MAX, INT_MAX, INT_MAX, INT_MAX, 0, 0};
    if (live && lane == 0) {
      for (int p0 = 0; p0 < P; p0 += GROUP) {
        const Group gp = load_group(lrow, arow, p0, P);
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          const Corners c = corners(gp.x[i], gp.y[i], h, w);
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            if (!c.in[k]) continue;
            bx[0] = min(bx[0], c.x[k]), bx[1] = min(bx[1], c.y[k]);
            bx[2] = min(bx[2], -c.x[k]), bx[3] = min(bx[3], -c.y[k]);
            bx[4] += 1, bx[5] += c.y[k];
          }
        }
      }
    }
#pragma unroll
    for (int k = 0; k < 6; ++k) {
      bx[k] = k < 4 ? __reduce_min_sync(0xffffffffu, bx[k]) : __reduce_add_sync(0xffffffffu, bx[k]);
      if (threadIdx.x % 32 != 0) continue;
      if (k < 4 && bx[k] != INT_MAX) atomicMin(&box[k], bx[k]);
      if (k >= 4 && bx[k] != 0) atomicAdd(&box[k], bx[k]);
    }
    __syncthreads();
    // the window: columns x_lo .. x_lo + bw - 1, rows y_lo .. y_lo + bh - 1
    const bool any = box[4] > 0;  // some corner of the block lies inside the map
    const int x_lo = box[0], bw = any ? -box[2] - x_lo + 1 : 0;
    const bool windowed = any && P <= GROUP && bw <= WINDOW_PIXELS;
    int y_lo = box[1], bh = 0;
    if (windowed) {
      const int rows = -box[3] - y_lo + 1;
      bh = min(rows, WINDOW_PIXELS / bw);
      if (bh < rows) {  // centred on the mean row: floor(mean - (bh - 1) / 2 + 1 / 2)
        const long long num = 2LL * box[5] + static_cast<long long>(box[4]) * (2 - bh);
        const long long mid = num / (2LL * box[4]);
        y_lo = static_cast<int>(min(max(mid, static_cast<long long>(y_lo)),
                                    static_cast<long long>(-box[3] - bh + 1)));
      }
    }
    const int npx = bw * bh;  // 0 unless windowed
    for (int i = threadIdx.x; i < npx; i += BWD_THREADS) cnt[i] = 0;
    __syncthreads();
    // the dots, d(loc), d(attn), the straight rows; the window's corners counted
    for (int p0 = 0; p0 < P; p0 += GROUP) {
      const Group gp = load_group(lrow, arow, p0, P);
      float da[GROUP], dx[GROUP], dy[GROUP];
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const Corners c = corners(gp.x[i], gp.y[i], h, w);
        Row<T, CPL> v[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) v[k].load(value + lofs + c.pix[k] * row + lane * CPL);
        float s[4];  // each corner's row . g over this lane's channels, 0 outside
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          float d = 0.f;
#pragma unroll
          for (int j = 0; j < CPL; ++j) d = fmaf(v[k].at(j), gg[j], d);
          s[k] = c.in[k] ? d : 0.f;
          if (!live || !c.in[k]) continue;
          if (windowed && c.y[k] >= y_lo && c.y[k] < y_lo + bh) {
            if (lane == 0) atomicAdd(cnt + (c.y[k] - y_lo) * bw + (c.x[k] - x_lo), 1);
          } else {
            const float cw = gp.a[i] * (c.wy[k >> 1] * c.wx[k & 1]);
            float4* dv = reinterpret_cast<float4*>(dvalue + lofs + c.pix[k] * row + lane * CPL);
#pragma unroll
            for (int j = 0; j < CPL; j += 4)
              atomicAdd(dv + j / 4, make_float4(cw * gg[j], cw * gg[j + 1], cw * gg[j + 2],
                                                cw * gg[j + 3]));
          }
        }
        const float *wy = c.wy, *wx = c.wx;
        da[i] = group_sum<LP>(wy[0] * (wx[0] * s[0] + wx[1] * s[1]) +
                              wy[1] * (wx[0] * s[2] + wx[1] * s[3]));
        const float dtx = group_sum<LP>(wy[0] * (s[1] - s[0]) + wy[1] * (s[3] - s[2]));
        const float dty = group_sum<LP>(wx[0] * (s[2] - s[0]) + wx[1] * (s[3] - s[1]));
        dx[i] = gp.a[i] * dtx * static_cast<float>(w);
        dy[i] = gp.a[i] * dty * static_cast<float>(h);
      }
      if (!live || lane != 0) continue;
      if (P % GROUP == 0) {
        store4(darow + p0, make_float4(da[0], da[1], da[2], da[3]));
        store4(drow + 2 * p0, make_float4(dx[0], dy[0], dx[1], dy[1]));
        store4(drow + 2 * p0 + 4, make_float4(dx[2], dy[2], dx[3], dy[3]));
      } else {
#pragma unroll
        for (int i = 0; i < GROUP; ++i) {
          if (p0 + i >= P) break;
          darow[p0 + i] = da[i];
          drow[2 * (p0 + i)] = dx[i];
          drow[2 * (p0 + i) + 1] = dy[i];
        }
      }
    }
    if (!windowed) continue;  // uniform over the block
    __syncthreads();
    const int listed = window_scan(cnt, npx, nz, warp_sums);
    __syncthreads();
    // each window corner listed under its pixel (P <= GROUP: one group)
    if (live && lane == 0) {
      const Group gp = load_group(lrow, arow, 0, P);
#pragma unroll
      for (int i = 0; i < GROUP; ++i) {
        const Corners c = corners(gp.x[i], gp.y[i], h, w);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          if (!c.in[k] || c.y[k] < y_lo || c.y[k] >= y_lo + bh) continue;
          const int e = atomicAdd(cnt + (c.y[k] - y_lo) * bw + (c.x[k] - x_lo), 1);
          list_q[e] = ql;
          list_w[e] = gp.a[i] * (c.wy[k >> 1] * c.wx[k & 1]);
        }
      }
    }
    __syncthreads();  // cnt[p] now ends pixel p's list (and so starts p + 1's)
    for (int i = threadIdx.x; i < listed * (D / 4); i += BWD_THREADS) {
      const int px = nz[i / (D / 4)], c4 = i % (D / 4);
      const int e0 = px ? cnt[px - 1] : 0, e1 = cnt[px];
      float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int e = e0; e < e1; ++e)
        fma4(acc, list_w[e], reinterpret_cast<const float4*>(gs + list_q[e] * D)[c4]);
      const long long pix = (y_lo + px / bw) * w + x_lo + px % bw;
      atomicAdd(reinterpret_cast<float4*>(dvalue + lofs + pix * row) + c4, acc);
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

// The lane map (LP lanes of CPL channels an item) the wrapper asks for,
// one of ops/msdeform.py LANES; any other, or LP * CPL != D, is refused
template <typename F>
cudaError_t dispatch(int D, int LP, int CPL, F&& f) {
  if (LP * CPL != D) return cudaErrorInvalidValue;
#define SFT_LANES(lp, cpl)  \
  if (LP == lp && CPL == cpl) \
    return f(std::integral_constant<int, lp>{}, std::integral_constant<int, cpl>{});
  SFT_LANES(1, 8)
  SFT_LANES(2, 8)
  SFT_LANES(4, 8)
  SFT_LANES(4, 16)
  SFT_LANES(4, 24)
  SFT_LANES(4, 32)
  SFT_LANES(8, 24)
  SFT_LANES(8, 32)
#undef SFT_LANES
  return cudaErrorInvalidValue;
}

}  // namespace

SFT_EXPORT int sft_ms_deform_attn_fwd(const void* value, const void* loc, const void* attn,
                                      void* out, const int* levels, int L, int B, int S, int Q,
                                      int M, int D, int P, int lanes, int cpl, int dtype,
                                      void* stream) {
  Levels lv;
  if (!read_levels(levels, L, lv) || B < 1 || Q < 1 || M < 1 || P < 1) return cudaErrorInvalidValue;
  const long long items = static_cast<long long>(B) * Q * M;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(D, lanes, cpl, [&](auto lp_c, auto cpl_c) -> cudaError_t {
    constexpr int LP = decltype(lp_c)::value, CPL = decltype(cpl_c)::value;
    const dim3 grid(static_cast<unsigned>((items + THREADS / LP - 1) / (THREADS / LP)));
    const auto* lf = static_cast<const float*>(loc);
    const auto* af = static_cast<const float*>(attn);
    auto* o = static_cast<float*>(out);
    if (dtype == SFT_BF16)
      msda_fwd_kernel<__nv_bfloat16, LP, CPL><<<grid, THREADS, 0, s>>>(
          static_cast<const __nv_bfloat16*>(value), lf, af, o, lv, items, S, Q, M, P);
    else
      msda_fwd_kernel<float, LP, CPL><<<grid, THREADS, 0, s>>>(
          static_cast<const float*>(value), lf, af, o, lv, items, S, Q, M, P);
    return cudaGetLastError();
  });
}

SFT_EXPORT int sft_ms_deform_attn_bwd(const void* value, const void* loc, const void* attn,
                                      const void* g, void* dvalue, void* dloc, void* dattn,
                                      const int* levels, int L, int B, int S, int Q, int M,
                                      int D, int P, int lanes, int cpl, int dtype, void* stream) {
  Levels lv;
  if (!read_levels(levels, L, lv) || B < 1 || Q < 1 || M < 1 || P < 1) return cudaErrorInvalidValue;
  auto s = static_cast<cudaStream_t>(stream);
  return dispatch(D, lanes, cpl, [&](auto lp_c, auto cpl_c) -> cudaError_t {
    constexpr int LP = decltype(lp_c)::value, CPL = decltype(cpl_c)::value;
    constexpr int QT = BWD_THREADS / LP, D_ = LP * CPL;
    const long long blocks = static_cast<long long>(B) * M * ((Q + QT - 1) / QT);
    if (blocks > INT_MAX) return cudaErrorInvalidValue;
    const auto* lf = static_cast<const float*>(loc);
    const auto* af = static_cast<const float*>(attn);
    const auto* gf = static_cast<const float*>(g);
    auto* dv = static_cast<float*>(dvalue);
    auto* dl = static_cast<float*>(dloc);
    auto* da = static_cast<float*>(dattn);
    // shared memory: the block's g rows, the window's counts and listed
    // pixels, its lists
    constexpr int BYTES = QT * D_ * 4 + WINDOW_PIXELS * 8 + QT * GROUP * 4 * 8;
    static_assert(BYTES <= 227 * 1024, "K9b's shared memory");
    auto launch = [&](auto kern, const auto* v) -> cudaError_t {
      cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                             BYTES);
      if (err != cudaSuccess) return err;
      kern<<<static_cast<unsigned>(blocks), BWD_THREADS, BYTES, s>>>(
          v, lf, af, gf, dv, dl, da, lv, S, Q, M, P);
      return cudaGetLastError();
    };
    if (dtype == SFT_BF16)
      return launch(msda_bwd_kernel<__nv_bfloat16, LP, CPL>,
                    static_cast<const __nv_bfloat16*>(value));
    return launch(msda_bwd_kernel<float, LP, CPL>, static_cast<const float*>(value));
  });
}
