// The front end that K7f (lowres_loss.cu) and K8 (resize_argmax.cu) share:
// lo (B, hl, wl, C), NHWC, sampled bilinearly at every fine pixel of
// (B, H, W) from shared memory, rows first, then columns, as the plain
// version's resize() (models/layers/common.py) computes it.
//
// A block owns a band of fine rows and a span of fine columns of one image
// (ops/transpose_geometry.py `lowres_fwd_geometry`: on the card as many
// near-equal bands as fill its resident blocks in one wave), so every
// fine pixel belongs to one block. Per fine row Y, with its taps (i0, i1, 1 - f, f)
// from the table:
// - Source rows arrive in a ring of source rows (3 slots where the rows are
//   upsampled 2x or more, 4 below, 6 where they are downsampled): each
//   row's span of source columns, every class,
//   float32 whatever lo's dtype, one column's C classes at `cstride` floats
//   (odd: lanes on neighbouring columns read distinct banks; where C is odd
//   the span's NHWC elements keep their order). float32 rows come by 4-byte
//   cp.async, each row once a band, asked for two fine rows before the
//   first one that samples it (rows i0 and i1 of row Y + 2, where they are
//   new); bf16 rows are loaded and converted. Rows take ring slots in the
//   order they are asked for, so a fine row's two rows are the last two
//   asked for when its turn to ask comes, at any ratio.
// - V, the vertical interpolation of the span's columns at a fine row, is
//   computed once a fine row into one of two V rows (float4 at a time: the
//   padded layout is flat), a fine row ahead of its pixels, so a fine
//   pixel's logit of class c is V[x0][c] (1 - fx) + V[x1][c] fx, two shared
//   loads.
// - Each product and sum is rounded as the plain version's passes round it
//   (__fmul_rn / __fadd_rn, no FMA contraction), with the plain version's
//   own weights from the table: the sampled logits equal the plain
//   version's in float32, for float32 and bf16 lo alike.
// One barrier a fine row: Y + 1's rows have landed (cp.async groups: one a
// fine row, each wait leaves the last one in flight), Y's V row is complete
// and every thread is done with Y - 1's.
#pragma once

#include "common.cuh"

namespace lowres {

// source rows a block holds: rows of Y (still read by a slow thread's V
// row), Y + 1 and Y + 2: at most 3 where two fine rows advance a source row
// at most by one (2 hl <= H), 4 where one does (hl <= H), else 6
constexpr int RING_UP2 = 3;
constexpr int RING = 4;
constexpr int RING_DOWN = 6;

__host__ __device__ inline int ring_rows_for(int hl, int H) {
  return 2 * hl <= H ? RING_UP2 : hl <= H ? RING : RING_DOWN;
}
constexpr int PIXELS = 4;  // adjacent fine pixels a thread a fine row (K8; K7f up to 32 classes)

// ops/transpose_geometry.py LowresFwdGeometry with one kernel's
// LowresFwdLayout, as the wrapper passes it (thirteen ints)
struct Layout {
  int rows_tab, cols_tab;    // word offsets of the fine rows' and columns' taps (i0, i1, 1 - f, f)
  int bands_tab, spans_tab;  // ... of each band's (Y0, Y1, first, last source row), each
                             // span's (first, last source column)
  int cols, spans, bands;    // fine columns a span, spans a fine row, bands an image
  int wmax, cstride;  // most source columns a span stages; floats between two columns
  int ring;           // ring_rows_for(hl, H)
  int pairs;          // fine columns 2k and 2k + 1 sample the same two source columns
  int threads, smem;
};

inline Layout layout_of(const int* a) {
  return Layout{a[0], a[1], a[2], a[3], a[4], a[5], a[6], a[7], a[8], a[9], a[10], a[11], a[12]};
}

// what the kernels cannot take from the host's layout (pixels: a thread's)
inline bool bad_layout(const Layout& g, int hl, int wl, int C, int H, int W, int B, int pixels,
                       int most_threads) {
  return B < 1 || hl < 1 || wl < 1 || C < 1 || H < 1 || W < 1 || g.threads < 32 ||
         g.threads > most_threads || g.threads % 32 || g.cols != g.threads * pixels ||
         g.spans != (W + g.cols - 1) / g.cols || g.bands < 1 || g.bands > H || g.wmax < 1 ||
         !(g.cstride & 1) || g.cstride < C || g.ring != ring_rows_for(hl, H) ||
         (g.pairs != 0 && g.pairs != 1) || (long long)B * hl * wl * C >= (1LL << 31);
}

// `kern` may take `smem` bytes of dynamic shared memory (`allowed`: what
// it was allowed so far)
template <typename K>
cudaError_t allow_smem(K kern, int smem, int& allowed) {
  if (smem <= allowed) return cudaSuccess;
  const cudaError_t err =
      cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) allowed = smem;
  return err;
}

// blocks of `kern` (`threads`, `smem`) resident on the current card at once
template <typename K>
cudaError_t resident_blocks(K kern, int threads, int smem, int& allowed, int* out) {
  cudaError_t err = allow_smem(kern, smem, allowed);
  int per_sm = 0, dev = 0, sms = 0;
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, threads, smem);
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  *out = per_sm * sms;
  return err;
}

// floats of one ring slot or V row, a multiple of 4 (V is built float4 at a time)
__host__ __device__ inline int slot_floats(const Layout& g) {
  return (g.wmax * g.cstride + 3) & ~3;
}
// bytes of the ring and the two V rows
__host__ __device__ inline int front_bytes(const Layout& g) {
  return (g.ring + 2) * slot_floats(g) * 4;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the one committed last has landed
__device__ __forceinline__ void cp_async_wait_all_but_last() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// x0 * a + x1 * b, each product and the sum rounded (the plain version's passes)
__device__ __forceinline__ float lerp_rn(float x0, float a, float x1, float b) {
  return __fadd_rn(__fmul_rn(x0, a), __fmul_rn(x1, b));
}

__device__ __forceinline__ int4 ldg4(const int* p) {
  return __ldg(reinterpret_cast<const int4*>(p));
}

// One block's band x span: its ring, its V rows and the rows asked for.
// Every thread of the block takes part in fetch and vrow.
template <typename T>
struct Front {
  const T* img;  // this image's lo
  float* ring;    // ring_rows slots, then the two V rows
  int ring_rows;  // ring_rows_for(hl, H)
  int slot;       // floats a slot
  int wl, C, cs;
  int xa, n;     // the span's first source column, its source columns
  int Y0, Y1;    // the band's fine rows [Y0, Y1)
  int next;             // the slot the next row asked for takes (in turn)
  int s_last, s_prev;   // the slots of the last row asked for and of the one before
  int last;             // the last source row asked for
  int sx, sc, dx, dc;  // this thread's first staged element (column, class), its step

  __device__ void init(const T* lo, float* smem, const int* tab, const Layout& g, int hl,
                       int wl_, int C_) {
    const int b = blockIdx.z, span = blockIdx.x, band = blockIdx.y;
    wl = wl_;
    C = C_;
    cs = g.cstride;
    slot = slot_floats(g);
    ring_rows = g.ring;
    img = lo + (long long)b * hl * wl * C;
    ring = smem;
    const int2 sp = __ldg(reinterpret_cast<const int2*>(tab + g.spans_tab) + span);
    xa = sp.x;
    n = sp.y - sp.x + 1;
    const int2 bd = __ldg(reinterpret_cast<const int2*>(tab + g.bands_tab) + 2 * band);
    Y0 = bd.x;
    Y1 = bd.y;
    next = s_last = s_prev = 0;
    last = -1;
    sx = threadIdx.x / C;
    sc = threadIdx.x - sx * C;
    dx = blockDim.x / C;
    dc = blockDim.x - dx * C;
  }

  // element e of the span's row (NHWC) to shared memory
  __device__ __forceinline__ void stage(float* dst, const T* src) {
    if constexpr (sizeof(T) == 4) {
      cp_async4(dst, reinterpret_cast<const float*>(src));
    } else {
      *dst = to_f32(*src);
    }
  }

  // source row r into the next ring slot: element (x, c) of the span, at
  // x * C + c in lo, to x * cs + c (the same place where C is odd)
  __device__ void fetch(int r) {
    float* dst = ring + next * slot;
    const T* src = img + ((long long)r * wl + xa) * C;
    if (cs == C) {
      for (int e = threadIdx.x; e < n * C; e += blockDim.x) stage(dst + e, src + e);
    } else {
      for (int x = sx, c = sc; x < n;) {
        stage(dst + x * cs + c, src + x * C + c);
        c += dc;
        x += dx;
        if (c >= C) {
          c -= C;
          ++x;
        }
      }
    }
    s_prev = s_last;
    s_last = next;
    next = next + 1 == ring_rows ? 0 : next + 1;
    last = r;
  }

  // rows i0 and i1 of a fine row that are not in the ring yet; the ring
  // slots of its two rows, the last two asked for (one where i0 == i1)
  __device__ int2 ask(int4 tap) {
    if (tap.x > last) fetch(tap.x);
    if (tap.y > last) fetch(tap.y);
    return make_int2(tap.y != tap.x ? s_prev : s_last, s_last);
  }

  __device__ float* vbuf(int buf) { return ring + (ring_rows + buf) * slot; }

  // V row `buf` of the fine row whose taps are `tap` and rows in `sl`
  __device__ void vrow(int4 tap, int2 sl, int buf) {
    const float4* r0 = reinterpret_cast<const float4*>(ring + sl.x * slot);
    const float4* r1 = reinterpret_cast<const float4*>(ring + sl.y * slot);
    float4* v4 = reinterpret_cast<float4*>(vbuf(buf));
    const float a = __int_as_float(tap.z), b = __int_as_float(tap.w);
    for (int i = threadIdx.x; i < (n * cs + 3) >> 2; i += blockDim.x) {
      const float4 x0 = r0[i], x1 = r1[i];
      v4[i] = make_float4(lerp_rn(x0.x, a, x1.x, b), lerp_rn(x0.y, a, x1.y, b),
                          lerp_rn(x0.z, a, x1.z, b), lerp_rn(x0.w, a, x1.w, b));
    }
  }
};

// Walk the block's band: for each fine row Y, `before(Y)` (the row's
// global loads), one barrier, then Y + 1's V row and `pixels(Y, V)` of Y's
// V row, built a fine row before. Rows are asked for two fine rows ahead:
// cp.async groups, one a fine row (two before the first), each wait leaving
// the last one in flight, so Y + 1's rows have landed at Y's barrier.
template <typename T, typename Before, typename Pixels>
__device__ __forceinline__ void walk(Front<T>& f, const int* tab, const Layout& g,
                                     Before&& before, Pixels&& pixels) {
  const int4* rows = reinterpret_cast<const int4*>(tab + g.rows_tab);
  const int4 tap1 = __ldg(rows + f.Y0);
  const int2 sl1 = f.ask(tap1);
  cp_async_commit();
  int4 tap2 = tap1;
  int2 sl2 = sl1;
  if (f.Y0 + 1 < f.Y1) {
    tap2 = __ldg(rows + f.Y0 + 1);
    sl2 = f.ask(tap2);
  }
  cp_async_commit();
  cp_async_wait_all_but_last();
  __syncthreads();  // the band's first rows have landed
  f.vrow(tap1, sl1, f.Y0 & 1);
  for (int Y = f.Y0; Y < f.Y1; ++Y) {
    // tap2 / sl2: row Y + 1's taps and ring slots; Y + 2's rows asked for now
    int4 tap3 = tap2;
    int2 sl3 = sl2;
    if (Y + 2 < f.Y1) {
      tap3 = __ldg(rows + Y + 2);
      sl3 = f.ask(tap3);
    }
    cp_async_commit();
    before(Y);
    cp_async_wait_all_but_last();
    __syncthreads();  // Y + 1's rows have landed, Y's V row is complete, Y - 1's pixels are done
    if (Y + 1 < f.Y1) f.vrow(tap2, sl2, (Y + 1) & 1);
    pixels(Y, f.vbuf(Y & 1));
    tap2 = tap3;
    sl2 = sl3;
  }
}

// Per-block sums of `nrows` rows of K floats each (S[r * K + k]), summed in a
// fixed order (each lane a strided share of a row, then the warp's tree),
// row r to out[r * stride]
__device__ __forceinline__ void block_rows(const float* S, int K, int nrows, float* out,
                                           long long stride) {
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, nw = blockDim.x >> 5;
  for (int r = w; r < nrows; r += nw) {
    float v = 0.f;
    for (int k = lane; k < K; k += 32) v += S[r * K + k];
    v = warp_sum(v);
    if (lane == 0) out[r * stride] = v;
  }
}

}  // namespace lowres
