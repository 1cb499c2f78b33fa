// K5f: out = sum over levels of the bilinear upsample of each level to the
// largest level's (H, W); levels NHWC (B, h_l, w_l, E) of one dtype, the
// full-size levels first. Accumulates in float32, writes the input dtype.
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_resize_sum.py
// `_forward` (:109, body `_kernel` :85), a polyphase upsample of dyadic
// pyramids in VMEM behind shape gates.
//
// What bounds it on the H100: bytes. At the main path's shape (bf16, B = 2,
// E = 768, a 256^2 full-size level over 128^2, 64^2 and 32^2) it reads 201
// MB of the full-size level and 66 MB of the smaller ones and writes 201
// MB: 0.140 ms at 3.35 TB/s; a few float32 operations an element. Design,
// separable as the plain version (rows first, then columns):
// - A block owns a band of fine rows (`rows`), a span of fine columns
//   (`cols`) and a slab of channels of one image (ops/transpose_geometry.py
//   `sum_fwd_geometry`: 32 rows x 64 columns x 64 channels on the main path).
//   A thread owns VEC channels of a pixel: 8 (16-byte bf16 loads and
//   stores) where E allows it, else 4. Indices are 32-bit inside an image;
//   no division after the set-up.
// - Every tap comes from tables of the plain version's taps (i0, i1, 1 - f,
//   f), built once per shape on the host and copied to the device once.
// - Per smaller level the block holds a ring of RING source rows in shared
//   memory: the two that the current fine row samples and the next two,
//   asked for by cp.async when the band's rows pass a source row, so each
//   source row is read once a band and lands a fine row before it is read.
//   The first full-size level comes the same way, into a ring of FRING
//   rows, each asked for two fine rows before its own (held a row ahead in
//   registers instead it measured 0.21 ms bare of the smaller levels, too
//   few bytes in flight). Per fine row, each level's sampled columns are
//   interpolated vertically once, in float32, into a row of shared memory
//   (two rows, alternating, so one barrier a fine row suffices); each
//   output pixel then takes its two horizontal taps per level from it,
//   adds them to the full-size levels and is stored once (streamed out).
// - The smaller levels' reads are their source rows and columns of each
//   band and span: a halo row and column per level, 1.22 times their size
//   on the main path (`read_factor`), the repeats served by L2.
// Every product and sum is rounded as the plain version's separate
// elementwise passes round it (no FMA contraction): x[i0] * (1 - f) +
// x[i1] * f per axis, then the sum, full-size levels first, then the
// smaller levels in the given order; so float32 results are the plain
// version's, and bf16 is rounded once at the end.
#include "common.cuh"

namespace {

constexpr int MAX_LEVELS = 8;
constexpr int THREADS = 256;
constexpr int ITEMS = 2;  // fine pixels a thread a fine row (one channel group each)
constexpr int RING = 4;   // source rows of a level held: the two sampled and two ahead
constexpr int FRING = 3;  // rows of the first full-size level held: this one and two ahead

struct Level {
  const void* src;
  int h, w;
  int rows, cols, spans;  // word offsets of its row taps, column taps and spans in the table
  int wmax;               // the most source columns a span samples
  int ring, v;            // byte offsets of its ring and its two V rows in shared memory
};

struct Geo {
  const void* full[MAX_LEVELS];  // the full-size levels, summed first, in order
  int nfull, nl;
  Level lv[MAX_LEVELS];
  int gshift;  // channel groups a block: 1 << gshift
  int cols, rows, spans;
  int colt;  // byte offset of the span's column taps in shared memory
  int fring;  // byte offset of the first full-size level's rows in shared memory
};

// VEC channels of T as stored: WORDS 32-bit words
template <typename T, int VEC>
__host__ __device__ constexpr int words() { return VEC * (int)sizeof(T) / 4; }

template <typename T, int VEC>
__device__ __forceinline__ void widen(float (&f)[VEC], const uint32_t (&u)[words<T, VEC>()]) {
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < VEC / 2; ++i) {
      f[2 * i] = __uint_as_float(u[i] << 16);
      f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
    }
  } else {
#pragma unroll
    for (int i = 0; i < VEC; ++i) f[i] = __uint_as_float(u[i]);
  }
}

// the words at p (8-byte aligned for two words, else 16): streamed from
// device memory (read once), or from shared memory
template <int WORDS>
__device__ __forceinline__ void load_stream(uint32_t (&u)[WORDS], const void* p) {
  if constexpr (WORDS == 2) {
    const uint2 v = __ldcs(reinterpret_cast<const uint2*>(p));
    u[0] = v.x; u[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      const uint4 v = __ldcs(reinterpret_cast<const uint4*>(p) + i);
      u[4 * i] = v.x; u[4 * i + 1] = v.y; u[4 * i + 2] = v.z; u[4 * i + 3] = v.w;
    }
  }
}
template <int WORDS>
__device__ __forceinline__ void load_shared(uint32_t (&u)[WORDS], const unsigned char* p) {
  if constexpr (WORDS == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    u[0] = v.x; u[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      u[4 * i] = v.x; u[4 * i + 1] = v.y; u[4 * i + 2] = v.z; u[4 * i + 3] = v.w;
    }
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void store_stream(T* p, const float (&f)[VEC]) {
  constexpr int WORDS = words<T, VEC>();
  uint32_t u[WORDS];
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) u[i] = pack_bf16(f[2 * i], f[2 * i + 1]);
  } else {
#pragma unroll
    for (int i = 0; i < WORDS; ++i) u[i] = __float_as_uint(f[i]);
  }
  if constexpr (WORDS == 2) {
    __stcs(reinterpret_cast<uint2*>(p), make_uint2(u[0], u[1]));
  } else {
#pragma unroll
    for (int i = 0; i < WORDS / 4; ++i)
      __stcs(reinterpret_cast<uint4*>(p) + i,
             make_uint4(u[4 * i], u[4 * i + 1], u[4 * i + 2], u[4 * i + 3]));
  }
}

// BYTES (8, 16 or 32) from global src to shared dst, asynchronously
template <int BYTES>
__device__ __forceinline__ void cp_async(unsigned char* dst, const void* src) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (BYTES == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src) : "memory");
  } else {
#pragma unroll
    for (int o = 0; o < BYTES; o += 16)
      asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d + o),
                   "l"(static_cast<const unsigned char*>(src) + o)
                   : "memory");
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// every group but the N committed last has landed
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// x0 * a + x1 * b, each product and the sum rounded (the plain version's passes)
__device__ __forceinline__ float lerp_rn(float x0, float a, float x1, float b) {
  return __fadd_rn(__fmul_rn(x0, a), __fmul_rn(x1, b));
}

// grid (E / (VEC << gshift), spans * bands, B); NL >= the smaller levels' count
template <typename T, int VEC, int NL>
__global__ void __launch_bounds__(THREADS, 2)
resize_sum_kernel(Geo p, const int* __restrict__ tab, T* __restrict__ out, int H, int W, int E) {
  constexpr int WORDS = words<T, VEC>();
  constexpr int BYTES = VEC * (int)sizeof(T);
  extern __shared__ __align__(16) unsigned char smem[];
  const int t = threadIdx.x, gshift = p.gshift, G = 1 << gshift, CS = G * VEC;
  const int span = blockIdx.y % p.spans, band = blockIdx.y / p.spans, b = blockIdx.z;
  const int c0 = blockIdx.x * CS, X0 = span * p.cols, ncols = min(p.cols, W - X0);
  const int Y0 = band * p.rows, Y1 = min(Y0 + p.rows, H);
  const long long img = (long long)b * H * W * E;  // the image in the output and the full-size levels
  const int rowE = W * E;

  // per level: the span's first source column, the V items (source column,
  // channel group) of the levels before it, the source row the band is at
  // and the last one it samples
  int xa[NL], first[NL + 1], k[NL], kmax[NL];
  int4 tap[NL];
  int4* colt = reinterpret_cast<int4*>(smem + p.colt);
  first[0] = 0;
#pragma unroll
  for (int l = 0; l < NL; ++l) {
    first[l + 1] = first[l];
    xa[l] = k[l] = kmax[l] = 0;
    tap[l] = make_int4(0, 0, 0, 0);
    if (l >= p.nl) continue;
    const Level& L = p.lv[l];
    const int2 sp = __ldg(reinterpret_cast<const int2*>(tab + L.spans) + span);
    xa[l] = sp.x;
    first[l + 1] += sp.y << gshift;
    k[l] = __ldg(tab + L.rows + 4 * Y0);
    kmax[l] = __ldg(tab + L.rows + 4 * (Y1 - 1) + 1);
    for (int x = t; x < ncols; x += THREADS) {
      const int4 q = __ldg(reinterpret_cast<const int4*>(tab + L.cols) + X0 + x);
      colt[l * p.cols + x] = make_int4(q.x - sp.x, q.y - sp.x, q.z, q.w);
    }
  }
  // source row `row` of level l into its ring slot, every channel group of
  // the span's source columns
  auto fetch_row = [&](int l, int row) {
    const Level& L = p.lv[l];
    const T* src = static_cast<const T*>(L.src) +
                   ((long long)(b * L.h + row) * L.w + xa[l]) * E + c0;
    unsigned char* dst = smem + L.ring + (row & (RING - 1)) * L.wmax * CS * (int)sizeof(T);
    for (int i = t; i < first[l + 1] - first[l]; i += THREADS) {
      const int col = i >> gshift, g = i & (G - 1);
      cp_async<BYTES>(dst + (col * CS + g * VEC) * (int)sizeof(T), src + col * E + g * VEC);
    }
  };
  // fine row Y of the first full-size level into its ring slot `slot`,
  // the span's pixels and the slab's channels
  const T* full0 = static_cast<const T*>(p.full[0]) + img + X0 * E + c0;
  auto fetch_full_row = [&](int Y, int slot) {
    unsigned char* dst = smem + p.fring + slot * p.cols * CS * (int)sizeof(T);
    for (int i = t; i < ncols << gshift; i += THREADS) {
      const int x = i >> gshift, g = i & (G - 1);
      cp_async<BYTES>(dst + (x * CS + g * VEC) * (int)sizeof(T), full0 + Y * rowE + x * E + g * VEC);
    }
  };
  // the rows the band's first fine row samples and its full-size row, then
  // the next two source rows and the next full-size row
#pragma unroll
  for (int l = 0; l < NL; ++l)
    if (l < p.nl)
      for (int r = k[l]; r <= min(k[l] + 1, kmax[l]); ++r) fetch_row(l, r);
  fetch_full_row(Y0, 0);
  cp_async_commit();
#pragma unroll
  for (int l = 0; l < NL; ++l)
    if (l < p.nl)
      for (int r = k[l] + 2; r <= min(k[l] + 3, kmax[l]); ++r) fetch_row(l, r);
  if (Y0 + 1 < Y1) fetch_full_row(Y0 + 1, 1);
  cp_async_commit();
  cp_async_commit();  // empty: the place of the full-size row a row before the band would ask for

  // this thread's pixels: X0 + (i >> gshift), channels c0 + VEC (i & (G - 1))
  int pix[ITEMS];  // element offset in the image's row, -1 past the span
  int xs[ITEMS], gs[ITEMS];
#pragma unroll
  for (int j = 0; j < ITEMS; ++j) {
    const int i = t + THREADS * j;
    xs[j] = i >> gshift;
    gs[j] = i & (G - 1);
    pix[j] = xs[j] < ncols ? (X0 + xs[j]) * E + c0 + gs[j] * VEC : -1;
  }
  cp_async_wait<2>();
  __syncthreads();

  // Per fine row Y, cp.async groups are committed twice: the source rows
  // asked for at its start, then (after its barrier) full-size row Y + 2.
  // Its barrier waits for all but the last two groups: the source rows
  // asked for before row Y - 1 and full-size row Y + 1.
  int fslot = 0;  // the ring slot of full-size row Y
  for (int Y = Y0; Y < Y1; ++Y) {
    const int buf = (Y - Y0) & 1;
    // the fine row's taps; where the band passes a source row, the row two
    // ahead of the new pair into the ring slot the old first row held
#pragma unroll
    for (int l = 0; l < NL; ++l) {
      if (l >= p.nl) continue;
      tap[l] = __ldg(reinterpret_cast<const int4*>(tab + p.lv[l].rows) + Y);
      if (tap[l].x != k[l]) {
        k[l] = tap[l].x;
        if (k[l] + 3 <= kmax[l]) fetch_row(l, k[l] + 3);
      }
    }
    cp_async_commit();
    // V: each sampled source column of each level at this fine row, rows
    // interpolated in float32, into V row `buf` (float4 slot j4 * G + g of
    // a column, so a quarter warp's reads are 128 contiguous bytes)
    for (int it = t; it < first[NL]; it += THREADS) {
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (it < first[l] || it >= first[l + 1]) continue;
        const Level& L = p.lv[l];
        const int i = it - first[l], col = i >> gshift, g = i & (G - 1);
        const int slot = L.wmax * CS * (int)sizeof(T);
        const unsigned char* r = smem + L.ring + (col * CS + g * VEC) * (int)sizeof(T);
        uint32_t u0[WORDS], u1[WORDS];
        load_shared(u0, r + (tap[l].x & (RING - 1)) * slot);
        load_shared(u1, r + (tap[l].y & (RING - 1)) * slot);
        float x0[VEC], x1[VEC];
        widen<T, VEC>(x0, u0);
        widen<T, VEC>(x1, u1);
        const float a = __int_as_float(tap[l].z), bw = __int_as_float(tap[l].w);
        float4* v = reinterpret_cast<float4*>(smem + L.v + buf * L.wmax * CS * 4) + col * (CS / 4) + g;
#pragma unroll
        for (int j4 = 0; j4 < VEC / 4; ++j4)
          v[j4 * G] = make_float4(lerp_rn(x0[4 * j4], a, x1[4 * j4], bw),
                                  lerp_rn(x0[4 * j4 + 1], a, x1[4 * j4 + 1], bw),
                                  lerp_rn(x0[4 * j4 + 2], a, x1[4 * j4 + 2], bw),
                                  lerp_rn(x0[4 * j4 + 3], a, x1[4 * j4 + 3], bw));
      }
    }
    cp_async_wait<2>();
    __syncthreads();  // V rows complete; the rows asked for before the last fine row have landed
    const int fnext = fslot == FRING - 1 ? 0 : fslot + 1;
    if (Y + 2 < Y1) fetch_full_row(Y + 2, fnext == FRING - 1 ? 0 : fnext + 1);
    cp_async_commit();
    const unsigned char* frow = smem + p.fring + fslot * p.cols * CS * (int)sizeof(T);
    // each pixel: the full-size levels, then each level's two columns
#pragma unroll
    for (int j = 0; j < ITEMS; ++j) {
      if (pix[j] < 0) continue;
      const int at = Y * rowE + pix[j];
      float acc[VEC];
      {
        uint32_t u[WORDS];
        load_shared(u, frow + (xs[j] * CS + gs[j] * VEC) * (int)sizeof(T));
        widen<T, VEC>(acc, u);
      }
#pragma unroll
      for (int f = 1; f < MAX_LEVELS; ++f) {
        if (f >= p.nfull) break;
        uint32_t u[WORDS];
        load_stream(u, static_cast<const T*>(p.full[f]) + img + at);
        float x[VEC];
        widen<T, VEC>(x, u);
#pragma unroll
        for (int q = 0; q < VEC; ++q) acc[q] = __fadd_rn(acc[q], x[q]);
      }
#pragma unroll
      for (int l = 0; l < NL; ++l) {
        if (l >= p.nl) continue;
        const Level& L = p.lv[l];
        const int4 ct = colt[l * p.cols + xs[j]];
        const float4* v = reinterpret_cast<const float4*>(smem + L.v + buf * L.wmax * CS * 4) + gs[j];
        const float a = __int_as_float(ct.z), bw = __int_as_float(ct.w);
#pragma unroll
        for (int j4 = 0; j4 < VEC / 4; ++j4) {
          const float4 v0 = v[ct.x * (CS / 4) + j4 * G], v1 = v[ct.y * (CS / 4) + j4 * G];
          float* o = acc + 4 * j4;
          o[0] = __fadd_rn(o[0], lerp_rn(v0.x, a, v1.x, bw));
          o[1] = __fadd_rn(o[1], lerp_rn(v0.y, a, v1.y, bw));
          o[2] = __fadd_rn(o[2], lerp_rn(v0.z, a, v1.z, bw));
          o[3] = __fadd_rn(o[3], lerp_rn(v0.w, a, v1.w, bw));
        }
      }
      store_stream<T, VEC>(out + img + at, acc);
    }
    fslot = fnext;
  }
}

template <typename T, int VEC, int NL>
cudaError_t launch(const Geo& geo, const int* tab, void* out, int B, int H, int W, int E,
                   int bands, size_t smem, cudaStream_t st) {
  auto kern = resize_sum_kernel<T, VEC, NL>;
  static size_t allowed = 48 * 1024;  // the instance's dynamic shared memory limit so far
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid((unsigned)(E / (VEC << geo.gshift)), (unsigned)(geo.spans * bands),
                  (unsigned)B);
  kern<<<grid, THREADS, smem, st>>>(geo, tab, static_cast<T*>(out), H, W, E);
  return cudaGetLastError();
}

template <typename T, int VEC>
cudaError_t dispatch(const Geo& geo, const int* tab, void* out, int B, int H, int W, int E,
                     int bands, size_t smem, cudaStream_t st) {
  if (geo.nl <= 3) return launch<T, VEC, 3>(geo, tab, out, B, H, W, E, bands, smem, st);
  return launch<T, VEC, MAX_LEVELS - 1>(geo, tab, out, B, H, W, E, bands, smem, st);
}

}  // namespace

// fulls: the nfull full-size levels (B, H, W, E); smalls, hs, ws: the nl
// smaller levels (B, h, w, E), summed in this order; tab: the geometry
// table on the device; offs: per smaller level its rows, cols and spans
// word offsets and wmax; layout: vec, groups' log2, cols, rows, spans,
// bands and the shared memory in bytes (ops/transpose_geometry.py
// SumFwdGeometry).
SFT_EXPORT int sft_resize_sum(const void* const* fulls, int nfull, const void* const* smalls,
                              const int* hs, const int* ws, int nl, const void* tab,
                              const int* offs, const int* layout, void* out, int B, int H, int W,
                              int E, int dtype, void* stream) {
  const int vec = layout[0], gshift = layout[1], cols = layout[2], rows = layout[3];
  const int spans = layout[4], bands = layout[5];
  if (nfull < 1 || nl < 0 || nfull + nl > MAX_LEVELS || (vec != 4 && vec != 8) || gshift < 0 ||
      gshift > 4 || E % (vec << gshift) || cols < 1 || (cols << gshift) > ITEMS * THREADS ||
      rows < 1 || spans != (W + cols - 1) / cols || bands != (H + rows - 1) / rows || B < 1 ||
      (long long)H * W * E >= (1LL << 31) || (dtype != SFT_F32 && dtype != SFT_BF16))
    return cudaErrorInvalidValue;
  const int elt = dtype == SFT_F32 ? 4 : 2, cs = vec << gshift;
  Geo geo;
  geo.nfull = nfull;
  geo.nl = nl;
  geo.gshift = gshift;
  geo.cols = cols;
  geo.rows = rows;
  geo.spans = spans;
  for (int i = 0; i < MAX_LEVELS; ++i) geo.full[i] = i < nfull ? fulls[i] : nullptr;
  size_t at = 0;
  for (int i = 0; i < nl; ++i) {
    Level& L = geo.lv[i];
    L.src = smalls[i];
    L.h = hs[i];
    L.w = ws[i];
    if (L.h > H) return cudaErrorInvalidValue;
    L.rows = offs[4 * i];
    L.cols = offs[4 * i + 1];
    L.spans = offs[4 * i + 2];
    L.wmax = offs[4 * i + 3];
    L.ring = (int)at;
    at += (size_t)RING * L.wmax * cs * elt;
    L.v = (int)at;
    at += (size_t)2 * L.wmax * cs * 4;
  }
  geo.colt = (int)at;
  at += (size_t)16 * cols * nl;
  geo.fring = (int)at;
  at += (size_t)FRING * cols * cs * elt;
  if (at != (size_t)layout[6]) return cudaErrorInvalidValue;  // the host's layout disagrees
  const int* t = static_cast<const int*>(tab);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32)
    return vec == 8 ? dispatch<float, 8>(geo, t, out, B, H, W, E, bands, at, st)
                    : dispatch<float, 4>(geo, t, out, B, H, W, E, bands, at, st);
  return vec == 8 ? dispatch<__nv_bfloat16, 8>(geo, t, out, B, H, W, E, bands, at, st)
                  : dispatch<__nv_bfloat16, 4>(geo, t, out, B, H, W, E, bands, at, st);
}
