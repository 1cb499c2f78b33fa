// K7f / K7b: cross-entropy and dice on the bilinear upsample of low-resolution
// logits lo (B, hl, wl, C) to the labels' (B, H, W), without the
// full-resolution logits ever existing. labels are int32; `ignore` marks
// void pixels; a label outside [0, C) that is not `ignore` is valid with an
// all-zero one-hot row (as jax.nn.one_hot gives).
//
// Replaces the TPU kernels segmentation_factory_tpu/ops/pallas_loss.py
// `_forward` (:261, body `_fwd_kernel` :120, pallas_call :270) and
// `_backward` (:292, body `_bwd_kernel` :151, pallas_call :304), which
// upsample polyphase in VMEM for dyadic scales; `_backward` computes each
// fine pixel's softmax once, transposes the upsample by phase shifts and
// folds the tiles' halo rows in afterwards.
//
// K7f writes, per fine pixel, the CE loss lse - logit[label] (float32,
// (B, H, W)), and per image and class the dice partials inter = sum p*y,
// psum = sum p, ysum = sum y over valid pixels ((B, 3, C) float32). The OHEM
// keep-set and the scalars stay in the caller's glue, as in the JAX package.
// K7b regenerates each fine pixel's softmax and writes the low-resolution
// cotangent (B, hl, wl, C) float32 of
//   dhi_c = wmap * (p_c - y_c) + p_c * (q_c - sum_k q_k p_k),
//   q_c = valid * (dI_c * y_c + dP_c),
// where wmap (B, H, W) is the per-pixel CE weight (OHEM keep / weight sum)
// and dcoef (B, 2, C) holds dL/dI and dL/dP of the dice term; the caller
// multiplies by the scalar's cotangent.
//
// What bounds them on the H100: bytes (labels and wmap at full resolution,
// the logits at 1/s^2 of it: 36.7 MB for K7b on the main path, 0.011 ms),
// then the arithmetic: a softmax over C classes for each of the 2.1 M fine
// pixels, about 40 M exponentials (0.011 ms on the SFUs' 16 a clock an SM).
// Design:
// - K7f: bands x spans of fine pixels (as many as fill the card's
//   resident blocks in one wave: 396 blocks of 10-11 fine rows x 512 columns
//   on the main path), each fine pixel's logits sampled from shared memory
//   by lowres_rows.cuh's front end (a ring of source rows, one V row a fine
//   row; the logits equal the plain version's resize). Up to 32 classes a
//   thread owns 4 adjacent pixels of each fine row (labels in one 16-byte
//   load, losses in one store where W % 4 == 0), two at a time (two
//   independent chains), their classes in registers, an instance per
//   multiple of 4 classes: per pixel the logits, the max, one exponential a
//   class (ex2.approx), lse, the loss, p = e / se; the thread's inter, psum
//   and ysum per class stay in registers across the band (predicated adds
//   at the label's class, no atomics). Above 32 classes a warp takes its 32
//   pixels one at a time with its lanes over the classes (at most 8 a
//   lane), max and sum by shuffles. At the end of the band the block's
//   3 C sums go through shared memory, each row summed by one warp in a
//   fixed order, to its own slot of a (B, 3 C, blocks) buffer; a second
//   kernel sums each image's blocks in a fixed order. No atomics: the
//   partials are the same bits from run to run.
// - K7b: a block owns a tile of lo (16 x 16 on the main path; smaller where
//   C is large, ops/transpose_geometry.py `loss_bwd_geometry`) and stages
//   it with its ring of one in shared memory. It computes every fine pixel
//   whose taps touch the tile, once, one thread a pixel, `r` fine rows at a
//   time (neighbouring threads take neighbouring pixels, so the label and
//   wmap loads are coalesced): its logits, softmax and dhi into D, one class
//   at a time (any C up to 256; no per-thread arrays of classes). Then the
//   transpose, separable: each thread owns one or two (lo column, class)
//   pairs of the tile; for each fine row it gathers the pair's column
//   footprint from D with the column weights and adds it with the row's
//   weights into two rolling float32 rows, writing a row of dlo when the
//   fine rows have passed it. Only the tile's own rows and columns are
//   kept: a fine pixel whose taps straddle two tiles is computed by each of
//   them (the ring), so no atomics and no fold pass; every dlo element is
//   written once.
//   At s = 4 a 16 x 16 tile computes 68 x 68 fine pixels for its 64 x 64:
//   (68 / 64)^2 = 1.13 softmaxes a fine pixel (`recompute`), not 4. Taps
//   and weights come from tables of the plain version's taps.
#include <algorithm>

#include "lowres_rows.cuh"

namespace {

using lowres::Layout;
using lowres::PIXELS;
using lowres::lerp_rn;

constexpr int FWD_THREADS = 128;  // the most threads a K7f block (transpose_geometry LOWF_THREADS)
constexpr int LANE_CLASSES = 32;  // above: a warp a pixel, lanes over the classes
constexpr int SLOTS = 8;          // classes a lane then, at most (256 classes)
constexpr float L2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// The block's slot in the (B, 3 C, blocks) partials: blocks of an image in
// (band, span) order
__device__ __forceinline__ float* block_partials(float* partial, const Layout& g, int C) {
  const int nblk = g.spans * g.bands;
  return partial + (long long)blockIdx.z * 3 * C * nblk + blockIdx.y * g.spans + blockIdx.x;
}

// K7f up to 32 classes, CM >= C a multiple of 4. grid (spans, bands, B),
// g.threads threads; a thread owns fine pixels X0 + PIXELS t + j of each
// fine row of the band.
template <typename T, int CM>
__global__ void __launch_bounds__(FWD_THREADS, CM > 24 ? 2 : 3)
loss_fwd_kernel(const T* __restrict__ lo, const int* __restrict__ lab, float* __restrict__ loss,
                float* __restrict__ partial, const int* __restrict__ tab, Layout g, int hl,
                int wl, int C, int H, int W, int ignore) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  lowres::Front<T> f;
  f.init(lo, smem, tab, g, hl, wl, C);
  const int t = threadIdx.x;
  const int X0 = blockIdx.x * g.cols + PIXELS * t;
  // each pixel's column taps: V offsets of its two source columns, weights
  int o0[PIXELS], o1[PIXELS];
  float ca[PIXELS], cb[PIXELS];
  bool here[PIXELS];
#pragma unroll
  for (int j = 0; j < PIXELS; ++j) {
    here[j] = X0 + j < W;
    const int4 q = here[j] ? lowres::ldg4(tab + g.cols_tab + 4 * (X0 + j)) : make_int4(0, 0, 0, 0);
    o0[j] = here[j] ? (q.x - f.xa) * f.cs : 0;
    o1[j] = here[j] ? (q.y - f.xa) * f.cs : 0;
    ca[j] = __int_as_float(q.z);
    cb[j] = __int_as_float(q.w);
  }
  const bool vec = (W & 3) == 0;
  const long long img = (long long)blockIdx.z * H * W;
  float psum[CM], inter[CM], ysum[CM];
#pragma unroll
  for (int c = 0; c < CM; ++c) psum[c] = inter[c] = ysum[c] = 0.f;
  int labs[PIXELS];

  auto before = [&](int Y) {  // the row's labels, in flight across the barrier
    const int* lr = lab + img + (long long)Y * W + X0;
    if (vec && here[0]) {
      const int4 l4 = __ldcs(reinterpret_cast<const int4*>(lr));
      labs[0] = l4.x; labs[1] = l4.y; labs[2] = l4.z; labs[3] = l4.w;
    } else {
#pragma unroll
      for (int j = 0; j < PIXELS; ++j) labs[j] = here[j] ? __ldcs(lr + j) : ignore;  // void past W
    }
  };
  float out[PIXELS];
  // pixels ja and ja + 1 together (two independent chains), their classes
  // in registers: logits, max, one exponential a class, lse, the loss, and
  // p into the per-class sums
  auto pair = [&](int ja, const float* V) {
    const int jb = ja + 1;
    const float* a0 = V + o0[ja];
    const float* a1 = V + o1[ja];
    const float* b0 = V + o0[jb];
    const float* b1 = V + o1[jb];
    float ea[CM], eb[CM];
    float ma = -INFINITY, mb = -INFINITY;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        ea[c] = lerp_rn(a0[c], ca[ja], a1[c], cb[ja]);
        eb[c] = lerp_rn(b0[c], ca[jb], b1[c], cb[jb]);
        ma = fmaxf(ma, ea[c]);
        mb = fmaxf(mb, eb[c]);
      }
    }
    const float na = -ma * L2E, nb = -mb * L2E;
    float sa = 0.f, sb = 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        ea[c] = ex2(fmaf(ea[c], L2E, na));
        eb[c] = ex2(fmaf(eb[c], L2E, nb));
        sa += ea[c];
        sb += eb[c];
      }
    }
    const bool va = labs[ja] != ignore, vb = labs[jb] != ignore;
    const int la = va && labs[ja] >= 0 && labs[ja] < C ? labs[ja] : -1;
    const int lb = vb && labs[jb] >= 0 && labs[jb] < C ? labs[jb] : -1;
    // the label's logit, from V as the class loop sampled it
    out[ja] = ma + __logf(sa) - (la >= 0 ? lerp_rn(a0[la], ca[ja], a1[la], cb[ja]) : 0.f);
    out[jb] = mb + __logf(sb) - (lb >= 0 ? lerp_rn(b0[lb], ca[jb], b1[lb], cb[jb]) : 0.f);
    const float ia = va ? __frcp_rn(sa) : 0.f, ib = vb ? __frcp_rn(sb) : 0.f;
#pragma unroll
    for (int c = 0; c < CM; ++c) {
      if (c < C) {
        const float pa = ea[c] * ia, pb = eb[c] * ib;
        psum[c] += pa;
        psum[c] += pb;
        if (c == la) {
          inter[c] += pa;
          ysum[c] += 1.f;
        }
        if (c == lb) {
          inter[c] += pb;
          ysum[c] += 1.f;
        }
      }
    }
  };
  auto pixels = [&](int Y, const float* V) {
    pair(0, V);
    pair(2, V);
    float* lr = loss + img + (long long)Y * W + X0;
    if (vec && here[0]) {
      *reinterpret_cast<float4*>(lr) = make_float4(out[0], out[1], out[2], out[3]);
    } else {
#pragma unroll
      for (int j = 0; j < PIXELS; ++j)
        if (here[j]) lr[j] = out[j];
    }
  };
  lowres::walk(f, tab, g, before, pixels);

  __syncthreads();  // the ring and V rows are free: they take each thread's sums
  const int nthr = blockDim.x;
#pragma unroll
  for (int c = 0; c < CM; ++c) {
    if (c < C) {
      smem[c * nthr + t] = inter[c];
      smem[(C + c) * nthr + t] = psum[c];
      smem[(2 * C + c) * nthr + t] = ysum[c];
    }
  }
  __syncthreads();
  lowres::block_rows(smem, nthr, 3 * C, block_partials(partial, g, C), g.spans * g.bands);
}

// K7f above 32 classes: warp w takes the fine pixels X0 + 32 w + j of each
// fine row, one at a time, lane l its classes l + 32 k; the span's column
// taps wait in shared memory after the ring and V rows.
template <typename T>
__global__ void __launch_bounds__(FWD_THREADS)
loss_fwd_lanes_kernel(const T* __restrict__ lo, const int* __restrict__ lab,
                      float* __restrict__ loss, float* __restrict__ partial,
                      const int* __restrict__ tab, Layout g, int hl, int wl, int C, int H, int W,
                      int ignore) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* smem = reinterpret_cast<float*>(smem_raw);
  lowres::Front<T> f;
  f.init(lo, smem, tab, g, hl, wl, C);
  const int t = threadIdx.x, lane = t & 31, w = t >> 5, nw = blockDim.x >> 5;
  const int Xs = blockIdx.x * g.cols;
  int4* colt = reinterpret_cast<int4*>(smem_raw + lowres::front_bytes(g));
  for (int x = t; x < g.cols; x += blockDim.x) {  // visible after the walk's first barrier
    const int4 q =
        Xs + x < W ? lowres::ldg4(tab + g.cols_tab + 4 * (Xs + x)) : make_int4(0, 0, 0, 0);
    colt[x] = make_int4((q.x - f.xa) * f.cs, (q.y - f.xa) * f.cs, q.z, q.w);
  }
  const int Xw = Xs + 32 * w, np = min(32, W - Xw);  // the warp's pixels (none where np <= 0)
  const long long img = (long long)blockIdx.z * H * W;
  float psum[SLOTS], inter[SLOTS], ysum[SLOTS];
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) psum[k] = inter[k] = ysum[k] = 0.f;
  int mylab = ignore;

  auto before = [&](int Y) {
    mylab = lane < np ? __ldcs(lab + img + (long long)Y * W + Xw + lane) : ignore;
  };
  auto pixels = [&](int Y, const float* V) {
    float myloss = 0.f;
    for (int j = 0; j < np; ++j) {
      const int4 q = colt[32 * w + j];
      const float* p0 = V + q.x;
      const float* p1 = V + q.y;
      const float a = __int_as_float(q.z), b = __int_as_float(q.w);
      const int lb = __shfl_sync(0xffffffffu, mylab, j);
      float v[SLOTS];
      float m = -INFINITY;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {  // slots no lane's class reaches are skipped
        v[k] = 0.f;
        if (32 * k < C) {
          const int c = lane + 32 * k;
          v[k] = c < C ? lerp_rn(p0[c], a, p1[c], b) : -INFINITY;
          m = fmaxf(m, v[k]);
        }
      }
      m = warp_max(m);
      const float nm = -m * L2E;
      float se = 0.f;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        if (32 * k < C) {
          v[k] = lane + 32 * k < C ? ex2(fmaf(v[k], L2E, nm)) : 0.f;
          se += v[k];
        }
      }
      se = warp_sum(se);
      const bool valid = lb != ignore;
      const int lc = valid && lb >= 0 && lb < C ? lb : -1;
      const float vl = lc >= 0 ? lerp_rn(p0[lc], a, p1[lc], b) : 0.f;
      if (lane == j) myloss = m + __logf(se) - vl;
      const float inv = valid ? __frcp_rn(se) : 0.f;
#pragma unroll
      for (int k = 0; k < SLOTS; ++k) {
        const int c = lane + 32 * k;
        if (c < C) {
          const float p = v[k] * inv;
          psum[k] += p;
          if (c == lc) {
            inter[k] += p;
            ysum[k] += 1.f;
          }
        }
      }
    }
    if (lane < np) loss[img + (long long)Y * W + Xw + lane] = myloss;
  };
  lowres::walk(f, tab, g, before, pixels);

  __syncthreads();  // the ring is free: it takes each warp's sums
#pragma unroll
  for (int k = 0; k < SLOTS; ++k) {
    const int c = lane + 32 * k;
    if (c < C) {
      smem[c * nw + w] = inter[k];
      smem[(C + c) * nw + w] = psum[k];
      smem[(2 * C + c) * nw + w] = ysum[k];
    }
  }
  __syncthreads();
  lowres::block_rows(smem, nw, 3 * C, block_partials(partial, g, C), g.spans * g.bands);
}

// K7f's second launch: parts[r] = the sum of partial[r][0 : nblk] in a
// fixed order, one warp a row (each lane a strided share, then the warp's tree)
__global__ void __launch_bounds__(128)
loss_fwd_finish_kernel(const float* __restrict__ partial, float* __restrict__ parts, int rows,
                       int nblk) {
  const int row = (blockIdx.x * blockDim.x + threadIdx.x) >> 5, lane = threadIdx.x & 31;
  if (row >= rows) return;
  float v = 0.f;
  for (int k = lane; k < nblk; k += 32) v += partial[(long long)row * nblk + k];
  v = warp_sum(v);
  if (lane == 0) parts[row] = v;
}

// bytes of K7f's shared memory (transpose_geometry.lowres_fwd_smem)
int fwd_smem(const Layout& g, int C) {
  const int front = lowres::front_bytes(g);
  if (C > LANE_CLASSES) return std::max(front + 16 * g.threads, 3 * C * (g.threads / 32) * 4);
  return std::max(front, 3 * C * g.threads * 4);
}

template <typename T>
using FwdKernel = void (*)(const T*, const int*, float*, float*, const int*, Layout, int, int,
                           int, int, int, int);

// K7f's instance for C classes (up to 32: a multiple of 4 at least C) and
// its dynamic shared memory limit so far
template <typename T>
FwdKernel<T> fwd_kernel(int C, int*& allowed) {
  static int limits[9] = {48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024,
                          48 * 1024, 48 * 1024, 48 * 1024, 48 * 1024};
  const int i = C > LANE_CLASSES ? 0 : (C + 3) / 4;
  allowed = limits + i;
  switch (i) {
    case 1: return loss_fwd_kernel<T, 4>;
    case 2: return loss_fwd_kernel<T, 8>;
    case 3: return loss_fwd_kernel<T, 12>;
    case 4: return loss_fwd_kernel<T, 16>;
    case 5: return loss_fwd_kernel<T, 20>;
    case 6: return loss_fwd_kernel<T, 24>;
    case 7: return loss_fwd_kernel<T, 28>;
    case 8: return loss_fwd_kernel<T, 32>;
    default: return loss_fwd_lanes_kernel<T>;
  }
}

template <typename T>
cudaError_t launch_fwd(const Layout& g, int B, cudaStream_t st, const void* lo, const int* lab,
                       float* loss, float* partial, const int* tab, int hl, int wl, int C, int H,
                       int W, int ignore) {
  int* allowed;
  const FwdKernel<T> kern = fwd_kernel<T>(C, allowed);
  const cudaError_t err = lowres::allow_smem(kern, g.smem, *allowed);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)g.spans, (unsigned)g.bands, (unsigned)B);
  kern<<<grid, g.threads, g.smem, st>>>(static_cast<const T*>(lo), lab, loss, partial, tab, g, hl,
                                          wl, C, H, W, ignore);
  return cudaGetLastError();
}

// K7b. grid (ceil(wl / tx), ceil(hl / ty), B), `threads` a block, `smem`
// bytes of shared memory (ops/transpose_geometry.py LossBwdGeometry)
struct LossGeo {
  int rows, cols;            // word offsets of each fine row's, column's taps (i0, i1, f, 0)
  int tile_rows, tile_cols;  // of each tile row's, column's region (first, last fine index)
  int foot, wts;             // of each lo column's footprint (Xlo, n, off, 0), its weights
  int ty, tx;                // the tile of lo a block owns
  int r;                     // fine rows a chunk
  int region_w;              // the widest region, in fine columns
  int dstride;               // floats between two classes in D (odd)
};

constexpr int PAIRS = 2;  // (lo column, class) pairs of the tile a thread owns at most

constexpr int MAX_THREADS_BWD = 1024;  // a cap of 64 registers: three blocks an SM

template <typename T>
__global__ void __launch_bounds__(MAX_THREADS_BWD)
loss_bwd_kernel(const T* __restrict__ lo, const int* __restrict__ lab,
                const float* __restrict__ wmap, const float* __restrict__ dcoef,
                float* __restrict__ dlo, const int* __restrict__ tab, LossGeo p, int hl, int wl,
                int C, int H, int W, int ignore) {
  extern __shared__ __align__(16) unsigned char smem[];
  const float* tabf = reinterpret_cast<const float*>(tab);
  const int b = blockIdx.z, tid = threadIdx.x, nthr = blockDim.x;
  const int ty0 = blockIdx.y * p.ty, tx0 = blockIdx.x * p.tx;
  const int tya = min(p.ty, hl - ty0), txa = min(p.tx, wl - tx0);
  // the fine pixels whose taps touch the tile, and the lo rows / columns
  // they tap: the tile and its ring of one, clamped to the image
  const int2 ry = *reinterpret_cast<const int2*>(tab + p.tile_rows + 2 * blockIdx.y);
  const int2 rx = *reinterpret_cast<const int2*>(tab + p.tile_cols + 2 * blockIdx.x);
  const int fw = rx.y - rx.x + 1;
  const int ly0 = max(ty0 - 1, 0), ly1 = min(ty0 + tya, hl - 1);
  const int lx0 = max(tx0 - 1, 0), lx1 = min(tx0 + txa, wl - 1);
  const int srow = (lx1 - lx0 + 1) * C;
  const int npair = txa * C;  // one lo row of the tile: (x, c) at x * C + c
  const int ds = p.dstride;

  T* los = reinterpret_cast<T*>(smem);  // [tile + ring rows][columns][C]
  float* D = reinterpret_cast<float*>(
      smem + (((size_t)(p.ty + 2) * (p.tx + 2) * C * sizeof(T) + 15) / 16) * 16);
  int* xo0 = reinterpret_cast<int*>(D + C * ds);  // D: [C][r x fw], each fine pixel's dhi
  int* xo1 = xo0 + p.region_w;                    // each region column's taps in los
  float* xf = reinterpret_cast<float*>(xo1 + p.region_w);
  int* flo = reinterpret_cast<int*>(xf + p.region_w);  // each tile column's footprint
  int* fn = flo + p.tx;
  int* foff = fn + p.tx;
  float* fwt = reinterpret_cast<float*>(foff + p.tx);
  float* di = fwt + 2 * (p.region_w + p.tx);  // dcoef's two rows
  float* dp = di + C;

  const T* lob = lo + (long)b * hl * wl * C;
  for (int i = tid; i < (ly1 - ly0 + 1) * srow; i += nthr) {
    const int yy = i / srow;
    los[i] = lob[((long)(ly0 + yy) * wl + lx0) * C + (i - yy * srow)];
  }
  for (int j = tid; j < fw; j += nthr) {
    const int4 ct = *reinterpret_cast<const int4*>(tab + p.cols + 4 * (rx.x + j));
    xo0[j] = (ct.x - lx0) * C;
    xo1[j] = (ct.y - lx0) * C;
    xf[j] = __int_as_float(ct.z);
  }
  const int4 f_first = *reinterpret_cast<const int4*>(tab + p.foot + 4 * tx0);
  const int4 f_last = *reinterpret_cast<const int4*>(tab + p.foot + 4 * (tx0 + txa - 1));
  for (int x = tid; x < txa; x += nthr) {
    const int4 f = *reinterpret_cast<const int4*>(tab + p.foot + 4 * (tx0 + x));
    flo[x] = f.x - rx.x;
    fn[x] = f.y;
    foff[x] = f.z - f_first.z;
  }
  for (int i = tid; i < f_last.z + f_last.y - f_first.z; i += nthr)
    fwt[i] = tabf[p.wts + f_first.z + i];
  for (int c = tid; c < 2 * C; c += nthr) di[c] = dcoef[(long)b * 2 * C + c];
  __syncthreads();

  // the pairs this thread owns, j = tid + u * nthr, and two rolling rows of
  // each: `open`, from the ring row above the tile down, and the next
  int pc[PAIRS], plo[PAIRS], pn[PAIRS], poff[PAIRS];
  float acc0[PAIRS], acc1[PAIRS];
#pragma unroll
  for (int u = 0; u < PAIRS; ++u) {
    const int j = tid + u * nthr, x = j < npair ? j / C : 0;
    pc[u] = j - x * C;
    plo[u] = flo[x];
    pn[u] = j < npair ? fn[x] : 0;
    poff[u] = foff[x];
    acc0[u] = acc1[u] = 0.f;
  }
  float* out = dlo + (((long)b * hl + ty0) * wl + tx0) * C + tid;
  const long out_row = (long)wl * C;
  int open = ty0 - 1;
  auto advance = [&]() {  // row `open` is complete: the tile's own rows go out
#pragma unroll
    for (int u = 0; u < PAIRS; ++u) {
      if (open >= ty0 && tid + u * nthr < npair) out[(open - ty0) * out_row + u * nthr] = acc0[u];
      acc0[u] = acc1[u];
      acc1[u] = 0.f;
    }
    ++open;
  };

  for (int yc = ry.x; yc <= ry.y; yc += p.r) {
    const int rr = min(p.r, ry.y - yc + 1);
    // 1. each fine pixel of the chunk once, one thread each: its logits
    //    sampled from the staged tile, softmax, and dhi into D
    for (int i = tid; i < rr * fw; i += nthr) {
      const int r = i / fw, j = i - r * fw;
      const int Y = yc + r;
      const int4 yt = __ldg(reinterpret_cast<const int4*>(tab + p.rows) + Y);
      const float fy = __int_as_float(yt.z), gy = 1.f - fy;
      const T* r0 = los + (yt.x - ly0) * srow;
      const T* r1 = los + (yt.y - ly0) * srow;
      const int a0 = xo0[j], a1 = xo1[j];
      const float fx = xf[j], gx = 1.f - fx;
      const long at = ((long)b * H + Y) * W + rx.x + j;
      const int label = lab[at];
      const float wce = wmap[at];
      float* d = D + i;
      float m = -INFINITY;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {  // rows first, then columns, as resize()
        const float v = gx * (gy * to_f32(r0[a0 + c]) + fy * to_f32(r1[a0 + c])) +
                        fx * (gy * to_f32(r0[a1 + c]) + fy * to_f32(r1[a1 + c]));
        d[c * ds] = v;
        m = fmaxf(m, v);
      }
      float se = 0.f, inner = 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float e = __expf(d[c * ds] - m);
        d[c * ds] = e;
        se += e;
        inner = fmaf(dp[c], e, inner);
      }
      // dhi_c = wmap (p_c - y_c) + p_c (q_c - sum_k q_k p_k), q_c = valid
      // (dI_c y_c + dP_c): p_c (A + valid dP_c) for every class, the label's
      // terms added after
      const bool valid = label != ignore;
      const bool onehot = valid && label >= 0 && label < C;
      const float inv = 1.f / se;
      const float pl = onehot ? d[label * ds] * inv : 0.f;
      const float qp = valid ? fmaf(inner, inv, onehot ? di[label] * pl : 0.f) : 0.f;
      const float A = wce - qp, qs = valid ? 1.f : 0.f;
#pragma unroll 4
      for (int c = 0; c < C; ++c) d[c * ds] = d[c * ds] * inv * fmaf(qs, dp[c], A);
      if (onehot) d[label * ds] += pl * di[label] - wce;
    }
    __syncthreads();
    // 2. the transpose, separable: each owned (lo column, class) gathers its
    //    column footprint's dhi with the column weights, a fine row at a
    //    time, and adds it with the row's weights into its rolling rows;
    //    the ring's rows belong to the neighbouring tiles, which compute
    //    these fine pixels themselves
    for (int r = 0; r < rr; ++r) {
      const int4 yt = __ldg(reinterpret_cast<const int4*>(tab + p.rows) + yc + r);
      const float f = __int_as_float(yt.z);
      const bool same = yt.y == yt.x;
      const float wa = same ? (1.f - f) + f : 1.f - f, wb = same ? 0.f : f;
      while (yt.x > open) advance();
#pragma unroll
      for (int u = 0; u < PAIRS; ++u) {
        const float* src = D + pc[u] * ds + r * fw + plo[u];
        const float* w = fwt + poff[u];
        float v = 0.f;
#pragma unroll 4
        for (int k = 0; k < pn[u]; ++k) v = fmaf(w[k], src[k], v);
        acc0[u] = fmaf(wa, v, acc0[u]);
        acc1[u] = fmaf(wb, v, acc1[u]);
      }
    }
    __syncthreads();  // D is rewritten by the next chunk
  }
  while (open < ty0 + tya) advance();
}

template <typename T>
cudaError_t launch_bwd(const void* lo, const int* lab, const float* wmap, const float* dcoef,
                       float* dlo, const int* tab, const LossGeo& geo, int threads, int smem,
                       int B, int hl, int wl, int C, int H, int W, int ignore,
                       cudaStream_t stream) {
  auto kern = loss_bwd_kernel<T>;
  static int allowed = 48 * 1024;  // the instance's dynamic shared memory limit so far
  if (smem > allowed) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    allowed = smem;
  }
  const dim3 grid((unsigned)((wl + geo.tx - 1) / geo.tx), (unsigned)((hl + geo.ty - 1) / geo.ty),
                  (unsigned)B);
  kern<<<grid, threads, smem, stream>>>(static_cast<const T*>(lo), lab, wmap, dcoef, dlo, tab,
                                        geo, hl, wl, C, H, W, ignore);
  return cudaGetLastError();
}

bool bad_shape(int B, int hl, int wl, int C, int H, int W) {
  return B < 1 || hl < 1 || wl < 1 || C < 1 || H < 1 || W < 1 || 3 * C * 4 > 48 * 1024;
}

}  // namespace

// K7f's first launch. loss: (B, H, W) float32 out; partial: (B, 3 C, blocks)
// float32 out, blocks = spans x bands of an image; tab: the geometry table on
// the device; layout: K7f's thirteen ints (lowres_rows.cuh Layout: the
// table's offsets, cols, spans, bands, wmax, cstride, ring, pairs, threads,
// smem).
SFT_EXPORT int sft_lowres_loss_fwd(const void* lo, const void* labels, void* loss, void* partial,
                                   const void* tab, const int* layout, int B, int hl, int wl,
                                   int C, int H, int W, int ignore, int dtype, void* stream) {
  const Layout g = lowres::layout_of(layout);
  if (C > LANE_CLASSES * SLOTS ||
      lowres::bad_layout(g, hl, wl, C, H, W, B, C > LANE_CLASSES ? 1 : PIXELS, FWD_THREADS) ||
      g.smem != fwd_smem(g, C))
    return cudaErrorInvalidValue;  // the host's layout disagrees
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const int* t = static_cast<const int*>(tab);
  float* l = static_cast<float*>(loss);
  float* p = static_cast<float*>(partial);
  if (dtype == SFT_F32)
    return launch_fwd<float>(g, B, st, lo, lab, l, p, t, hl, wl, C, H, W, ignore);
  if (dtype == SFT_BF16)
    return launch_fwd<__nv_bfloat16>(g, B, st, lo, lab, l, p, t, hl, wl, C, H, W, ignore);
  return cudaErrorInvalidValue;
}

// *slots = K7f's blocks for C classes of `threads` and `smem` bytes resident
// on the current card at once (the geometry's bands fill them in one wave).
SFT_EXPORT int sft_lowres_loss_fwd_slots(int C, int dtype, int threads, int smem, int* slots) {
  int* allowed;
  if (dtype == SFT_F32) {
    const FwdKernel<float> kern = fwd_kernel<float>(C, allowed);
    return lowres::resident_blocks(kern, threads, smem, *allowed, slots);
  }
  if (dtype == SFT_BF16) {
    const FwdKernel<__nv_bfloat16> kern = fwd_kernel<__nv_bfloat16>(C, allowed);
    return lowres::resident_blocks(kern, threads, smem, *allowed, slots);
  }
  return cudaErrorInvalidValue;
}

// K7f's second launch: parts (rows floats, rows = B x 3 C) = partial
// (rows, nblk) summed over its blocks.
SFT_EXPORT int sft_lowres_loss_fwd_finish(const void* partial, void* parts, int rows, int nblk,
                                          void* stream) {
  if (rows < 1 || nblk < 1) return cudaErrorInvalidValue;
  loss_fwd_finish_kernel<<<(rows + 3) / 4, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), static_cast<float*>(parts), rows, nblk);
  return cudaGetLastError();
}

// wmap: (B, H, W) float32; dcoef: (B, 2, C) float32; dlo: (B, hl, wl, C)
// float32 out; tab: the geometry table on the device; geo: its offsets and
// layout (rows, cols, tile_rows, tile_cols, foot, wts, ty, tx, r, region_w,
// dstride, threads, smem).
SFT_EXPORT int sft_lowres_loss_bwd(const void* lo, const void* labels, const void* wmap,
                                   const void* dcoef, void* dlo, const void* tab, const int* geo,
                                   int B, int hl, int wl, int C, int H, int W, int ignore,
                                   int dtype, void* stream) {
  if (bad_shape(B, hl, wl, C, H, W)) return cudaErrorInvalidValue;
  const LossGeo g{geo[0], geo[1], geo[2], geo[3], geo[4], geo[5], geo[6], geo[7], geo[8],
                  geo[9], geo[10]};
  const int threads = geo[11], smem = geo[12];
  if (threads < 32 || threads > MAX_THREADS_BWD || g.ty < 1 || g.tx < 1 || g.r < 1 || !(g.dstride & 1) ||
      g.dstride < g.r * g.region_w || g.tx * C > PAIRS * threads)
    return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lab = static_cast<const int*>(labels);
  const float* wm = static_cast<const float*>(wmap);
  const float* dc = static_cast<const float*>(dcoef);
  const int* t = static_cast<const int*>(tab);
  float* out = static_cast<float*>(dlo);
  if (dtype == SFT_F32)
    return launch_bwd<float>(lo, lab, wm, dc, out, t, g, threads, smem, B, hl, wl, C, H, W,
                             ignore, st);
  if (dtype == SFT_BF16)
    return launch_bwd<__nv_bfloat16>(lo, lab, wm, dc, out, t, g, threads, smem, B, hl, wl, C, H,
                                     W, ignore, st);
  return cudaErrorInvalidValue;
}
