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
// What bounds them on the H100: bytes (labels and wmap at full resolution,
// the logits at 1/s^2 of it: 36.7 MB for K7b on the main path, 0.011 ms),
// then the arithmetic: a softmax and dhi over C classes for each of the
// 2.1 M fine pixels (about 40 M exponentials). Design:
// - K7f: one thread per fine pixel computes its 2x2 taps once and walks the
//   C channels three times (max, sum of exp, then p for the dice sums),
//   reading the 4 tap rows from L1/L2; the dice partials are warp-reduced,
//   then block-reduced in shared memory and added to the global buffer with
//   one atomicAdd per block and value. A block never straddles two images.
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

template <typename T>
cudaError_t launch_fwd(const void* lo, const int* lab, float* loss, float* parts, int B, int hl,
                       int wl, int C, int H, int W, int ignore, cudaStream_t stream) {
  const dim3 grid((unsigned)(((long)H * W + THREADS - 1) / THREADS), B);
  loss_fwd_kernel<T><<<grid, THREADS, 3 * C * sizeof(float), stream>>>(
      static_cast<const T*>(lo), lab, loss, parts, hl, wl, C, H, W, ignore);
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
