// K6f / K6b: SegFormerHead's training tail in one pass over the fuse tensor
// s (N = B*H*W pixels, E channels, float32 or bf16):
//   xhat = (s - mu) * rsig,  y1 = round_T(xhat * gamma + beta),
//   y3 = relu(y1) * dmask[b]   (float32, not rounded),
//   logits = y3 W^T + bcls     (float32 (N, NC); W in the 1x1 conv's (NC, E)).
// mu / rsig come from the batch statistics (the `stats` kernel: per-channel
// float32 sums of s and s^2; the wrapper turns them into mean, the fast
// variance E[s^2] - E[s]^2 clipped at 0, and rsqrt(var + eps)).
//
// Replaces the TPU kernels segmentation_factory_tpu/ops/pallas_head_tail.py
// `_forward` (:161, body `_fwd_kernel` :71) and the two pallas_calls of
// `_bwd_rule` (:216): the reduction kernel (:231, body `_bwd_red_kernel`
// :91) that accumulates dW, db, dgamma and dbeta over the sequential grid,
// and the input-cotangent kernel (:254, body `_bwd_ds_kernel` :131)
//   ds = gamma * rsig * (dy1 - dbeta / N - xhat * dgamma / N),
//   dy1 = (dl W) * dmask[b] * (y1 > 0),
// cast to s's dtype. dgamma and dbeta are returned as raw sums.
//
// What bounds them on the H100: at the main shape (N = 131072, E = 768,
// NC = 19) the float32 products (FMAs, not TF32: the TPU kernel's product is
// float32), 2*N*E*NC flops forward and three times that backward, are
// about as long at the 67 TFLOP/s FP32 peak as reading s at 3.35 TB/s.
// Design:
// - stats: each thread sums 4 channels over a strided run of pixels in
//   registers; the block reduces its rows in shared memory and adds its
//   partial sums with one float32 atomic per value.
// - K6f: one block per 64-pixel tile walks E in chunks of 64 channels. Per
//   chunk it stages y3 (64 x 64) and the chunk's W rows (32*G x 64) in
//   shared memory; lane k of a warp owns class k (+32 g) and 8 pixels, so a
//   float4 of W feeds 32 FMAs and the y3 reads are warp broadcasts.
// - K6b: two passes (the input cotangent needs dgamma and dbeta summed over
//   every pixel; storing dy1 instead of recomputing dl W would write and
//   read 4 N E bytes), each of persistent blocks with register-tiled
//   products fed by double-buffered loads: see the K6b section below.
// y1 is computed with explicitly rounded float32 operations (no FMA
// contraction), as the plain version's separate elementwise passes, so the
// bf16 rounding of y1 and the ReLU mask taken on it agree with it exactly.
#include "common.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TP = 64;      // pixels per tile
constexpr int CC = 64;      // channels per chunk
constexpr int LD = CC + 4;  // K6f shared row stride (floats): 16-byte rows, conflict-free float4
constexpr int PP = TP / (THREADS / 32);  // K6f pixels per warp

struct Tail {
  const float* mu;
  const float* rsig;
  const float* gamma;
  const float* beta;
  const float* dmask;  // (B, E)
  const float* w;      // (NC, E)
  long long n;         // pixels
  int p_img;           // pixels per image
  int e, nc;
};

// ReLU that keeps a NaN, as jnp.maximum and torch.relu do (a non-finite
// input must reach the loss, or the train step's skip would not see it)
__device__ __forceinline__ float relu(float x) { return x > 0.f || x != x ? x : 0.f; }

// xhat, and y1 rounded to the storage type T, from a channel's parameters
template <typename T>
__device__ __forceinline__ float bn_y1v(float x, float mu, float rsig, float gamma, float beta,
                                        float& xhat) {
  xhat = __fmul_rn(__fsub_rn(x, mu), rsig);
  return to_f32(from_f32<T>(__fadd_rn(__fmul_rn(xhat, gamma), beta)));
}
// the same for channel c
template <typename T>
__device__ __forceinline__ float bn_y1(const Tail& a, float x, int c, float& xhat) {
  return bn_y1v<T>(x, a.mu[c], a.rsig[c], a.gamma[c], a.beta[c], xhat);
}

// per-channel sum and sum of squares; grid (ceil(E / CC), splits)
template <typename T>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ s, long long n, int e, float* __restrict__ sums) {
  __shared__ float4 red[2][THREADS];
  constexpr int Q = CC / 4;  // threads per pixel row
  const int q = threadIdx.x % Q, row = threadIdx.x / Q;
  const int c = blockIdx.x * CC + q * 4;
  float4 s1 = make_float4(0.f, 0.f, 0.f, 0.f), s2 = s1;
  if (c < e) {
    for (long long p = (long long)blockIdx.y * (THREADS / Q) + row; p < n;
         p += (long long)gridDim.y * (THREADS / Q)) {
      const float4 x = load4(s + p * e + c);
      s1.x += x.x; s1.y += x.y; s1.z += x.z; s1.w += x.w;
      s2.x = fmaf(x.x, x.x, s2.x); s2.y = fmaf(x.y, x.y, s2.y);
      s2.z = fmaf(x.z, x.z, s2.z); s2.w = fmaf(x.w, x.w, s2.w);
    }
  }
  red[0][threadIdx.x] = s1;
  red[1][threadIdx.x] = s2;
  __syncthreads();
  if (row == 0 && c < e) {
    for (int r = 1; r < THREADS / Q; ++r) {
      const float4 a = red[0][r * Q + q], b = red[1][r * Q + q];
      s1.x += a.x; s1.y += a.y; s1.z += a.z; s1.w += a.w;
      s2.x += b.x; s2.y += b.y; s2.z += b.z; s2.w += b.w;
    }
    atomicAdd(sums + c, s1.x); atomicAdd(sums + c + 1, s1.y);
    atomicAdd(sums + c + 2, s1.z); atomicAdd(sums + c + 3, s1.w);
    atomicAdd(sums + e + c, s2.x); atomicAdd(sums + e + c + 1, s2.y);
    atomicAdd(sums + e + c + 2, s2.z); atomicAdd(sums + e + c + 3, s2.w);
  }
}

// K6f; grid ceil(N / TP); shared (TP + 32 G) * LD floats; G class groups of 32
template <typename T, int G>
__global__ void __launch_bounds__(THREADS)
fwd_kernel(const T* __restrict__ s, Tail a, const float* __restrict__ bcls,
           float* __restrict__ logits) {
  extern __shared__ float4 smem4[];
  float* ys = reinterpret_cast<float*>(smem4);  // [TP][LD] y3
  float* ws = ys + TP * LD;                      // [32 G][LD] W rows
  const long long p0 = (long long)blockIdx.x * TP;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  float acc[G][PP];
#pragma unroll
  for (int g = 0; g < G; ++g)
#pragma unroll
    for (int i = 0; i < PP; ++i) acc[g][i] = 0.f;

  for (int c0 = 0; c0 < a.e; c0 += CC) {
    for (int i = threadIdx.x; i < TP * (CC / 4); i += THREADS) {
      const int p = i / (CC / 4), cq = (i % (CC / 4)) * 4, c = c0 + cq;
      const long long n = p0 + p;
      float4 y = make_float4(0.f, 0.f, 0.f, 0.f);
      if (n < a.n && c < a.e) {
        const float4 x = load4(s + n * a.e + c);
        const float* dm = a.dmask + (n / a.p_img) * a.e + c;
        float xh;
        y.x = relu(bn_y1<T>(a, x.x, c, xh)) * dm[0];
        y.y = relu(bn_y1<T>(a, x.y, c + 1, xh)) * dm[1];
        y.z = relu(bn_y1<T>(a, x.z, c + 2, xh)) * dm[2];
        y.w = relu(bn_y1<T>(a, x.w, c + 3, xh)) * dm[3];
      }
      *reinterpret_cast<float4*>(ys + p * LD + cq) = y;
    }
    for (int i = threadIdx.x; i < 32 * G * (CC / 4); i += THREADS) {
      const int k = i / (CC / 4), cq = (i % (CC / 4)) * 4, c = c0 + cq;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      if (k < a.nc && c < a.e) v = load4(a.w + (long long)k * a.e + c);
      *reinterpret_cast<float4*>(ws + k * LD + cq) = v;
    }
    __syncthreads();
#pragma unroll 2
    for (int c = 0; c < CC; c += 4) {
      float4 y[PP];
#pragma unroll
      for (int i = 0; i < PP; ++i)
        y[i] = *reinterpret_cast<const float4*>(ys + (warp * PP + i) * LD + c);
#pragma unroll
      for (int g = 0; g < G; ++g) {
        const float4 w = *reinterpret_cast<const float4*>(ws + (lane + 32 * g) * LD + c);
#pragma unroll
        for (int i = 0; i < PP; ++i) {
          float v = acc[g][i];
          v = fmaf(y[i].x, w.x, v);
          v = fmaf(y[i].y, w.y, v);
          v = fmaf(y[i].z, w.z, v);
          acc[g][i] = fmaf(y[i].w, w.w, v);
        }
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int k = lane + 32 * g;
    if (k >= a.nc) continue;
    const float b = bcls[k];
#pragma unroll
    for (int i = 0; i < PP; ++i) {
      const long long n = p0 + warp * PP + i;
      if (n < a.n) logits[n * a.nc + k] = acc[g][i] + b;
    }
  }
}

// ---------------------------------------------------------------- K6b
//
// Two passes, persistent blocks of 256 threads over (channel chunk of BCC,
// pixel split), two blocks an SM in bfloat16: a block keeps its chunk's W
// rows and its channels' BatchNorm parameters in shared memory across every
// 64-pixel tile it walks. Per tile, s comes in by cp.async (16 bytes a
// thread where rows allow it, else 8) one tile ahead, double-buffered, and
// the tile's dl slice (BTP pixels x KS classes, float32) is loaded into
// registers one tile ahead and stored transposed, dlT[class][pixel].
// Products on the CUDA cores in float32, register-tiled:
// - dy3 = dl W: a thread owns 4 pixels x 8 channels; per class one float4
//   of dlT and two of W (its 8 channels, the W tile's float4 slots permuted
//   so that the 16 channel groups of a warp read 16 adjacent slots) feed 32
//   FMAs. The reduction pass, which holds more live values, takes the
//   pixels as two halves of 2 (one float2 of dlT, 16 FMAs a class);
// - dW += y3^T dl (reduction pass): a thread owns 4 channels x KPT classes;
//   per 4 pixels four float4 of y3 (stored transposed, ysT[channel][pixel],
//   its float4 slots XOR-swizzled by the channel's group of 8 so that both
//   the writes and the reads are conflict-free) and KPT float4 of dlT feed
//   16 KPT FMAs.
// The reduction pass adds dgamma, dbeta (the block's partials reduced by a
// shuffle and shared memory), dW (per thread) and db (chunk 0's blocks: a
// warp per class row, lanes over pixels, a shuffle sum at the end) once per
// block with float32 atomics; grid.z splits the classes in slices of KS
// (one slice at NC <= 24), each slice's dy3 adding its share of dgamma and
// dbeta, which are linear in dl. The ds pass needs dy3 over every class
// before its one rounding: it walks the slices itself (the W slice restaged
// for each when there are several) and stores ds 16 bytes a thread where
// rows allow it.
constexpr int BTP = 64;       // pixels a tile
constexpr int BCC = 128;      // channels a block
constexpr int KS = 24;        // classes a slice
constexpr int KPT = KS / 8;   // dW: classes a thread (8 class groups, a warp each)
constexpr int TLD = BTP + 4;  // transposed tiles' rows, floats: conflict-free float4 columns
constexpr int DLR = KS * BTP / THREADS;  // dl values a thread loads a tile

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async8(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   static_cast<uint32_t>(__cvta_generic_to_shared(dst))),
               "l"(src), "r"(valid ? 8 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Tile (pixels p0.., channels c0..) of s into a dense [BTP][BCC] stage,
// zeros past N and E; v16: E * sizeof(T) is a multiple of 16
template <typename T>
__device__ __forceinline__ void load_s(uint8_t* stage, const T* __restrict__ s, long long p0,
                                       int c0, const Tail& a, bool v16) {
  const int unit = v16 ? 16 : 8, per_row = BCC * (int)sizeof(T) / unit;
  const int elems = unit / (int)sizeof(T);
  for (int u = threadIdx.x; u < BTP * per_row; u += THREADS) {
    const int p = u / per_row, cu = u % per_row, c = c0 + cu * elems;
    const bool valid = p0 + p < a.n && c < a.e;
    const T* src = valid ? s + (p0 + p) * a.e + c : s;
    uint8_t* dst = stage + (p * BCC) * (int)sizeof(T) + cu * unit;
    if (v16) cp_async16(dst, src, valid);
    else cp_async8(dst, src, valid);
  }
  cp_async_commit();
}

// this thread's DLR values of the tile's dl slice (classes k0 .. k0 + ks):
// value r is (pixel e / KS, class e % KS) for e = tid + THREADS r, 0 past N
__device__ __forceinline__ void load_dl(float (&v)[DLR], const float* __restrict__ dl,
                                        long long p0, int k0, int ks, const Tail& a) {
#pragma unroll
  for (int r = 0; r < DLR; ++r) {
    const int e = threadIdx.x + THREADS * r, p = e / KS, kk = e % KS;
    v[r] = p0 + p < a.n && kk < ks ? dl[(p0 + p) * a.nc + k0 + kk] : 0.f;
  }
}
__device__ __forceinline__ void store_dl(float* dlT, const float (&v)[DLR]) {
#pragma unroll
  for (int r = 0; r < DLR; ++r) {
    const int e = threadIdx.x + THREADS * r;
    dlT[(e % KS) * TLD + e / KS] = v[r];
  }
}

// The slot of channel group L (channels 4 L .. 4 L + 3 of the chunk) in a
// row of float4: channel group cg's two float4 (8 cg .. 8 cg + 7) at slots
// cg and 16 + cg
__device__ __forceinline__ int slot4(int L) { return (L & 1) * 16 + (L >> 1); }

// W rows k0 .. k0 + ks of the chunk into ws [KS][BCC / 4] (slot4)
__device__ __forceinline__ void load_w(float4* ws, int k0, int ks, int c0, const Tail& a) {
  for (int i = threadIdx.x; i < KS * (BCC / 4); i += THREADS) {
    const int k = i / (BCC / 4), L = i % (BCC / 4), c = c0 + 4 * L;
    ws[k * (BCC / 4) + slot4(L)] =
        k < ks && c < a.e ? *reinterpret_cast<const float4*>(a.w + (long long)(k0 + k) * a.e + c)
                          : make_float4(0.f, 0.f, 0.f, 0.f);
  }
}

// The chunk's per-channel parameters in shared memory, channel 8 cg + j at
// [j * 16 + cg] (a warp's 16 channel groups on adjacent entries):
// (mu, rsig, gamma, beta) and, for the ds pass, (dgm, dbm); 0 past E
__device__ __forceinline__ void load_prm(float4* prm, float2* prm2, int c0, const Tail& a,
                                         const float* dgm, const float* dbm) {
  for (int i = threadIdx.x; i < BCC; i += THREADS) {
    const int c = c0 + i, at = (i & 7) * 16 + (i >> 3);
    const bool in = c < a.e;
    prm[at] = in ? make_float4(a.mu[c], a.rsig[c], a.gamma[c], a.beta[c])
                 : make_float4(0.f, 0.f, 0.f, 0.f);
    if (prm2 != nullptr) prm2[at] = in ? make_float2(dgm[c], dbm[c]) : make_float2(0.f, 0.f);
  }
}

// dy3[i][j] += sum_k dlT[k][p + i] W[k][8 cg + j] over the slice's ks
// classes, for NP (2 or 4) pixels from p: per class one float2 or float4
// of dlT and two float4 of W feed 8 NP FMAs
template <int NP>
__device__ __forceinline__ void dy3_rows(float (&dy3)[NP][8], const float* dlT, const float4* ws,
                                         int ks, int p, int cg) {
#pragma unroll 4
  for (int k = 0; k < ks; ++k) {
    float dv[NP];
    if constexpr (NP == 4) {
      const float4 d = *reinterpret_cast<const float4*>(dlT + k * TLD + p);
      dv[0] = d.x; dv[1] = d.y; dv[2] = d.z; dv[3] = d.w;
    } else {
      const float2 d = *reinterpret_cast<const float2*>(dlT + k * TLD + p);
      dv[0] = d.x; dv[1] = d.y;
    }
    const float4 w0 = ws[k * (BCC / 4) + cg], w1 = ws[k * (BCC / 4) + 16 + cg];
    const float wv[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
#pragma unroll
    for (int i = 0; i < NP; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) dy3[i][j] = fmaf(dv[i], wv[j], dy3[i][j]);
  }
}

// the 8 channels (from c0 + 8 cg) of pixel p of a stage, as float32
template <typename T>
__device__ __forceinline__ void read_s(float (&x)[8], const uint8_t* stage, int p, int cg) {
  const T* row = reinterpret_cast<const T*>(stage) + p * BCC + 8 * cg;
  if constexpr (sizeof(T) == 4) {
    const float4* v = reinterpret_cast<const float4*>(row);
    const float4 a = v[0], b = v[1];
    x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
  } else {
    const uint4 v = *reinterpret_cast<const uint4*>(row);
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(u[j] << 16);
      x[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  }
}

// the dropout mask of pixel n's image at this thread's 8 channels from c
// (0 past E, and everywhere past N; N < 2^31, bad_shape)
__device__ __forceinline__ void load_dm(float (&dm)[8], long long n, int c, const Tail& a) {
  const bool in = n < a.n;
  const float* src = a.dmask + (in ? (unsigned)n / (unsigned)a.p_img : 0u) * a.e + c;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float4 q = in && c + 4 * h < a.e ? *reinterpret_cast<const float4*>(src + 4 * h)
                                           : make_float4(0.f, 0.f, 0.f, 0.f);
    dm[4 * h] = q.x; dm[4 * h + 1] = q.y; dm[4 * h + 2] = q.z; dm[4 * h + 3] = q.w;
  }
}

// K6b reduction; grid (ceil(E / BCC), splits, ceil(NC / KS))
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bwd_reduce_kernel(const T* __restrict__ s, Tail a, const float* __restrict__ dl,
                  float* __restrict__ dw, float* __restrict__ db, float* __restrict__ dgamma,
                  float* __restrict__ dbeta, bool v16) {
  extern __shared__ float4 smem4[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem4);      // 2 x [BTP][BCC] of T
  constexpr int STAGE = BTP * BCC * sizeof(T);
  float* dlT = reinterpret_cast<float*>(stages + 2 * STAGE);  // 2 x [KS][TLD]
  float* ysT = dlT + 2 * KS * TLD;                             // [BCC][TLD]
  float4* ws = reinterpret_cast<float4*>(ysT + BCC * TLD);     // [KS][BCC / 4]
  float4* prm = ws + KS * (BCC / 4);                           // [BCC]
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int pg = tid >> 4, cg = tid & 15;  // dy3 and the elementwise part
  const int cw = lane, kg = warp;          // dW
  const int c0 = blockIdx.x * BCC, k0 = blockIdx.z * KS, ks = min(KS, a.nc - k0);
  const bool first = blockIdx.x == 0;      // chunk 0 also sums db
  const long long tiles = (a.n + BTP - 1) / BTP;
  float dg[8] = {}, dbt[8] = {}, acc[4][KPT] = {}, dbp[KPT] = {}, dlv[DLR];
  load_w(ws, k0, ks, c0, a);
  load_prm(prm, nullptr, c0, a, nullptr, nullptr);

  long long t = blockIdx.y;
  if (t < tiles) {
    load_s(stages, s, t * BTP, c0, a, v16);
    load_dl(dlv, dl, t * BTP, k0, ks, a);
  }
  for (int it = 0; t < tiles; ++it, t += gridDim.y) {
    const long long p0 = t * BTP;
    const uint8_t* st = stages + (it & 1) * STAGE;
    float* dlt = dlT + (it & 1) * KS * TLD;
    cp_async_wait_all();
    store_dl(dlt, dlv);
    __syncthreads();  // s and dl of this tile in place; the last tile's readers done
    if (t + gridDim.y < tiles) {
      load_s(stages + ((it + 1) & 1) * STAGE, s, p0 + (long long)gridDim.y * BTP, c0, a, v16);
      load_dl(dlv, dl, p0 + (long long)gridDim.y * BTP, k0, ks, a);
    }
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {  // pixels 4 pg + 2 h, + 1
      float dy3[2][8] = {}, y3[8][2];
      dy3_rows<2>(dy3, dlt, ws, ks, 4 * pg + 2 * h, cg);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int p = 4 * pg + 2 * h + i;
        float x[8], dm[8];
        read_s<T>(x, st, p, cg);
        load_dm(dm, p0 + p, c0 + 8 * cg, a);
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float4 q = prm[j * 16 + cg];  // mu, rsig, gamma, beta
          float xh;
          const float y1 = bn_y1v<T>(x[j], q.x, q.y, q.z, q.w, xh);
          y3[j][i] = relu(y1) * dm[j];
          const float dy1 = y1 > 0.f ? dy3[i][j] * dm[j] : 0.f;
          dg[j] = fmaf(dy1, xh, dg[j]);
          dbt[j] += dy1;
        }
      }
#pragma unroll
      for (int j = 0; j < 8; ++j)  // channel 8 cg + j: its float4 slots XOR its group, cg
        *reinterpret_cast<float2*>(ysT + (8 * cg + j) * TLD + 4 * (pg ^ cg) + 2 * h) =
            make_float2(y3[j][0], y3[j][1]);
    }
    __syncthreads();  // ysT complete
    // dW[k][c] += sum_p y3[p][c] dl[p][k]: channels cw + 32 i, classes kg + 8 j
#pragma unroll 4
    for (int q = 0; q < BTP / 4; ++q) {
      float4 y[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int c = cw + 32 * i;
        y[i] = *reinterpret_cast<const float4*>(ysT + c * TLD + 4 * (q ^ (c >> 3)));
      }
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        if (kg + 8 * j >= ks) continue;  // uniform over the warp
        const float4 d = *reinterpret_cast<const float4*>(dlt + (kg + 8 * j) * TLD + 4 * q);
#pragma unroll
        for (int i = 0; i < 4; ++i)
          acc[i][j] = fmaf(y[i].w, d.w, fmaf(y[i].z, d.z, fmaf(y[i].y, d.y,
                                                                fmaf(y[i].x, d.x, acc[i][j]))));
      }
    }
    if (first)
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        if (kg + 8 * j < ks) {
          const float* row = dlt + (kg + 8 * j) * TLD;
          dbp[j] += row[lane] + row[lane + 32];
        }
  }

  // dW and db: once per block
#pragma unroll
  for (int j = 0; j < KPT; ++j) {
    const int k = kg + 8 * j;
    if (k >= ks) continue;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int c = c0 + cw + 32 * i;
      if (c < a.e) atomicAdd(dw + (long long)(k0 + k) * a.e + c, acc[i][j]);
    }
    if (first) {
      const float v = warp_sum(dbp[j]);
      if (lane == 0) atomicAdd(db + k0 + k, v);
    }
  }
  // dgamma, dbeta: lanes l and l ^ 16 share their channels, then the warps
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    dg[j] += __shfl_xor_sync(0xffffffffu, dg[j], 16);
    dbt[j] += __shfl_xor_sync(0xffffffffu, dbt[j], 16);
  }
  __syncthreads();  // ysT is free: it takes the warps' partials [2][8][BCC]
  if (lane < 16)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      ysT[warp * BCC + 8 * cg + j] = dg[j];
      ysT[(8 + warp) * BCC + 8 * cg + j] = dbt[j];
    }
  __syncthreads();
  const int c = tid % BCC, which = tid / BCC;  // threads 0..127 dgamma, 128..255 dbeta
  if (c0 + c < a.e) {
    float v = 0.f;
#pragma unroll
    for (int w = 0; w < 8; ++w) v += ysT[(8 * which + w) * BCC + c];
    atomicAdd((which ? dbeta : dgamma) + c0 + c, v);
  }
}

// ds of this thread's 8 channels at p (the first `left` of them inside E):
// 16-byte stores where rows allow them (v16), else 8-byte ones
template <typename T>
__device__ __forceinline__ void store_ds(T* p, const float (&o)[8], int left, bool v16) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (4 * h < left)
        *reinterpret_cast<float4*>(p + 4 * h) =
            make_float4(o[4 * h], o[4 * h + 1], o[4 * h + 2], o[4 * h + 3]);
  } else if (v16) {
    if (left >= 8)
      *reinterpret_cast<uint4*>(p) = make_uint4(pack_bf16(o[0], o[1]), pack_bf16(o[2], o[3]),
                                                pack_bf16(o[4], o[5]), pack_bf16(o[6], o[7]));
  } else {
#pragma unroll
    for (int h = 0; h < 2; ++h)
      if (4 * h < left)
        *reinterpret_cast<uint2*>(p + 4 * h) =
            make_uint2(pack_bf16(o[4 * h], o[4 * h + 1]), pack_bf16(o[4 * h + 2], o[4 * h + 3]));
  }
}

// K6b input cotangent; grid (ceil(E / BCC), splits); dgm = dgamma / N, dbm
// = dbeta / N
template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
bwd_ds_kernel(const T* __restrict__ s, Tail a, const float* __restrict__ dl,
              const float* __restrict__ dgm, const float* __restrict__ dbm, T* __restrict__ ds,
              bool v16) {
  extern __shared__ float4 smem4[];
  uint8_t* stages = reinterpret_cast<uint8_t*>(smem4);      // 2 x [BTP][BCC] of T
  constexpr int STAGE = BTP * BCC * sizeof(T);
  const int nsl = (a.nc + KS - 1) / KS, rows = nsl * KS;
  float* dlT = reinterpret_cast<float*>(stages + 2 * STAGE);     // 2 x [rows][TLD]
  float4* ws = reinterpret_cast<float4*>(dlT + 2 * rows * TLD);  // [KS][BCC / 4]
  float4* prm = ws + KS * (BCC / 4);                              // [BCC]
  float2* prm2 = reinterpret_cast<float2*>(prm + BCC);            // [BCC]
  const int tid = threadIdx.x, pg = tid >> 4, cg = tid & 15;
  const int c0 = blockIdx.x * BCC, c = c0 + 8 * cg;
  const long long tiles = (a.n + BTP - 1) / BTP;
  float dlv[DLR];
  if (nsl == 1) load_w(ws, 0, a.nc, c0, a);
  load_prm(prm, prm2, c0, a, dgm, dbm);

  long long t = blockIdx.y;
  if (t < tiles) {
    load_s(stages, s, t * BTP, c0, a, v16);
    if (nsl == 1) load_dl(dlv, dl, t * BTP, 0, a.nc, a);
  }
  for (int it = 0; t < tiles; ++it, t += gridDim.y) {
    const long long p0 = t * BTP;
    const uint8_t* st = stages + (it & 1) * STAGE;
    float* dlt = dlT + (it & 1) * rows * TLD;
    cp_async_wait_all();
    if (nsl == 1) {
      store_dl(dlt, dlv);
    } else {  // every slice of the tile's dl, without a prefetch
      for (int sl = 0; sl < nsl; ++sl) {
        load_dl(dlv, dl, p0, sl * KS, min(KS, a.nc - sl * KS), a);
        store_dl(dlt + sl * KS * TLD, dlv);
      }
    }
    __syncthreads();  // s and dl of this tile in place; the last tile's readers done
    if (t + gridDim.y < tiles) {
      load_s(stages + ((it + 1) & 1) * STAGE, s, p0 + (long long)gridDim.y * BTP, c0, a, v16);
      if (nsl == 1) load_dl(dlv, dl, p0 + (long long)gridDim.y * BTP, 0, a.nc, a);
    }
    float dy3[4][8] = {};
    for (int sl = 0; sl < nsl; ++sl) {
      const int ks = min(KS, a.nc - sl * KS);
      if (nsl > 1) {  // restage W for each slice
        __syncthreads();
        load_w(ws, sl * KS, ks, c0, a);
        __syncthreads();
      }
      dy3_rows<4>(dy3, dlt + sl * KS * TLD, ws, ks, 4 * pg, cg);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const long long n = p0 + 4 * pg + i;
      float x[8], dm[8], o[8];
      read_s<T>(x, st, 4 * pg + i, cg);
      load_dm(dm, n, c, a);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float4 q = prm[j * 16 + cg];  // mu, rsig, gamma, beta
        const float2 r = prm2[j * 16 + cg];  // dgm, dbm
        float xh;
        const float y1 = bn_y1v<T>(x[j], q.x, q.y, q.z, q.w, xh);
        const float dy1 = y1 > 0.f ? dy3[i][j] * dm[j] : 0.f;
        o[j] = q.z * q.y * (dy1 - r.y - xh * r.x);
      }
      if (n < a.n) store_ds(ds + n * a.e + c, o, a.e - c, v16);
    }
  }
}

int sm_count() {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return sms;
}

template <typename K>
cudaError_t allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

Tail make_tail(const float* mu, const float* rsig, const float* gamma, const float* beta,
               const float* dmask, const float* w, long long n, int p_img, int e, int nc) {
  Tail a;
  a.mu = mu; a.rsig = rsig; a.gamma = gamma; a.beta = beta; a.dmask = dmask; a.w = w;
  a.n = n; a.p_img = p_img; a.e = e; a.nc = nc;
  return a;
}

bool bad_shape(long long n, int p_img, int e, int nc) {
  return n < 1 || n >= (1LL << 31) || p_img < 1 || n % p_img || e < 4 || e % 4 || nc < 1 ||
         nc > 256;
}

template <typename T, int G>
cudaError_t launch_fwd(const void* s, const Tail& a, const float* bcls, float* logits,
                       cudaStream_t st) {
  const size_t bytes = (size_t)(TP + 32 * G) * LD * sizeof(float);
  cudaError_t err = allow_smem(fwd_kernel<T, G>, bytes);
  if (err != cudaSuccess) return err;
  const unsigned grid = (unsigned)((a.n + TP - 1) / TP);
  fwd_kernel<T, G><<<grid, THREADS, bytes, st>>>(static_cast<const T*>(s), a, bcls, logits);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_fwd_g(const void* s, const Tail& a, const float* bcls, float* logits,
                         cudaStream_t st) {
  if (a.nc <= 32) return launch_fwd<T, 1>(s, a, bcls, logits, st);
  if (a.nc <= 64) return launch_fwd<T, 2>(s, a, bcls, logits, st);
  if (a.nc <= 128) return launch_fwd<T, 4>(s, a, bcls, logits, st);
  return launch_fwd<T, 8>(s, a, bcls, logits, st);
}

// persistent blocks: as many as fit on the card at once, `others` (the grid's
// other dimensions) apart, at most one a tile
template <typename K>
long long splits(K kern, size_t bytes, int others, long long tiles) {
  int per_sm = 1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, THREADS, bytes) != cudaSuccess ||
      per_sm < 1)
    per_sm = 1;
  const long long n = ((long long)per_sm * sm_count() + others - 1) / others;
  return n < 1 ? 1 : n > tiles ? tiles : n;
}

template <typename T>
cudaError_t launch_reduce(const void* s, const Tail& a, const float* dl, float* dw, float* db,
                          float* dgamma, float* dbeta, cudaStream_t st) {
  const size_t bytes =
      2 * BTP * BCC * sizeof(T) + (2 * KS * TLD + BCC * TLD + KS * BCC + 4 * BCC) * 4;
  auto kern = bwd_reduce_kernel<T>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  const int chunks = (a.e + BCC - 1) / BCC, slices = (a.nc + KS - 1) / KS;
  const long long tiles = (a.n + BTP - 1) / BTP;
  dim3 grid(chunks, (unsigned)splits(kern, bytes, chunks * slices, tiles), slices);
  kern<<<grid, THREADS, bytes, st>>>(static_cast<const T*>(s), a, dl, dw, db, dgamma, dbeta,
                                     (a.e * sizeof(T)) % 16 == 0);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ds(const void* s, const Tail& a, const float* dl, const float* dgm,
                      const float* dbm, void* ds, cudaStream_t st) {
  const int rows = (a.nc + KS - 1) / KS * KS;
  const size_t bytes = 2 * BTP * BCC * sizeof(T) + (2 * rows * TLD + KS * BCC + 6 * BCC) * 4;
  auto kern = bwd_ds_kernel<T>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  const int chunks = (a.e + BCC - 1) / BCC;
  const long long tiles = (a.n + BTP - 1) / BTP;
  dim3 grid(chunks, (unsigned)splits(kern, bytes, chunks, tiles));
  kern<<<grid, THREADS, bytes, st>>>(static_cast<const T*>(s), a, dl, dgm, dbm,
                                     static_cast<T*>(ds), (a.e * sizeof(T)) % 16 == 0);
  return cudaGetLastError();
}

}  // namespace

// sums (2, E) float32, zeroed by the caller: sum of s and of s^2 per channel
SFT_EXPORT int sft_head_tail_stats(const void* s, long long n, int e, float* sums, int dtype,
                                   void* stream) {
  if (n < 1 || e < 4 || e % 4) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int chunks = (e + CC - 1) / CC;
  long long splits = (8LL * sm_count() + chunks - 1) / chunks;
  const long long rows = (n + THREADS / (CC / 4) - 1) / (THREADS / (CC / 4));
  if (splits > rows) splits = rows;
  dim3 grid(chunks, (unsigned)splits);
  if (dtype == SFT_F32)
    stats_kernel<float><<<grid, THREADS, 0, st>>>(static_cast<const float*>(s), n, e, sums);
  else if (dtype == SFT_BF16)
    stats_kernel<__nv_bfloat16><<<grid, THREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(s), n, e, sums);
  else
    return cudaErrorInvalidValue;
  return cudaGetLastError();
}

// K6f: logits (N, NC) float32 of s (N, E); every other array float32
SFT_EXPORT int sft_head_tail_fwd(const void* s, const float* mu, const float* rsig,
                                 const float* gamma, const float* beta, const float* dmask,
                                 const float* w, const float* bcls, float* logits, long long n,
                                 int p_img, int e, int nc, int dtype, void* stream) {
  if (bad_shape(n, p_img, e, nc)) return cudaErrorInvalidValue;
  const Tail a = make_tail(mu, rsig, gamma, beta, dmask, w, n, p_img, e, nc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32) return launch_fwd_g<float>(s, a, bcls, logits, st);
  if (dtype == SFT_BF16) return launch_fwd_g<__nv_bfloat16>(s, a, bcls, logits, st);
  return cudaErrorInvalidValue;
}

// K6b reduction: dw (NC, E), db (NC), dgamma, dbeta (E), float32, zeroed by
// the caller, for the logits' cotangent dl (N, NC) float32
SFT_EXPORT int sft_head_tail_bwd_reduce(const void* s, const float* mu, const float* rsig,
                                        const float* gamma, const float* beta,
                                        const float* dmask, const float* w, const float* dl,
                                        float* dw, float* db, float* dgamma, float* dbeta,
                                        long long n, int p_img, int e, int nc, int dtype,
                                        void* stream) {
  if (bad_shape(n, p_img, e, nc)) return cudaErrorInvalidValue;
  const Tail a = make_tail(mu, rsig, gamma, beta, dmask, w, n, p_img, e, nc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32) return launch_reduce<float>(s, a, dl, dw, db, dgamma, dbeta, st);
  if (dtype == SFT_BF16)
    return launch_reduce<__nv_bfloat16>(s, a, dl, dw, db, dgamma, dbeta, st);
  return cudaErrorInvalidValue;
}

// K6b input cotangent: ds (N, E) in s's dtype; dgm = dgamma / N, dbm = dbeta / N
SFT_EXPORT int sft_head_tail_bwd_ds(const void* s, const float* mu, const float* rsig,
                                    const float* gamma, const float* beta, const float* dmask,
                                    const float* w, const float* dl, const float* dgm,
                                    const float* dbm, void* ds, long long n, int p_img, int e,
                                    int nc, int dtype, void* stream) {
  if (bad_shape(n, p_img, e, nc)) return cudaErrorInvalidValue;
  const Tail a = make_tail(mu, rsig, gamma, beta, dmask, w, n, p_img, e, nc);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == SFT_F32) return launch_ds<float>(s, a, dl, dgm, dbm, ds, st);
  if (dtype == SFT_BF16) return launch_ds<__nv_bfloat16>(s, a, dl, dgm, dbm, ds, st);
  return cudaErrorInvalidValue;
}
