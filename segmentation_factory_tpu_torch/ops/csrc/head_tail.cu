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
// Design (simple first, correct before fast):
// - stats: each thread sums 4 channels over a strided run of pixels in
//   registers; the block reduces its rows in shared memory and adds its
//   partial sums with one float32 atomic per value.
// - K6f: one block per 64-pixel tile walks E in chunks of 64 channels. Per
//   chunk it stages y3 (64 x 64) and the chunk's W rows (32*G x 64) in
//   shared memory; lane k of a warp owns class k (+32 g) and 8 pixels, so a
//   float4 of W feeds 32 FMAs and the y3 reads are warp broadcasts.
// - K6b reduction: a grid of (channel chunk, pixel split) blocks, a few per
//   SM, each looping over 64-pixel tiles: the tile's dl and y3 in shared
//   memory, dy3 = dl W per (pixel, channel) with the channel's W column
//   read from shared memory, dgamma / dbeta in registers, dW and db as
//   partial sums in shared memory; one float32 atomic per entry per block
//   at the end (not per tile).
// - K6b ds: one block per (64-pixel tile, channel chunk) recomputes xhat,
//   y1 and dy3 and writes ds; no atomics.
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
constexpr int ROWS = THREADS / CC;       // K6b pixel rows per block pass (thread = channel, row)
constexpr int PT = TP / ROWS;            // K6b pixels per thread and tile

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

// xhat, and y1 rounded to the storage type T, for channel c
template <typename T>
__device__ __forceinline__ float bn_y1(const Tail& a, float x, int c, float& xhat) {
  xhat = __fmul_rn(__fsub_rn(x, a.mu[c]), a.rsig[c]);
  return to_f32(from_f32<T>(__fadd_rn(__fmul_rn(xhat, a.gamma[c]), a.beta[c])));
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

// dl tile (TP pixels x NC classes, contiguous in dl) into shared memory
__device__ __forceinline__ void load_dl(float* dls, const float* __restrict__ dl, long long p0,
                                        const Tail& a) {
  const long long base = p0 * a.nc, end = a.n * a.nc;
  for (int i = threadIdx.x; i < TP * a.nc; i += THREADS)
    dls[i] = base + i < end ? dl[base + i] : 0.f;
}

// W columns of the chunk: ws[k * CC + cl] = W[k][c0 + cl]
__device__ __forceinline__ void load_w(float* ws, int c0, const Tail& a) {
  for (int i = threadIdx.x; i < a.nc * CC; i += THREADS) {
    const int k = i / CC, c = c0 + i % CC;
    ws[i] = c < a.e ? a.w[(long long)k * a.e + c] : 0.f;
  }
}

// dy3 of this thread's PT pixels (rows row + ROWS * i of the tile) at channel cl
__device__ __forceinline__ void tile_dy3(float (&dy3)[PT], const float* dls, const float* ws,
                                         int row, int cl, int nc) {
#pragma unroll
  for (int i = 0; i < PT; ++i) dy3[i] = 0.f;
  for (int k = 0; k < nc; ++k) {
    const float w = ws[k * CC + cl];
#pragma unroll
    for (int i = 0; i < PT; ++i) dy3[i] = fmaf(dls[(row + ROWS * i) * nc + k], w, dy3[i]);
  }
}

// K6b reduction; grid (ceil(E / CC), splits); each block loops over the tiles
// blockIdx.y, blockIdx.y + splits, ...; shared: ws, dls, ys, dws (+ dbs)
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_reduce_kernel(const T* __restrict__ s, Tail a, const float* __restrict__ dl,
                  float* __restrict__ dw, float* __restrict__ db, float* __restrict__ dgamma,
                  float* __restrict__ dbeta) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [NC][CC]
  float* dls = ws + a.nc * CC;                   // [TP][NC]
  float* ys = dls + TP * a.nc;                   // [TP][CC] y3
  float* dws = ys + TP * CC;                     // [NC][CC] partial dW
  float* dbs = dws + a.nc * CC;                  // [NC] partial db
  const int c0 = blockIdx.x * CC;
  const int cl = threadIdx.x % CC, row = threadIdx.x / CC, c = c0 + cl;
  const bool first = blockIdx.x == 0;  // one channel chunk also sums db
  load_w(ws, c0, a);
  for (int i = threadIdx.x; i < a.nc * CC; i += THREADS) dws[i] = 0.f;
  for (int i = threadIdx.x; i < a.nc; i += THREADS) dbs[i] = 0.f;
  float dg = 0.f, dbt = 0.f;
  const long long tiles = (a.n + TP - 1) / TP;
  for (long long t = blockIdx.y; t < tiles; t += gridDim.y) {
    const long long p0 = t * TP;
    __syncthreads();  // the previous tile's readers are done with dls / ys
    load_dl(dls, dl, p0, a);
    __syncthreads();
    float dy3[PT];
    tile_dy3(dy3, dls, ws, row, cl, a.nc);
#pragma unroll
    for (int i = 0; i < PT; ++i) {
      const int p = row + ROWS * i;
      const long long n = p0 + p;
      float y3 = 0.f;
      if (n < a.n && c < a.e) {
        float xh;
        const float y1 = bn_y1<T>(a, to_f32(s[n * a.e + c]), c, xh);
        const float dm = a.dmask[(n / a.p_img) * a.e + c];
        y3 = relu(y1) * dm;
        const float dy1 = y1 > 0.f ? dy3[i] * dm : 0.f;
        dg = fmaf(dy1, xh, dg);
        dbt += dy1;
      }
      ys[p * CC + cl] = y3;
    }
    __syncthreads();
    // dW[k][c] += sum_p y3[p][c] dl[p][k]: this thread owns k = row + ROWS j
    for (int j0 = row; j0 < a.nc; j0 += 4 * ROWS) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
      for (int p = 0; p < TP; ++p) {
        const float y = ys[p * CC + cl];
        const float* d = dls + p * a.nc;
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int k = j0 + ROWS * u;
          if (k < a.nc) acc[u] = fmaf(y, d[k], acc[u]);
        }
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int k = j0 + ROWS * u;
        if (k < a.nc) dws[k * CC + cl] += acc[u];
      }
    }
    if (first)
      for (int k = threadIdx.x; k < a.nc; k += THREADS) {
        float v = 0.f;
        for (int p = 0; p < TP; ++p) v += dls[p * a.nc + k];
        dbs[k] += v;
      }
  }
  __syncthreads();
  // dgamma / dbeta: sum this block's ROWS partials per channel
  ys[row * CC + cl] = dg;
  ys[(ROWS + row) * CC + cl] = dbt;
  __syncthreads();
  if (row == 0 && c < a.e) {
    float g = 0.f, b = 0.f;
    for (int r = 0; r < ROWS; ++r) {
      g += ys[r * CC + cl];
      b += ys[(ROWS + r) * CC + cl];
    }
    atomicAdd(dgamma + c, g);
    atomicAdd(dbeta + c, b);
  }
  for (int i = threadIdx.x; i < a.nc * CC; i += THREADS) {
    const int k = i / CC, cc = c0 + i % CC;
    if (cc < a.e) atomicAdd(dw + (long long)k * a.e + cc, dws[i]);
  }
  if (first)
    for (int k = threadIdx.x; k < a.nc; k += THREADS) atomicAdd(db + k, dbs[k]);
}

// K6b input cotangent; grid (ceil(N / TP), ceil(E / CC)); shared: ws, dls
template <typename T>
__global__ void __launch_bounds__(THREADS)
bwd_ds_kernel(const T* __restrict__ s, Tail a, const float* __restrict__ dl,
              const float* __restrict__ dgm, const float* __restrict__ dbm, T* __restrict__ ds) {
  extern __shared__ float4 smem4[];
  float* ws = reinterpret_cast<float*>(smem4);  // [NC][CC]
  float* dls = ws + a.nc * CC;                   // [TP][NC]
  const int c0 = blockIdx.y * CC;
  const int cl = threadIdx.x % CC, row = threadIdx.x / CC, c = c0 + cl;
  const long long p0 = (long long)blockIdx.x * TP;
  load_w(ws, c0, a);
  load_dl(dls, dl, p0, a);
  __syncthreads();
  float dy3[PT];
  tile_dy3(dy3, dls, ws, row, cl, a.nc);
  if (c >= a.e) return;
  const float gr = a.gamma[c] * a.rsig[c];
#pragma unroll
  for (int i = 0; i < PT; ++i) {
    const long long n = p0 + row + ROWS * i;
    if (n >= a.n) break;
    float xh;
    const float y1 = bn_y1<T>(a, to_f32(s[n * a.e + c]), c, xh);
    const float dy1 = y1 > 0.f ? dy3[i] * a.dmask[(n / a.p_img) * a.e + c] : 0.f;
    ds[n * a.e + c] = from_f32<T>(gr * (dy1 - dbm[c] - xh * dgm[c]));
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
  return n < 1 || p_img < 1 || n % p_img || e < 4 || e % 4 || nc < 1 || nc > 256;
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

template <typename T>
cudaError_t launch_reduce(const void* s, const Tail& a, const float* dl, float* dw, float* db,
                          float* dgamma, float* dbeta, cudaStream_t st) {
  const size_t bytes = (size_t)(2 * a.nc * CC + TP * a.nc + TP * CC + a.nc) * sizeof(float);
  cudaError_t err = allow_smem(bwd_reduce_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  const int chunks = (a.e + CC - 1) / CC;
  const long long tiles = (a.n + TP - 1) / TP;
  long long splits = (4LL * sm_count() + chunks - 1) / chunks;
  if (splits > tiles) splits = tiles;
  dim3 grid(chunks, (unsigned)splits);
  bwd_reduce_kernel<T><<<grid, THREADS, bytes, st>>>(static_cast<const T*>(s), a, dl, dw, db,
                                                     dgamma, dbeta);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ds(const void* s, const Tail& a, const float* dl, const float* dgm,
                      const float* dbm, void* ds, cudaStream_t st) {
  const size_t bytes = (size_t)(a.nc * CC + TP * a.nc) * sizeof(float);
  cudaError_t err = allow_smem(bwd_ds_kernel<T>, bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((unsigned)((a.n + TP - 1) / TP), (a.e + CC - 1) / CC);
  bwd_ds_kernel<T><<<grid, THREADS, bytes, st>>>(static_cast<const T*>(s), a, dl, dgm, dbm,
                                                 static_cast<T*>(ds));
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
