// K6f / K6b: SegFormerHead's training tail in one pass over the fuse tensor
// s (N = B*H*W pixels, E channels, float32 or bf16):
//   xhat = (s - mu) * rsig,  y1 = round_T(xhat * gamma + beta),
//   y3 = relu(y1) * dmask[b]   (float32, not rounded),
//   logits = y3 W^T + bcls     (float32 (N, NC); W in the 1x1 conv's (NC, E)).
// mu / rsig come from the batch statistics: the mean, the fast variance
// E[s^2] - E[s]^2 clipped at 0, and rsig = 1 / sqrt(var + eps).
//
// Replaces the TPU kernels segmentation_factory_tpu/ops/pallas_head_tail.py
// `_forward` (:161, body `_fwd_kernel` :73; its statistics `_stats`
// :185-190 are XLA's there) and the two pallas_calls of `_bwd_rule` (:216):
// the reduction kernel (:231, body `_bwd_red_kernel` :91) that accumulates
// dW, db, dgamma and dbeta over the sequential grid, and the input-cotangent
// kernel (:254, body `_bwd_ds_kernel` :131)
//   ds = gamma * rsig * (dy1 - dbeta / N - xhat * dgamma / N),
//   dy1 = (dl W) * dmask[b] * (y1 > 0),
// cast to s's dtype. dgamma and dbeta are returned as raw sums.
//
// What bounds them on the H100: at the main shape (N = 131072, E = 768,
// NC = 19) the float32 products (FMAs, not TF32: the TPU kernel's product is
// float32), 2*N*E*NC flops forward and three times that backward, are
// about as long at the 67 TFLOP/s FP32 peak as reading s at 3.35 TB/s.
// Design:
// - K6f: three launches in one call. The statistics kernel streams s once
//   (16 bytes a thread where rows allow it) and writes each block's
//   per-channel float32 sums of s and s^2 to a row of partials; a small
//   kernel sums the partials in a fixed order and finishes mean, var and
//   rsig on the device. The logits kernel reads s again: see the K6f
//   section below.
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
__device__ __forceinline__ float relu(float x) { return x <= 0.f ? 0.f : x; }

// xhat, and y1 rounded to the storage type T, from a channel's parameters
template <typename T>
__device__ __forceinline__ float bn_y1v(float x, float mu, float rsig, float gamma, float beta,
                                        float& xhat) {
  xhat = __fmul_rn(__fsub_rn(x, mu), rsig);
  return to_f32(from_f32<T>(__fadd_rn(__fmul_rn(xhat, gamma), beta)));
}

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
__device__ __forceinline__ void cp_async_wait_group1() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// ---------------------------------------------------------------- K6f
//
// Statistics. `stats_kernel`: grid (ceil(E / (32 VEC)), splits); a thread
// owns VEC channels (8 bf16: 16-byte loads; 4 where rows allow no more, and
// 4 float32) of every SROWS-th pixel row of the block's strided run, eight
// rows in flight; the block reduces its rows in shared memory and writes
// its sums of s and s^2 to its row of the partials (splits, 2, E).
// `stats_finish_kernel` sums each channel's partials in a fixed order, 8
// warps a block over the splits, and writes mean, var and rsig: one small
// launch instead of PyTorch's division, clamp and rsqrt kernels.
//
// Logits. `logits_kernel`: a block of THREADS threads owns a tile of
// THREADS * P pixels and a slice of KS classes (the main shape: one slice
// of 19, P = 4, 128 blocks, one an SM); W's slice (zero-padded, a channel
// quad's 4 weights of a class in one float4) and every channel's (mu,
// rsig, gamma, beta) stay in shared memory for the block's life. A thread
// owns P pixels x all KS classes: it computes its own pixels' y3 =
// relu(y1) * dmask once an element in registers, and per channel quad
// reads each class's float4 of W with one address across the warp (a
// broadcast) for 4 P FMAs, so shared memory keeps up with the FMAs. A tile
// of pixels x classes split across lanes, as K6b's passes, needs a load of
// y3 and of W per lane: on the H100 a warp's 16-byte shared load takes
// 3.15 cycles of an SM whether its lanes read one address or eight
// (tools/smem_loads.py), so at 2 pixels x 5 classes a thread a channel
// quad's 7 loads (22 cycles) outlast its 40 FMAs (10). What bounds it now
// is latency: 8 warps an SM (80 accumulators a thread fill the register
// file); without its loads of s it takes 0.158 of its 0.194 ms
// (tools/head_variants.py `no_loads`). Classes past one slice are
// grid.y slices, each recomputing y3. Each block owns whole pixels of its
// slice: no atomics. Tiles run last first: the statistics kernel read the
// last pixels last, so the first tiles find part of s in L2.
constexpr int SROWS = THREADS / 32;  // pixel rows a statistics block takes at a time
constexpr int LCB = 64;              // bytes of a pixel a logits chunk: LCB / sizeof(T) channels
constexpr int UNITS = LCB / 16;      // its 16-byte units

template <typename T, int VEC>
__device__ __forceinline__ void load_vec(float (&x)[VEC], const T* p) {
  if constexpr (sizeof(T) == 4) {
#pragma unroll
    for (int h = 0; h < VEC / 4; ++h) {
      const float4 v = __ldg(reinterpret_cast<const float4*>(p) + h);
      x[4 * h] = v.x; x[4 * h + 1] = v.y; x[4 * h + 2] = v.z; x[4 * h + 3] = v.w;
    }
  } else if constexpr (VEC == 8) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(p));
    const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      x[2 * j] = __uint_as_float(u[j] << 16);
      x[2 * j + 1] = __uint_as_float(u[j] & 0xffff0000u);
    }
  } else {
    const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
    x[0] = __uint_as_float(v.x << 16); x[1] = __uint_as_float(v.x & 0xffff0000u);
    x[2] = __uint_as_float(v.y << 16); x[3] = __uint_as_float(v.y & 0xffff0000u);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(THREADS)
stats_kernel(const T* __restrict__ s, int n, int e, float* __restrict__ part) {
  constexpr int SC = 32 * VEC;  // channels a block
  __shared__ float red[2][SROWS][SC];
  const int t = threadIdx.x, q = t & 31, r = t >> 5, c = blockIdx.x * SC + q * VEC;
  float s1[VEC] = {}, s2[VEC] = {};
  if (c < e) {
    const int step = gridDim.y * SROWS;
    int p = blockIdx.y * SROWS + r;
    for (; p + 7 * step < n; p += 8 * step) {
      float x[8][VEC];
#pragma unroll
      for (int u = 0; u < 8; ++u) load_vec<T, VEC>(x[u], s + (size_t)(p + u * step) * e + c);
#pragma unroll
      for (int u = 0; u < 8; ++u)
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          s1[j] += x[u][j];
          s2[j] = fmaf(x[u][j], x[u][j], s2[j]);
        }
    }
    for (; p < n; p += step) {
      float x[VEC];
      load_vec<T, VEC>(x, s + (size_t)p * e + c);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        s1[j] += x[j];
        s2[j] = fmaf(x[j], x[j], s2[j]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[0][r][q * VEC + j] = s1[j];
    red[1][r][q * VEC + j] = s2[j];
  }
  __syncthreads();
  for (int i = t; i < 2 * SC; i += THREADS) {
    const int which = i / SC, cc = i % SC;
    if (blockIdx.x * SC + cc >= e) continue;
    float v = 0.f;
#pragma unroll
    for (int rr = 0; rr < SROWS; ++rr) v += red[which][rr][cc];
    part[((size_t)blockIdx.y * 2 + which) * e + blockIdx.x * SC + cc] = v;
  }
}

// grid ceil(E / 32): lane l of warp w sums channel 32 blockIdx + l over the
// splits w, w + 8, ...; the 8 warps' sums added in order
__global__ void __launch_bounds__(THREADS)
stats_finish_kernel(const float* __restrict__ part, int splits, int e, int n, float eps,
                    float* __restrict__ mean, float* __restrict__ var, float* __restrict__ rsig) {
  __shared__ float red[2][THREADS / 32][33];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5, c = blockIdx.x * 32 + lane;
  float a = 0.f, q = 0.f;
  if (c < e)
    for (int j = w; j < splits; j += THREADS / 32) {
      a += part[(size_t)2 * j * e + c];
      q += part[(size_t)(2 * j + 1) * e + c];
    }
  red[0][w][lane] = a;
  red[1][w][lane] = q;
  __syncthreads();
  if (w == 0 && c < e) {
    a = q = 0.f;
#pragma unroll
    for (int i = 0; i < THREADS / 32; ++i) {
      a += red[0][i][lane];
      q += red[1][i][lane];
    }
    const float nf = (float)n, m = __fdiv_rn(a, nf);
    const float v = fmaxf(__fsub_rn(__fdiv_rn(q, nf), __fmul_rn(m, m)), 0.f);
    mean[c] = m;
    var[c] = v;
    rsig[c] = __fdiv_rn(1.f, __fsqrt_rn(__fadd_rn(v, eps)));
  }
}

__device__ __forceinline__ float4 dmask4(const float* row, int c, int e) {
  return c < e ? __ldg(reinterpret_cast<const float4*>(row + c)) : make_float4(0.f, 0.f, 0.f, 0.f);
}

// channels 4 h .. 4 h + 3 of a staged 16-byte unit, as float32
template <typename T>
__device__ __forceinline__ float4 unit4(uint4 u, int h) {
  if constexpr (sizeof(T) == 4) {
    return make_float4(__uint_as_float(u.x), __uint_as_float(u.y), __uint_as_float(u.z),
                       __uint_as_float(u.w));
  } else {
    const uint32_t lo = h ? u.z : u.x, hi = h ? u.w : u.y;
    return make_float4(__uint_as_float(lo << 16), __uint_as_float(lo & 0xffff0000u),
                       __uint_as_float(hi << 16), __uint_as_float(hi & 0xffff0000u));
  }
}

// grid (tiles of THREADS * P pixels, class slices of KS); shared memory
// `logits_smem`. Thread t owns pixels t + THREADS j (j < P) of the tile and
// every class of the slice. The tile walks E in chunks of LCB bytes a
// pixel; a warp stages its own pixels' chunk by cp.async one chunk ahead,
// four lanes a pixel (16 bytes a copy where rows allow it, else 8), so a
// warp's copy instruction asks for 8 whole 64-byte pieces; each pixel's
// 16-byte units are XOR-swizzled by its lane, so a warp's reads of one unit
// are conflict-free. A __syncwarp, no barrier, in the loop.
template <typename T, int KS, int P>
__global__ void __launch_bounds__(THREADS, 1)
logits_kernel(const T* __restrict__ s, Tail a, const float* __restrict__ bcls,
              float* __restrict__ logits, bool v16) {
  constexpr int LCC = LCB / (int)sizeof(T);  // channels a chunk
  constexpr int LQ = LCC / 4;                // channel quads a chunk
  constexpr int CPU = 16 / (int)sizeof(T);   // channels a unit
  constexpr int STAGE = P * THREADS * LCB;
  extern __shared__ float4 smem4[];
  const int chunks = (a.e + LCC - 1) / LCC, q4 = chunks * LQ;  // channel quads, padded
  float4* ws = smem4;                                          // [q4][KS] W
  float4* prm = ws + q4 * KS;                                  // [4 q4] (mu, rsig, gamma, beta)
  uint8_t* stages = reinterpret_cast<uint8_t*>(prm + 4 * q4);  // 2 x [P][THREADS][UNITS] units
                                                               // (then the logits' rows)
  const int t = threadIdx.x, lane = t & 31, k0 = blockIdx.y * KS, nk = min(KS, a.nc - k0);
  const int n = (int)a.n, e = a.e, tiles = (n + THREADS * P - 1) / (THREADS * P);
  for (int i = t; i < q4 * KS; i += THREADS) {
    const int k = i % KS, c = 4 * (i / KS);
    ws[i] = k < nk && c < e
                ? __ldg(reinterpret_cast<const float4*>(a.w + (size_t)(k0 + k) * e + c))
                : make_float4(0.f, 0.f, 0.f, 0.f);
  }
  for (int c = t; c < 4 * q4; c += THREADS)
    prm[c] = c < e ? make_float4(a.mu[c], a.rsig[c], a.gamma[c], a.beta[c])
                   : make_float4(0.f, 0.f, 0.f, 0.f);
  // tiles last first: the statistics kernel read the last pixels last, so
  // the first tiles find part of s in L2
  const int p0 = (tiles - 1 - (int)blockIdx.x) * THREADS * P;
  // unit u of lane l's pixel at u ^ swz(l): 8 lanes' reads of one unit
  // fall in 8 distinct 16-byte bank groups
  auto swizzle = [](int l) { return (l / (8 / UNITS)) % UNITS; };
  const int swz = swizzle(lane);
  const float* dmrow[P];
  bool one_image = true;
#pragma unroll
  for (int j = 0; j < P; ++j) {
    const int p = min(p0 + t + THREADS * j, n - 1);
    dmrow[j] = a.dmask + (size_t)(p / a.p_img) * e;
    one_image = one_image && dmrow[j] == dmrow[0];
  }
  // the warp's pixels of the chunk: copy m of lane l is unit l % UNITS of
  // the warp's pixel m * 32 / UNITS + l / UNITS
  auto stage_chunk = [&](int ch) {
    uint8_t* st = stages + (ch & 1) * STAGE;
    const int u = lane % UNITS, c = ch * LCC + u * CPU;
#pragma unroll
    for (int j = 0; j < P; ++j) {
#pragma unroll
      for (int m = 0; m < UNITS; ++m) {
        const int pl = m * (32 / UNITS) + lane / UNITS, owner = (t & ~31) + pl;
        const int p = p0 + owner + THREADS * j;
        uint8_t* dst = st + ((j * THREADS + owner) * UNITS + (u ^ swizzle(pl))) * 16;
        if (v16) {
          const bool ok = p < n && c < e;
          cp_async16(dst, ok ? s + (size_t)p * e + c : s, ok);
        } else {  // bf16 rows of E % 8 == 4 channels: 8-byte copies
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const bool ok = p < n && c + 4 * h < e;
            cp_async8(dst + 8 * h, ok ? s + (size_t)p * e + c + 4 * h : s, ok);
          }
        }
      }
    }
    cp_async_commit();
  };

  float acc[P][KS];
#pragma unroll
  for (int j = 0; j < P; ++j)
#pragma unroll
    for (int k = 0; k < KS; ++k) acc[j][k] = 0.f;
  stage_chunk(0);
  __syncthreads();  // W and the parameters in place
  for (int ch = 0; ch < chunks; ++ch) {
    __syncwarp();  // the warp is done with the stage the next chunk overwrites
    if (ch + 1 < chunks) stage_chunk(ch + 1);
    else cp_async_commit();
    cp_async_wait_group1();
    __syncwarp();  // this chunk of the warp's pixels has landed
    const uint8_t* st = stages + (ch & 1) * STAGE;
    // rolled: a chunk unrolled is thousands of FMAs of straight code, more
    // than the instruction cache holds (tools/head_variants.py)
#pragma unroll 1
    for (int u = 0; u < UNITS; ++u) {
      uint4 raw[P];  // this unit of each pixel: a warp's loads of it are conflict-free
#pragma unroll
      for (int j = 0; j < P; ++j)
        raw[j] = *reinterpret_cast<const uint4*>(st + ((j * THREADS + t) * UNITS + (u ^ swz)) * 16);
#pragma unroll
      for (int h = 0; h < CPU / 4; ++h) {
        const int c = ch * LCC + u * CPU + 4 * h;
        const float4 q0 = prm[c], q1 = prm[c + 1], q2 = prm[c + 2], q3 = prm[c + 3];
        const float4 dm0 = dmask4(dmrow[0], c, e);
        float4 y[P];  // y3 of this thread's pixels at the quad's 4 channels
#pragma unroll
        for (int j = 0; j < P; ++j) {
          const float4 dm = one_image ? dm0 : dmask4(dmrow[j], c, e);
          const float4 x = unit4<T>(raw[j], h);
          float xh;
          y[j] = make_float4(relu(bn_y1v<T>(x.x, q0.x, q0.y, q0.z, q0.w, xh)) * dm.x,
                             relu(bn_y1v<T>(x.y, q1.x, q1.y, q1.z, q1.w, xh)) * dm.y,
                             relu(bn_y1v<T>(x.z, q2.x, q2.y, q2.z, q2.w, xh)) * dm.z,
                             relu(bn_y1v<T>(x.w, q3.x, q3.y, q3.z, q3.w, xh)) * dm.w);
        }
        const float4* wq = ws + (c / 4) * KS;  // one address across the warp: a broadcast
#pragma unroll
        for (int k = 0; k < KS; ++k) {
          const float4 w = wq[k];
#pragma unroll
          for (int j = 0; j < P; ++j)
            acc[j][k] = fmaf(y[j].w, w.w, fmaf(y[j].z, w.z, fmaf(y[j].y, w.y,
                                                                  fmaf(y[j].x, w.x, acc[j][k]))));
        }
      }
    }
  }
  // the logits through shared memory (the stages are free), a pixel row of
  // the slice at a time per thread, out in coalesced rows
  cp_async_wait_all();
  __syncthreads();
  float* ob = reinterpret_cast<float*>(stages);  // [THREADS][KS + 1]
#pragma unroll
  for (int j = 0; j < P; ++j) {
#pragma unroll
    for (int k = 0; k < KS; ++k) ob[t * (KS + 1) + k] = acc[j][k];
    __syncthreads();
    const int pj = p0 + THREADS * j;
    for (int i = t; i < THREADS * nk; i += THREADS) {
      const int r = i / nk, k = i - r * nk;
      if (pj + r < n) logits[(size_t)(pj + r) * a.nc + k0 + k] = ob[r * (KS + 1) + k] + bcls[k0 + k];
    }
    __syncthreads();
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

// K6f's statistics: the partials' splits (at most max_splits, about four
// blocks an SM), then the finishing step; with a `plan`, only (channel
// chunks, splits) into it
template <typename T, int VEC>
cudaError_t launch_stats(const void* s, int n, int e, float* part, int max_splits, float eps,
                         float* mean, float* var, float* rsig, cudaStream_t st, int* plan) {
  const int chunks = (e + 32 * VEC - 1) / (32 * VEC), rows = (n + SROWS - 1) / SROWS;
  int sp = (4 * sm_count() + chunks - 1) / chunks;
  if (sp > max_splits) sp = max_splits;
  if (sp > rows) sp = rows;
  if (plan) {
    plan[0] = chunks;
    plan[1] = sp;
    return cudaSuccess;
  }
  stats_kernel<T, VEC><<<dim3(chunks, sp), THREADS, 0, st>>>(static_cast<const T*>(s), n, e, part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  stats_finish_kernel<<<(e + 31) / 32, THREADS, 0, st>>>(part, sp, e, n, eps, mean, var, rsig);
  return cudaGetLastError();
}

// W's slice, the parameters, and the two stages (which the logits reuse)
size_t logits_smem(int e, int ks, int p, int elt) {
  const int lcc = LCB / elt;  // channels a chunk
  const size_t q4 = (size_t)(e + lcc - 1) / lcc * (lcc / 4);
  const size_t stages = 2 * (size_t)p * THREADS * LCB, out = (size_t)THREADS * (ks + 1) * 4;
  return q4 * ks * 16 + 4 * q4 * 16 + (stages > out ? stages : out);
}

// with a `plan`, only (classes a slice, pixels a thread, class slices,
// blocks a slice, shared memory bytes) into it
template <typename T, int KS, int P>
cudaError_t launch_logits(const void* s, const Tail& a, const float* bcls, float* logits,
                          cudaStream_t st, int* plan) {
  const size_t bytes = logits_smem(a.e, KS, P, sizeof(T));
  auto kern = logits_kernel<T, KS, P>;
  cudaError_t err = allow_smem(kern, bytes);
  if (err != cudaSuccess) return err;
  const int slices = (a.nc + KS - 1) / KS;
  const long long tiles = (a.n + THREADS * P - 1) / (THREADS * P);
  const dim3 grid((unsigned)tiles, slices);
  if (plan) {
    plan[0] = KS;
    plan[1] = P;
    plan[2] = slices;
    plan[3] = (int)tiles;
    plan[4] = (int)bytes;
    return cudaSuccess;
  }
  kern<<<grid, THREADS, bytes, st>>>(static_cast<const T*>(s), a, bcls, logits,
                                     (a.e * sizeof(T)) % 16 == 0);
  return cudaGetLastError();
}

// a slice of KS classes: NC rounded up to a multiple of 4 up to 32 (slices
// of 32 beyond), but 19 (Cityscapes' classes) exactly; 4 pixels a thread up
// to 20 classes, else 2; fewer classes a slice where W's slice would not fit
template <typename T>
cudaError_t launch_logits_k(const void* s, const Tail& a, const float* bcls, float* logits,
                            cudaStream_t st, int* plan) {
  int ks = a.nc == 19 ? 19 : a.nc <= 32 ? (a.nc + 3) / 4 * 4 : 32;
  while (ks > 4 && logits_smem(a.e, ks, ks <= 20 ? 4 : 2, sizeof(T)) > 232448) ks = (ks - 1) / 4 * 4;
  switch (ks) {
    case 19: return launch_logits<T, 19, 4>(s, a, bcls, logits, st, plan);
    case 4: return launch_logits<T, 4, 4>(s, a, bcls, logits, st, plan);
    case 8: return launch_logits<T, 8, 4>(s, a, bcls, logits, st, plan);
    case 12: return launch_logits<T, 12, 4>(s, a, bcls, logits, st, plan);
    case 16: return launch_logits<T, 16, 4>(s, a, bcls, logits, st, plan);
    case 20: return launch_logits<T, 20, 4>(s, a, bcls, logits, st, plan);
    case 24: return launch_logits<T, 24, 2>(s, a, bcls, logits, st, plan);
    case 28: return launch_logits<T, 28, 2>(s, a, bcls, logits, st, plan);
    default: return launch_logits<T, 32, 2>(s, a, bcls, logits, st, plan);
  }
}

// K6f: the statistics, their finishing step and the logits; or, with a
// `plan`, the geometry of both into it: the statistics' chunks and splits,
// then the logits' `launch_logits` plan
int head_tail_fwd(const void* s, const Tail& a, const float* bcls, float* part, int max_splits,
                  float eps, float* var, float* logits, int dtype, cudaStream_t st, int* plan) {
  const int n = (int)a.n, e = a.e;
  float* mean = const_cast<float*>(a.mu);
  float* rsig = const_cast<float*>(a.rsig);
  cudaError_t err;
  if (dtype == SFT_F32) {
    err = launch_stats<float, 4>(s, n, e, part, max_splits, eps, mean, var, rsig, st, plan);
    return err != cudaSuccess ? err
                              : launch_logits_k<float>(s, a, bcls, logits, st, plan ? plan + 2 : plan);
  }
  if (dtype == SFT_BF16) {
    err = e % 8 == 0 ? launch_stats<__nv_bfloat16, 8>(s, n, e, part, max_splits, eps, mean, var,
                                                      rsig, st, plan)
                     : launch_stats<__nv_bfloat16, 4>(s, n, e, part, max_splits, eps, mean, var,
                                                      rsig, st, plan);
    return err != cudaSuccess
               ? err
               : launch_logits_k<__nv_bfloat16>(s, a, bcls, logits, st, plan ? plan + 2 : plan);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// K6f: the batch statistics mean, var and rsig = 1 / sqrt(var + eps) ((E)
// float32) and the logits (N, NC) float32 of s (N, E); part: scratch of
// max_splits x 2 x E floats (the statistics' partials); every other array
// float32. Three launches: statistics, their finishing step, logits.
SFT_EXPORT int sft_head_tail_fwd(const void* s, const float* gamma, const float* beta,
                                 const float* dmask, const float* w, const float* bcls,
                                 float* part, int max_splits, float eps, float* mean, float* var,
                                 float* rsig, float* logits, long long n, int p_img, int e,
                                 int nc, int dtype, void* stream) {
  if (bad_shape(n, p_img, e, nc) || max_splits < 1) return cudaErrorInvalidValue;
  const Tail a = make_tail(mean, rsig, gamma, beta, dmask, w, n, p_img, e, nc);
  return head_tail_fwd(s, a, bcls, part, max_splits, eps, var, logits, dtype,
                       static_cast<cudaStream_t>(stream), nullptr);
}

// K6f's launch geometry at (n, e, nc, dtype, max_splits) into plan[7]: the
// statistics' channel chunks and splits, the logits' classes a slice,
// pixels a thread, class slices, blocks a slice and shared memory bytes
SFT_EXPORT int sft_head_tail_fwd_plan(long long n, int e, int nc, int dtype, int max_splits,
                                      int* plan) {
  if (bad_shape(n, 1, e, nc) || max_splits < 1) return cudaErrorInvalidValue;
  const Tail a = make_tail(nullptr, nullptr, nullptr, nullptr, nullptr, nullptr, n, 1, e, nc);
  return head_tail_fwd(nullptr, a, nullptr, nullptr, max_splits, 0.f, nullptr, nullptr, dtype,
                       nullptr, plan);
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
