// K3b: the attention half-block backward. For out = x + fac[b] * z with
// z = attn(ln Wq^T + bq, K, V) Wo^T + bo and ln = LN1(x) (attn_block.cu), and
// the cotangent g of out, writes dx (like x) and accumulates into zeroed
// float32 buffers dk, dv (B, M, C), dlg, dlb (C), dWq, dWo (C, C) as
// (out, in), dbq, dbo (C). With dz = g * fac rounded to the compute type:
//   doh = dz Wo, dp = doh v^T, ds = p * (dp - rowsum(doh * o)),
//   dq = ds k * scale, dk = ds^T q * scale, dv = p^T doh,
//   dWo = dz^T o, dWq = dq^T ln, dln = dq Wq, dx = g + LN1'(x)^T dln.
// The drop-path factor's cotangent is not formed (it is data, not a
// parameter).
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_block.py
// `_attn_bwd_rule` (:303, body `_attn_bwd_kernel` :131), which recomputes the
// forward per row tile with one exact softmax and accumulates dk/dv across
// the row tiles and the weight and LN gradients across the whole sequential
// grid.
//
// What bounds it on the H100: operations (per token ~12*M*C attention and
// ~10*C*C projection flops against x, g and dx). Hopper blocks run in no
// order, so the TPU's two sequential accumulations become, as in K1b
// (sra_attention_bwd.cuh), a query-side and a key-side kernel, plus one
// kernel per weight gradient:
// 1. dq side, a block per 64 tokens (as K3f): LN1 and dz into shared memory;
//    per head q_h and doh_h on the tensor cores, delta = rowsum(doh * o)
//    from the forward's saved attention output o, then K1b's dq loop over
//    64-key tiles with p regenerated from the forward's log-sum-exp; then
//    dln = dq Wq for the tile, the row-local LN backward (dx = g + dx_ln),
//    and the tile's column sums of dln * xhat, dln, dq and dz added to dlg,
//    dlb, dbq, dbo with float32 atomics.
// 2. dk/dv side: K1b's dk/dv kernel, a block per 64 keys over a chunk of the
//    tokens, on the q and doh that step 1 wrote (the choice between
//    recomputing LN1 and q_h per key-tile visit and keeping them: kept, in
//    scratch the wrapper allocates, 2 x N x C in the compute type, 16.8 MB
//    each in bf16 at stage 1, written once and read once per key tile).
// 3. dWq = dq^T ln and dWo = dz^T o: a block per 64 x 64 output tile and
//    chunk of tokens, partials added with float32 atomics (step 1 also
//    writes ln, dz and dq for these).
// bfloat16 on mma.sync m16n8k16; float32 on FMAs through the same fragment
// layout (frag.cuh), with K1b's float32 dk/dv kernel.
#include "attn_block.cuh"
#include "sra_attention_bwd.cuh"

namespace ab {
namespace {

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
attn_block_dq_kernel(const T* __restrict__ x, const T* __restrict__ k, const T* __restrict__ v,
                     const float* __restrict__ lg, const float* __restrict__ lb,
                     const T* __restrict__ wq, const T* __restrict__ bq,
                     const T* __restrict__ wot, const T* __restrict__ wqt,
                     const float* __restrict__ fac, const T* __restrict__ gout,
                     const T* __restrict__ o, const float* __restrict__ lse, T* __restrict__ dx,
                     T* __restrict__ lns, T* __restrict__ qs, T* __restrict__ dzs,
                     T* __restrict__ dohs, T* __restrict__ dqs, float* __restrict__ delta,
                     float* __restrict__ dlg, float* __restrict__ dlb, float* __restrict__ dbq,
                     float* __restrict__ dbo, int N, int M, int C, float qscale, float scale) {
  using F = Frag<T>;
  const int H = C / D;
  const int LD = C + 8, KLD = D + 8, VLD = BK + 8, DLD = C + 4;
  extern __shared__ __align__(16) unsigned char smem_ab[];
  T* Zs = reinterpret_cast<T*>(smem_ab);  // dz rows [row][c]
  T* Ls = Zs + BQ * LD;                    // LN1 rows
  T* Ks = Ls + BQ * LD;                    // K tile [key][d]
  T* Vs = Ks + BK * KLD;                   // V tile [key][d]
  T* Kt = Vs + BK * KLD;                   // K tile transposed [d][key]
  float* mu = reinterpret_cast<float*>(Kt + D * VLD);
  float* rs = mu + BQ;
  float* DL = reinterpret_cast<float*>(smem_ab);  // dln rows, over Zs and Ls at the end

  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.y;
  const int q0 = blockIdx.x * BQ;
  const int nvalid = min(BQ, N - q0);
  const long rb = (long)b * N;  // first row of the image
  const float f = fac[b];

  for (int idx = tid; idx < BQ * C; idx += THREADS) {
    const int r = idx / C, c = idx % C;
    T z = from_f32<T>(0.f);
    if (r < nvalid) {
      const long at = (rb + q0 + r) * C + c;
      z = from_f32<T>(to_f32(gout[at]) * f);
      dzs[at] = z;
    }
    Zs[r * LD + c] = z;
  }
  ln_rows<T>(x + rb * C, q0, nvalid, C, lg, lb, Ls, LD, mu, rs, lns + rb * C);
  __syncthreads();

  const int w0 = warp * 16;  // the warp's rows of the tile
  for (int c = lane; c < C; c += 32) {  // dbo: column sums of dz
    float s = 0.f;
    for (int r = w0; r < min(w0 + 16, nvalid); ++r) s += to_f32(Zs[r * LD + c]);
    atomicAdd(dbo + c, s);
  }

  const int r0 = q0 + w0 + g;  // this lane's rows r0 and r0 + 8 (of the image)
  const int r1 = r0 + 8;
  for (int h = 0; h < H; ++h) {
    typename F::pair qa[D / 16][4], oa[D / 16][4];
    project_q<T, D>(Ls + w0 * LD, LD, wq, bq, C, h, qs + rb * C, q0 + w0, N, qa);

    // doh_h = dz Wo_h (wot = Wo^T, (in, out)), rounded; delta = rowsum(doh * o)
    float dacc[D / 8][4];
    zero_acc(dacc);
    rowmm<T, D / 8>(Zs + w0 * LD, LD, wot, C, h * D, dacc);
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = h * D + nt * 8 + 2 * t;
#pragma unroll
      for (int e = 0; e < 4; ++e) dacc[nt][e] = rnd<T>(dacc[nt][e]);
      if (r0 < N) {
        const long at = (rb + r0) * C + col;
        F::store(dohs + at, dacc[nt][0], dacc[nt][1]);
        d0 += dacc[nt][0] * to_f32(o[at]) + dacc[nt][1] * to_f32(o[at + 1]);
      }
      if (r1 < N) {
        const long at = (rb + r1) * C + col;
        F::store(dohs + at, dacc[nt][2], dacc[nt][3]);
        d1 += dacc[nt][2] * to_f32(o[at]) + dacc[nt][3] * to_f32(o[at + 1]);
      }
    }
    repack<T, D / 16>(dacc, oa);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 1);
    d0 += __shfl_xor_sync(0xffffffffu, d0, 2);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 1);
    d1 += __shfl_xor_sync(0xffffffffu, d1, 2);
    const long lh = ((long)b * H + h) * N;
    if (t == 0) {
      if (r0 < N) delta[lh + r0] = d0;
      if (r1 < N) delta[lh + r1] = d1;
    }
    // rows past N: p = 0
    const float L0 = r0 < N ? lse[lh + r0] : INFINITY;
    const float L1 = r1 < N ? lse[lh + r1] : INFINITY;

    const T* kh = k + (long)b * M * C + h * D;
    const T* vh = v + (long)b * M * C + h * D;
    float acc[D / 8][4];
    zero_acc(acc);
    for (int k0 = 0; k0 < M; k0 += BK) {
      __syncthreads();
      load_rows<T, D, false>(kh, k0, M, C, Ks, KLD);
      load_rows<T, D, false>(vh, k0, M, C, Vs, KLD);
      load_rows<T, D, true>(kh, k0, M, C, Kt, VLD);
      __syncthreads();
      float s[BK / 8][4], dp[BK / 8][4];
      scores<T, D>(qa, Ks, KLD, s);
      scores<T, D>(oa, Vs, KLD, dp);
      const int valid = M - k0;
#pragma unroll
      for (int nt = 0; nt < BK / 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const bool in = nt * 8 + 2 * t + e < valid;
          const float p0 = in ? exp2f(s[nt][e] * qscale - L0) : 0.f;
          const float p1 = in ? exp2f(s[nt][2 + e] * qscale - L1) : 0.f;
          s[nt][e] = p0 * (dp[nt][e] - d0);  // ds
          s[nt][2 + e] = p1 * (dp[nt][2 + e] - d1);
        }
      accumulate<T, D>(s, Kt, VLD, acc);
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      const int col = h * D + nt * 8 + 2 * t;
      if (r0 < N) F::store(dqs + (rb + r0) * C + col, acc[nt][0] * scale, acc[nt][1] * scale);
      if (r1 < N) F::store(dqs + (rb + r1) * C + col, acc[nt][2] * scale, acc[nt][3] * scale);
    }
  }
  __syncthreads();  // every warp is done with Zs and Ls: DL goes over them

  // dln = dq Wq (wqt = Wq^T, (in, out)) for the warp's rows, 32 columns at a
  // time; dq comes back from device memory (rows past the image are padding
  // the wrapper allocates and are never stored)
  __syncwarp();
  for (int n0 = 0; n0 < C; n0 += 32) {
    float z[4][4];
    zero_acc(z);
    rowmm<T, 4>(dqs + (rb + q0 + w0) * C, C, wqt, C, n0, z);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = n0 + nt * 8 + 2 * t;
      DL[(w0 + g) * DLD + col] = z[nt][0];
      DL[(w0 + g) * DLD + col + 1] = z[nt][1];
      DL[(w0 + g + 8) * DLD + col] = z[nt][2];
      DL[(w0 + g + 8) * DLD + col + 1] = z[nt][3];
    }
  }
  __syncwarp();

  // the LN backward of each row, and the column sums of the warp's rows
  constexpr int CJ = MAX_C / 32;
  float sg[CJ], sb[CJ], sq[CJ];
#pragma unroll
  for (int j = 0; j < CJ; ++j) sg[j] = sb[j] = sq[j] = 0.f;
  const int nj = C / 32;
  for (int r = w0; r < min(w0 + 16, nvalid); ++r) {
    const long row = (rb + q0 + r) * C;
    const float m = mu[r], rsig = rs[r];
    float xh[CJ], gl[CJ], s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      if (j >= nj) break;
      const int c = lane + 32 * j;
      const float dl = DL[r * DLD + c];
      xh[j] = (to_f32(x[row + c]) - m) * rsig;
      gl[j] = dl * lg[c];
      s1 += gl[j];
      s2 += gl[j] * xh[j];
      sg[j] += dl * xh[j];
      sb[j] += dl;
      sq[j] += to_f32(dqs[row + c]);
    }
    s1 = warp_sum(s1) / C;
    s2 = warp_sum(s2) / C;
#pragma unroll
    for (int j = 0; j < CJ; ++j) {
      if (j >= nj) break;
      const int c = lane + 32 * j;
      dx[row + c] = from_f32<T>(to_f32(gout[row + c]) + rsig * (gl[j] - s1 - xh[j] * s2));
    }
  }
#pragma unroll
  for (int j = 0; j < CJ; ++j) {
    if (j >= nj) break;
    const int c = lane + 32 * j;
    atomicAdd(dlg + c, sg[j]);
    atomicAdd(dlb + c, sb[j]);
    atomicAdd(dbq + c, sq[j]);
  }
}

// out[i][j] += sum_r a[r][i] * bm[r][j] over this block's chunk of the R rows,
// for its 64 x 64 tile of the (C, C) output
template <typename T>
__global__ void __launch_bounds__(THREADS)
wgrad_kernel(const T* __restrict__ a, const T* __restrict__ bm, float* __restrict__ out, int R,
             int C, int rows_per_split) {
  using F = Frag<T>;
  constexpr int TLD = 64 + 8;
  constexpr int VE = 16 / sizeof(T);
  __shared__ __align__(16) T At[64 * TLD];  // a transposed [i][r]
  __shared__ __align__(16) T Bt[64 * TLD];  // bm transposed [j][r]
  const int tid = threadIdx.x;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * 64;
  const int rbeg = blockIdx.z * rows_per_split;
  const int rend = min(R, rbeg + rows_per_split);
  float acc[8][4];
  zero_acc(acc);
  for (int r0 = rbeg; r0 < rend; r0 += 64) {
    __syncthreads();
    for (int idx = tid; idx < 64 * (64 / VE); idx += THREADS) {
      const int r = idx / (64 / VE), c = (idx % (64 / VE)) * VE;
      uint4 va = make_uint4(0u, 0u, 0u, 0u), vb = va;
      if (r0 + r < rend) {
        if (i0 + c < C) va = *reinterpret_cast<const uint4*>(a + (long)(r0 + r) * C + i0 + c);
        if (j0 + c < C) vb = *reinterpret_cast<const uint4*>(bm + (long)(r0 + r) * C + j0 + c);
      }
      const T* ea = reinterpret_cast<const T*>(&va);
      const T* eb = reinterpret_cast<const T*>(&vb);
#pragma unroll
      for (int e = 0; e < VE; ++e) {
        At[(c + e) * TLD + r] = ea[e];
        Bt[(c + e) * TLD + r] = eb[e];
      }
    }
    __syncthreads();
    const T* aw = At + warp * 16 * TLD;
#pragma unroll
    for (int kc = 0; kc < 64; kc += 16) {
      const typename F::pair af[4] = {
          F::load(aw + g * TLD + kc + 2 * t), F::load(aw + (g + 8) * TLD + kc + 2 * t),
          F::load(aw + g * TLD + kc + 8 + 2 * t), F::load(aw + (g + 8) * TLD + kc + 8 + 2 * t)};
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const T* br = Bt + (nt * 8 + g) * TLD + kc + 2 * t;
        F::mma(acc[nt], af, F::load(br), F::load(br + 8));
      }
    }
  }
  const int ia = i0 + warp * 16 + g, ib = ia + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int j = j0 + nt * 8 + 2 * t;
    if (j >= C) continue;  // C is even: j + 1 < C too
    if (ia < C) {
      atomicAdd(out + (long)ia * C + j, acc[nt][0]);
      atomicAdd(out + (long)ia * C + j + 1, acc[nt][1]);
    }
    if (ib < C) {
      atomicAdd(out + (long)ib * C + j, acc[nt][2]);
      atomicAdd(out + (long)ib * C + j + 1, acc[nt][3]);
    }
  }
}

template <typename T>
cudaError_t launch_wgrad(const T* a, const T* bm, float* out, int R, int C, cudaStream_t st) {
  const int tiles = (C + 63) / 64;
  const int chunks = (R + 63) / 64;
  int split = (2 * 132 + tiles * tiles - 1) / (tiles * tiles);  // two blocks per SM
  split = max(1, min(split, chunks));
  const int per = (chunks + split - 1) / split * 64;
  dim3 grid(tiles, tiles, (R + per - 1) / per);
  wgrad_kernel<T><<<grid, THREADS, 0, st>>>(a, bm, out, R, C, per);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const void* x, const void* k, const void* v, const float* lg, const float* lb,
                   const void* wq, const void* bq, const void* wot, const void* wqt,
                   const float* fac, const void* g, const void* o, const float* lse, void* dx,
                   float* dk, float* dv, float* dlg, float* dlb, float* dwq, float* dbq,
                   float* dwo, float* dbo, void* lns, void* qs, void* dzs, void* dohs, void* dqs,
                   float* delta, int B, int N, int M, int C, float scale, cudaStream_t st) {
  const int H = C / D;
  const float qscale = scale * LOG2E;
  const int bytes = (2 * BQ * (C + 8) + 2 * BK * (D + 8) + D * (BK + 8)) * (int)sizeof(T) +
                    2 * BQ * 4;
  auto kdq = attn_block_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(kdq, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const T* tx = static_cast<const T*>(x);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  T* tq = static_cast<T*>(qs);
  T* tdoh = static_cast<T*>(dohs);
  kdq<<<dim3((N + BQ - 1) / BQ, B), THREADS, bytes, st>>>(
      tx, tk, tv, lg, lb, static_cast<const T*>(wq), static_cast<const T*>(bq),
      static_cast<const T*>(wot), static_cast<const T*>(wqt), fac, static_cast<const T*>(g),
      static_cast<const T*>(o), lse, static_cast<T*>(dx), static_cast<T*>(lns), tq,
      static_cast<T*>(dzs), tdoh, static_cast<T*>(dqs), delta, dlg, dlb, dbq, dbo, N, M, C,
      qscale, scale);
  if ((err = cudaGetLastError())) return err;

  // K1b's dk/dv kernel on the q and doh written above
  const int per = ::rows_per_split(N, M, B * H);
  const dim3 grid_kv((M + ::BQ - 1) / ::BQ, B * H, (N + per - 1) / per);
  if constexpr (std::is_same<T, float>::value) {
    auto kkv = ::f32::dkdv_kernel<D>;
    constexpr int b2 = ::f32::dkdv_bytes<D>();
    if ((err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, b2)))
      return err;
    kkv<<<grid_kv, ::THREADS, b2, st>>>(tq, tk, tv, tdoh, lse, delta, dk, dv, N, M, H, qscale,
                                        scale, per);
  } else {
    auto kkv = ::tc::dkdv_kernel<D>;
    constexpr int b2 = ::tc::dkdv_bytes<D>();
    if ((err = cudaFuncSetAttribute(kkv, cudaFuncAttributeMaxDynamicSharedMemorySize, b2)))
      return err;
    kkv<<<grid_kv, ::THREADS, b2, st>>>(tq, tk, tv, tdoh, lse, delta, dk, dv, N, M, H, qscale,
                                        scale, per);
  }
  if ((err = cudaGetLastError())) return err;

  if ((err = launch_wgrad<T>(static_cast<const T*>(dqs), static_cast<const T*>(lns), dwq, B * N,
                             C, st)))
    return err;
  return launch_wgrad<T>(static_cast<const T*>(dzs), static_cast<const T*>(o), dwo, B * N, C, st);
}

template <typename T>
cudaError_t dispatch(int D, const void* x, const void* k, const void* v, const float* lg,
                     const float* lb, const void* wq, const void* bq, const void* wot,
                     const void* wqt, const float* fac, const void* g, const void* o,
                     const float* lse, void* dx, float* dk, float* dv, float* dlg, float* dlb,
                     float* dwq, float* dbq, float* dwo, float* dbo, void* lns, void* qs,
                     void* dzs, void* dohs, void* dqs, float* delta, int B, int N, int M, int C,
                     float scale, cudaStream_t st) {
  switch (D) {
    case 32:
      return launch<T, 32>(x, k, v, lg, lb, wq, bq, wot, wqt, fac, g, o, lse, dx, dk, dv, dlg,
                           dlb, dwq, dbq, dwo, dbo, lns, qs, dzs, dohs, dqs, delta, B, N, M, C,
                           scale, st);
    case 64:
      return launch<T, 64>(x, k, v, lg, lb, wq, bq, wot, wqt, fac, g, o, lse, dx, dk, dv, dlg,
                           dlb, dwq, dbq, dwo, dbo, lns, qs, dzs, dohs, dqs, delta, B, N, M, C,
                           scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace
}  // namespace ab

// wq (C, C) as (out, in); wot = Wo^T and wqt = Wq^T, (in, out); o and lse as
// K3f wrote them. dk, dv (B, M, C) and dlg .. dbo: zeroed float32. Scratch:
// lns, qs, dzs, dohs, dqs (B * N + 64, C) in x's type, delta (B, H, N) float32.
SFT_EXPORT int sft_attn_block_bwd(const void* x, const void* k, const void* v, const void* lg,
                                  const void* lb, const void* wq, const void* bq, const void* wot,
                                  const void* wqt, const void* fac, const void* g, const void* o,
                                  const void* lse, void* dx, void* dk, void* dv, void* dlg,
                                  void* dlb, void* dwq, void* dbq, void* dwo, void* dbo,
                                  void* lns, void* qs, void* dzs, void* dohs, void* dqs,
                                  void* delta, int B, int N, int M, int C, int D, float scale,
                                  int dtype, void* stream) {
  using ab::MAX_C;
  if (B < 1 || N < 1 || M < 1 || C % 32 || C > MAX_C || C % D) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto fp = [](const void* p) { return static_cast<const float*>(p); };
  auto fw = [](void* p) { return static_cast<float*>(p); };
  if (dtype == SFT_F32)
    return ab::dispatch<float>(D, x, k, v, fp(lg), fp(lb), wq, bq, wot, wqt, fp(fac), g, o,
                               fp(lse), dx, fw(dk), fw(dv), fw(dlg), fw(dlb), fw(dwq), fw(dbq),
                               fw(dwo), fw(dbo), lns, qs, dzs, dohs, dqs, fw(delta), B, N, M, C,
                               scale, st);
  if (dtype == SFT_BF16)
    return ab::dispatch<__nv_bfloat16>(D, x, k, v, fp(lg), fp(lb), wq, bq, wot, wqt, fp(fac), g,
                                       o, fp(lse), dx, fw(dk), fw(dv), fw(dlg), fw(dlb), fw(dwq),
                                       fw(dbq), fw(dwo), fw(dbo), lns, qs, dzs, dohs, dqs,
                                       fw(delta), B, N, M, C, scale, st);
  return cudaErrorInvalidValue;
}
