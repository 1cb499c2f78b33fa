// K1b: spatial-reduction attention backward. Given q (B, N, H, D), k and v
// (B, M, H, D), the forward output o, its cotangent dout (both like q) and
// the forward's per-row log2-domain log-sum-exp lse (B, H, N), writes
// dq (like q) and accumulates dk, dv into zeroed float32 (B, M, H, D)
// buffers. With s = q k^T * scale and p = softmax(s):
//   dp = dout v^T, ds = p * (dp - rowsum(dout * o)),
//   dq = ds k * scale, dk = ds^T q * scale, dv = p^T dout.
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_attention.py
// `_backward` (:164, body `_bwd_kernel` :120), which recomputes p for a
// q-tile with one exact softmax over all of M in VMEM, writes dq and
// accumulates dk/dv across the sequential q-tile grid.
//
// What bounds it on the H100: operations (five N x M x D products against
// q/k/v/o/dout read once). Hopper has no sequential grid, so this is the
// FlashAttention-2 split into two kernels, both reading p back from the
// forward's lse instead of re-running the softmax:
// - dq: a block owns 64 query rows and walks K/V in 64-key tiles (S, dP, dS,
//   dQ += dS K); it also writes delta = rowsum(dout * o) for the second.
// - dk/dv: a block owns 64 keys and walks a chunk of the query rows (S^T,
//   dP^T, dV += P^T dout, dK += dS^T q). At stage 1 a block per key tile
//   gives only B*H*M/64 = 32 blocks, so N is split into chunks until the
//   grid covers the 132 SMs twice; the chunks' partial dk/dv meet through
//   float32 atomicAdd (a few thousand per block) into the zeroed buffers.
// - bfloat16 (the training path): every product on the tensor cores
//   (mma.sync m16n8k16, float32 accumulation) with the fragment layout of
//   the forward; p and ds are rounded to bfloat16 as A operands.
// - float32: plain FMAs from shared memory, the forward's float32 layout.
#include "sra_attention_bwd.cuh"


// delta: (B, H, N) float32 scratch; dk, dv: zeroed (B, M, H, D) float32.
SFT_EXPORT int sft_sra_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                     const void* dout, const void* lse, void* delta, void* dq,
                                     void* dk, void* dv, int B, int N, int M, int H, int D,
                                     float scale, int dtype, void* stream) {
  if (B < 1 || N < 1 || M < 1 || H < 1) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  float* fk = static_cast<float*>(dk);
  float* fv = static_cast<float*>(dv);
  const bool bf = dtype == SFT_BF16;
  if (!bf && dtype != SFT_F32) return cudaErrorInvalidValue;
  switch (D) {
    case 32:
      return bf ? launch<32, true>(q, k, v, o, dout, l, dl, dq, fk, fv, B, N, M, H, scale, st)
                : launch<32, false>(q, k, v, o, dout, l, dl, dq, fk, fv, B, N, M, H, scale, st);
    case 64:
      return bf ? launch<64, true>(q, k, v, o, dout, l, dl, dq, fk, fv, B, N, M, H, scale, st)
                : launch<64, false>(q, k, v, o, dout, l, dl, dq, fk, fv, B, N, M, H, scale, st);
    default: return cudaErrorInvalidValue;
  }
}
