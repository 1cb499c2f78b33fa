// The attention-forward core on Hopper, shared by K1f (sra_attention.cu,
// one (batch, head) a block) and K3f (attn_block.cu, every head of a row
// tile in turn): one consumer warpgroup's walk over a ring of K/V tiles
// that a producer warp fills by TMA.
//
// Per 64-key tile: S = Q K^T on wgmma (Q and K both K-major in swizzled
// shared memory), the online softmax in exp2 on the score registers
// (warp w of the warpgroup holds query rows 16w..16w+15 in mma.sync's
// fragment layout), the exponentials packed as P, wgmma's register A
// operand, and O += P V with V read MN-major through the transpose bit.
// The next tile's S goes to the tensor cores while this tile's
// exponentials run. Keys past M get -inf (only the last tile of a
// head has any; key 0 of a tile is always valid).
#pragma once

#include "sm90.cuh"

namespace attn_fwd {

using namespace sm90;

constexpr int STAGES = 2;  // K/V tiles in flight

// One consumer thread's share of a head's 64 query rows: the output
// accumulator (wgmma's layout, 8-column tiles), and the running max m (in
// the log2e-scaled domain) and this lane's share of the row sum l of its
// rows g and g + 8.
template <int D>
struct State {
  float acc[D / 2];
  float m0, m1, l0, l1;
};

// IN_PLACE: the exponentials overwrite the score registers before they are
// packed into P's fragments. ptxas then serializes wgmmas around those
// writes (C7515: the registers are a product's accumulators), yet K1f runs
// 5-14 % faster so at MiT's stages 1-3 on the H100; K3f runs 8-15 % faster
// with them packed straight from the scores (tools/kernel_variants.py).
//
// Walk the `ntiles` K/V tiles of one head against the 64 x D Q tile `q`
// (rows of ROW = D * 2 bytes, the swizzle of the same width, as TMA writes
// it). Tile t is the ring's T = T0 + t: stage T % STAGES of `k_ring` and
// `v_ring` (`tile_bytes` a stage), complete on full[stage]; the stage is
// freed on empty[stage] once the products that read it are done.
template <int D, int ROW, bool IN_PLACE>
__device__ __forceinline__ void run(const uint8_t* q, const uint8_t* k_ring,
                                    const uint8_t* v_ring, int tile_bytes, uint64_t* full,
                                    uint64_t* empty, int T0, int ntiles, int M, float qscale,
                                    State<D>& st) {
  constexpr int NO = D / 8;  // 8-column output tiles
  const int t4 = threadIdx.x & 3;
#pragma unroll
  for (int i = 0; i < D / 2; ++i) st.acc[i] = 0.f;
  st.m0 = st.m1 = -INFINITY;
  st.l0 = st.l1 = 0.f;

  // S = Q K_T^T into `sc` (issued, not waited for)
  auto issue_s = [&](float (&sc)[32], int T) {
    const int s = T % STAGES;
    mbar_wait(full + s, (T / STAGES) & 1);
    const uint8_t* ks = k_ring + s * tile_bytes;
    fence_regs(sc);
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < D / 16; ++kc)
      wgmma_ss_m64n64<0, 0>(sc, make_desc(q + kc * 32, ROW, false),
                            make_desc(ks + kc * 32, ROW, false), kc > 0);
    wgmma_commit();
  };
  auto step = [&](float (&sc)[32], float (&next)[32], int t) {
    const int T = T0 + t;
    const int valid = M - t * 64;
    if (valid < 64) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e)
          if (nt * 8 + 2 * t4 + e >= valid) sc[4 * nt + e] = sc[4 * nt + 2 + e] = -INFINITY;
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      mx0 = fmaxf(mx0, fmaxf(sc[4 * nt], sc[4 * nt + 1]));
      mx1 = fmaxf(mx1, fmaxf(sc[4 * nt + 2], sc[4 * nt + 3]));
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float n0 = fmaxf(st.m0, mx0 * qscale), n1 = fmaxf(st.m1, mx1 * qscale);
    const float c0 = fast_exp2(st.m0 - n0), c1 = fast_exp2(st.m1 - n1);
    st.m0 = n0;
    st.m1 = n1;
    // the output is rescaled before the next tile's S is issued: no
    // accumulator of a product in flight is written meanwhile
#pragma unroll
    for (int nt = 0; nt < NO; ++nt) {
      st.acc[4 * nt + 0] *= c0;
      st.acc[4 * nt + 1] *= c0;
      st.acc[4 * nt + 2] *= c1;
      st.acc[4 * nt + 3] *= c1;
    }
    fence_regs(st.acc);
    if (t + 1 < ntiles) issue_s(next, T + 1);
    // p = 2^(s * qscale - m) as P's A fragments for P V (two score tiles a
    // 16-key slice; r odd is row g + 8), the row sums in the same order
    float ps0 = 0.f, ps1 = 0.f;
    uint32_t pa[4][4];
    if constexpr (IN_PLACE) {
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        sc[4 * nt + 0] = fast_exp2(fmaf(sc[4 * nt + 0], qscale, -n0));
        sc[4 * nt + 1] = fast_exp2(fmaf(sc[4 * nt + 1], qscale, -n0));
        sc[4 * nt + 2] = fast_exp2(fmaf(sc[4 * nt + 2], qscale, -n1));
        sc[4 * nt + 3] = fast_exp2(fmaf(sc[4 * nt + 3], qscale, -n1));
        ps0 += sc[4 * nt + 0] + sc[4 * nt + 1];
        ps1 += sc[4 * nt + 2] + sc[4 * nt + 3];
      }
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kc][r] = pack_bf16(sc[8 * kc + 2 * r], sc[8 * kc + 2 * r + 1]);
    } else {
#pragma unroll
      for (int kc = 0; kc < 4; ++kc)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float nr = (r & 1) ? n1 : n0;
          const float e0 = fast_exp2(fmaf(sc[8 * kc + 2 * r], qscale, -nr));
          const float e1 = fast_exp2(fmaf(sc[8 * kc + 2 * r + 1], qscale, -nr));
          if (r & 1) ps1 += e0 + e1;
          else ps0 += e0 + e1;
          pa[kc][r] = pack_bf16(e0, e1);
        }
    }
    st.l0 = st.l0 * c0 + ps0;
    st.l1 = st.l1 * c1 + ps1;

    // O += P V over 16-key slices
    const uint8_t* vs = v_ring + (T % STAGES) * tile_bytes;
    wgmma_fence();
#pragma unroll
    for (int kc = 0; kc < 4; ++kc) {
      const uint64_t dv = make_desc(vs + kc * 16 * ROW, ROW, true);
      if constexpr (D == 64) wgmma_rs_m64n64<1>(st.acc, pa[kc], dv);
      else wgmma_rs_m64n32<1>(st.acc, pa[kc], dv);
    }
    wgmma_commit();
    wgmma_wait_all();  // P V and the next tile's S
    fence_regs(st.acc);
    fence_regs(next);
    mbar_arrive(empty + T % STAGES);
  };

  float sa[32], sb[32];  // the score tiles of even and odd t
  issue_s(sa, T0);
  wgmma_wait_all();
  fence_regs(sa);
  for (int t = 0; t < ntiles; t += 2) {
    step(sa, sb, t);
    if (t + 1 < ntiles) step(sb, sa, t + 1);
  }
}

// The rows' sums over the quad; 1 / l for the output and the log2-domain
// log-sum-exp m + log2 l (the backward's lse) of rows g and g + 8.
template <int D>
__device__ __forceinline__ void finish(State<D>& st, float& inv0, float& inv1, float& lse0,
                                       float& lse1) {
  float l0 = st.l0, l1 = st.l1;
  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  inv0 = 1.f / l0;
  inv1 = 1.f / l1;
  lse0 = st.m0 + log2f(l0);
  lse1 = st.m1 + log2f(l1);
}

}  // namespace attn_fwd
