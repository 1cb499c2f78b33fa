// Hopper (sm_90a) building blocks shared by the kernels that run on wgmma:
// mbarriers, TMA tile loads, wgmma shared-memory descriptors and the wgmma
// instructions themselves (inline PTX, so that nvcc stays fast: no CUTLASS
// or CuTe headers), the host-side tensor-map encoding, and the GEMM of the
// Mix-FFN and attention half-block backwards (exported by mixffn_bwd.cu; its
// callers are K2b, K4b and K3b).
//
// Shared-memory tiles are loaded by TMA with the 128-byte (64 bf16 per
// row) or 64-byte (32 bf16 per row) swizzle and read by wgmma through
// descriptors of the same swizzle: a K-major operand (its contraction index
// contiguous) steps 32 bytes per k16 slice inside a row; an MN-major one
// (the transpose bit of 16-bit wgmma) steps 16 rows per slice.
//
// cuTensorMapEncodeTiled lives in libcuda, and the libraries link the CUDA
// runtime only: it is looked up once with dlsym in libcuda.so.1, which every
// process that has a CUDA context has loaded.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <algorithm>
#include <type_traits>

#include "common.cuh"

namespace sm90 {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---------------------------------------------------------------- mbarriers

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
// make the initialised barriers visible to the other threads and to TMA
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// wait until the barrier's phase of parity `parity` has completed; a wait
// that never ends (a fault in the pipeline) traps, failing the launch
// instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done;
  uint32_t polls = 0;
  do {
    if (++polls == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---------------------------------------------------------------- TMA loads

__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, uint64_t* bar,
                                            int c0, int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_addr(bar)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3)
      : "memory");
}

// `bytes` (a multiple of 16) of contiguous memory at a 16-byte aligned
// address, completing on `bar` as a TMA tile load does
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// a barrier among the `count` threads (a multiple of 32) that name `id`
// (1..15; __syncthreads is 0), e.g. the consumer warps once the producer
// warp has left
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// the dynamic shared memory's start rounded up to 1024 bytes, the alignment
// of the 128-byte swizzle's atoms
__device__ __forceinline__ uint8_t* align_1024(uint8_t* p) {
  return reinterpret_cast<uint8_t*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                    ~static_cast<uintptr_t>(1023));
}

// Byte offset of 16-byte chunk `c16` of row `r` in a tile of `row_bytes`
// (128 or 64) rows laid out as TMA writes it with the swizzle of that width
// (the tile 1024-byte aligned): how threads store an operand that wgmma
// then reads through make_desc.
__device__ __forceinline__ int swz(int r, int c16, int row_bytes) {
  return row_bytes == 128 ? r * 128 + ((c16 ^ (r & 7)) << 4)
                          : r * 64 + ((c16 ^ ((r >> 1) & 3)) << 4);
}

// LayerNorm in place (common.cuh: float32 statistics, the fast variance
// clipped at 0, eps 1e-6) of rows 0 .. nrows - 1 of a 128B-swizzled bf16
// tile that TMA loaded (64-column blocks `blk_bytes` apart, C channels, a
// multiple of 8 up to 256 CPL), by the `warps` warps that call it (warp
// index `warp`): a row takes the smallest power of two of lanes that holds
// its C / 8 16-byte chunks (at most 32, CPL chunks a lane), so a warp
// normalises 32 / lanes rows at once, and U such groups' reductions
// interleave. The rows come out normalised and rounded: the wgmma operand
// of the product after.
template <int U, int CPL>
__device__ __forceinline__ void ln_tile(uint8_t* tile, int blk_bytes, int warp, int warps,
                                        int nrows, int C, const float* lg, const float* lb) {
  const int lane = threadIdx.x & 31, nch = C / 8;
  int seg = 32;
  while (seg / 2 >= nch) seg /= 2;
  const int per = 32 / seg, sub = lane / seg, cl = lane % seg;
  float gv[CPL][8], bv[CPL][8];  // this lane's channels of the scale and bias, once
#pragma unroll
  for (int i = 0; i < CPL; ++i)
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      const int c = (cl + seg * i) * 8 + k;
      gv[i][k] = c < C ? lg[c] : 0.f;
      bv[i][k] = c < C ? lb[c] : 0.f;
    }
  for (int g0 = warp; g0 * per < nrows; g0 += U * warps) {
    uint4 raw[U][CPL];
    float sum[U], sq[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = (g0 + u * warps) * per + sub;
      sum[u] = sq[u] = 0.f;
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int ch = cl + seg * i;
        raw[u][i] = r < nrows && ch < nch
                        ? *reinterpret_cast<const uint4*>(tile + (ch >> 3) * blk_bytes +
                                                          swz(r, ch & 7, 128))
                        : make_uint4(0u, 0u, 0u, 0u);
        const bf16* e = reinterpret_cast<const bf16*>(&raw[u][i]);
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          const float f = __bfloat162float(e[k]);
          sum[u] += f;
          sq[u] += f * f;
        }
      }
    }
    for (int o = seg / 2; o > 0; o >>= 1)
#pragma unroll
      for (int u = 0; u < U; ++u) {
        sum[u] += __shfl_xor_sync(0xffffffffu, sum[u], o);
        sq[u] += __shfl_xor_sync(0xffffffffu, sq[u], o);
      }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int r = (g0 + u * warps) * per + sub;
      const float mu = sum[u] / C, rs = rsqrtf(fmaxf(sq[u] / C - mu * mu, 0.f) + LN_EPS);
#pragma unroll
      for (int i = 0; i < CPL; ++i) {
        const int ch = cl + seg * i;
        if (r >= nrows || ch >= nch) continue;
        bf16* e = reinterpret_cast<bf16*>(&raw[u][i]);
#pragma unroll
        for (int k = 0; k < 8; ++k)
          e[k] = __float2bfloat16((__bfloat162float(e[k]) - mu) * rs * gv[i][k] + bv[i][k]);
        *reinterpret_cast<uint4*>(tile + (ch >> 3) * blk_bytes + swz(r, ch & 7, 128)) = raw[u][i];
      }
    }
  }
}

// ---------------------------------------------------------------- wgmma

// Shared-memory matrix descriptor of a swizzled tile whose rows are
// `row_bytes` (64 or 128) long, rows 0..7 forming one swizzle atom:
// K-major, the 8-row groups `8 * row_bytes` apart (SBO) and the leading
// offset unused; MN-major, the 8-row (k) groups at the same distance, which
// the leading offset repeats (the operand's MN extent is one atom wide, so
// either reading gives the same address).
__device__ __forceinline__ uint64_t make_desc(const void* tile, int row_bytes, bool mn_major) {
  const uint32_t group = 8 * row_bytes;
  const uint64_t lbo = mn_major ? group : 16;
  uint64_t d = (smem_addr(tile) & 0x3FFFF) >> 4;
  d |= (lbo >> 4) << 16;
  d |= static_cast<uint64_t>(group >> 4) << 32;
  d |= static_cast<uint64_t>(row_bytes == 128 ? 1 : 2) << 62;  // 128B / 64B swizzle
  return d;
}

// 2^x on the special-function unit (flush-to-zero; 2^-inf = 0)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Pin registers in place around wgmma: the compiler may not move their
// reads or writes across this point (accumulators are read only after the
// wait, and written before the product that reads them is issued).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// the same for A fragments in registers: kept until the product reading
// them has been waited for, so that their registers are not reused meanwhile
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// order this thread's generic-proxy writes to shared memory before later
// async-proxy reads (wgmma operands written by the threads themselves)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// D (64 x N float32, the accumulator layout below) += A . B (D = A . B when
// `accumulate` is 0) with the
// operands in shared memory (descriptors; TA / TB = 1 for MN-major) or A in
// registers (the m16n8k16 A fragments of each warp's 16 rows). Accumulator
// of thread (warp w of the warpgroup, lane = 4 g + t): d[4 j + 2 h + e] =
// D[16 w + g + 8 h][8 j + 2 t + e], the layout of mma.sync m16n8k16's D
// fragment per 8 columns.
template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t da, uint64_t db,
                                                int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, %32, %33, p, 1, 1, %35, %36;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TA, int TB>
__device__ __forceinline__ void wgmma_ss_m64n32(float (&d)[16], uint64_t da, uint64_t db,
                                                int accumulate = 1) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, %16, %17, p, 1, 1, %19, %20;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TA), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n64(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}

template <int TB>
__device__ __forceinline__ void wgmma_rs_m64n32(float (&d)[16], const uint32_t (&a)[4],
                                                uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15}, {%16, %17, %18, %19}, %20, p, 1, 1, %22;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1), "n"(TB));
}


// ---------------------------------------------------------------- host: tensor maps

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_LAZY | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_LAZY);
    return lib ? reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled")) : nullptr;
  }();
  return fn;
}

// A bf16 tensor map of `rank` dimensions (innermost first, `strides` in
// bytes for dimensions 1..rank-1) loading `box`; the swizzle is the box's
// row, box[0] * 2 bytes (128 or 64). Reads past the edges fill zeros.
inline cudaError_t make_map(CUtensorMap* map, const void* ptr, int rank, const cuuint64_t* dims,
                            const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return cudaErrorSharedObjectSymbolNotFound;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  const CUresult r =
      fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(ptr), dims, strides, box,
         ones, CU_TENSOR_MAP_INTERLEAVE_NONE,
         box[0] * 2 == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
         CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// A (B, rows, H, D) bf16 tensor (the attention kernels' q, k, v, o layout)
// as a 4-D map {D, H, rows, B} whose boxes are one head's 64 rows; rows
// past `rows` fill with zeros.
inline cudaError_t head_map(CUtensorMap* map, const void* p, int B, int rows, int H, int D) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(rows), static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)rows * H * D * 2};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(D), 1, 64, 1};
  return make_map(map, p, 4, dims, strides, box);
}

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------- GEMM
//
// out = A . B over a contraction of length K, in three forms (FORM):
// - NT: A (M, K) and B (N, K) row-major (both K-major), out (M, N) stored,
//   float32 or in the operands' type, plus an optional per-column bias;
// - NN: A (M, K) row-major as in NT, B (K, N) row-major (MN-major, read as
//   in TN), with NT's epilogue: a weight in its own (in, out) layout, no
//   transposed copy;
// - TN: A (K, M) and B (K, N) row-major (both MN-major), out (M, N) float32,
//   or (N, M) with `trans`, added with atomics into a zeroed buffer: the
//   contraction (the pixels) is split over blockIdx.z so that the grid
//   fills the card, and every split adds its partial once per element.
// bfloat16 runs on wgmma: a 128 x 64 tile per block, two consumer
// warpgroups of 64 rows and one producer warp that keeps a ring of four
// 64-deep stages of TMA loads in flight. float32 runs the same contract on
// FMAs (the check path).
constexpr int NT = 0, TN = 1, NN = 2;

struct GemmEpi {
  float* out_f;       // float32 output (NT, NN) or the zeroed sum (TN)
  void* out_t;        // NT, NN: the output in the operands' type instead
  const void* bias;   // NT, NN: (N,) bias in the operands' type, or null
  int trans;          // TN: out_f is (N, M)
};

constexpr int GBM = 128, GBN = 64, GBK = 64, GST = 4;
constexpr int G_A = GBM * GBK * 2, G_B = GBN * GBK * 2;
constexpr int G_THREADS = 288;  // two consumer warpgroups + the producer warp
constexpr int G_SMEM = GST * (G_A + G_B) + 2 * GST * 8 + 1024;
constexpr int FBM = 64, FBK = 16;  // float32 tile

__device__ __forceinline__ void store2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void store2(bf16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// output columns n, n + 1 of row m (N is even)
template <typename T, int FORM>
__device__ __forceinline__ void gemm_store(const GemmEpi& e, int M, int N, int m, int n, float v0,
                                           float v1) {
  if (m >= M || n >= N) return;
  if (FORM == TN) {
    if (e.trans) {
      atomicAdd(e.out_f + (long)n * M + m, v0);
      atomicAdd(e.out_f + (long)(n + 1) * M + m, v1);
    } else {  // one vector atomic for the adjacent pair (N is even)
      atomicAdd(reinterpret_cast<float2*>(e.out_f + (long)m * N + n), make_float2(v0, v1));
    }
    return;
  }
  if (e.bias != nullptr) {
    const T* b = static_cast<const T*>(e.bias);
    v0 += to_f32(b[n]);
    v1 += to_f32(b[n + 1]);
  }
  if (e.out_t != nullptr) store2(static_cast<T*>(e.out_t) + (long)m * N + n, v0, v1);
  else store2(e.out_f + (long)m * N + n, v0, v1);
}

template <int FORM>
__global__ void __launch_bounds__(G_THREADS, 1)
gemm_wgmma_kernel(const __grid_constant__ CUtensorMap ta, const __grid_constant__ CUtensorMap tb,
                  GemmEpi epi, int M, int N, int K, int kt_per) {
  constexpr bool A_MN = FORM == TN, B_MN = FORM != NT;  // which operands are MN-major
  extern __shared__ uint8_t gemm_smem[];
  uint8_t* As = align_1024(gemm_smem);
  uint8_t* Bs = As + GST * G_A;
  uint64_t* full = reinterpret_cast<uint64_t*>(Bs + GST * G_B);
  uint64_t* empty = full + GST;
  const int m0 = blockIdx.x * GBM, n0 = blockIdx.y * GBN;
  const int kt0 = blockIdx.z * kt_per, kt1 = min(kt0 + kt_per, cdiv(K, GBK));
  const int tid = threadIdx.x, warp = tid >> 5;
  if (tid == 0) {
    for (int s = 0; s < GST; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, G_THREADS - 32);
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // producer: one lane issues the loads
    if ((tid & 31) == 0) {
      for (int kt = kt0; kt < kt1; ++kt) {
        const int i = kt - kt0, s = i % GST;
        mbar_wait(empty + s, ((i / GST) & 1) ^ 1);
        mbar_expect_tx(full + s, G_A + G_B);
        uint8_t* a = As + s * G_A;
        uint8_t* b = Bs + s * G_B;
        if (A_MN) {  // (64 k) x (64 m) boxes: one per consumer warpgroup
          tma_load_2d(a, &ta, full + s, m0, kt * GBK);
          tma_load_2d(a + G_A / 2, &ta, full + s, m0 + 64, kt * GBK);
        } else {     // (128 m) x (64 k)
          tma_load_2d(a, &ta, full + s, kt * GBK, m0);
        }
        if (B_MN) tma_load_2d(b, &tb, full + s, n0, kt * GBK);  // (64 k) x (64 n)
        else tma_load_2d(b, &tb, full + s, kt * GBK, n0);       // (64 n) x (64 k)
      }
    }
    return;
  }

  const int wg = warp >> 2;  // rows 64 wg .. of the tile
  float acc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) acc[i] = 0.f;
  for (int kt = kt0; kt < kt1; ++kt) {
    const int i = kt - kt0, s = i % GST;
    mbar_wait(full + s, (i / GST) & 1);
    const uint8_t* a = As + s * G_A + wg * (G_A / 2);
    const uint8_t* b = Bs + s * G_B;
    fence_regs(acc);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < GBK / 16; ++kk) {
      // a k16 slice: 16 k-rows of 128 bytes (MN-major) or 16 k-columns, 32
      // bytes, of every row (K-major)
      const uint64_t da = A_MN ? make_desc(a + kk * 2048, 128, true)
                               : make_desc(a + kk * 32, 128, false);
      const uint64_t db = B_MN ? make_desc(b + kk * 2048, 128, true)
                               : make_desc(b + kk * 32, 128, false);
      wgmma_ss_m64n64<A_MN, B_MN>(acc, da, db);
    }
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc);
    mbar_arrive(empty + s);
  }
  const int lane = tid & 31, g = lane >> 2, t = lane & 3;
  const int row = m0 + wg * 64 + (warp & 3) * 16 + g;
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int h = 0; h < 2; ++h)
      gemm_store<bf16, FORM>(epi, M, N, row + 8 * h, n0 + 8 * j + 2 * t, acc[4 * j + 2 * h],
                             acc[4 * j + 2 * h + 1]);
}

// The same contract on FMAs: a 64 x 64 tile per block of 256 threads, each
// owning 4 x 4 outputs, the operands staged 16 deep in shared memory.
template <typename T, int FORM>
__global__ void __launch_bounds__(256)
gemm_fma_kernel(const T* __restrict__ a, const T* __restrict__ b, GemmEpi epi, int M, int N,
                int K, int kt_per) {
  constexpr bool A_MN = FORM == TN, B_MN = FORM != NT;
  __shared__ float As[FBK][FBM + 4], Bs[FBK][GBN + 4];  // [k][m], [k][n]
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int m0 = blockIdx.x * FBM, n0 = blockIdx.y * GBN;
  const int k_lo = blockIdx.z * kt_per * GBK, k_hi = min(K, k_lo + kt_per * GBK);
  float acc[4][4] = {};
  for (int k0 = k_lo; k0 < k_hi; k0 += FBK) {
    for (int idx = tid; idx < FBK * 64; idx += 256) {
      // an MN-major operand is read along rows of the contraction (m / n
      // fastest), a K-major one along rows of m / n
      const int kmn = idx / 64, rmn = idx % 64, kk_ = idx % FBK, rk = idx / FBK;
      {
        const int kk = A_MN ? kmn : kk_, r = A_MN ? rmn : rk, k = k0 + kk, m = m0 + r;
        As[kk][r] = k < k_hi && m < M ? to_f32(A_MN ? a[(long)k * M + m] : a[(long)m * K + k])
                                      : 0.f;
      }
      {
        const int kk = B_MN ? kmn : kk_, r = B_MN ? rmn : rk, k = k0 + kk, n = n0 + r;
        Bs[kk][r] = k < k_hi && n < N ? to_f32(B_MN ? b[(long)k * N + n] : b[(long)n * K + k])
                                      : 0.f;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < FBK; ++kk) {
      const float4 av = *reinterpret_cast<const float4*>(&As[kk][ty * 4]);
      const float4 bv = *reinterpret_cast<const float4*>(&Bs[kk][tx * 4]);
      const float ar[4] = {av.x, av.y, av.z, av.w}, br[4] = {bv.x, bv.y, bv.z, bv.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(ar[i], br[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; j += 2)
      gemm_store<T, FORM>(epi, M, N, m0 + ty * 4 + i, n0 + tx * 4 + j, acc[i][j], acc[i][j + 1]);
}

template <int FORM, typename T>
cudaError_t gemm_form(const T* a, const T* b, GemmEpi epi, int M, int N, int K,
                      cudaStream_t stream) {
  constexpr bool WG = std::is_same<T, bf16>::value;
  constexpr bool A_MN = FORM == TN, B_MN = FORM != NT;
  const int bm = WG ? GBM : FBM;
  const int tiles = cdiv(M, bm) * cdiv(N, GBN), ktiles = cdiv(K, GBK);
  int splits = 1;
  if (FORM == TN)  // >= 4 k-tiles a split
    splits = std::max(1, std::min(cdiv(2 * 132, tiles), ktiles / 4));
  const int kt_per = cdiv(ktiles, splits);
  splits = cdiv(ktiles, kt_per);
  const dim3 grid(cdiv(M, bm), cdiv(N, GBN), splits);
  if constexpr (WG) {
    CUtensorMap ta, tb;
    // innermost dimension first: an MN-major operand (K, M) or (K, N), a
    // K-major one (M, K) or (N, K)
    using u64 = cuuint64_t;
    const cuuint32_t box_a[2] = {64, static_cast<cuuint32_t>(A_MN ? 64 : GBM)}, box_b[2] = {64, 64};
    const u64 da[2] = {static_cast<u64>(A_MN ? M : K), static_cast<u64>(A_MN ? K : M)};
    const u64 db[2] = {static_cast<u64>(B_MN ? N : K), static_cast<u64>(B_MN ? K : N)};
    const cuuint64_t sa[1] = {da[0] * 2}, sb[1] = {db[0] * 2};
    cudaError_t err = make_map(&ta, a, 2, da, sa, box_a);
    if (err == cudaSuccess) err = make_map(&tb, b, 2, db, sb, box_b);
    if (err != cudaSuccess) return err;
    auto kern = gemm_wgmma_kernel<FORM>;
    err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, G_SMEM);
    if (err != cudaSuccess) return err;
    kern<<<grid, G_THREADS, G_SMEM, stream>>>(ta, tb, epi, M, N, K, kt_per);
  } else {
    gemm_fma_kernel<T, FORM><<<grid, 256, 0, stream>>>(a, b, epi, M, N, K, kt_per);
  }
  return cudaGetLastError();
}

// Launch out = A . B in form `form` (NT, TN or NN; see GemmEpi); M, N, K >
// 0, N even, every operand's rows a multiple of 16 bytes.
template <typename T>
cudaError_t gemm(const T* a, const T* b, GemmEpi epi, int M, int N, int K, int form,
                 cudaStream_t stream) {
  switch (form) {
    case NT: return gemm_form<NT>(a, b, epi, M, N, K, stream);
    case TN: return gemm_form<TN>(a, b, epi, M, N, K, stream);
    case NN: return gemm_form<NN>(a, b, epi, M, N, K, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace sm90
