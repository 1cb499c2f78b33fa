// K8: label map = argmax over channels of the bilinear upsample of NHWC
// logits lo (B, hl, wl, C) to (B, H, W), int32, first index on ties; the
// upsample is computed in float32 whatever lo's dtype.
//
// Replaces the TPU kernel segmentation_factory_tpu/ops/pallas_loss.py
// `resize_argmax_to` (:377, body `_argmax_kernel` :338), a polyphase upsample
// of dyadic scales in VMEM behind a shape gate.
//
// What bounds it on the H100: bytes (the int32 map written once; the
// low-resolution logits are 1/s^2 of the full-resolution ones), then a
// compare a (pixel, class). Design: lowres_rows.cuh's front end, as K7f's
// (bands x spans of fine pixels, a ring of source rows in shared memory,
// one V row a fine row, rows then columns rounded as the plain version's
// resize, so the logits and hence the labels equal the plain version's
// everywhere). A thread owns 4 adjacent fine pixels of each fine row, walks
// the classes keeping 4 running (max, index) pairs (strictly greater
// replaces: the first index wins a tie, as torch.argmax) and writes them as
// one int4 where W % 4 == 0. Where every two fine columns 2k, 2k + 1
// sample the same two source columns (s >= 4; the geometry's `pairs`,
// uniform over the grid) it loads four values a class for its four pixels,
// else eight. The full-resolution logits never exist. Any output size
// works, which is why no shape gate is carried over.
#include "lowres_rows.cuh"

namespace {

using lowres::Layout;
using lowres::PIXELS;

constexpr int THREADS = 128;  // the most threads a block (transpose_geometry LOWF_THREADS)

// grid (spans, bands, B), g.threads threads; a thread owns fine pixels
// X0 + PIXELS t + j of each fine row of the band
template <typename T>
__global__ void __launch_bounds__(THREADS)
resize_argmax_kernel(const T* __restrict__ lo, int* __restrict__ out, const int* __restrict__ tab,
                     Layout g, int hl, int wl, int C, int H, int W) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  lowres::Front<T> f;
  f.init(lo, reinterpret_cast<float*>(smem_raw), tab, g, hl, wl, C);
  const int X0 = blockIdx.x * g.cols + PIXELS * threadIdx.x;
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

  auto pixels = [&](int Y, const float* V) {
    float best[PIXELS];
    int arg[PIXELS];
#pragma unroll
    for (int j = 0; j < PIXELS; ++j) {
      best[j] = -INFINITY;
      arg[j] = 0;
    }
    auto keep = [&](int j, float v, int c) {
      if (v > best[j]) {  // strict: the first index wins a tie
        best[j] = v;
        arg[j] = c;
      }
    };
    if (g.pairs) {  // pixels 0 and 1 sample one pair of columns, 2 and 3 one
      const float *a0 = V + o0[0], *a1 = V + o1[0], *b0 = V + o0[2], *b1 = V + o1[2];
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
        const float x0 = a0[c], x1 = a1[c], y0 = b0[c], y1 = b1[c];
        keep(0, lowres::lerp_rn(x0, ca[0], x1, cb[0]), c);
        keep(1, lowres::lerp_rn(x0, ca[1], x1, cb[1]), c);
        keep(2, lowres::lerp_rn(y0, ca[2], y1, cb[2]), c);
        keep(3, lowres::lerp_rn(y0, ca[3], y1, cb[3]), c);
      }
    } else {
#pragma unroll 4
      for (int c = 0; c < C; ++c) {
#pragma unroll
        for (int j = 0; j < PIXELS; ++j)
          keep(j, lowres::lerp_rn(V[o0[j] + c], ca[j], V[o1[j] + c], cb[j]), c);
      }
    }
    int* orow = out + img + (long long)Y * W + X0;
    if (vec && here[0]) {
      __stcs(reinterpret_cast<int4*>(orow), make_int4(arg[0], arg[1], arg[2], arg[3]));
    } else {
#pragma unroll
      for (int j = 0; j < PIXELS; ++j)
        if (here[j]) orow[j] = arg[j];
    }
  };
  lowres::walk(f, tab, g, [](int) {}, pixels);
}

int allowed[2] = {48 * 1024, 48 * 1024};  // each instance's dynamic shared memory limit so far

template <typename T>
cudaError_t launch(const Layout& g, const int* tab, int* out, const void* lo, int B, int hl,
                   int wl, int C, int H, int W, cudaStream_t st) {
  auto kern = resize_argmax_kernel<T>;
  const cudaError_t err = lowres::allow_smem(kern, g.smem, allowed[sizeof(T) == 2]);
  if (err != cudaSuccess) return err;
  const dim3 grid((unsigned)g.spans, (unsigned)g.bands, (unsigned)B);
  kern<<<grid, g.threads, g.smem, st>>>(static_cast<const T*>(lo), out, tab, g, hl, wl, C, H, W);
  return cudaGetLastError();
}

}  // namespace

// out: (B, H, W) int32; tab: the geometry table on the device; layout: K8's
// thirteen ints (lowres_rows.cuh Layout: the table's offsets, cols, spans,
// bands, wmax, cstride, ring, pairs, threads, smem).
SFT_EXPORT int sft_resize_argmax(const void* lo, void* out, const void* tab, const int* layout,
                                 int B, int hl, int wl, int C, int H, int W, int dtype,
                                 void* stream) {
  const Layout g = lowres::layout_of(layout);
  if (lowres::bad_layout(g, hl, wl, C, H, W, B, PIXELS, THREADS) ||
      g.smem != lowres::front_bytes(g))
    return cudaErrorInvalidValue;  // the host's layout disagrees
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* t = static_cast<const int*>(tab);
  int* o = static_cast<int*>(out);
  if (dtype == SFT_F32) return launch<float>(g, t, o, lo, B, hl, wl, C, H, W, st);
  if (dtype == SFT_BF16) return launch<__nv_bfloat16>(g, t, o, lo, B, hl, wl, C, H, W, st);
  return cudaErrorInvalidValue;
}

// *slots = K8's blocks of `threads` and `smem` bytes resident on the current
// card at once (the geometry's bands fill them in one wave).
SFT_EXPORT int sft_resize_argmax_slots(int dtype, int threads, int smem, int* slots) {
  if (dtype == SFT_F32)
    return lowres::resident_blocks(resize_argmax_kernel<float>, threads, smem, allowed[0], slots);
  if (dtype == SFT_BF16)
    return lowres::resident_blocks(resize_argmax_kernel<__nv_bfloat16>, threads, smem,
                                   allowed[1], slots);
  return cudaErrorInvalidValue;
}
