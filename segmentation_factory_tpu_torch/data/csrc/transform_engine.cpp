// Host transform engine of the port's input pipeline: the fused
// random-scale + crop + pad of (image, label) pairs, threaded over a batch,
// the paired rotation, and PIL's bilinear, bicubic and nearest resizes. The
// scale-crop and the rotation are the port's own copy of
// segmentation_factory_tpu/native/transform_engine.cpp (its scale-crop,
// batched scale-crop and rotation entries), with the same arithmetic, so the
// port's Loader gives the JAX Loader's train batches bit for bit when both
// are built with the same flags on the same host. The PIL resizes stand in
// for the JAX package's PIL calls (Image.BILINEAR in the eval shrink,
// infer.preprocess and the Kvasir recipe; Image.BICUBIC in the Synapse
// recipe; Image.NEAREST for their labels): they follow Pillow's Resample.c
// and Geometry.c rules, so they give PIL's bytes.
//
// Built by g++ at first use (data/native.py) with the engine's other sources
// (jpeg_decode.cpp, png_unfilter.cpp) into one library and loaded with
// ctypes; C ABI.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cmath>
#include <thread>
#include <vector>

namespace {

// Bilinear sample of HWC uint8 at (fy, fx) into dst[c].
inline void bilinear_px(const uint8_t* src, int sh, int sw, int ch, float fy,
                        float fx, uint8_t* dst) {
  int y0 = static_cast<int>(fy);
  int x0 = static_cast<int>(fx);
  y0 = std::max(0, std::min(y0, sh - 1));
  x0 = std::max(0, std::min(x0, sw - 1));
  int y1 = std::min(y0 + 1, sh - 1);
  int x1 = std::min(x0 + 1, sw - 1);
  // clamp interpolation weights: callers may pass fy/fx slightly outside the
  // grid (e.g. rotate near borders); extrapolated weights would overflow the
  // uint8 cast below and wrap around
  float ty = std::max(0.0f, std::min(fy - static_cast<float>(y0), 1.0f));
  float tx = std::max(0.0f, std::min(fx - static_cast<float>(x0), 1.0f));
  const uint8_t* p00 = src + (static_cast<size_t>(y0) * sw + x0) * ch;
  const uint8_t* p01 = src + (static_cast<size_t>(y0) * sw + x1) * ch;
  const uint8_t* p10 = src + (static_cast<size_t>(y1) * sw + x0) * ch;
  const uint8_t* p11 = src + (static_cast<size_t>(y1) * sw + x1) * ch;
  for (int c = 0; c < ch; ++c) {
    float v = (1 - ty) * ((1 - tx) * p00[c] + tx * p01[c]) +
              ty * ((1 - tx) * p10[c] + tx * p11[c]);
    v = std::max(0.0f, std::min(v, 255.0f));
    dst[c] = static_cast<uint8_t>(v + 0.5f);
  }
}

}  // namespace

extern "C" {

// Fused: scale the (img, lbl) pair by `scale`, then crop `crop x crop` at
// (top, left) of the scaled canvas, padding with 0 / ignore_index where the
// scaled image is smaller than the crop. Output buffers are crop*crop*(3|1).
void sft_scale_crop_pair(const uint8_t* img, const int32_t* lbl, int h, int w,
                         float scale, int crop, int top, int left,
                         int ignore_index, uint8_t* out_img, int32_t* out_lbl) {
  const int nh = std::max(1, static_cast<int>(h * scale));
  const int nw = std::max(1, static_cast<int>(w * scale));
  const float sy = static_cast<float>(h) / nh;
  const float sx = static_cast<float>(w) / nw;
  for (int y = 0; y < crop; ++y) {
    const int yy = y + top;  // coordinate in the scaled canvas
    for (int x = 0; x < crop; ++x) {
      const int xx = x + left;
      uint8_t* po = out_img + (static_cast<size_t>(y) * crop + x) * 3;
      int32_t* pl = out_lbl + static_cast<size_t>(y) * crop + x;
      if (yy >= nh || xx >= nw) {  // pad region
        po[0] = po[1] = po[2] = 0;
        *pl = ignore_index;
        continue;
      }
      float fy = (yy + 0.5f) * sy - 0.5f;
      float fx = (xx + 0.5f) * sx - 0.5f;
      if (fy < 0) fy = 0;
      if (fx < 0) fx = 0;
      bilinear_px(img, h, w, 3, fy, fx, po);
      int ly = std::min(static_cast<int>((yy + 0.5f) * sy), h - 1);
      int lx = std::min(static_cast<int>((xx + 0.5f) * sx), w - 1);
      *pl = lbl[static_cast<size_t>(ly) * w + lx];
    }
  }
}

// Batched fused transform: one thread per sample. All images share one
// (h, w) canvas (the loader pre-pads decode output); per-sample scale and
// crop offsets come from the host RNG to stay bit-compatible with the
// Python fallback path.
void sft_batch_scale_crop(const uint8_t* imgs, const int32_t* lbls, int n,
                          int h, int w, const float* scales, const int* tops,
                          const int* lefts, int crop, int ignore_index,
                          uint8_t* out_imgs, int32_t* out_lbls,
                          int num_threads) {
  const size_t img_in = static_cast<size_t>(h) * w * 3;
  const size_t lbl_in = static_cast<size_t>(h) * w;
  const size_t img_out = static_cast<size_t>(crop) * crop * 3;
  const size_t lbl_out = static_cast<size_t>(crop) * crop;
  if (num_threads <= 1 || n == 1) {
    for (int i = 0; i < n; ++i) {
      sft_scale_crop_pair(imgs + i * img_in, lbls + i * lbl_in, h, w, scales[i],
                          crop, tops[i], lefts[i], ignore_index,
                          out_imgs + i * img_out, out_lbls + i * lbl_out);
    }
    return;
  }
  std::vector<std::thread> pool;
  int per = (n + num_threads - 1) / num_threads;
  for (int t = 0; t < num_threads; ++t) {
    int lo = t * per;
    int hi = std::min(n, lo + per);
    if (lo >= hi) break;
    pool.emplace_back([=]() {
      for (int i = lo; i < hi; ++i) {
        sft_scale_crop_pair(imgs + i * img_in, lbls + i * lbl_in, h, w,
                            scales[i], crop, tops[i], lefts[i], ignore_index,
                            out_imgs + i * img_out, out_lbls + i * lbl_out);
      }
    });
  }
  for (auto& th : pool) th.join();
}

// Paired rotation about the image center, output size == input size
// (PIL.Image.rotate(expand=False) semantics: inverse mapping, sample at
// pixel centers). Label always NEAREST; image bilinear unless nearest_img.
// Out-of-bounds pixels get img_fill / lbl_fill.
void sft_rotate_pair(const uint8_t* img, const int32_t* lbl, int h, int w,
                     float angle_deg, int nearest_img, int img_fill,
                     int lbl_fill, uint8_t* out_img, int32_t* out_lbl) {
  const float rad = angle_deg * 3.14159265358979323846f / 180.0f;
  // inverse mapping: rotate output coords by -angle about the center
  const float ca = std::cos(rad), sa = std::sin(rad);
  const float cx = w * 0.5f, cy = h * 0.5f;
  for (int y = 0; y < h; ++y) {
    const float oy = y + 0.5f - cy;
    for (int x = 0; x < w; ++x) {
      const float ox = x + 0.5f - cx;
      // PIL rotates counter-clockwise for positive angles; the inverse map
      // from output to input is the clockwise rotation
      const float ix = ca * ox - sa * oy + cx;  // continuous source coords
      const float iy = sa * ox + ca * oy + cy;
      uint8_t* po = out_img + (static_cast<size_t>(y) * w + x) * 3;
      int32_t* pl = out_lbl + static_cast<size_t>(y) * w + x;
      if (ix < 0.f || ix >= static_cast<float>(w) || iy < 0.f ||
          iy >= static_cast<float>(h)) {
        po[0] = po[1] = po[2] = static_cast<uint8_t>(img_fill);
        *pl = lbl_fill;
        continue;
      }
      const int nx = std::min(static_cast<int>(ix), w - 1);
      const int ny = std::min(static_cast<int>(iy), h - 1);
      *pl = lbl[static_cast<size_t>(ny) * w + nx];
      if (nearest_img) {
        const uint8_t* ps = img + (static_cast<size_t>(ny) * w + nx) * 3;
        po[0] = ps[0];
        po[1] = ps[1];
        po[2] = ps[2];
      } else {
        bilinear_px(img, h, w, 3, iy - 0.5f, ix - 0.5f, po);
      }
    }
  }
}

}  // extern "C"

// Pillow's own builds do not fuse multiply-adds; neither may these weights.
#pragma GCC push_options
#pragma GCC optimize("fp-contract=off")

namespace {

constexpr int kPrecisionBits = 22;  // Pillow's PRECISION_BITS (32 - 8 - 2)

// Pillow's bicubic kernel (a = -0.5), support 2
inline double bicubic(double x) {
  const double a = -0.5;
  if (x < 0.0) x = -x;
  if (x < 1.0) return ((a + 2.0) * x - (a + 3.0)) * x * x + 1;
  if (x < 2.0) return (((x - 5) * x + 8) * x - 4) * a;
  return 0.0;
}

// Pillow's bilinear (triangle) kernel, support 1
inline double bilinear(double x) {
  if (x < 0.0) x = -x;
  if (x < 1.0) return 1.0 - x;
  return 0.0;
}

struct Filter {
  double (*fn)(double);
  double support;
};

// Pillow's precompute_coeffs + normalize_coeffs_8bpc for one axis: for each
// output index its first source index, its tap count and `ksize` weights in
// 22-bit fixed point (rounded half away from zero). The filter's support
// widens by the scale when shrinking (the antialias).
int resample_coeffs(int in_size, int out_size, Filter filter, std::vector<int>& bounds,
                    std::vector<int32_t>& kk) {
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = scale < 1.0 ? 1.0 : scale;
  const double support = filter.support * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;
  bounds.assign(static_cast<size_t>(out_size) * 2, 0);
  kk.assign(static_cast<size_t>(out_size) * ksize, 0);
  std::vector<double> k(ksize);
  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    const double ss = 1.0 / filterscale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    xmax -= xmin;
    double ww = 0.0;
    for (int x = 0; x < xmax; ++x) {
      const double wgt = filter.fn((x + xmin - center + 0.5) * ss);
      k[x] = wgt;
      ww += wgt;
    }
    for (int x = 0; x < xmax; ++x) {
      if (ww != 0.0) k[x] /= ww;
    }
    for (int x = xmax; x < ksize; ++x) k[x] = 0;
    for (int x = 0; x < ksize; ++x) {
      const double v = k[x] * (1 << kPrecisionBits);
      kk[static_cast<size_t>(xx) * ksize + x] =
          static_cast<int32_t>(k[x] < 0 ? -0.5 + v : 0.5 + v);
    }
    bounds[xx * 2] = xmin;
    bounds[xx * 2 + 1] = xmax;
  }
  return ksize;
}

#pragma GCC pop_options

inline uint8_t clip8(int32_t v) {
  if (v >= (1 << kPrecisionBits << 8)) return 255;
  if (v <= 0) return 0;
  return static_cast<uint8_t>(v >> kPrecisionBits);
}

// Pillow's ImagingResample of an HWC uint8 image with `filter`
// (reducing_gap=None): the horizontal pass into a uint8 buffer, then the
// vertical pass, each pixel accumulated in int32 from 1 << 21 and clipped to
// [0, 255]. (Pillow cuts the buffer to the rows the vertical pass reads and
// skips a pass whose size does not change; neither changes a byte: a pass at
// the same size has the weights 0 and 1.)
void resample_u8(const uint8_t* src, int sh, int sw, int ch, uint8_t* dst, int dh, int dw,
                 Filter filter) {
  std::vector<int> bx, by;
  std::vector<int32_t> kx, ky;
  const int ksx = resample_coeffs(sw, dw, filter, bx, kx);
  const int ksy = resample_coeffs(sh, dh, filter, by, ky);
  std::vector<uint8_t> tmp(static_cast<size_t>(sh) * dw * ch);
  for (int y = 0; y < sh; ++y) {
    const uint8_t* row = src + static_cast<size_t>(y) * sw * ch;
    uint8_t* out = tmp.data() + static_cast<size_t>(y) * dw * ch;
    for (int xx = 0; xx < dw; ++xx) {
      const int xmin = bx[xx * 2], n = bx[xx * 2 + 1];
      const int32_t* k = kx.data() + static_cast<size_t>(xx) * ksx;
      for (int c = 0; c < ch; ++c) {
        int32_t ss = 1 << (kPrecisionBits - 1);
        for (int x = 0; x < n; ++x) ss += row[(x + xmin) * ch + c] * k[x];
        out[xx * ch + c] = clip8(ss);
      }
    }
  }
  for (int yy = 0; yy < dh; ++yy) {
    const int ymin = by[yy * 2], n = by[yy * 2 + 1];
    const int32_t* k = ky.data() + static_cast<size_t>(yy) * ksy;
    uint8_t* out = dst + static_cast<size_t>(yy) * dw * ch;
    for (int i = 0; i < dw * ch; ++i) {
      int32_t ss = 1 << (kPrecisionBits - 1);
      for (int y = 0; y < n; ++y) ss += tmp[static_cast<size_t>(y + ymin) * dw * ch + i] * k[y];
      out[i] = clip8(ss);
    }
  }
}

}  // namespace

extern "C" {

// Pillow's Image.resize(..., Image.BICUBIC) of an HWC uint8 image.
void sft_resize_bicubic_u8(const uint8_t* src, int sh, int sw, int ch,
                           uint8_t* dst, int dh, int dw) {
  resample_u8(src, sh, sw, ch, dst, dh, dw, Filter{bicubic, 2.0});
}

// Pillow's Image.resize(..., Image.BILINEAR) of an HWC uint8 image: the
// triangle filter, antialiased when shrinking.
void sft_resize_bilinear_pil_u8(const uint8_t* src, int sh, int sw, int ch,
                                uint8_t* dst, int dh, int dw) {
  resample_u8(src, sh, sw, ch, dst, dh, dw, Filter{bilinear, 1.0});
}

// Pillow's Image.resize(..., Image.NEAREST) of an HW int32 map: the source
// index of output k is the truncation of x_k, x_0 = 0.5 * in / out and
// x_{k+1} = x_k + in / out accumulated in double (ImagingScaleAffine).
void sft_resize_nearest_pil_i32(const int32_t* src, int sh, int sw, int32_t* dst,
                                int dh, int dw) {
  std::vector<int> xs(dw);
  const double ax = static_cast<double>(sw) / dw, ay = static_cast<double>(sh) / dh;
  double xo = ax * 0.5;
  for (int x = 0; x < dw; ++x, xo += ax) xs[x] = std::min(static_cast<int>(xo), sw - 1);
  double yo = ay * 0.5;
  for (int y = 0; y < dh; ++y, yo += ay) {
    const int32_t* row = src + static_cast<size_t>(std::min(static_cast<int>(yo), sh - 1)) * sw;
    int32_t* out = dst + static_cast<size_t>(y) * dw;
    for (int x = 0; x < dw; ++x) out[x] = row[xs[x]];
  }
}

}  // extern "C"
