// Host transform engine of the port's input pipeline: bilinear uint8 image
// and nearest int32 label resizes, and the fused random-scale + crop + pad of
// (image, label) pairs, threaded over a batch. The port's own copy of
// segmentation_factory_tpu/native/transform_engine.cpp (the resize, scale-crop
// and batched scale-crop entries; the rotation is not needed here), with the
// same arithmetic, so the port's Loader gives the JAX Loader's batches bit
// for bit when both are built with the same flags on the same host.
//
// Built by g++ at first use (data/native.py) and loaded with ctypes; C ABI.

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

// Bilinear resize HWC uint8 (align_corners=False pixel-center mapping,
// matching PIL/torch semantics closely enough for augmentation).
void sft_resize_bilinear_u8(const uint8_t* src, int sh, int sw, int ch,
                            uint8_t* dst, int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    float fy = (y + 0.5f) * sy - 0.5f;
    if (fy < 0) fy = 0;
    for (int x = 0; x < dw; ++x) {
      float fx = (x + 0.5f) * sx - 0.5f;
      if (fx < 0) fx = 0;
      bilinear_px(src, sh, sw, ch, fy, fx, dst + (static_cast<size_t>(y) * dw + x) * ch);
    }
  }
}

// Nearest-neighbour resize HW int32 (labels are always NEAREST).
void sft_resize_nearest_i32(const int32_t* src, int sh, int sw, int32_t* dst,
                            int dh, int dw) {
  const float sy = static_cast<float>(sh) / dh;
  const float sx = static_cast<float>(sw) / dw;
  for (int y = 0; y < dh; ++y) {
    int yy = std::min(static_cast<int>((y + 0.5f) * sy), sh - 1);
    for (int x = 0; x < dw; ++x) {
      int xx = std::min(static_cast<int>((x + 0.5f) * sx), sw - 1);
      dst[static_cast<size_t>(y) * dw + x] = src[static_cast<size_t>(yy) * sw + xx];
    }
  }
}

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

}  // extern "C"
