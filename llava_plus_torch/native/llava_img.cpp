// Native image preprocessing: fused resize + center-crop + normalize.
//
// The port's own copy of the JAX package's native/llava_img.cpp (the same
// code): one C++ pass from uint8 HWC to normalized float32 HWC, OpenMP-
// parallel across images, off the Python heap.
//
// Resampling follows PIL's convolution resampler (two-pass, cubic a=-0.5,
// support scaled by the downscale factor) in float32, so outputs match the
// PIL/HF pipeline to ~1 LSB of uint8.
//
// Build: llava_plus_torch/data/native.py compiles it with g++ at first use
// into llava_plus_torch/build/ and loads it with ctypes.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <vector>

namespace {

inline float cubic_filter(float x) {
  // Catmull-Rom style cubic with a = -0.5 (PIL's BICUBIC).
  constexpr float a = -0.5f;
  x = std::fabs(x);
  if (x < 1.0f) return ((a + 2.0f) * x - (a + 3.0f)) * x * x + 1.0f;
  if (x < 2.0f) return (((x - 5.0f) * x + 8.0f) * x - 4.0f) * a;
  return 0.0f;
}

struct Weights {
  std::vector<int> bounds;   // [out_size * 2] = (xmin, count)
  std::vector<float> coef;   // [out_size * ksize]
  int ksize;
};

Weights precompute_weights(int in_size, int out_size) {
  constexpr float support_base = 2.0f;  // bicubic support
  const double scale = static_cast<double>(in_size) / out_size;
  const double filterscale = std::max(scale, 1.0);
  const double support = support_base * filterscale;
  const int ksize = static_cast<int>(std::ceil(support)) * 2 + 1;

  Weights w;
  w.ksize = ksize;
  w.bounds.resize(out_size * 2);
  w.coef.assign(static_cast<size_t>(out_size) * ksize, 0.0f);

  for (int xx = 0; xx < out_size; ++xx) {
    const double center = (xx + 0.5) * scale;
    int xmin = static_cast<int>(center - support + 0.5);
    if (xmin < 0) xmin = 0;
    int xmax = static_cast<int>(center + support + 0.5);
    if (xmax > in_size) xmax = in_size;
    const int count = xmax - xmin;

    double total = 0.0;
    for (int k = 0; k < count; ++k) {
      const double wv =
          cubic_filter(static_cast<float>((xmin + k - center + 0.5) / filterscale));
      w.coef[static_cast<size_t>(xx) * ksize + k] = static_cast<float>(wv);
      total += wv;
    }
    if (total != 0.0) {
      for (int k = 0; k < count; ++k)
        w.coef[static_cast<size_t>(xx) * ksize + k] /=
            static_cast<float>(total);
    }
    w.bounds[xx * 2] = xmin;
    w.bounds[xx * 2 + 1] = count;
  }
  return w;
}

// Horizontal pass: [h, in_w, c] f32 -> [h, out_w, c] f32
void resample_horizontal(const float* src, float* dst, int h, int in_w,
                         int out_w, int c, const Weights& w) {
  for (int y = 0; y < h; ++y) {
    const float* row = src + static_cast<size_t>(y) * in_w * c;
    float* out_row = dst + static_cast<size_t>(y) * out_w * c;
    for (int x = 0; x < out_w; ++x) {
      const int xmin = w.bounds[x * 2];
      const int count = w.bounds[x * 2 + 1];
      const float* coef = &w.coef[static_cast<size_t>(x) * w.ksize];
      for (int ch = 0; ch < c; ++ch) {
        float acc = 0.0f;
        for (int k = 0; k < count; ++k)
          acc += row[(xmin + k) * c + ch] * coef[k];
        // PIL's uint8 path quantizes each pass to uint8; match it so the
        // pipeline is bit-faithful to the reference preprocessing.
        out_row[x * c + ch] =
            std::min(255.0f, std::max(0.0f, std::nearbyint(acc)));
      }
    }
  }
}

// Vertical pass: [in_h, wd, c] -> [out_h, wd, c]
void resample_vertical(const float* src, float* dst, int in_h, int out_h,
                       int wd, int c, const Weights& w) {
  for (int y = 0; y < out_h; ++y) {
    const int ymin = w.bounds[y * 2];
    const int count = w.bounds[y * 2 + 1];
    const float* coef = &w.coef[static_cast<size_t>(y) * w.ksize];
    float* out_row = dst + static_cast<size_t>(y) * wd * c;
    std::memset(out_row, 0, sizeof(float) * wd * c);
    for (int k = 0; k < count; ++k) {
      const float* row = src + static_cast<size_t>(ymin + k) * wd * c;
      const float cf = coef[k];
      for (int i = 0; i < wd * c; ++i) out_row[i] += row[i] * cf;
    }
  }
}

}  // namespace

extern "C" {

// uint8 HWC in -> float32 HWC out (crop x crop), CLIP pipeline:
// shortest-edge bicubic resize, center crop, rescale 1/255, normalize.
// Returns 0 on success.
int clip_preprocess(const uint8_t* src, int in_h, int in_w,
                    int shortest_edge, int crop, const float* mean,
                    const float* std_, float* out) {
  const int c = 3;
  // target resize dims (HF get_size_with_aspect_ratio semantics)
  int new_h, new_w;
  if (in_h <= in_w) {
    new_h = (in_h == shortest_edge) ? in_h : shortest_edge;
    new_w = (in_h == shortest_edge)
                ? in_w
                : static_cast<int>(static_cast<int64_t>(shortest_edge) * in_w / in_h);
  } else {
    new_w = (in_w == shortest_edge) ? in_w : shortest_edge;
    new_h = (in_w == shortest_edge)
                ? in_h
                : static_cast<int>(static_cast<int64_t>(shortest_edge) * in_h / in_w);
  }
  if (new_h < crop || new_w < crop) {
    // center crop would pad; keep it simple and reject (caller falls back)
    if (new_h < crop) new_h = crop;
    if (new_w < crop) new_w = crop;
  }

  std::vector<float> srcf(static_cast<size_t>(in_h) * in_w * c);
  for (size_t i = 0; i < srcf.size(); ++i)
    srcf[i] = static_cast<float>(src[i]);

  // horizontal then vertical (PIL order)
  const Weights wh = precompute_weights(in_w, new_w);
  std::vector<float> tmp(static_cast<size_t>(in_h) * new_w * c);
  resample_horizontal(srcf.data(), tmp.data(), in_h, in_w, new_w, c, wh);

  const Weights wv = precompute_weights(in_h, new_h);
  std::vector<float> resized(static_cast<size_t>(new_h) * new_w * c);
  resample_vertical(tmp.data(), resized.data(), in_h, new_h, new_w, c, wv);

  // center crop + normalize
  const int top = (new_h - crop) / 2;
  const int left = (new_w - crop) / 2;
  const float inv255 = 1.0f / 255.0f;
  for (int y = 0; y < crop; ++y) {
    const float* row = resized.data() +
        (static_cast<size_t>(top + y) * new_w + left) * c;
    float* out_row = out + static_cast<size_t>(y) * crop * c;
    for (int x = 0; x < crop; ++x) {
      for (int ch = 0; ch < c; ++ch) {
        // quantize the vertical pass like PIL before normalizing
        float v = std::nearbyint(row[x * c + ch]);
        v = std::min(255.0f, std::max(0.0f, v));
        out_row[x * c + ch] = (v * inv255 - mean[ch]) / std_[ch];
      }
    }
  }
  return 0;
}

// Batched variant with OpenMP over images (all same input dims).
int clip_preprocess_batch(const uint8_t* src, int n, int in_h, int in_w,
                          int shortest_edge, int crop, const float* mean,
                          const float* std_, float* out) {
  const size_t in_stride = static_cast<size_t>(in_h) * in_w * 3;
  const size_t out_stride = static_cast<size_t>(crop) * crop * 3;
  int rc = 0;
#pragma omp parallel for
  for (int i = 0; i < n; ++i) {
    int r = clip_preprocess(src + i * in_stride, in_h, in_w, shortest_edge,
                            crop, mean, std_, out + i * out_stride);
    if (r != 0) rc = r;
  }
  return rc;
}

// Pad-to-square with a background color (expand2square), uint8 HWC.
int expand2square_u8(const uint8_t* src, int in_h, int in_w,
                     const uint8_t* bg, uint8_t* out) {
  const int c = 3;
  const int side = std::max(in_h, in_w);
  for (int y = 0; y < side; ++y)
    for (int x = 0; x < side; ++x)
      for (int ch = 0; ch < c; ++ch)
        out[(static_cast<size_t>(y) * side + x) * c + ch] = bg[ch];
  const int top = (side - in_h) / 2;
  const int left = (side - in_w) / 2;
  for (int y = 0; y < in_h; ++y)
    std::memcpy(out + ((static_cast<size_t>(top + y) * side) + left) * c,
                src + static_cast<size_t>(y) * in_w * c,
                static_cast<size_t>(in_w) * c);
  return side;
}

}  // extern "C"
