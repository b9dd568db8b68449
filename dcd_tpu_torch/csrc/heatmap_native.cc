// Native host-side target-encoding kernels.
//
// The reference ships its hot device kernels as CUDA and leaves the input
// pipeline in per-object python (DGDE/data/datasets/kitti.py:406-566,
// model/heatmap_coder.py:83-124). On TPU the device side is XLA/Pallas;
// the host input pipeline is the part that benefits from native code, so
// the gaussian heatmap splatting (the per-sample inner loop) lives here.
//
// A copy of the JAX package's dcd_tpu/native/heatmap_native.cc (but for
// pad_normalize_image, which takes its pad offset from the caller), bound by
// ctypes in dcd_tpu_torch/data/native.py and built without -march=native;
// bitwise equal to the NumPy splats in dcd_tpu_torch/data/heatmap.py and to
// target_encoder.py's pad + normalize (tests/test_torch_native.py).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <limits>

extern "C" {

// Max-splat one isotropic gaussian (reference draw_umich_gaussian,
// heatmap_coder.py:83-106): diameter = 2r+1, sigma = diameter/6.
void splat_gaussian(float* heatmap, int height, int width, int cx, int cy,
                    int radius, float k) {
  if (radius < 0) return;
  const double diameter = 2.0 * radius + 1.0;
  const double sigma = diameter / 6.0;
  const double denom = 2.0 * sigma * sigma;

  const int left = std::min(cx, radius);
  const int right = std::min(width - cx, radius + 1);
  const int top = std::min(cy, radius);
  const int bottom = std::min(height - cy, radius + 1);
  if (left + right <= 0 || top + bottom <= 0) return;

  // threshold below which the gaussian is zeroed (numpy eps * max)
  const double eps_cut =
      std::numeric_limits<float>::epsilon() * 1.0;  // max of gaussian == 1

  for (int dy = -top; dy < bottom; ++dy) {
    float* row = heatmap + (cy + dy) * width;
    for (int dx = -left; dx < right; ++dx) {
      double g = std::exp(-(static_cast<double>(dx) * dx + static_cast<double>(dy) * dy) / denom);
      if (g < eps_cut) g = 0.0;
      float v = static_cast<float>(g * k);
      float& cell = row[cx + dx];
      if (v > cell) cell = v;
    }
  }
}

// Max-splat one axis-aligned elliptic gaussian (reference
// draw_umich_gaussian_2D, heatmap_coder.py:108-124).
void splat_gaussian_2d(float* heatmap, int height, int width, int cx, int cy,
                       int radius_x, int radius_y, float k) {
  if (radius_x < 0 || radius_y < 0) return;
  const double dx_diam = 2.0 * radius_x + 1.0;
  const double dy_diam = 2.0 * radius_y + 1.0;
  const double sx = dx_diam / 6.0, sy = dy_diam / 6.0;
  const double denx = 2.0 * sx * sx, deny = 2.0 * sy * sy;

  const int left = std::min(cx, radius_x);
  const int right = std::min(width - cx, radius_x + 1);
  const int top = std::min(cy, radius_y);
  const int bottom = std::min(height - cy, radius_y + 1);
  if (left + right <= 0 || top + bottom <= 0) return;
  const double eps_cut = std::numeric_limits<float>::epsilon();

  for (int dy = -top; dy < bottom; ++dy) {
    float* row = heatmap + (cy + dy) * width;
    for (int dx = -left; dx < right; ++dx) {
      double g = std::exp(-(static_cast<double>(dx) * dx) / denx -
                          (static_cast<double>(dy) * dy) / deny);
      if (g < eps_cut) g = 0.0;
      float v = static_cast<float>(g * k);
      float& cell = row[cx + dx];
      if (v > cell) cell = v;
    }
  }
}

// Batch: splat n objects into a (num_cls, H, W) heatmap.
// kind[i]: 0 = isotropic (rx used as radius), 1 = elliptic (rx, ry).
void splat_batch(float* heatmap, int num_cls, int height, int width,
                 const int32_t* cls_ids, const int32_t* cxs, const int32_t* cys,
                 const int32_t* rxs, const int32_t* rys, const int32_t* kind,
                 int n) {
  for (int i = 0; i < n; ++i) {
    int c = cls_ids[i];
    if (c < 0 || c >= num_cls) continue;
    float* hm = heatmap + static_cast<size_t>(c) * height * width;
    if (kind[i] == 0) {
      splat_gaussian(hm, height, width, cxs[i], cys[i], rxs[i], 1.0f);
    } else {
      splat_gaussian_2d(hm, height, width, cxs[i], cys[i], rxs[i], rys[i], 1.0f);
    }
  }
}

// Pad a HWC uint8 image at (pad_x, pad_y) into a zeroed output buffer and
// normalize to float32 (x/255 - mean)/std per channel (reference pad_image
// kitti.py:262-272 + transforms.py:5-30 fused into one pass). The caller
// owns the offset (target_encoder.pad_offset: centred).
void pad_normalize_image(const uint8_t* src, int h, int w, int c,
                         float* dst, int out_h, int out_w, int pad_x, int pad_y,
                         const float* mean, const float* std_) {
  std::memset(dst, 0, sizeof(float) * out_h * out_w * c);
  // padded zeros normalize to (-mean/std); the reference normalizes after
  // padding, so apply to the whole canvas first
  for (int ch = 0; ch < c; ++ch) {
    const float base = (0.0f - mean[ch]) / std_[ch];
    for (int i = 0; i < out_h * out_w; ++i) dst[i * c + ch] = base;
  }
  for (int y = 0; y < h; ++y) {
    const uint8_t* srow = src + static_cast<size_t>(y) * w * c;
    float* drow = dst + (static_cast<size_t>(y + pad_y) * out_w + pad_x) * c;
    for (int x = 0; x < w * c; ++x) {
      int ch = x % c;
      drow[x] = (srow[x] / 255.0f - mean[ch]) / std_[ch];
    }
  }
}

}  // extern "C"
