// Host image ops of the train augment chain (RGB8), with no Pillow: the
// port's counterpart of the JAX package's native warp and of the Pillow
// calls its host chain makes (data/transforms.py there).
//
//   * the affine warp: bilinear, 16.16 fixed point, 8-bit weights, taps
//     outside the source black; byte for byte the JAX package's
//     native/dfd_native.cc warp_affine_rgb8, and its pool entry;
//   * Image.blend as ImageEnhance uses it (an f32 factor, the result
//     truncated, clipped when the factor is outside [0, 1]): Brightness,
//     Contrast (the grey mean rounded as ImageStat gives it) and Color;
//   * convert("L") (fixed point), convert("HSV") and HSV -> RGB, as
//     Pillow's Convert.c computes them, and the hue step over them;
//   * GaussianBlur: Pillow's extended box blur (three passes a direction,
//     horizontal first, edge pixels repeated, 24-bit fixed point weights);
//   * the NEAREST affine of Image.rotate: Pillow's 16.16 fixed-point walk.
//
// Every op reads a source whose pixels may be strided (a channel slice of
// a packed (H, W, 3F) clip: pixel stride 3F, rows dense) and writes its own
// buffer.  The floating-point expressions keep Pillow's types and order:
// build with -ffp-contract=off (an FMA would move a rounding) and without
// -ffast-math.
//
// Pure C ABI, loaded with ctypes by data/native.py, which builds this file
// and jpeg_decode.cc into one library (one worker pool, pool.h) with the
// host C++ compiler at first use:
//   c++ -O3 -std=c++17 -ffp-contract=off -shared -fPIC
//       jpeg_decode.cc imaging.cc -lpthread

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

#include "pool.h"

namespace {

// ---------------------------------------------------------------------------
// affine warp (bilinear, black outside)
// ---------------------------------------------------------------------------

// coef = (A, B, C, D, E, F) maps output pixel (x, y) to source (A·x+B·y+C,
// D·x+E·y+F).  src_stride / dst_stride: bytes between neighbouring pixels
// (3 for a tight buffer, 3F for a frame's slice of a packed clip); rows are
// dense (a row is width × stride bytes).
void warp_affine_rgb8(const uint8_t* src, int sw, int sh, int src_stride,
                      uint8_t* dst, int dw, int dh, int dst_stride,
                      const double* coef) {
  const int64_t kOne = 1 << 16;
  const int64_t Ai = static_cast<int64_t>(std::llround(coef[0] * kOne));
  const int64_t Di = static_cast<int64_t>(std::llround(coef[3] * kOne));
  const size_t ss = static_cast<size_t>(src_stride > 0 ? src_stride : 3);
  const size_t src_row = static_cast<size_t>(sw) * ss;
  for (int y = 0; y < dh; ++y) {
    int64_t sx = static_cast<int64_t>(
        std::llround((coef[1] * y + coef[2]) * kOne));
    int64_t sy = static_cast<int64_t>(
        std::llround((coef[4] * y + coef[5]) * kOne));
    uint8_t* row = dst + static_cast<size_t>(y) * dw * dst_stride;
    for (int x = 0; x < dw; ++x, sx += Ai, sy += Di) {
      const int x0 = static_cast<int>(sx >> 16);   // floor, either sign
      const int y0 = static_cast<int>(sy >> 16);
      uint8_t* px = row + static_cast<size_t>(dst_stride) * x;
      const uint32_t wx1 = (sx >> 8) & 0xff, wx0 = 256 - wx1;
      const uint32_t wy1 = (sy >> 8) & 0xff, wy0 = 256 - wy1;
      const uint8_t* r0 = src + static_cast<size_t>(y0) * src_row +
                          static_cast<size_t>(x0) * ss;
      if (x0 >= 0 && y0 >= 0 && x0 + 1 < sw && y0 + 1 < sh) {
        const uint8_t* r1 = r0 + src_row;
        const uint32_t w00 = wx0 * wy0, w10 = wx1 * wy0;
        const uint32_t w01 = wx0 * wy1, w11 = wx1 * wy1;
        for (size_t c = 0; c < 3; ++c)
          px[c] = static_cast<uint8_t>((w00 * r0[c] + w10 * r0[ss + c] +
                                        w01 * r1[c] + w11 * r1[ss + c] +
                                        32768) >> 16);
        continue;
      }
      if (x0 < -1 || y0 < -1 || x0 >= sw || y0 >= sh) {
        px[0] = px[1] = px[2] = 0;
        continue;
      }
      // on the border: the taps outside read as black
      const bool in_x0 = x0 >= 0, in_x1 = x0 + 1 < sw;
      const bool in_y0 = y0 >= 0, in_y1 = y0 + 1 < sh;
      const uint8_t* r1 = r0 + src_row;
      for (size_t c = 0; c < 3; ++c) {
        uint32_t v = 0;
        if (in_y0) {
          if (in_x0) v += wx0 * wy0 * r0[c];
          if (in_x1) v += wx1 * wy0 * r0[ss + c];
        }
        if (in_y1) {
          if (in_x0) v += wx0 * wy1 * r1[c];
          if (in_x1) v += wx1 * wy1 * r1[ss + c];
        }
        px[c] = static_cast<uint8_t>((v + 32768) >> 16);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// per-pixel ops (Pillow's Convert.c and Blend.c)
// ---------------------------------------------------------------------------

inline uint8_t clip8(int v) { return v <= 0 ? 0 : v >= 255 ? 255 : v; }

// convert("L"): ITU-R 601-2 luma in 16.16 fixed point
inline uint8_t luma(const uint8_t* p) {
  return static_cast<uint8_t>(
      (p[0] * 19595 + p[1] * 38470 + p[2] * 7471 + 0x8000) >> 16);
}

// Image.blend(a, b, alpha) of one byte: a + alpha·(b − a) in f32, truncated;
// clipped to 0..255 when alpha lies outside [0, 1]
inline uint8_t blend8(int a, int b, float alpha, bool extrapolate) {
  const float t = static_cast<float>(a) + alpha * static_cast<float>(b - a);
  if (!extrapolate) return static_cast<uint8_t>(t);
  if (t <= 0.0) return 0;
  if (t >= 255.0) return 255;
  return static_cast<uint8_t>(t);
}

inline bool extrapolates(float alpha) {
  return !(alpha >= 0 && alpha <= 1.0);
}

void rgb_to_hsv(const uint8_t* in, uint8_t* out) {
  const uint8_t r = in[0], g = in[1], b = in[2];
  const uint8_t maxc = std::max(r, std::max(g, b));
  const uint8_t minc = std::min(r, std::min(g, b));
  uint8_t uh = 0, us = 0;
  if (minc != maxc) {
    const float cr = static_cast<float>(maxc - minc);
    const float s = cr / static_cast<float>(maxc);
    const float rc = static_cast<float>(maxc - r) / cr;
    const float gc = static_cast<float>(maxc - g) / cr;
    const float bc = static_cast<float>(maxc - b) / cr;
    float h;
    if (r == maxc)
      h = bc - gc;
    else if (g == maxc)
      h = 2.0 + rc - bc;
    else
      h = 4.0 + gc - rc;
    h = std::fmod((h / 6.0 + 1.0), 1.0);
    uh = clip8(static_cast<int>(h * 255.0));
    us = clip8(static_cast<int>(s * 255.0));
  }
  out[0] = uh;
  out[1] = us;
  out[2] = maxc;
}

void hsv_to_rgb(const uint8_t* in, uint8_t* out) {
  const uint8_t h = in[0], s = in[1], v = in[2];
  if (s == 0) {
    out[0] = out[1] = out[2] = v;
    return;
  }
  const int i = static_cast<int>(std::floor(static_cast<float>(h) * 6.0 /
                                            255.0));
  const float f = static_cast<float>(h) * 6.0 / 255.0 - static_cast<float>(i);
  const float fs = static_cast<float>(s) / 255.0;
  const uint8_t p = clip8(static_cast<int>(
      std::round(static_cast<float>(v) * (1.0 - fs))));
  const uint8_t q = clip8(static_cast<int>(
      std::round(static_cast<float>(v) * (1.0 - fs * f))));
  const uint8_t t = clip8(static_cast<int>(
      std::round(static_cast<float>(v) * (1.0 - fs * (1.0 - f)))));
  uint8_t r, g, b;
  switch (i % 6) {
    case 0: r = v; g = t; b = p; break;
    case 1: r = q; g = v; b = p; break;
    case 2: r = p; g = v; b = t; break;
    case 3: r = p; g = q; b = v; break;
    case 4: r = t; g = p; b = v; break;
    default: r = v; g = p; b = q; break;
  }
  out[0] = r;
  out[1] = g;
  out[2] = b;
}

// ---------------------------------------------------------------------------
// GaussianBlur: Pillow's BoxBlur.c
// ---------------------------------------------------------------------------

// the box radius of one of `passes` extended box passes for a Gaussian of
// standard deviation `radius` (Gwosdek et al., SSVM 2011, eqs. 7, 10, 11)
float gaussian_box_radius(float radius, int passes) {
  const float sigma2 = radius * radius / passes;
  const float L = std::sqrt(12.0 * sigma2 + 1.0);
  const float l = std::floor((L - 1.0) / 2.0);
  float a = (2 * l + 1) * (l * (l + 1) - 3 * sigma2);
  a /= 6 * (sigma2 - (l + 1) * (l + 1));
  return l + a;
}

struct BoxWeights {
  int radius, edge_a, edge_b;
  uint32_t ww, fw;
};

BoxWeights box_weights(float radius, int size) {
  BoxWeights b;
  b.radius = static_cast<int>(radius);
  b.ww = static_cast<uint32_t>(static_cast<uint32_t>(1 << 24) /
                               (radius * 2 + 1));
  b.fw = ((1 << 24) - (b.radius * 2 + 1) * b.ww) / 2;
  b.edge_a = std::min(b.radius + 1, size);
  b.edge_b = std::max(size - b.radius - 1, 0);
  return b;
}

// One extended box pass over a line of `n` RGB pixels `step` bytes apart:
// the window of 2·radius + 1 pixels at weight ww and the two beyond it at
// fw, pixels past either end repeating the end pixel.  `out` is another
// buffer with the same layout.
void box_line(const uint8_t* in, uint8_t* out, int n, size_t step,
              const BoxWeights& b) {
  const int radius = b.radius, edge_a = b.edge_a, edge_b = b.edge_b;
  const int last = n - 1;
  const uint32_t ww = b.ww, fw = b.fw;
  for (int c = 0; c < 3; ++c) {
    auto at = [&](int i) -> uint32_t { return in[i * step + c]; };
    uint32_t acc = at(0) * (radius + 1);
    for (int x = 0; x < edge_a - 1; ++x) acc += at(x);
    acc += at(last) * (radius - edge_a + 1);
    auto save = [&](int x, int left, int right) {
      const uint32_t bulk = acc * ww + (at(left) + at(right)) * fw;
      out[x * step + c] = static_cast<uint8_t>((bulk + (1 << 23)) >> 24);
    };
    if (edge_a <= edge_b) {
      for (int x = 0; x < edge_a; ++x) {
        acc += at(x + radius) - at(0);
        save(x, 0, x + radius + 1);
      }
      for (int x = edge_a; x < edge_b; ++x) {
        acc += at(x + radius) - at(x - radius - 1);
        save(x, x - radius - 1, x + radius + 1);
      }
      for (int x = edge_b; x <= last; ++x) {
        acc += at(last) - at(x - radius - 1);
        save(x, x - radius - 1, last);
      }
    } else {
      for (int x = 0; x < edge_b; ++x) {
        acc += at(x + radius) - at(0);
        save(x, 0, x + radius + 1);
      }
      for (int x = edge_b; x < edge_a; ++x) {
        acc += at(last) - at(0);
        save(x, 0, last);
      }
      for (int x = edge_a; x <= last; ++x) {
        acc += at(last) - at(x - radius - 1);
        save(x, x - radius - 1, last);
      }
    }
  }
}

}  // namespace

extern "C" {

// Bumped on any signature change: the bridge refuses a library whose
// symbols resolve but whose argument layout moved.
int dfd_img_abi_version(void) { return 2; }

void dfd_img_warp_affine(const uint8_t* src, int sw, int sh, int src_stride,
                         uint8_t* dst, int dw, int dh, int dst_stride,
                         const double* coef) {
  warp_affine_rgb8(src, sw, sh, src_stride > 0 ? src_stride : 3, dst, dw,
                   dh, dst_stride > 0 ? dst_stride : 3, coef);
}

// Warp n frames with one coef on the pool (dfd_jpeg_pool_new); blocks until
// all are done.
// dsts[i] honour dst_stride (tight buffers with 3, or base + 3·i of one
// packed (dh, dw, 3n) clip with 3n); src_strides[i] is frame i's source
// pixel stride (null or 0: tight RGB).
void dfd_img_pool_warp_affine(void* pool, int n, const uint8_t** srcs,
                              const int* sws, const int* shs,
                              const int* src_strides, uint8_t** dsts,
                              int dw, int dh, int dst_stride,
                              const double* coef) {
  dfd_native::Pool* p = static_cast<dfd_native::Pool*>(pool);
  const int stride = dst_stride > 0 ? dst_stride : 3;
  dfd_native::Latch latch(n);
  for (int i = 0; i < n; ++i) {
    p->Submit([&, i] {
      const int ss = src_strides != nullptr && src_strides[i] > 0
                         ? src_strides[i]
                         : 3;
      warp_affine_rgb8(srcs[i], sws[i], shs[i], ss, dsts[i], dw, dh, stride,
                       coef);
      latch.Done();
    });
  }
  latch.Wait();
}

// convert("L") of n pixels (src pixels `ss` bytes apart) into n bytes
void dfd_img_luma(const uint8_t* src, int ss, uint8_t* dst, int64_t n) {
  for (int64_t i = 0; i < n; ++i) dst[i] = luma(src + i * ss);
}

// convert("HSV") and back, n pixels, tight 3-byte output
void dfd_img_rgb_to_hsv(const uint8_t* src, int ss, uint8_t* dst,
                        int64_t n) {
  for (int64_t i = 0; i < n; ++i) rgb_to_hsv(src + i * ss, dst + 3 * i);
}

void dfd_img_hsv_to_rgb(const uint8_t* src, int ss, uint8_t* dst,
                        int64_t n) {
  for (int64_t i = 0; i < n; ++i) hsv_to_rgb(src + i * ss, dst + 3 * i);
}

// ImageEnhance.Brightness(img).enhance(f): blend(black, img, f)
void dfd_img_brightness(const uint8_t* src, int ss, uint8_t* dst, int64_t n,
                        float f) {
  const bool ex = extrapolates(f);
  for (int64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c)
      dst[3 * i + c] = blend8(0, src[i * ss + c], f, ex);
}

// ImageStat.Stat(img.convert("L")).mean rounded as Contrast rounds it:
// int(sum / count + 0.5), the sum exact in a double
int dfd_img_grey_mean(const uint8_t* src, int ss, int64_t n) {
  if (n <= 0) return 0;
  uint64_t sum = 0;
  for (int64_t i = 0; i < n; ++i) sum += luma(src + i * ss);
  return static_cast<int>(static_cast<double>(sum) / static_cast<double>(n) +
                          0.5);
}

// ImageEnhance.Contrast(img).enhance(f): blend(grey mean, img, f)
void dfd_img_contrast(const uint8_t* src, int ss, uint8_t* dst, int64_t n,
                      float f) {
  const int mean = dfd_img_grey_mean(src, ss, n);
  const bool ex = extrapolates(f);
  for (int64_t i = 0; i < n; ++i)
    for (int c = 0; c < 3; ++c)
      dst[3 * i + c] = blend8(mean, src[i * ss + c], f, ex);
}

// ImageEnhance.Color(img).enhance(f): blend(L widened to RGB, img, f)
void dfd_img_color(const uint8_t* src, int ss, uint8_t* dst, int64_t n,
                   float f) {
  const bool ex = extrapolates(f);
  for (int64_t i = 0; i < n; ++i) {
    const uint8_t* p = src + i * ss;
    const int l = luma(p);
    for (int c = 0; c < 3; ++c) dst[3 * i + c] = blend8(l, p[c], f, ex);
  }
}

// convert("HSV"), hue + shift mod 256, convert("RGB")
void dfd_img_hue(const uint8_t* src, int ss, uint8_t* dst, int64_t n,
                 int shift) {
  uint8_t hsv[3];
  const int k = ((shift % 256) + 256) % 256;
  for (int64_t i = 0; i < n; ++i) {
    rgb_to_hsv(src + i * ss, hsv);
    hsv[0] = static_cast<uint8_t>((hsv[0] + k) & 255);
    hsv_to_rgb(hsv, dst + 3 * i);
  }
}

// ImageFilter.GaussianBlur(radius) of a w × h frame into a tight buffer:
// three box passes along the rows, then three along the columns.  A radius
// of 0 copies.
void dfd_img_gaussian_blur(const uint8_t* src, int w, int h, int ss,
                           uint8_t* dst, float radius) {
  const size_t n = static_cast<size_t>(w) * h;
  for (size_t i = 0; i < n; ++i)
    std::memcpy(dst + 3 * i, src + i * ss, 3);
  if (radius == 0 || w <= 0 || h <= 0) return;
  const float r = gaussian_box_radius(radius, 3);
  if (r == 0) return;
  std::vector<uint8_t> tmp(n * 3);
  const BoxWeights bx = box_weights(r, w), by = box_weights(r, h);
  for (int pass = 0; pass < 3; ++pass) {
    for (int y = 0; y < h; ++y)
      box_line(dst + static_cast<size_t>(y) * w * 3,
               tmp.data() + static_cast<size_t>(y) * w * 3, w, 3, bx);
    std::memcpy(dst, tmp.data(), n * 3);
  }
  for (int pass = 0; pass < 3; ++pass) {
    for (int x = 0; x < w; ++x)
      box_line(dst + 3 * x, tmp.data() + 3 * x, h,
               static_cast<size_t>(w) * 3, by);
    std::memcpy(dst, tmp.data(), n * 3);
  }
}

// Image.transform(AFFINE, a, NEAREST) into a black dw × dh canvas, by
// Pillow's 16.16 fixed-point walk (Geometry.c affine_fixed); the caller
// checks that the corners are in its range (|coord| < 32768)
void dfd_img_affine_nearest(const uint8_t* src, int sw, int sh, int ss,
                            uint8_t* dst, int dw, int dh, const double* a) {
  auto fix = [](double v) -> int {
    const double t = v * 65536.0 + 0.5;
    return t < 0.0 ? static_cast<int>(std::floor(t)) : static_cast<int>(t);
  };
  const int a0 = fix(a[0]), a1 = fix(a[1]), a3 = fix(a[3]), a4 = fix(a[4]);
  int a2 = fix(a[2] + a[0] * 0.5 + a[1] * 0.5);
  int a5 = fix(a[5] + a[3] * 0.5 + a[4] * 0.5);
  std::memset(dst, 0, static_cast<size_t>(dw) * dh * 3);
  for (int y = 0; y < dh; ++y) {
    int xx = a2, yy = a5;
    uint8_t* out = dst + static_cast<size_t>(y) * dw * 3;
    for (int x = 0; x < dw; ++x, out += 3) {
      const int xin = xx >> 16;
      if (xin >= 0 && xin < sw) {
        const int yin = yy >> 16;
        if (yin >= 0 && yin < sh)
          std::memcpy(out, src + (static_cast<size_t>(yin) * sw + xin) * ss,
                      3);
      }
      xx += a0;
      yy += a3;
    }
    a2 += a1;
    a5 += a4;
  }
}

}  // extern "C"
