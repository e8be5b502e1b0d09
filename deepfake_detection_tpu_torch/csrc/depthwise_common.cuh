// What the depthwise forward (depthwise_fwd.cu) and dx (depthwise_dx.cu)
// kernels share: one wave of blocks walks work items, each a strip of 32
// channels of one image's band of rows by a segment of columns; a block
// stages an item's input with its halo in shared memory (by TMA, or by the
// threads on the scalar path; zeros where it falls outside the image, so
// the inner loops have no bounds checks), and each thread computes a few
// outputs for 4 of the channels from there.  Here: stores and shared-memory
// loads of 4 values widened to f32, the epilogue's activations, the walk
// and its grid, the scalar path's staging, and the launch report of an
// instantiation.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "sm90.cuh"

namespace dwk {

constexpr int kCW = 32;                 // channels a block (its strip)
constexpr int kTX = kCW / 4;            // threads along the strip
constexpr int kWorkers = 16;            // most threads along the tile
constexpr int kThreads = kTX * kWorkers;
constexpr int kSlots = 2;               // work items staged at once
constexpr int64_t kFewItems = 132 * 4;  // under this, halve the item rows

// V f32 values stored as V consecutive values of T in global memory.
template <typename T, int V> struct Vec;

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void store(float* p, const float (&o)[1]) {
    p[0] = o[0];
  }
};

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void store(float* p, const float (&o)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&o)[1]) {
    p[0] = __float2bfloat16_rn(o[0]);
  }
};

template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&o)[4]) {
    const __nv_bfloat162 lo = __floats2bfloat162_rn(o[0], o[1]);
    const __nv_bfloat162 hi = __floats2bfloat162_rn(o[2], o[3]);
    uint2 raw;
    memcpy(&raw.x, &lo, sizeof(lo));
    memcpy(&raw.y, &hi, sizeof(hi));
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

// Stores 4 f32 values as T at p: one vector store, or one value at a time
// for the channels below C (the scalar path).
template <typename T, bool VEC>
__device__ __forceinline__ void store4(T* p, const float (&o)[4],
                                       int64_t c, int64_t C) {
  if (VEC) {
    if (c < C) Vec<T, 4>::store(p, o);
  } else {
#pragma unroll
    for (int v = 0; v < 4; ++v) {
      const float one[1] = {o[v]};
      if (c + v < C) Vec<T, 1>::store(p + v, one);
    }
  }
}

// 4 consecutive values of shared memory, widened to f32.
__device__ __forceinline__ void lds4(const float* p, float (&o)[4]) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
}

__device__ __forceinline__ void lds4(const __nv_bfloat16* p, float (&o)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  __nv_bfloat162 lo, hi;
  memcpy(&lo, &raw.x, sizeof(lo));
  memcpy(&hi, &raw.y, sizeof(hi));
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
}

// act codes match FUSED_DW_ACTS in ops/depthwise.py: 0 none, 1 silu, 2 relu
__device__ __forceinline__ float apply_act(float u, int act) {
  if (act == 1) return __fdividef(u, 1.0f + __expf(-u));
  if (act == 2) return fmaxf(u, 0.0f);
  return u;
}

inline int64_t cdiv(int64_t a, int64_t b) { return (a + b - 1) / b; }
inline int64_t round_up(int64_t a, int64_t b) { return cdiv(a, b) * b; }

constexpr int round128(int n) { return (n + 127) / 128 * 128; }

// A walk over work items: an item is one image's band of `rows` output rows
// (or groups) by a segment of `cols` columns, for a strip of 32 channels;
// rows and cols are the largest allowed, evened out over the image and
// rounded up to the thread's unit, and the rows are halved (down to the
// unit) while there are fewer than kFewItems items, so that a small
// output still spreads over the card.  Blocks take items i, i + grid, ...
// (wave()); the kernel fills in the staging sizes.  items is -1 where the
// count does not fit an int.
struct Walk {
  int items, B, strips, bands, segs;
  int rows, cols, in_rows, in_cols, w_bytes, slot_bytes, tx_bytes;
};

inline Walk walk(int64_t B, int64_t rows, int64_t cols, int64_t C,
                 int max_rows, int max_cols, int row_unit, int col_unit) {
  const int64_t strips = cdiv(C, kCW);
  const int64_t segs0 = cdiv(cols, max_cols);
  const int64_t seg_cols = round_up(cdiv(cols, segs0), col_unit);
  const int64_t segs = cdiv(cols, seg_cols);
  int64_t band_rows, bands, items;
  for (int64_t most = max_rows;; most /= 2) {
    const int64_t bands0 = cdiv(rows, most);
    band_rows = round_up(cdiv(rows, bands0), row_unit);
    bands = cdiv(rows, band_rows);
    items = strips * B * bands * segs;
    if (items >= kFewItems || most / 2 < row_unit) break;
  }
  Walk p{};
  p.items = items > 2147483647 ? -1 : (int)items;
  p.B = (int)B;
  p.strips = (int)strips;
  p.bands = (int)bands;
  p.segs = (int)segs;
  p.rows = (int)band_rows;
  p.cols = (int)seg_cols;
  return p;
}

// The grid of a walk: as many blocks as fit on the card at once (one
// wave), at most one an item.
template <typename Kernel>
cudaError_t wave(Kernel kernel, dim3 block, size_t smem, int64_t items,
                 unsigned& grid) {
  static int sms = 0;
  cudaError_t err;
  if (sms == 0) {
    int dev = 0;
    err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return err;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
  }
  int per_sm = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &per_sm, kernel, (int)(block.x * block.y), smem);
  if (err != cudaSuccess) return err;
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t fit = (int64_t)sms * per_sm;
  grid = (unsigned)(items < fit ? items : fit);
  return cudaSuccess;
}

// The scalar path's staging: an nrows x ncols pixel window of an image
// (src: its (H, W, C) base) starting at (row0, col0), channels [c0, c0 +
// 32), into dst ([nrows][ncols][32] of T), one value a copy (4-byte
// cp.async for f32, a load and a store for bf16); zeros where the pixel
// lies outside the image or the channel past C, as the TMA box of the
// vector path has them.
template <typename T>
__device__ __forceinline__ void stage_tile(T* dst, const T* src, int64_t row0,
                                           int64_t col0, int nrows, int ncols,
                                           int64_t H, int64_t W, int64_t C,
                                           int64_t c0, int tid, int nt) {
  for (int i = tid; i < nrows * ncols * kCW; i += nt) {
    const int px = i / kCW, ch = i % kCW;
    const int64_t h = row0 + px / ncols, w = col0 + px % ncols;
    const bool in = h >= 0 && h < H && w >= 0 && w < W && c0 + ch < C;
    const T* from = in ? src + (h * W + w) * C + c0 + ch : src;
    if (sizeof(T) == 4) {
      sm90::cp_async4(dst + i, from, in ? 4 : 0);
    } else {
      dst[i] = in ? *from : T(0.0f);
    }
  }
}

// The scalar path's k*k taps of the strip's 32 channels into dst ([k*k][32]
// f32) by 4-byte cp.async, zero past C.
__device__ __forceinline__ void stage_weights(float* dst, const float* w,
                                              int taps, int64_t C, int64_t c0,
                                              int tid, int nt) {
  for (int i = tid; i < taps * kCW; i += nt) {
    const int tap = i / kCW, ch = i % kCW;
    const bool in = c0 + ch < C;
    sm90::cp_async4(dst + i, in ? w + tap * C + c0 + ch : w, in ? 4 : 0);
  }
}

inline bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// An instantiation's registers, local bytes, largest dynamic shared bytes
// and resident blocks per SM at those bytes and kThreads, into out[0..4).
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, bool& configured, size_t smem,
                        int* out) {
  cudaError_t err = sm90::configure(kernel, configured, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      kThreads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return err;
}

}  // namespace dwk
