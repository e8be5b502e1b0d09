// Depthwise conv weight gradient, NHWC:
//   dw[r, s, c] = sum_{b, h, w} dz[b, h, w, c] * x[b, h*S + r - pt, w*S + s - pl, c]
// (x outside its H x W reads as 0), f32 accumulation, x f32 or bf16, dz f32.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/depthwise_pallas.py
// ::_dwgrad_kernel (launched by _dwgrad_call), which carries the k*k x C sum
// in VMEM scratch across a sequential (batch, row-tile) grid.  Blocks on the
// card run in no order, so the sum is split in two passes instead.
//
// What bounds it on an H100: memory.  It must read x and dz once each:
// 2*k*k FLOP per dz element against 8 bytes (f32 x and dz at stride 1),
// 2.25 FLOP per byte at k = 3 and 6.25 at k = 5, under the card's f32 ratio
// of 67 TFLOP/s to 3.35 TB/s = 20.  So the design reads each value of x and
// dz from device memory about once and keeps the reuse on the SM:
//
// 1. dwgrad_partial: block (channel strip, tile) owns 32 channels of one
//    image's band of output rows and one segment of at most 32 output
//    columns.  It walks the band's rows in order; for each row it stages
//    the dz row segment and the x rows the row's taps read (the segment's
//    columns with their halo, zero past the edges of x) in shared memory by
//    cp.async, kAhead rows ahead, x in a ring of k + kAhead*S rows, so each
//    x row arrives once for the band.  A thread owns 4 channels, one tap row
//    r (threadIdx.z) and a contiguous run of the segment's output columns
//    (threadIdx.y): it slides a window of the k x vectors of its tap row
//    along the run, so each output pixel costs one dz load and S x loads
//    from shared memory for k vector FMAs, and keeps its k x 4 sums in
//    registers for the whole band.  At the end the block adds its threads'
//    sums over the column runs in a fixed order and writes its (k*k, 32)
//    partial to the workspace (tiles, k*k, C).
// 2. dwgrad_sum: 32 threads per (tap, c) add the tiles in a fixed order.
//
// The tiles (image, band, segment) are planned from the shapes to fill
// about two waves of the card's SMs.  No atomics: the order of every sum
// depends only on the shapes, so two calls give bitwise-equal dw.  All
// offsets into x and dz are 64-bit.  On an H100 80GB HBM3 (700 W) the
// flagship's 55 stages at batch 3 take 2.59 ms against a 1.08 ms bytes
// bound; the k = 5 stages at 19^2-75^2 (8-10-row bands) lag most.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes by deepfake_detection_tpu_torch/ops/depthwise.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "sm90.cuh"

namespace {

constexpr int kSumLanes = 32;           // the second pass: threads a sum
constexpr int kCW = 32;                 // channels a block
constexpr int kTX = kCW / 4;            // threads along the channels
constexpr int kRuns = 4;                // threads along a segment's columns
constexpr int kSeg = 32;                // most output columns a segment
constexpr int kAhead = 2;               // rows staged ahead
constexpr int64_t kTargetBlocks = 2 * 132 * 3;  // ~2 waves, 3 blocks an SM
constexpr int64_t kMinBandRows = 8;

// The tiling depends on the shapes only (not on the stride or the vector
// path), so the workspace query and the launch agree.
struct Plan {
  int64_t strips, segs, seg_cols, bands, band_rows;
  // tiles per image
  __host__ __device__ int64_t tiles() const { return segs * bands; }
};

Plan plan(int64_t B, int64_t Ho, int64_t Wo, int64_t C) {
  Plan p;
  p.strips = (C + kCW - 1) / kCW;
  p.segs = (Wo + kSeg - 1) / kSeg;
  p.seg_cols = (Wo + p.segs - 1) / p.segs;
  int64_t bands = (kTargetBlocks + p.strips * B * p.segs - 1) /
                  (p.strips * B * p.segs);
  int64_t rows = (Ho + bands - 1) / bands;
  if (rows < kMinBandRows) rows = kMinBandRows;
  if (rows > Ho) rows = Ho;
  p.band_rows = rows;
  p.bands = (Ho + rows - 1) / rows;
  return p;
}

// Floats of shared memory the first pass uses: the x ring, the dz rows and,
// after them, the reduction over the column runs.
template <int K, int S>
constexpr int64_t kXCols = (kSeg - 1) * S + K;
template <int K, int S>
constexpr int64_t kRing = K + kAhead * S;
template <int K, int S>
constexpr int64_t smem_floats() {
  const int64_t stage = (kRing<K, S> * kXCols<K, S> + (kAhead + 1) * kSeg) *
                        kCW;
  const int64_t red = (int64_t)K * K * kRuns * kCW;
  return stage > red ? stage : red;
}

// Stages n pixels of one row into dst ([n][32] floats): pixel i is column
// col0 + i of the row at src (a (W, C) row of x or dz), channels
// [c0, c0 + 32); zeros where the row is outside (row_in false), the column
// outside [0, W) or the channel past C.  vec: 16-byte copies (C % 4 == 0 and
// 16-byte aligned bases); else 4-byte copies; bf16 is widened by the threads.
__device__ __forceinline__ void stage_row(float* dst, const float* src,
                                          bool row_in, int64_t col0, int n,
                                          int64_t W, int64_t C, int64_t c0,
                                          bool vec, int tid, int nt) {
  if (vec) {
    for (int i = tid; i < n * kTX; i += nt) {
      const int p = i / kTX, ch = i % kTX * 4;
      const int64_t w = col0 + p;
      const bool in = row_in && w >= 0 && w < W && c0 + ch < C;
      sm90::cp_async16(dst + p * kCW + ch, in ? src + w * C + c0 + ch : src,
                 in ? 16 : 0);
    }
  } else {
    for (int i = tid; i < n * kCW; i += nt) {
      const int p = i / kCW, ch = i % kCW;
      const int64_t w = col0 + p;
      const bool in = row_in && w >= 0 && w < W && c0 + ch < C;
      sm90::cp_async4(dst + p * kCW + ch, in ? src + w * C + c0 + ch : src,
                in ? 4 : 0);
    }
  }
}

__device__ __forceinline__ void stage_row(float* dst,
                                          const __nv_bfloat16* src,
                                          bool row_in, int64_t col0, int n,
                                          int64_t W, int64_t C, int64_t c0,
                                          bool, int tid, int nt) {
  for (int i = tid; i < n * kCW; i += nt) {
    const int p = i / kCW, ch = i % kCW;
    const int64_t w = col0 + p;
    const bool in = row_in && w >= 0 && w < W && c0 + ch < C;
    dst[p * kCW + ch] = in ? __bfloat162float(src[w * C + c0 + ch]) : 0.f;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

template <typename T, int K, int S>
__global__ void __launch_bounds__(kTX * kRuns * K)
dwgrad_partial(const T* __restrict__ x, const float* __restrict__ dz,
               float* __restrict__ ws, int64_t H, int64_t W, int64_t C,
               int64_t Ho, int64_t Wo, int pad_top, int pad_left, Plan p,
               int vec_x, int vec_dz) {
  constexpr int XC = kXCols<K, S>, NR = kRing<K, S>;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // [NR][XC][32]
  float* dzs = xs + NR * XC * kCW;               // [kAhead + 1][kSeg][32]
  const int tx = threadIdx.x, run = threadIdx.y, r = threadIdx.z;
  const int tid = (r * kRuns + run) * kTX + tx, nt = kTX * kRuns * K;

  // the tile: image b, band of output rows [h0, h1), segment of output
  // columns [w0, w0 + ncols)
  const int64_t c0 = (int64_t)blockIdx.x * kCW;
  const int64_t tile = blockIdx.y;
  const int64_t b = tile / p.tiles(), rest = tile % p.tiles();
  const int64_t band = rest / p.segs, seg = rest % p.segs;
  const int64_t h0 = band * p.band_rows;
  const int64_t h1 = h0 + p.band_rows < Ho ? h0 + p.band_rows : Ho;
  const int64_t w0 = seg * p.seg_cols;
  const int ncols = (int)(w0 + p.seg_cols < Wo ? p.seg_cols : Wo - w0);
  const int nx = (ncols - 1) * S + K;       // x columns the segment reads
  const int64_t xcol0 = w0 * S - pad_left;
  const int64_t xrow0 = h0 * S - pad_top;   // x row of ring row 0

  // the thread's run of output columns [j0, j1) of the segment
  const int per = (ncols + kRuns - 1) / kRuns;
  const int j0 = run * per, j1 = j0 + per < ncols ? j0 + per : ncols;

  // stages ring rows [lo, hi) and dz row i (relative to h0)
  auto stage = [&](int i, int64_t lo, int64_t hi) {
    for (int64_t rr = lo; rr < hi; ++rr) {
      const int64_t xr = xrow0 + rr;
      const bool in = xr >= 0 && xr < H;
      stage_row(xs + (rr % NR) * XC * kCW,
                x + (b * H + (in ? xr : 0)) * W * C, in, xcol0, nx, W, C, c0,
                vec_x, tid, nt);
    }
    stage_row(dzs + (i % (kAhead + 1)) * kSeg * kCW,
              dz + (b * Ho + h0 + i) * Wo * C, true, w0, ncols, Wo, C, c0,
              vec_dz, tid, nt);
  };

  float acc[K][4];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[s][v] = 0.f;

  const int rows = (int)(h1 - h0);
  // row i reads ring rows [i S, i S + K): row 0 brings K, each later one S
  stage(0, 0, K);
  sm90::cp_async_commit();
#pragma unroll
  for (int i = 1; i < kAhead; ++i) {
    if (i < rows) stage(i, (int64_t)i * S + K - S, (int64_t)i * S + K);
    sm90::cp_async_commit();
  }
  for (int i = 0; i < rows; ++i) {
    const int ia = i + kAhead;
    if (ia < rows) stage(ia, (int64_t)ia * S + K - S, (int64_t)ia * S + K);
    sm90::cp_async_commit();
    sm90::cp_async_wait<kAhead>();
    __syncthreads();

    const int64_t xr = xrow0 + (int64_t)i * S + r;
    if (xr >= 0 && xr < H && j0 < j1) {
      const float* xrow = xs + (((int64_t)i * S + r) % NR) * XC * kCW + 4 * tx;
      const float* drow = dzs + (i % (kAhead + 1)) * kSeg * kCW + 4 * tx;
      float4 win[K];
#pragma unroll
      for (int s = 0; s < K; ++s) win[s] = ld4(xrow + (j0 * S + s) * kCW);
      for (int j = j0;;) {
        const float4 g = ld4(drow + j * kCW);
#pragma unroll
        for (int s = 0; s < K; ++s) {
          acc[s][0] = fmaf(g.x, win[s].x, acc[s][0]);
          acc[s][1] = fmaf(g.y, win[s].y, acc[s][1]);
          acc[s][2] = fmaf(g.z, win[s].z, acc[s][2]);
          acc[s][3] = fmaf(g.w, win[s].w, acc[s][3]);
        }
        if (++j == j1) break;
#pragma unroll
        for (int s = 0; s < K - S; ++s) win[s] = win[s + S];
#pragma unroll
        for (int s = K - S; s < K; ++s) win[s] = ld4(xrow + (j * S + s) * kCW);
      }
    }
    __syncthreads();  // this row's slots are read before they refill
  }

  // sums over the column runs, in order
  sm90::cp_async_wait<0>();
  float* red = xs;  // [K][K][kRuns][32]
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int v = 0; v < 4; ++v)
      red[((r * K + s) * kRuns + run) * kCW + 4 * tx + v] = acc[s][v];
  __syncthreads();
  for (int i = tid; i < K * K * kCW; i += nt) {
    const int rs = i / kCW, ch = i % kCW;
    if (c0 + ch >= C) continue;
    float sum = 0.f;
    for (int u = 0; u < kRuns; ++u) sum += red[(rs * kRuns + u) * kCW + ch];
    ws[(tile * K * K + rs) * C + c0 + ch] = sum;
  }
}

// dw[i] = the sum over the tiles of ws[t][i], in a fixed order: thread
// (x, y) of a block adds tiles y, y + L, y + 2L, ... (L = blockDim.y) of
// output 32 blockIdx.x + x, then the L partial sums are added in order.
__global__ void __launch_bounds__(32 * kSumLanes)
dwgrad_sum(const float* __restrict__ ws, float* __restrict__ dw, int64_t n,
           int64_t tiles) {
  __shared__ float part[kSumLanes][33];
  const int x = threadIdx.x, y = threadIdx.y, lanes = blockDim.y;
  const int64_t i = blockIdx.x * 32LL + x;
  float s = 0.f;
  if (i < n)
    for (int64_t t = y; t < tiles; t += lanes) s += ws[t * n + i];
  part[y][x] = s;
  __syncthreads();
  if (y == 0 && i < n) {
    float sum = 0.f;
    for (int u = 0; u < lanes; ++u) sum += part[u][x];
    dw[i] = sum;
  }
}

struct Args {
  const void* x; const float* dz; float* ws; float* dw;
  int64_t B, H, W, C, Ho, Wo;
  int pad_top, pad_left;
  cudaStream_t stream;
};

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int K, int S>
cudaError_t launch(const Args& a) {
  const int64_t n = (int64_t)K * K * a.C;
  if (a.B * a.Ho * a.Wo == 0)
    return cudaMemsetAsync(a.dw, 0, n * sizeof(float), a.stream);
  const Plan p = plan(a.B, a.Ho, a.Wo, a.C);
  const int64_t tiles = a.B * p.tiles();
  constexpr size_t smem = smem_floats<K, S>() * sizeof(float);
  static bool configured = false;
  cudaError_t err = sm90::configure(dwgrad_partial<T, K, S>, configured, smem);
  if (err != cudaSuccess) return err;
  const bool vec_dz = a.C % 4 == 0 && aligned(a.dz, 16);
  const bool vec_x = vec_dz && aligned(a.x, 16);  // f32 x only
  const dim3 grid((unsigned)p.strips, (unsigned)tiles);
  const dim3 block(kTX, kRuns, K);
  dwgrad_partial<T, K, S><<<grid, block, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.dz, a.ws, a.H, a.W, a.C, a.Ho, a.Wo,
      a.pad_top, a.pad_left, p, vec_x, vec_dz);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 sum_block(32, (unsigned)(tiles < kSumLanes ? tiles : kSumLanes));
  dwgrad_sum<<<(unsigned)((n + 31) / 32), sum_block, 0, a.stream>>>(
      a.ws, a.dw, n, tiles);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_ks(const Args& a, int k, int stride) {
  if (k == 3 && stride == 1) return launch<T, 3, 1>(a);
  if (k == 3 && stride == 2) return launch<T, 3, 2>(a);
  if (k == 5 && stride == 1) return launch<T, 5, 1>(a);
  if (k == 5 && stride == 2) return launch<T, 5, 2>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of f32 workspace dfd_depthwise_dwgrad needs for these shapes.
extern "C" int64_t dfd_depthwise_dwgrad_workspace(int64_t B, int64_t Ho,
                                                  int64_t Wo, int64_t C,
                                                  int k) {
  if (B * Ho * Wo == 0) return 0;
  return B * plan(B, Ho, Wo, C).tiles() * k * k * C;
}

// x (B, H, W, C) in dtype 0 = float32 or 1 = bfloat16; dz (B, Ho, Wo, C)
// float32; ws the workspace above; dw (k, k, C) float32, fully written.
// Returns the cudaError_t of the launches; the caller raises on anything
// but 0.
extern "C" int dfd_depthwise_dwgrad(const void* x, const void* dz, void* ws,
                                    void* dw, int64_t B, int64_t H, int64_t W,
                                    int64_t C, int64_t Ho, int64_t Wo, int k,
                                    int stride, int pad_top, int pad_left,
                                    int dtype, void* stream) {
  const Args a{x, static_cast<const float*>(dz), static_cast<float*>(ws),
               static_cast<float*>(dw), B, H, W, C, Ho, Wo, pad_top, pad_left,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_ks<float>(a, k, stride);
  if (dtype == 1) return (int)launch_ks<__nv_bfloat16>(a, k, stride);
  return (int)cudaErrorInvalidValue;
}
