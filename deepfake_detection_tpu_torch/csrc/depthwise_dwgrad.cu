// Depthwise conv weight gradient, NHWC:
//   dw[r, s, c] = sum_{b, h, w} dz[b, h, w, c] * x[b, h*S + r - pt, w*S + s - pl, c]
// (x outside its H x W reads as 0), f32 accumulation, x f32 or bf16, dz f32.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/depthwise_pallas.py
// ::_dwgrad_kernel (launched by _dwgrad_call), which carries the k*k x C sum
// in VMEM scratch across a sequential (batch, row-tile) grid.  Blocks on the
// card run in no order, so the sum is split in two passes instead:
//
// 1. dwgrad_partial: block (c-chunk, pixel tile) walks a contiguous range of
//    the B*Ho*Wo output pixels.  Threads run along C (threadIdx.x, 4 channels
//    a thread when C % 4 == 0 and the pointers align, so a warp reads whole
//    sectors of a pixel's channels), along pixels (threadIdx.y, strided) and
//    along the k tap rows (threadIdx.z): each thread keeps only the k x V
//    sums of its tap row in registers (32-56 registers), so several blocks
//    share an SM even at k = 5.  The block then reduces them over
//    threadIdx.y with a fixed tree in shared memory, one tap column at a
//    time, and writes its (k*k, C) partial to the workspace (tiles, k*k, C).
// 2. dwgrad_sum: one thread per (tap, c) adds the tiles in order.
//
// No atomics: the order of every sum depends only on the shapes, so two
// calls give bitwise-equal dw.  The halo is handled by bounds checks on x;
// no padded copy of x is made.  All offsets are 64-bit.
//
// What bounds it on an H100: memory.  It must read x and dz once each:
// 2*k*k FLOP per dz element against 8 bytes (f32 x and dz at stride 1),
// 2.25 FLOP per byte at k = 3 and 6.25 at k = 5, under the card's f32 ratio
// of 67 TFLOP/s to 3.35 TB/s = 20.  Reuse of x across taps comes from L1/L2;
// shared-memory halo tiles are later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes by deepfake_detection_tpu_torch/ops/depthwise.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;            // the second pass
constexpr int kPixelThreads = 128;       // threadIdx.x * threadIdx.y
constexpr int kMaxThreads = 5 * kPixelThreads;   // times k tap rows
constexpr int64_t kTargetBlocks = 1024;   // blocks of the first pass
constexpr int64_t kMinTilePixels = 32;

template <typename T, int V> struct Load;

template <> struct Load<float, 1> {
  static __device__ __forceinline__ void run(const float* p, float (&o)[1]) {
    o[0] = __ldg(p);
  }
};

template <> struct Load<float, 4> {
  static __device__ __forceinline__ void run(const float* p, float (&o)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
};

template <> struct Load<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&o)[1]) {
    o[0] = __bfloat162float(p[0]);
  }
};

template <> struct Load<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void run(const __nv_bfloat16* p,
                                             float (&o)[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, sizeof(lo));
    memcpy(&hi, &raw.y, sizeof(hi));
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
};

// The tiling depends on the shapes only (not on the vector width), so the
// workspace query and the launch agree.
struct Tiles {
  int64_t count;
  int64_t pixels;  // output pixels per tile
};

Tiles plan_tiles(int64_t B, int64_t Ho, int64_t Wo, int64_t C) {
  const int64_t P = B * Ho * Wo;
  int64_t chunks = C / 128;
  if (chunks < 1) chunks = 1;
  int64_t count = kTargetBlocks / chunks;
  const int64_t most = P / kMinTilePixels;
  if (count > most) count = most;
  if (count < 1) count = 1;
  const int64_t pixels = (P + count - 1) / count;
  return Tiles{pixels > 0 ? (P + pixels - 1) / pixels : 1,
               pixels > 0 ? pixels : 1};
}

template <typename T, int K, int S, int V>
__global__ void __launch_bounds__(kMaxThreads)
dwgrad_partial(const T* __restrict__ x, const float* __restrict__ dz,
               float* __restrict__ ws, int64_t B, int64_t H, int64_t W,
               int64_t C, int64_t Ho, int64_t Wo, int pad_top, int pad_left,
               int64_t tile_pixels) {
  extern __shared__ float red[];  // (K, blockDim.y, blockDim.x, V)
  const int tc = blockDim.x, tp = blockDim.y;
  const int tx = threadIdx.x, ty = threadIdx.y, r = threadIdx.z;
  const int64_t c0 = ((int64_t)blockIdx.x * tc + tx) * V;
  const bool active = c0 < C;
  const int64_t P = B * Ho * Wo;
  const int64_t p_begin = (int64_t)blockIdx.y * tile_pixels;
  int64_t p_end = p_begin + tile_pixels;
  if (p_end > P) p_end = P;

  float acc[K][V];
#pragma unroll
  for (int s = 0; s < K; ++s)
#pragma unroll
    for (int v = 0; v < V; ++v) acc[s][v] = 0.0f;

  if (active) {
    for (int64_t p = p_begin + ty; p < p_end; p += tp) {
      const int64_t wo = p % Wo;
      const int64_t rest = p / Wo;
      const int64_t ho = rest % Ho;
      const int64_t b = rest / Ho;
      const int64_t hi = ho * S - pad_top + r;
      if (hi < 0 || hi >= H) continue;
      float g[V];
      Load<float, V>::run(dz + p * C + c0, g);
      const T* xrow = x + (b * H + hi) * W * C + c0;
      const int64_t wi0 = wo * S - pad_left;
#pragma unroll
      for (int s = 0; s < K; ++s) {
        const int64_t wi = wi0 + s;
        if (wi < 0 || wi >= W) continue;
        float xv[V];
        Load<T, V>::run(xrow + wi * C, xv);
#pragma unroll
        for (int v = 0; v < V; ++v) acc[s][v] = fmaf(g[v], xv[v], acc[s][v]);
      }
    }
  }

  float* mine = red + (((int64_t)r * tp + ty) * tc + tx) * V;
#pragma unroll
  for (int s = 0; s < K; ++s) {
#pragma unroll
    for (int v = 0; v < V; ++v) mine[v] = acc[s][v];
    __syncthreads();
    for (int half = tp / 2; half > 0; half /= 2) {  // fixed tree over ty
      if (ty < half) {
        const float* other = mine + (int64_t)half * tc * V;
#pragma unroll
        for (int v = 0; v < V; ++v) mine[v] += other[v];
      }
      __syncthreads();
    }
    if (ty == 0 && active) {
      float* out = ws + ((int64_t)blockIdx.y * K * K + r * K + s) * C + c0;
#pragma unroll
      for (int v = 0; v < V; ++v) out[v] = mine[v];
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(kThreads)
dwgrad_sum(const float* __restrict__ ws, float* __restrict__ dw, int64_t n,
           int64_t tiles) {
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < n;
       i += (int64_t)gridDim.x * blockDim.x) {
    float s = 0.0f;
    for (int64_t t = 0; t < tiles; ++t) s += ws[t * n + i];
    dw[i] = s;
  }
}

struct Args {
  const void* x; const float* dz; float* ws; float* dw;
  int64_t B, H, W, C, Ho, Wo;
  int pad_top, pad_left;
  cudaStream_t stream;
};

template <typename T, int K, int S, int V>
cudaError_t launch(const Args& a) {
  const int64_t n = (int64_t)K * K * a.C;
  if (a.B * a.Ho * a.Wo == 0)
    return cudaMemsetAsync(a.dw, 0, n * sizeof(float), a.stream);
  const Tiles tiles = plan_tiles(a.B, a.Ho, a.Wo, a.C);
  const int64_t cv = (a.C + V - 1) / V;
  int tc = 1;
  while (tc < 32 && tc < cv) tc *= 2;
  const int tp = kPixelThreads / tc;
  const dim3 grid((unsigned)((cv + tc - 1) / tc), (unsigned)tiles.count);
  const dim3 block(tc, tp, K);
  const size_t smem = (size_t)K * tc * tp * V * sizeof(float);
  dwgrad_partial<T, K, S, V><<<grid, block, smem, a.stream>>>(
      static_cast<const T*>(a.x), a.dz, a.ws, a.B, a.H, a.W, a.C, a.Ho, a.Wo,
      a.pad_top, a.pad_left, tiles.pixels);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > 65535) blocks = 65535;  // the loop strides over the rest
  dwgrad_sum<<<(unsigned)blocks, kThreads, 0, a.stream>>>(a.ws, a.dw, n,
                                                          tiles.count);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int K, int S>
cudaError_t launch_vec(const Args& a) {
  const bool vec = a.C % 4 == 0 && aligned(a.x, 4 * sizeof(T)) &&
                   aligned(a.dz, 16) && aligned(a.ws, 16);
  return vec ? launch<T, K, S, 4>(a) : launch<T, K, S, 1>(a);
}

template <typename T>
cudaError_t launch_ks(const Args& a, int k, int stride) {
  if (k == 3 && stride == 1) return launch_vec<T, 3, 1>(a);
  if (k == 3 && stride == 2) return launch_vec<T, 3, 2>(a);
  if (k == 5 && stride == 1) return launch_vec<T, 5, 1>(a);
  if (k == 5 && stride == 2) return launch_vec<T, 5, 2>(a);
  return cudaErrorInvalidValue;
}

}  // namespace

// Floats of f32 workspace dfd_depthwise_dwgrad needs for these shapes.
extern "C" int64_t dfd_depthwise_dwgrad_workspace(int64_t B, int64_t Ho,
                                                  int64_t Wo, int64_t C,
                                                  int k) {
  return plan_tiles(B, Ho, Wo, C).count * k * k * C;
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
