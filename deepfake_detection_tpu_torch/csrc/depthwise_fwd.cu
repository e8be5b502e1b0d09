// Fused depthwise conv -> per-channel affine -> activation, forward, NHWC.
//
// Replaces the Pallas TPU kernel deepfake_detection_tpu/ops/depthwise_pallas.py
// ::_fwd_kernel (launched by _dw_call): y = act(dwconv(x, w) * scale + bias),
// f32 accumulation and epilogue, y in x's dtype.
//
// What bounds it on an H100: memory.  The stage must read x once and write y
// once (w, scale and bias are k*k*C + 2*C floats); at the flagship's shapes
// that is ~3 FLOP per byte in f32, far below the card's ratio of f32 rate to
// memory rate.  The design therefore aims at whole-sector, coalesced traffic:
//
// * threads run along C, so neighbouring threads touch neighbouring
//   addresses; with C % 4 == 0 and aligned pointers each thread moves 4
//   channels per access (16 bytes in f32, 8 in bf16), else one;
// * each thread computes a strip of TW output pixels along W for its
//   channels: per tap row it loads the (TW-1)*S+K input columns the strip
//   needs once into registers and reuses them across the K column taps and
//   the TW outputs; the k*k weights are read once per strip;
// * the halo is handled with bounds checks, so no padded copy of x exists
//   (the TPU version pads in XLA first, one more pass over memory);
// * all offsets are 64-bit: at batch 8 the first flagship stage already
//   holds 184 M elements.
//
// Shared-memory halo tiles, TMA and tuning are later work.
//
// Built with nvcc into a shared library with a plain C interface and loaded
// through ctypes by deepfake_detection_tpu_torch/ops/depthwise.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTW = 4;  // output pixels per thread along W

// V consecutive values of T moved as one access, converted to / from f32.
template <typename T, int V> struct Vec;

template <> struct Vec<float, 1> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[1]) {
    o[0] = __ldg(p);
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[1]) {
    p[0] = o[0];
  }
};

template <> struct Vec<float, 4> {
  static __device__ __forceinline__ void load(const float* p, float (&o)[4]) {
    const float4 v = __ldg(reinterpret_cast<const float4*>(p));
    o[0] = v.x; o[1] = v.y; o[2] = v.z; o[3] = v.w;
  }
  static __device__ __forceinline__ void store(float* p, const float (&o)[4]) {
    *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
  }
};

template <> struct Vec<__nv_bfloat16, 1> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[1]) {
    o[0] = __bfloat162float(p[0]);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p,
                                               const float (&o)[1]) {
    p[0] = __float2bfloat16_rn(o[0]);
  }
};

template <> struct Vec<__nv_bfloat16, 4> {
  static __device__ __forceinline__ void load(const __nv_bfloat16* p,
                                              float (&o)[4]) {
    const uint2 raw = __ldg(reinterpret_cast<const uint2*>(p));
    __nv_bfloat162 lo, hi;
    memcpy(&lo, &raw.x, sizeof(lo));
    memcpy(&hi, &raw.y, sizeof(hi));
    const float2 a = __bfloat1622float2(lo);
    const float2 b = __bfloat1622float2(hi);
    o[0] = a.x; o[1] = a.y; o[2] = b.x; o[3] = b.y;
  }
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

// act codes match FUSED_DW_ACTS in ops/depthwise.py: 0 none, 1 silu, 2 relu
__device__ __forceinline__ float apply_act(float u, int act) {
  if (act == 1) return u / (1.0f + expf(-u));
  if (act == 2) return fmaxf(u, 0.0f);
  return u;
}

template <typename T, int K, int S, int V>
__global__ void __launch_bounds__(kThreads)
dw_fwd_kernel(const T* __restrict__ x, const float* __restrict__ w,
              const float* __restrict__ scale, const float* __restrict__ bias,
              T* __restrict__ y, int64_t B, int64_t H, int64_t W, int64_t C,
              int64_t Ho, int64_t Wo, int pad_top, int pad_left, int act) {
  constexpr int NCOL = (kTW - 1) * S + K;  // input columns a strip reads
  const int64_t CV = C / V;
  const int64_t n_strip = (Wo + kTW - 1) / kTW;
  const int64_t total = B * Ho * n_strip * CV;
  for (int64_t idx = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
       idx < total; idx += (int64_t)gridDim.x * blockDim.x) {
    const int64_t c0 = (idx % CV) * V;
    int64_t rest = idx / CV;
    const int64_t wo0 = (rest % n_strip) * kTW;
    rest /= n_strip;
    const int64_t ho = rest % Ho;
    const int64_t b = rest / Ho;
    const int64_t hi0 = ho * S - pad_top;
    const int64_t wi0 = wo0 * S - pad_left;

    float acc[kTW][V];
#pragma unroll
    for (int t = 0; t < kTW; ++t)
#pragma unroll
      for (int v = 0; v < V; ++v) acc[t][v] = 0.0f;

#pragma unroll
    for (int r = 0; r < K; ++r) {
      const int64_t hi = hi0 + r;
      if (hi < 0 || hi >= H) continue;
      const T* xrow = x + (b * H + hi) * W * C + c0;
      float col[NCOL][V];
#pragma unroll
      for (int j = 0; j < NCOL; ++j) {
        const int64_t wi = wi0 + j;
        if (wi >= 0 && wi < W) {
          Vec<T, V>::load(xrow + wi * C, col[j]);
        } else {
#pragma unroll
          for (int v = 0; v < V; ++v) col[j][v] = 0.0f;
        }
      }
#pragma unroll
      for (int s = 0; s < K; ++s) {
        float wt[V];
        Vec<float, V>::load(w + (int64_t)(r * K + s) * C + c0, wt);
#pragma unroll
        for (int t = 0; t < kTW; ++t)
#pragma unroll
          for (int v = 0; v < V; ++v)
            acc[t][v] = fmaf(col[t * S + s][v], wt[v], acc[t][v]);
      }
    }

    float sc[V], bi[V];
    if (scale != nullptr) {
      Vec<float, V>::load(scale + c0, sc);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) sc[v] = 1.0f;
    }
    if (bias != nullptr) {
      Vec<float, V>::load(bias + c0, bi);
    } else {
#pragma unroll
      for (int v = 0; v < V; ++v) bi[v] = 0.0f;
    }
#pragma unroll
    for (int t = 0; t < kTW; ++t) {
      const int64_t wo = wo0 + t;
      if (wo >= Wo) break;
      float out[V];
#pragma unroll
      for (int v = 0; v < V; ++v)
        out[v] = apply_act(acc[t][v] * sc[v] + bi[v], act);
      Vec<T, V>::store(y + ((b * Ho + ho) * Wo + wo) * C + c0, out);
    }
  }
}

struct Args {
  const void* x; const float* w; const float* scale; const float* bias;
  void* y;
  int64_t B, H, W, C, Ho, Wo;
  int pad_top, pad_left, act;
  cudaStream_t stream;
};

template <typename T, int K, int S, int V>
cudaError_t launch(const Args& a) {
  const int64_t total = a.B * a.Ho * ((a.Wo + kTW - 1) / kTW) * (a.C / V);
  if (total == 0) return cudaSuccess;
  int64_t blocks = (total + kThreads - 1) / kThreads;
  if (blocks > 2147483647) blocks = 2147483647;  // the loop strides over rest
  dw_fwd_kernel<T, K, S, V><<<(unsigned)blocks, kThreads, 0, a.stream>>>(
      static_cast<const T*>(a.x), a.w, a.scale, a.bias, static_cast<T*>(a.y),
      a.B, a.H, a.W, a.C, a.Ho, a.Wo, a.pad_top, a.pad_left, a.act);
  return cudaGetLastError();
}

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

template <typename T, int K, int S>
cudaError_t launch_vec(const Args& a) {
  const bool vec = a.C % 4 == 0 && aligned(a.x, 4 * sizeof(T)) &&
                   aligned(a.y, 4 * sizeof(T)) && aligned(a.w, 16) &&
                   aligned(a.scale, 16) && aligned(a.bias, 16);
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

// dtype: 0 = float32, 1 = bfloat16 (x and y); w, scale, bias are float32,
// scale and bias may be null (identity).  Returns the cudaError_t of the
// launch; the caller raises on anything but 0.
extern "C" int dfd_depthwise_fwd(const void* x, const void* w,
                                 const void* scale, const void* bias, void* y,
                                 int64_t B, int64_t H, int64_t W, int64_t C,
                                 int64_t Ho, int64_t Wo, int k, int stride,
                                 int pad_top, int pad_left, int act, int dtype,
                                 void* stream) {
  if (act < 0 || act > 2) return (int)cudaErrorInvalidValue;
  const Args a{x, static_cast<const float*>(w),
               static_cast<const float*>(scale),
               static_cast<const float*>(bias), y, B, H, W, C, Ho, Wo,
               pad_top, pad_left, act, static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return (int)launch_ks<float>(a, k, stride);
  if (dtype == 1) return (int)launch_ks<__nv_bfloat16>(a, k, stride);
  return (int)cudaErrorInvalidValue;
}
