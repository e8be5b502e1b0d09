// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): tile loads into shared memory, the
// mask, row reductions and the C-side launch checks.
//
// Layout: q, k, v, o and dO are (BH, L, D) row-major with D <= 128; lse and
// delta are (BH, Lq) float32.  A block owns one (bh, 64-row tile) and runs
// 256 threads as a 16 x 16 grid: ty = tid / 16 owns 4 consecutive rows of
// its 64-row tile, tx = tid % 16 owns 4 columns of a 64-column score tile
// (columns tx, tx+16, tx+32, tx+48) and D/16 consecutive columns of a
// (64, D) product.  The 16 threads of one ty are one half-warp, so a row's
// max and sum are 4 shuffles.
//
// Shared-memory tiles, all float32 (bf16 is widened at the load, as the TPU
// kernel casts every tile to f32):
//   T  "transposed"  [DT][68]: tile[d][r] = x[r][d]; a thread reads its 4
//                    rows as one float4 (a broadcast within the half-warp);
//   P  "permuted"    [DT][68]: tile[d][(r % 16) * 4 + r / 16] = x[r][d];
//                    thread tx reads rows tx, tx+16, tx+32, tx+48 as one
//                    float4 at [d][4 tx];
//   R  "rows"        [64][DT]: tile[r][d] = x[r][d], read as float4 along d.
// The row stride 68 = 64 + 4 keeps float4 alignment and spreads the
// transposed stores over the banks.  Rows past the end of the buffer and
// columns past D read as 0; DT is D rounded up to 32, 64 or 128.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace flash {

constexpr int kThreads = 256;
constexpr int kTile = 64;
constexpr int kTS = kTile + 4;  // row stride of the T and P tiles

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

enum class Layout { kT, kP, kR };

// Loads rows [0, min(rows, 64)) of the (rows, D) matrix at src into dst in
// the given layout, each value times mul (the scale of q), zero-filled.
template <Layout L, int DT, typename T>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          int rows, int D, float mul) {
  for (int i = threadIdx.x; i < kTile * DT; i += kThreads) {
    const int r = i / DT, d = i % DT;
    float v = 0.f;
    if (r < rows && d < D) v = to_f32(src[(int64_t)r * D + d]) * mul;
    if (L == Layout::kT) dst[d * kTS + r] = v;
    if (L == Layout::kP) dst[d * kTS + (r % 16) * 4 + r / 16] = v;
    if (L == Layout::kR) dst[r * DT + d] = v;
  }
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float a, float b, float c,
                                    float d) {
  *reinterpret_cast<float4*>(p) = make_float4(a, b, c, d);
}

// Loads NC consecutive floats of a row (NC = DT / 16: 2, 4 or 8).
template <int NC>
__device__ __forceinline__ void ld_row(const float* p, float (&out)[NC]) {
  if constexpr (NC == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    out[0] = v.x; out[1] = v.y;
  } else {
#pragma unroll
    for (int c = 0; c < NC; c += 4) {
      const float4 v = ld4(p + c);
      out[c] = v.x; out[c + 1] = v.y; out[c + 2] = v.z; out[c + 3] = v.w;
    }
  }
}

// acc[a][b] += sum_d A[d][a-th of 4] * B[d][b-th of 4] over d < DT, with A
// and B two T/P tiles read at the thread's float4 offsets.
template <int DT>
__device__ __forceinline__ void outer_4x4(float (&acc)[4][4], const float* A,
                                          int a_off, const float* B,
                                          int b_off) {
#pragma unroll 8
  for (int d = 0; d < DT; ++d) {
    const float4 a = ld4(A + d * kTS + a_off);
    const float4 b = ld4(B + d * kTS + b_off);
    const float av[4] = {a.x, a.y, a.z, a.w};
    const float bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
  }
}

// acc[i][c] += sum_j S[j][4 ty + i] * R[j][NC tx + c] over the 64 rows j:
// S a [64][68] score tile stored row-of-R-major, R a [64][DT] rows tile.
template <int DT>
__device__ __forceinline__ void scores_times_rows(float (&acc)[4][DT / 16],
                                                  const float* S, int ty,
                                                  const float* R, int tx) {
  constexpr int NC = DT / 16;
#pragma unroll 4
  for (int j = 0; j < kTile; ++j) {
    const float4 s = ld4(S + j * kTS + 4 * ty);
    const float sv[4] = {s.x, s.y, s.z, s.w};
    float r[NC];
    ld_row<NC>(R + j * DT + NC * tx, r);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < NC; ++c) acc[i][c] = fmaf(sv[i], r[c], acc[i][c]);
  }
}

// Max and sum over the 16 threads of a half-warp (one row group).
__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// The TPU kernels' mask: key kg (index in the KV buffer) is hidden from
// query qg (index in the Q buffer) when it is padding (kg >= seq_len) or,
// causal, when it lies after the query in the global sequence.
__device__ __forceinline__ bool masked(int qg, int kg, int seq_len,
                                       bool causal, int q_off, int kv_off) {
  return kg >= seq_len || (causal && kv_off + kg > q_off + qg);
}

// Whether the 64 x 64 tile (q rows from q0, keys from k0) holds a key some
// of its rows may see: the TPU kernels' `relevant` test.
__device__ __forceinline__ bool tile_relevant(int q0, int k0, int seq_len,
                                              bool causal, int q_off,
                                              int kv_off) {
  return k0 < seq_len && !(causal && kv_off + k0 > q_off + q0 + kTile - 1);
}

struct Args {
  const void* q; const void* k; const void* v; const void* dout;
  const float* lse; const float* delta;
  void* out0; void* out1;  // fwd: o, lse; dq: dq; dkv: dk, dv
  int BH, Lq, Lk, D, seq_len, causal, q_off, kv_off;
  float scale;
  cudaStream_t stream;
};

inline int head_tile(int D) {
  return D <= 32 ? 32 : D <= 64 ? 64 : D <= 128 ? 128 : 0;
}

// Launches with `smem` bytes of dynamic shared memory, raising the
// kernel's limit above 48 KB at its first launch (`configured`, one flag
// per kernel instantiation), so that later launches, which a CUDA graph may
// capture, are launches only.
template <typename Kernel, typename... A>
cudaError_t launch(Kernel kernel, bool& configured, dim3 grid, size_t smem,
                   cudaStream_t stream, A... args) {
  if (!configured) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    configured = true;
  }
  kernel<<<grid, kThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

inline bool valid(const Args& a) {
  return a.BH > 0 && a.BH <= 65535 && a.Lq > 0 && a.Lk > 0 && a.D > 0 &&
         head_tile(a.D) != 0 && a.seq_len >= 0 && a.seq_len <= a.Lk;
}

}  // namespace flash
