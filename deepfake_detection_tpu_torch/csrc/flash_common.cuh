// Shared pieces of the flash-attention kernels (flash_fwd.cu,
// flash_bwd_dq.cu, flash_bwd_dkv.cu): the input types, the TPU kernels'
// mask and tile test, the arguments and the C-side launch checks.
//
// Layout: q, k, v, o and dO are (BH, L, D) row-major with D <= 128; lse and
// delta are (BH, Lq) float32.  Every kernel works on 64-row tiles; D is
// rounded up to a head tile DT of 32, 64 or 128 and the columns past D are
// zero.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "sm90.cuh"

namespace flash {

constexpr int kTile = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store_as(float* p, float v) { *p = v; }
__device__ __forceinline__ void store_as(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
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

// Launches `threads` threads a block with `smem` bytes of dynamic shared
// memory.
template <typename Kernel, typename... A>
cudaError_t launch(Kernel kernel, bool& configured, dim3 grid, int threads,
                   size_t smem, cudaStream_t stream, A... args) {
  const cudaError_t err = sm90::configure(kernel, configured, smem);
  if (err != cudaSuccess) return err;
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// What the card gives the kernel: out = {registers a thread, local
// (spill) bytes a thread, dynamic shared bytes a block, resident blocks
// per SM}.
template <typename Kernel>
cudaError_t kernel_info(Kernel kernel, bool& configured, int threads,
                        size_t smem, int* out) {
  cudaError_t err = sm90::configure(kernel, configured, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, kernel);
  if (err != cudaSuccess) return err;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, kernel,
                                                      threads, smem);
  out[0] = attr.numRegs;
  out[1] = (int)attr.localSizeBytes;
  out[2] = (int)smem;
  out[3] = blocks;
  return err;
}

inline bool valid(const Args& a) {
  return a.BH > 0 && a.BH <= 65535 && a.Lq > 0 && a.Lk > 0 && a.D > 0 &&
         head_tile(a.D) != 0 && a.seq_len >= 0 && a.seq_len <= a.Lk;
}

}  // namespace flash
