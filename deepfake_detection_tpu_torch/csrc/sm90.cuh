// What the card offers the port's kernels that stage tiles in shared memory
// by cp.async (flash_tf32.cuh's flash kernels, depthwise_dwgrad.cu), as
// PTX, and the one-time raise of a kernel's shared-memory limit.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sm90 {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global src to shared dst, the last 16 - bytes zero-filled.
__device__ __forceinline__ void cp_async16(float* dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

// 4 bytes, or a zero where bytes == 0.
__device__ __forceinline__ void cp_async4(float* dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Raises the kernel's dynamic shared-memory limit to `smem` bytes once
// (`configured`, one flag per kernel instantiation), so that later
// launches, which a CUDA graph may capture, are launches only.
template <typename Kernel>
cudaError_t configure(Kernel kernel, bool& configured, size_t smem) {
  if (configured) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err == cudaSuccess) configured = true;
  return err;
}

}  // namespace sm90
