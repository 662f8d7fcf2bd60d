// Asynchronous 16-byte copies from device to shared memory (cp.async),
// shared by the kernels that stage packed operands through two buffers
// (plucker.cu and compact.cu through plucker_planes.cuh, quad.cu).

#pragma once

#include <cuda_runtime.h>

namespace {

// 16-byte asynchronous copy from device to shared memory (both 16-byte
// aligned); a thread's copies complete in commit-group order.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's commit groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace
