// Shared device helpers: cp.async copies into shared memory with zero fill
// (the conv kernels' strips and rows), the shared-memory address of a
// pointer, the packing of two floats into a bf16 pair (the Hopper
// kernels' A fragments, hopper.cuh) and their split into bf16 terms (the
// attention kernels' fp32 operands, P and dS).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace ladcast {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes when `valid`, else 16 zero bytes (src-size 0: nothing is read, so
// `gmem` may be any address inside the tensor).
__device__ __forceinline__ void cp_async16_zfill(void* smem, const void* gmem,
                                                 bool valid) {
  const int n = valid ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "r"(n));
}

// The same for BYTES = 4 or 8 (cp.async.ca: the only form below 16 bytes).
template <int BYTES>
__device__ __forceinline__ void cp_async_small_zfill(void* smem, const void* gmem,
                                                     bool valid) {
  const int n = valid ? BYTES : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n"
               :: "r"(smem_addr(smem)), "l"(gmem), "n"(BYTES), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The bf16 pair nearest (x, y), packed; x and y are left holding what it
// leaves of them (exact in fp32). Called n times, it gives the n bf16 terms
// that carry two fp32 values through the tensor cores' products.
__device__ __forceinline__ uint32_t take_bf16x2(float& x, float& y) {
  const __nv_bfloat162 t = __floats2bfloat162_rn(x, y);
  x -= __low2float(t);
  y -= __high2float(t);
  return *reinterpret_cast<const uint32_t*>(&t);
}

}  // namespace ladcast
