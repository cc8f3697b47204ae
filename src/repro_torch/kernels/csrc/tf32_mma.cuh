// Tensor-core helpers of the kernels that multiply on the tensor cores
// (paged_append_attention.cu, flash_attention.cu, ssd_scan.cu): TF32
// rounding and the 3xTF32 split of fp32 operands, one m16n8k8 TF32
// mma.sync, the 16-byte cp.async copies that stage tiles in shared memory,
// and, on the host, the grant of the dynamic shared memory their blocks
// take.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace repro {

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero): add half an ulp of the 10-bit mantissa to the bits, clear the
// low 13.  Two integer operations at the full rate, where the cvt runs on
// the conversion unit at a fraction of it.  x is finite.
__device__ __forceinline__ uint32_t to_tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

// x = hi + lo + O(2^-22 |x|), both exact in TF32
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi,
                                           uint32_t& lo) {
  hi = to_tf32(x);
  lo = to_tf32(x - __uint_as_float(hi));
}

// c += a . b on one m16n8k8 TF32 fragment
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}
// 16 bytes to shared memory of which the first `bytes` are read from src
// and the rest are zero; src is 16-byte aligned even when bytes is 0
__device__ __forceinline__ void cp_async16z(void* dst, const void* src,
                                            int bytes) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s),
               "l"(src), "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// Lets kKernel take `bytes` of dynamic shared memory on the current card:
// above 48 KB only on request.  The grant is an attribute of the function
// on one device, so what was granted is kept per device.
template <auto kKernel>
cudaError_t allow_smem(size_t bytes) {
  constexpr int kCards = 64;
  static size_t granted[kCards] = {};
  if (bytes <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  const bool kept = dev < kCards;
  if (kept && bytes <= granted[dev]) return cudaSuccess;
  e = cudaFuncSetAttribute(kKernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                           (int)bytes);
  if (e == cudaSuccess && kept) granted[dev] = bytes;
  return e;
}

}  // namespace repro
