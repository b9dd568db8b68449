// Helpers shared by the deformable-conv kernels (dcn_fwd.cu, dcn_bwd.cu):
// cp.async copies into shared memory and fp32 products on the tensor cores
// as 3xTF32 (each operand split into a TF32 high part and a TF32 remainder;
// lo*hi + hi*lo + hi*hi keeps about fp32's accuracy).

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KT = 9;  // taps of a 3x3 kernel

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// 16 bytes from global to shared memory; bytes < 16 zero-fills the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(bytes));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}
// wait until at most N of this thread's committed groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// d += a b on a 16 x 8 x 8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(f));
  return r;
}
// v = hi + lo, both TF32 (dcn_fwd.cu)
__device__ __forceinline__ void split_tf32(float v, uint32_t& hi, uint32_t& lo) {
  hi = to_tf32(v);
  lo = to_tf32(v - __uint_as_float(hi));
}
// The same without the conversion unit (dcn_bwd.cu), whose
// cvt.rna.tf32.f32 issues at a fraction of the integer rate and bounded the
// backward's products: hi is v rounded to TF32 (nearest, ties away) by an
// integer add and mask, lo = v - hi is exact in fp32, and the tensor cores
// read lo's top 19 bits.
__device__ __forceinline__ void split_tf32_int(float v, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(v) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(v - __uint_as_float(hi));
}

}  // namespace
