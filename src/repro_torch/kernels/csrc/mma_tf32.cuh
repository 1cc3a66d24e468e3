// f32 products on Hopper's TF32 tensor cores at near-f32 accuracy, and the
// asynchronous 16-byte copies that stage their operands (sm_80+ PTX).
// Shared by linear_scan.cu and flash_prefill_block.cu.
//
// An f32 operand x is split into hi + lo: hi keeps the sign, the exponent
// and the top 10 mantissa bits (a mask), lo = x - hi is exact in f32 and
// goes in as it is (the tensor cores read its top bits), so |x - hi -
// lo_read| <= 2^-20 |x|.  A product then runs as three mma.sync m16n8k8
// TF32 products, lo.hi + hi.lo + hi.hi (the small terms first, lo.lo
// dropped): ~2^-19 relative error per product at f32's exponent range.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ void cp_async16(float* dst, const float* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(static_cast<uint32_t>(__cvta_generic_to_shared(dst))), "l"(src),
                  "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() { cp_async_wait<0>(); }

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

// d += a b: A a 16 x 8 row fragment, B an 8 x 8 column fragment (PTX ISA,
// "Matrix Fragments for mma.m16n8k8" with .tf32)
__device__ __forceinline__ void mma_tf32(float* d, const uint32_t* a, const uint32_t* b) {
  asm(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

}  // namespace
