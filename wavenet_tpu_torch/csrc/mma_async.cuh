// The f64 tensor-core product and the asynchronous copies into shared
// memory, shared by the kernels that sum bf16 (or f32) products exactly
// on the f64 tensor cores: train_stack.cu (mma_pass) and probes.cu (P3,
// which checks that pattern).
#pragma once

#include <stdint.h>

namespace {

// Asynchronous copies into shared memory; with !ok the destination is
// zero-filled and nothing is read.
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 8 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(ok ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until every committed group has landed.
__device__ __forceinline__ void cp_async_wait0() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// d += a . b, one m16n8k4 f64 tile: a [16][4] (rows g and g + 8 at column
// t of lane 4 g + t), b [4][8] (row t, column g), c [16][8] (rows g and
// g + 8 at columns 2t, 2t + 1).
__device__ __forceinline__ void mma_f64(double c[4], double a0, double a1,
                                        double b) {
  asm volatile(
      "mma.sync.aligned.m16n8k4.row.col.f64.f64.f64.f64 "
      "{%0,%1,%2,%3}, {%4,%5}, {%6}, {%0,%1,%2,%3};\n"
      : "+d"(c[0]), "+d"(c[1]), "+d"(c[2]), "+d"(c[3])
      : "d"(a0), "d"(a1), "d"(b));
}

}  // namespace
