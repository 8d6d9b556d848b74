// bf16 -> f64 widening by integer operations, shared by the kernels that
// sum bf16 products exactly in f64: train_stack.cu (its f64 MMA operands)
// and the two decode kernels (decode_common.cuh's dot products).  A
// float -> double conversion runs at a quarter of the f64 FMA rate on
// Hopper; moving the fields with integer operations does not.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

// The bf16 value whose bits are h (the low 16) as a double, exactly: a
// normal number by moving its fields (integer operations), zero, a
// subnormal, an infinity or a NaN by a conversion.
__device__ __forceinline__ double bf2d(uint32_t h) {
  const uint32_t mag = h & 0x7fffu;
  if (mag - 0x80u >= 0x7f00u) return (double)__uint_as_float(h << 16);
  return __hiloint2double(
      (int)(((h & 0x8000u) << 16) | ((mag << 13) + 0x38000000u)), 0);
}

// The same for a bf16 value.
__device__ __forceinline__ double bf2d_v(__nv_bfloat16 v) {
  return bf2d((uint32_t)__bfloat16_as_ushort(v));
}

}  // namespace
