// The gate's transcendentals, one definition for every kernel that
// computes a WaveNet gate h = tanh(z_f) * sigmoid(z_g): the two decode
// kernels (through decode_common.cuh), train_stack.cu and probes.cu, whose
// probe_gate measures these very functions against the CPU's.  tanhf and
// expf are CUDA's accurate versions (no --use_fast_math, ops/cuda/build.py).
#pragma once

#include <math.h>

namespace {

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
}

}  // namespace
