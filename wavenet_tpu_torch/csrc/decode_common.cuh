// Device helpers shared by the two whole-loop decode kernels, decode.cu
// (the narrow kernel) and decode_wide.cu (R a multiple of 128): the exact
// dot products, the bf16 rounding, the gate's sigmoid (gate.cuh) and the
// per-row argmax.
//
// Exact dot products: out = f32(sum over k of in[k] * W[k][o]) with the sum
// taken in f64.  Products of bf16 values are exact there and so is their
// sum (barring an exponent spread of ~30 binades), so the result is the
// correctly rounded f32 dot product, independent of summation order: the
// plain PyTorch version (models/wavenet.py _dot) gets the same bits, and a
// kernel may split one sum over several accumulators, threads or partial
// sums in any order.  W is [K, N] bf16 row-major ([in, out]); the input is
// held in shared memory as inT [K][BT] (BT batch rows), bf16 values stored
// as f64 (converted once when written).  dot_part (the wide kernel's)
// widens each weight once per use by integer operations (bf16_exact.cuh
// bf2d).  The narrow kernel (decode.cu) has its own lane loops over packed
// weights and widens by the float -> double conversion, which measured
// faster there than bf2d; it shares the rounding, the input rows' loads and
// the argmax.
#pragma once

#include <cuda_bf16.h>
#include <math.h>

#include "bf16_exact.cuh"
#include "gate.cuh"

namespace {

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// v[r] = p[r] for the BT rows of one k (16-byte shared loads).
template <int BT>
__device__ __forceinline__ void load_rows(const double* p, double v[BT]) {
  if constexpr (BT % 2 == 0) {
#pragma unroll
    for (int i = 0; i < BT; i += 2) {
      const double2 q = *reinterpret_cast<const double2*>(p + i);
      v[i] = q.x; v[i + 1] = q.y;
    }
  } else {
    v[0] = p[0];
  }
}

// A phase is bound by latency (L2 loads, then a chain of dependent f64
// FMAs), so the weight loads are double-buffered in batches of kHalf (the
// next batch is in flight while the current one is summed) and a row uses
// up to 4 independent accumulators.  A range whose length is not a multiple
// of kHalf ends with single loads.
constexpr int kHalf = 16;

template <int BT, int NA>
__device__ __forceinline__ void fma_batch(double (&acc)[NA][BT],
                                          const __nv_bfloat16 (&wk)[kHalf],
                                          const double* inT, int k0) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const double wj = bf2d_v(wk[j]);
    double v[BT];
    load_rows<BT>(inT + (k0 + j) * BT, v);
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[j % NA][r] = fma(v[r], wj, acc[j % NA][r]);
  }
}

__device__ __forceinline__ void load_batch(__nv_bfloat16 (&wk)[kHalf],
                                           const __nv_bfloat16* w, int k0,
                                           int N) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) wk[j] = w[(size_t)(k0 + j) * N];
}

// sum[r] = sum over k in [kb, ke) of inT[k][r] * W[k][o], exact in f64.
template <int BT>
__device__ __forceinline__ void dot_part(const __nv_bfloat16* __restrict__ W,
                                         int kb, int ke, int N, int o,
                                         const double* inT, double sum[BT]) {
  constexpr int NA = BT >= 4 ? 1 : 4 / BT;   // accumulators per row
  double acc[NA][BT];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[a][r] = 0.0;
  const __nv_bfloat16* w = W + o;
  int k = kb;
  if (ke - k >= kHalf) {
    __nv_bfloat16 wa[kHalf], wb[kHalf];
    load_batch(wa, w, k, N);
    while (ke - k >= 2 * kHalf) {
      load_batch(wb, w, k + kHalf, N);
      fma_batch<BT, NA>(acc, wa, inT, k);
      if (ke - k >= 3 * kHalf) load_batch(wa, w, k + 2 * kHalf, N);
      fma_batch<BT, NA>(acc, wb, inT, k + kHalf);
      k += 2 * kHalf;
    }
    if (ke - k >= kHalf) {
      fma_batch<BT, NA>(acc, wa, inT, k);
      k += kHalf;
    }
  }
  for (; k < ke; ++k) {
    const double wj = bf2d_v(w[(size_t)k * N]);
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[0][r] = fma(inT[k * BT + r], wj, acc[0][r]);
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    double t = acc[0][r];
#pragma unroll
    for (int a = 1; a < NA; ++a) t += acc[a][r];
    sum[r] = t;
  }
}

// First-index argmax of row r's Q scores (scoreT [Q][BT]), taken by one
// whole warp; the index is valid in lane 0.
template <int BT>
__device__ __forceinline__ int warp_argmax(const float* scoreT, int Q, int r,
                                           int lane) {
  float best = -INFINITY;
  int bi = Q;                      // sentinel: nothing seen yet
  for (int q = lane; q < Q; q += 32) {
    const float v = scoreT[q * BT + r];
    if (v > best || bi == Q) { best = v; bi = q; }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (oi < Q && (bi == Q || ov > best || (ov == best && oi < bi))) {
      best = ov;
      bi = oi;
    }
  }
  return bi;
}

}  // namespace
