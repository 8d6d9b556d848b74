// Hopper counterparts of the Mosaic probes in tools/, the small kernels the
// reference's verify tool was built around.  On the card the questions they
// asked of Mosaic become checks of the port's own patterns:
//
//   P1 probe_scratch (tools/tpu_scratch_test.py::kern,
//      tools/tpu_scratch2d.py::kern, kern2, kern3): scratch that persists
//      across a sequential grid.  A TPU grid runs in order on one core; CUDA
//      blocks run in no order, so one block owns a grid row and walks its
//      tiles in a loop, the scratch in shared memory (mode 0 accumulate,
//      1 reset at each row's first tile, 2 a ring read before it is
//      written, 3 a partial store from a second buffer read back the next
//      tile).  Mode 4 runs mode 2's body with every tile its own launch and
//      the ring in device memory passed from launch to launch: the decode
//      kernels' rings carried across chunk launches.
//   P2 probe_gate (tools/tpu_tanh_probe.py::kern): tanhf, sigmoidf and
//      their product, the gate.cuh functions every kernel's gate runs.
//   P3 probe_lane (tools/tpu_lane_ops_check.py::kernel_a, kernel_b,
//      kernel_c): [a | b] staged in shared memory as one [rows, 128]
//      operand (train_stack.cu's [x | shift_d x]) feeding a product; lane
//      slices of a product; an f32 concat contracted on its lanes.  The
//      products run as train_stack.cu's mma_pass runs them: staged by
//      cp.async, m16n8k4 MMAs on the f64 tensor cores (mma_async.cuh), every
//      product exact in f64, rounded to f32 once.
//   P4 probe_shift (tools/tpu_concat_probe.py::kA-kD): the time-axis
//      concatenations of the causal shift, ring or snapshot slice + value
//      (forward) and value tail + ring slice (backward dz ring), as one
//      gather per output element.
//
// What bounds each on this card, at the verify tool's sizes, and what the
// design does about it:
//   * P1 and P4 move 8-512 KB and compute nothing: a launch's own cost
//     (~2 us back to back) is their time, far above their bytes' (<0.2 us).
//     One launch each (mode 4 one a tile, by design), a block per grid row
//     or 256 elements.
//   * P2 reads 32 KB and writes 96 KB at n = 8,192, ~0.04 us at the memory
//     rate: launch-bound too, and past the launch bound by the chain each
//     thread runs (tanhf, expf, a division) more than by its memory
//     instructions.  It computes tanhf and sigmoidf once each (gate.cuh's
//     accurate functions, no fast math) and takes two elements a thread by
//     one 8-byte load and three 8-byte stores (4,096 threads at n =
//     8,192).  Where x or an output is off 8-byte alignment (x a view at
//     an offset), every element is taken one at a time, and an odd n's
//     last element too, inside the same launch.
//   * P3 does 4.2 MFLOP a case at T = 256, ~0.06 us at the f64 tensor
//     cores' 67 TFLOP/s, beside ~0.05 us of bytes.  Run as serial f64 FMA
//     chains on CUDA cores (128 dependent FMAs a thread, 32 blocks) it took
//     ~16 us a case.  On the tensor cores it takes ~3 us, ~0.8 us above a
//     launch (the copies' latency and the MMA chain): each block computes
//     one m16n8 output tile with its contraction split over four warps (8
//     or 4 MMAs each), and the four f64 partials are added in shared
//     memory in a fixed order: [N / 8, ceil(T / 16)] blocks, 128-256 at
//     T = 256.  The bf16 cases' sums are exact whatever their order
//     (train_stack.cu's argument), so they equal the plain version's
//     float64 product bit for bit; case c's f32 x f32 products are exact in
//     f64 too, their f64 sum rounded once.  Rows past T are zero-filled by
//     the copies and not stored, so any T >= 1 runs.  The 16-byte copies
//     need every operand 16-byte aligned: one that is not (a view at an
//     offset) is refused, not staged another way.
// Built by ops/cuda/build.py like the other sources; bound by
// ops/cuda/probes.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_exact.cuh"
#include "gate.cuh"
#include "mma_async.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 8 * 128;   // one [8, 128] f32 tile: a thread an element
constexpr int kGateThreads = 256;
constexpr int kLaneWarps = 4;    // P3's warps a block, each a share of K
constexpr int kLaneThreads = 32 * kLaneWarps;

// P1, modes 0-3: block = grid row, 1024 threads = one tile's elements.
__global__ void __launch_bounds__(kTile)
scratch_kernel(float* __restrict__ out, int mode, int tiles) {
  __shared__ float ring[2 * kTile];      // [16, 128]; modes 0-2 use [8, 128]
  __shared__ float buf[2 * kTile];       // [16, 128] (mode 3)
  const int e = threadIdx.x;
  float* o = out + (size_t)blockIdx.x * tiles * kTile;
  for (int j = 0; j < tiles; ++j) {
    if (j == 0) {                        // pl.when(program_id == 0)
      ring[e] = 0.0f;
      ring[kTile + e] = 0.0f;
    }
    __syncthreads();
    if (mode <= 1) {                     // acc += 1; out = acc
      ring[e] += 1.0f;
      o[j * kTile + e] = ring[e];
    } else if (mode == 2) {              // out = ring; ring += j + 1
      o[j * kTile + e] = ring[e];
      ring[e] += (float)(j + 1);
    } else {                             // buf = j + 1; out = ring[0:8];
      buf[e] = (float)(j + 1);           // ring[0:8] = buf[8:16]
      buf[kTile + e] = (float)(j + 1);
      __syncthreads();
      o[j * kTile + e] = ring[e];
      __syncthreads();
      ring[e] = buf[kTile + e];
    }
    __syncthreads();
  }
}

// P1, mode 4: tile j of every grid row as its own launch, the ring
// [rows, 8, 128] in device memory carried from launch to launch.
__global__ void __launch_bounds__(kTile)
scratch_tile_kernel(float* __restrict__ out, float* __restrict__ ring,
                    int tiles, int j) {
  const int e = threadIdx.x;
  float* r = ring + (size_t)blockIdx.x * kTile;
  if (j == 0) r[e] = 0.0f;
  out[((size_t)blockIdx.x * tiles + j) * kTile + e] = r[e];
  r[e] += (float)(j + 1);
}

// P2, one element.
__device__ __forceinline__ void gate1(float z, float& t, float& s, float& g) {
  t = tanhf(z);
  s = sigmoidf(z);
  g = __fmul_rn(t, s);
}

// P2: x [n] -> t, s, g [n], elements 2 i and 2 i + 1 for thread i: one
// float2 access each where all four pointers are 8-byte aligned, else one
// element at a time.
__global__ void __launch_bounds__(kGateThreads)
gate_kernel(const float* __restrict__ x, float* __restrict__ t,
            float* __restrict__ s, float* __restrict__ g, int n) {
  const int e = 2 * (blockIdx.x * kGateThreads + threadIdx.x);
  const bool pairs = (((uintptr_t)x | (uintptr_t)t | (uintptr_t)s |
                       (uintptr_t)g) & 7) == 0;
  if (pairs && e + 1 < n) {
    const float2 z = *reinterpret_cast<const float2*>(x + e);
    float2 tv, sv, gv;
    gate1(z.x, tv.x, sv.x, gv.x);
    gate1(z.y, tv.y, sv.y, gv.y);
    *reinterpret_cast<float2*>(t + e) = tv;
    *reinterpret_cast<float2*>(s + e) = sv;
    *reinterpret_cast<float2*>(g + e) = gv;
    return;
  }
  for (int k = e; k < n && k < e + 2; ++k) gate1(x[k], t[k], s[k], g[k]);
}

// P3's operand types and widths by case (0: kernel_a, 1: kernel_b, 2:
// kernel_c): A [T, K] = [a | b] (case 1: h), W [K, N] (case 2: w [N, K],
// contracted on its lanes).
template <int kCase>
struct Lane {
  typedef bf16 E;
  static constexpr int K = kCase == 1 ? 64 : 128, N = kCase == 1 ? 128 : 64;
  static constexpr int kLdA = K + 8;   // A_s row stride: fragment reads on
                                       // distinct banks
  static __device__ __forceinline__ double widen(E v) { return bf2d_v(v); }
};
template <>
struct Lane<2> {
  typedef float E;
  static constexpr int K = 128, N = 64;
  static constexpr int kLdA = K + 4;
  static __device__ __forceinline__ double widen(E v) { return (double)v; }
};

// P3: one m16n8 tile of o = A W per block, rows m0 = 16 blockIdx.y + [0,
// 16), columns n0 = 8 blockIdx.x + [0, 8).  The A rows and W's eight
// columns are staged by cp.async (rows past T zero); warp w multiplies the
// contraction's share w on the f64 tensor cores, widening each fragment
// as it is read; the warps' partials are added in warp order in f64 and
// rounded to f32 once.  Case 1 writes o[:, :64] * 2 + 1 to o1 and
// o[:, 64:] * 3 - 1 to o2 (each rounding separate: no contraction).
template <int kCase>
__global__ void __launch_bounds__(kLaneThreads)
lane_kernel(const void* __restrict__ a_, const void* __restrict__ b_,
            const void* __restrict__ w_, float* __restrict__ o1,
            float* __restrict__ o2, int T) {
  typedef Lane<kCase> L;
  typedef typename L::E E;
  constexpr int K = L::K, N = L::N, kLdA = L::kLdA;
  constexpr int kV = 16 / sizeof(E);       // elements of a 16-byte copy
  constexpr int kKW = K / kLaneWarps;      // contraction columns a warp
  static_assert(kKW % 4 == 0, "a warp's share of K is whole k4 steps");
  // W's eight columns: [K][8] bf16, or w's eight rows [8][K + 4] f32
  constexpr int kWs = kCase == 2 ? 8 * (K + 4) : K * 8;
  __shared__ __align__(16) E A_s[16 * kLdA];
  __shared__ __align__(16) E W_s[kWs];
  __shared__ double part[kLaneWarps][16 * 8];
  const E* a = static_cast<const E*>(a_);
  const E* b = static_cast<const E*>(b_);
  const E* w = static_cast<const E*>(w_);
  const int tid = threadIdx.x, n0 = 8 * blockIdx.x, m0 = 16 * blockIdx.y;
  // A: row m0 + r is [a | b]'s (case 1: h's; its K = 64 never reaches b)
  for (int e = tid; e < 16 * (K / kV); e += kLaneThreads) {
    const int r = e / (K / kV), k = (e % (K / kV)) * kV, t = m0 + r;
    const E* src = k < 64 ? a + (size_t)t * 64 + k
                          : b + (size_t)t * 64 + (k - 64);
    cp_async16(A_s + r * kLdA + k, t < T ? src : a, t < T);
  }
  if (kCase == 2) {
    for (int e = tid; e < 8 * (K / kV); e += kLaneThreads) {
      const int c = e / (K / kV), k = (e % (K / kV)) * kV;
      cp_async16(W_s + c * (K + 4) + k, w + (size_t)(n0 + c) * K + k, true);
    }
  } else {
    for (int k = tid; k < K; k += kLaneThreads)
      cp_async16(W_s + k * 8, w + (size_t)k * N + n0, true);
  }
  cp_async_commit();
  cp_async_wait0();
  __syncthreads();
  // this lane's A elements: rows g and g + 8 at column k; its W element:
  // row k, column g
  const int wp = tid >> 5, g = (tid & 31) >> 2, k0 = wp * kKW + (tid & 3);
  double acc[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int kk = 0; kk < kKW; kk += 4) {
    const int k = k0 + kk;
    const E wv = kCase == 2 ? W_s[g * (K + 4) + k] : W_s[k * 8 + g];
    mma_f64(acc, L::widen(A_s[g * kLdA + k]),
            L::widen(A_s[(g + 8) * kLdA + k]), L::widen(wv));
  }
  double* p = part[wp];
  const int c2 = 2 * (tid & 3);
  p[g * 8 + c2] = acc[0];
  p[g * 8 + c2 + 1] = acc[1];
  p[(g + 8) * 8 + c2] = acc[2];
  p[(g + 8) * 8 + c2 + 1] = acc[3];
  __syncthreads();
  // element e of the tile: output row m0 + e / 8, column n0 + e % 8
  for (int e = tid; e < 16 * 8; e += kLaneThreads) {
    const int t = m0 + (e >> 3), n = n0 + (e & 7);
    if (t >= T) break;
    double sum = part[0][e];
#pragma unroll
    for (int q = 1; q < kLaneWarps; ++q) sum += part[q][e];
    const float v = __double2float_rn(sum);
    if (kCase != 1)
      o1[(size_t)t * N + n] = v;
    else if (n < 64)
      o1[(size_t)t * 64 + n] = __fadd_rn(__fmul_rn(v, 2.0f), 1.0f);
    else
      o2[(size_t)t * 64 + n - 64] = __fsub_rn(__fmul_rn(v, 3.0f), 1.0f);
  }
}

// P4: out [TT, R] f32, one thread an element.  mode 0 (and 1, the ring
// read from a [1, 1, rows, R] snapshot: the same memory): concat(ring[off:
// off + d], x[:TT - d]) * 2; mode 2: concat(x[d:], ring[off:off + d]) * 2;
// mode 3: as 2 on v = x * 1.5, rounded to f32 before the * 2.
__global__ void shift_kernel(int mode, const float* __restrict__ ring,
                             const float* __restrict__ x,
                             float* __restrict__ out, int TT, int R, int d,
                             int off) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= TT * R) return;
  const int t = i / R, c = i % R;
  float v;
  if (mode <= 1) {
    v = t < d ? ring[(size_t)(off + t) * R + c] : x[(size_t)(t - d) * R + c];
  } else if (t < TT - d) {
    v = x[(size_t)(t + d) * R + c];
    if (mode == 3) v = __fmul_rn(v, 1.5f);
  } else {
    v = ring[(size_t)(off + t - (TT - d)) * R + c];
  }
  out[i] = __fmul_rn(v, 2.0f);
}

}  // namespace

extern "C" {

// P1.  mode 0-3: one launch of `rows` blocks over `tiles` tiles; mode 4:
// the launch of tile `tile` only, ring [rows, 8, 128] f32 carried by the
// caller.  out [rows, tiles, 8, 128] f32.  Returns a cudaError_t code.
int wn_probe_scratch(float* out, float* ring, int mode, int rows, int tiles,
                     int tile, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (rows < 1 || tiles < 1 || mode < 0 || mode > 4 ||
      (mode == 4 && (ring == nullptr || tile < 0 || tile >= tiles)))
    return (int)cudaErrorInvalidValue;
  if (mode == 4)
    scratch_tile_kernel<<<rows, kTile, 0, s>>>(out, ring, tiles, tile);
  else
    scratch_kernel<<<rows, kTile, 0, s>>>(out, mode, tiles);
  return (int)cudaGetLastError();
}

// P2.  x [n] f32 -> tanh, sigmoid, gate [n] f32.
int wn_probe_gate(const float* x, float* t, float* sg, float* g, int n,
                  void* stream) {
  if (n < 1) return (int)cudaErrorInvalidValue;
  const int threads = (n + 1) / 2;
  gate_kernel<<<(threads + kGateThreads - 1) / kGateThreads, kGateThreads,
                0, (cudaStream_t)stream>>>(x, t, sg, g, n);
  return (int)cudaGetLastError();
}

// P3.  case 0 (kernel_a): a, b [T, 64] bf16, w [128, 64] bf16 -> o1
// [T, 64]; case 1 (kernel_b): a = h [T, 64] bf16, w [64, 128] bf16 -> o1,
// o2 [T, 64]; case 2 (kernel_c): a = x, b = y [T, 64] f32, w [64, 128] f32
// -> o1 [T, 64].  Every pointer 16-byte aligned.
int wn_probe_lane(int which, const void* a, const void* b, const void* w,
                  float* o1, float* o2, int T, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int rows = (T + 15) / 16;
  if (T < 1 || rows > 65535 || which < 0 || which > 2 ||
      (which == 1 && o2 == nullptr) || (which != 1 && b == nullptr))
    return (int)cudaErrorInvalidValue;
  if (((uintptr_t)a | (uintptr_t)b | (uintptr_t)w | (uintptr_t)o1 |
       (uintptr_t)o2) & 15)
    return (int)cudaErrorMisalignedAddress;
  switch (which) {
    case 0:
      lane_kernel<0><<<dim3(Lane<0>::N / 8, rows), kLaneThreads, 0, s>>>(
          a, b, w, o1, o2, T);
      break;
    case 1:
      lane_kernel<1><<<dim3(Lane<1>::N / 8, rows), kLaneThreads, 0, s>>>(
          a, b, w, o1, o2, T);
      break;
    default:
      lane_kernel<2><<<dim3(Lane<2>::N / 8, rows), kLaneThreads, 0, s>>>(
          a, b, w, o1, o2, T);
  }
  return (int)cudaGetLastError();
}

// P4.  mode 0-3 (kA-kD); ring [>= off + d, R] f32, x [TT, R] f32, out
// [TT, R] f32.
int wn_probe_shift(int mode, const float* ring, const float* x, float* out,
                   int TT, int R, int d, int off, void* stream) {
  if (mode < 0 || mode > 3 || TT < 1 || R < 1 || d < 0 || d > TT)
    return (int)cudaErrorInvalidValue;
  const int n = TT * R;
  shift_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(
      mode, ring, x, out, TT, R, d, off);
  return (int)cudaGetLastError();
}

const char* wn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
