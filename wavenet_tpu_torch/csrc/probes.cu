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
//      slices of a product; an f32 concat contracted on its lanes.  bf16
//      products are summed exactly in f64 and rounded once (the decode
//      kernels' recipe), f32 ones in f32 in order k = 0, 1, ...
//   P4 probe_shift (tools/tpu_concat_probe.py::kA-kD): the time-axis
//      concatenations of the causal shift, ring or snapshot slice + value
//      (forward) and value tail + ring slice (backward dz ring), as one
//      gather per output element.
//
// All four are latency-bound at the probes' sizes (16-512 KB moved, under
// 10 MFLOP): one launch each, no tiling beyond a block per row group.
// Built by ops/cuda/build.py like the other sources; bound by
// ops/cuda/probes.py.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "gate.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kTile = 8 * 128;   // one [8, 128] f32 tile: a thread an element
constexpr int kLaneRows = 8;     // rows of a P3 block

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

// P2: elementwise over n inputs.
__global__ void gate_kernel(const float* __restrict__ x, float* __restrict__ t,
                            float* __restrict__ s, float* __restrict__ g,
                            int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const float z = x[i];
  t[i] = tanhf(z);
  s[i] = sigmoidf(z);
  g[i] = __fmul_rn(tanhf(z), sigmoidf(z));
}

// P3, case a: o [T, N] = [a | b] @ w, a and b [T, 64] bf16, w [128, N]
// bf16; exact f64 sums.  Block: kLaneRows rows x N columns.
__global__ void lane_cat_dot_kernel(const bf16* __restrict__ a,
                                    const bf16* __restrict__ b,
                                    const bf16* __restrict__ w,
                                    float* __restrict__ o, int T, int N) {
  __shared__ double cat[kLaneRows][128];   // [a | b], bf16 values in f64
  const int r0 = blockIdx.x * kLaneRows;
  for (int i = threadIdx.x; i < kLaneRows * 128; i += blockDim.x) {
    const int r = i / 128, k = i % 128, t = r0 + r;
    double v = 0.0;
    if (t < T)
      v = (double)__bfloat162float(k < 64 ? a[(size_t)t * 64 + k]
                                          : b[(size_t)t * 64 + k - 64]);
    cat[r][k] = v;
  }
  __syncthreads();
  const int n = threadIdx.x % N, r = threadIdx.x / N, t = r0 + r;
  if (t >= T) return;
  double acc = 0.0;
  for (int k = 0; k < 128; ++k)
    acc = fma(cat[r][k], (double)__bfloat162float(w[(size_t)k * N + n]), acc);
  o[(size_t)t * N + n] = __double2float_rn(acc);
}

// P3, case b: o = h @ w_rs ([T, 64] bf16 x [64, 128] bf16, exact), then
// o1 = o[:, :64] * 2 + 1 and o2 = o[:, 64:] * 3 - 1 in f32.
__global__ void lane_slice_kernel(const bf16* __restrict__ h,
                                  const bf16* __restrict__ w,
                                  float* __restrict__ o1,
                                  float* __restrict__ o2, int T) {
  __shared__ double hs[kLaneRows][64];
  const int r0 = blockIdx.x * kLaneRows;
  for (int i = threadIdx.x; i < kLaneRows * 64; i += blockDim.x) {
    const int r = i / 64, k = i % 64, t = r0 + r;
    hs[r][k] = t < T ? (double)__bfloat162float(h[(size_t)t * 64 + k]) : 0.0;
  }
  __syncthreads();
  const int n = threadIdx.x % 128, r = threadIdx.x / 128, t = r0 + r;
  if (t >= T) return;
  double acc = 0.0;
  for (int k = 0; k < 64; ++k)
    acc = fma(hs[r][k], (double)__bfloat162float(w[k * 128 + n]), acc);
  const float v = __double2float_rn(acc);
  if (n < 64)
    o1[(size_t)t * 64 + n] = __fadd_rn(__fmul_rn(v, 2.0f), 1.0f);
  else
    o2[(size_t)t * 64 + n - 64] = __fsub_rn(__fmul_rn(v, 3.0f), 1.0f);
}

// P3, case c: o [T, 64] = [x | y] contracted on its 128 lanes with w
// [64, 128] f32 (dot_general (1, 1)): o[t, n] = sum_k cat[t, k] w[n, k],
// summed in f32 in order k = 0..127.
__global__ void lane_f32_kernel(const float* __restrict__ x,
                                const float* __restrict__ y,
                                const float* __restrict__ w,
                                float* __restrict__ o, int T) {
  __shared__ float cat[kLaneRows][128];
  const int r0 = blockIdx.x * kLaneRows;
  for (int i = threadIdx.x; i < kLaneRows * 128; i += blockDim.x) {
    const int r = i / 128, k = i % 128, t = r0 + r;
    cat[r][k] = t < T ? (k < 64 ? x[(size_t)t * 64 + k]
                                : y[(size_t)t * 64 + k - 64]) : 0.0f;
  }
  __syncthreads();
  const int n = threadIdx.x % 64, r = threadIdx.x / 64, t = r0 + r;
  if (t >= T) return;
  float acc = 0.0f;
  for (int k = 0; k < 128; ++k)
    acc = __fadd_rn(acc, __fmul_rn(cat[r][k], w[n * 128 + k]));
  o[(size_t)t * 64 + n] = acc;
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
  gate_kernel<<<(n + 255) / 256, 256, 0, (cudaStream_t)stream>>>(x, t, sg, g,
                                                                 n);
  return (int)cudaGetLastError();
}

// P3.  case 0 (kernel_a): a, b [T, 64] bf16, w [128, 64] bf16 -> o1
// [T, 64]; case 1 (kernel_b): a = h [T, 64] bf16, w [64, 128] bf16 -> o1,
// o2 [T, 64]; case 2 (kernel_c): a = x, b = y [T, 64] f32, w [64, 128] f32
// -> o1 [T, 64].
int wn_probe_lane(int which, const void* a, const void* b, const void* w,
                  float* o1, float* o2, int T, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int grid = (T + kLaneRows - 1) / kLaneRows;
  if (T < 1) return (int)cudaErrorInvalidValue;
  switch (which) {
    case 0:
      lane_cat_dot_kernel<<<grid, kLaneRows * 64, 0, s>>>(
          (const bf16*)a, (const bf16*)b, (const bf16*)w, o1, T, 64);
      break;
    case 1:
      lane_slice_kernel<<<grid, kLaneRows * 128, 0, s>>>(
          (const bf16*)a, (const bf16*)w, o1, o2, T);
      break;
    case 2:
      lane_f32_kernel<<<grid, kLaneRows * 64, 0, s>>>(
          (const float*)a, (const float*)b, (const float*)w, o1, T);
      break;
    default:
      return (int)cudaErrorInvalidValue;
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
