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
//      (forward) and value tail + ring slice (backward dz ring), row by
//      row.
//
// What bounds each on this card, at the verify tool's sizes, and what the
// design does about it:
//   * P1 and P4 move 8-512 KB and compute nothing: the launch (~2.25 us a
//     kernel back to back, a one-element add's) is their time, far above
//     their bytes' (<0.2 us).  What a design can take off is the rest:
//     the work past the launch, and, where launches follow one another
//     in a stream, the gap between them.
//     - P1, modes 0-3: one launch, a block of 256 threads per grid row
//       (1-2 blocks), thread i owning quad i of every [8, 128] tile, so
//       the scratch is read and written by 16-byte shared accesses with
//       no barrier (scratch_kernel's comment has the argument) and each
//       tile stored by 16-byte stores.
//     - P1, mode 4: one launch a tile, each carrying the ring [rows, 8,
//       128] in device memory to the next, as the decode kernels carry
//       their rings across chunk launches.  Each launch is made under
//       programmatic dependent launch (PDL: cudaLaunchKernelEx with
//       programmatic stream serialization): it lets the next launch begin
//       at once (griddepcontrol.launch_dependents) and waits
//       (griddepcontrol.wait) for the one before to complete, its writes
//       visible, before it touches any global memory.  The next launch's
//       set-up thus overlaps this one instead of following its drain.
//     - P4: the grid lies over rows, a block of 128 threads over 128 /
//       (R / 4) rows, each thread one 16-byte unit of its row (the row's
//       source, ring or x, picked once): at TT = 512, R = 64, 64 blocks,
//       the 128 KB a case reads and the 128 KB it writes in one
//       16-byte ld.global.nc and one 16-byte store a thread, one memory
//       round trip past the launch, no division by R.  Staging through
//       shared memory would add a copy with nothing to reuse.  Where R %
//       4 != 0 or ring, x or out is off 16-byte alignment (x a view at an
//       offset), the same launch takes one f32 a unit.
//     - P1's modes 0-3 and P4 are launched under PDL too, with every
//       global access after the wait: in a stream of such launches queued
//       back to back each one's set-up overlaps the one before it.  Where a
//       call is followed by a host copy (a verify run) only mode 4's chain
//       overlaps.
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

constexpr int kTile = 8 * 128;   // one [8, 128] f32 tile
constexpr int kQuads = kTile / 4;  // P1: a thread a quad (4 f32) of a tile
constexpr int kGateThreads = 256;
constexpr int kLaneWarps = 4;    // P3's warps a block, each a share of K
constexpr int kLaneThreads = 32 * kLaneWarps;
constexpr int kShiftThreads = 128;  // P4: a block's threads
// PDL inside a kernel: let the stream's next kernel launch now (its blocks
// then wait at their own pdl_wait), and wait until every grid this one
// depends on has completed with its writes visible.  A kernel touches no
// global memory before pdl_wait: the memory it reads or writes may be the
// previous kernel's (the caching allocator hands one call the buffers the
// call before it freed).
__device__ __forceinline__ void pdl_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

__device__ __forceinline__ void pdl_wait() {
  asm volatile("griddepcontrol.wait;\n" ::: "memory");
}

// 16-byte shared-memory accesses, kept as written (P1's scratch is what
// the probe checks, so it is never held in registers instead).
__device__ __forceinline__ float4 lds16(const float* p) {
  float4 v;
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
               : "r"((unsigned)__cvta_generic_to_shared(p))
               : "memory");
  return v;
}

__device__ __forceinline__ void sts16(float* p, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(p)),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

__device__ __forceinline__ float4 splat4(float s) {
  return make_float4(s, s, s, s);
}

__device__ __forceinline__ float4 add4(float4 v, float s) {
  return make_float4(__fadd_rn(v.x, s), __fadd_rn(v.y, s),
                     __fadd_rn(v.z, s), __fadd_rn(v.w, s));
}

__device__ __forceinline__ float4 mul4(float4 v, float s) {
  return make_float4(__fmul_rn(v.x, s), __fmul_rn(v.y, s),
                     __fmul_rn(v.z, s), __fmul_rn(v.w, s));
}

// P1, modes 0-3: block = grid row, walking its tiles in order.  Thread i
// owns quad i (elements 4 i .. 4 i + 3) of every tile, of both halves of
// the ring [16, 128] and of both halves of buf [16, 128] (mode 3).  No
// barrier: every thread reads only shared words it wrote itself (mode 3's
// ring[0:8] = buf[8:16] moves element 4 i + k of buf's second half to
// element 4 i + k of the ring, both thread i's), so program order orders
// every access.
__global__ void __launch_bounds__(kQuads)
scratch_kernel(float* __restrict__ out, int mode, int tiles) {
  __shared__ __align__(16) float ring[2 * kTile];
  __shared__ __align__(16) float buf[2 * kTile];
  const int q = 4 * threadIdx.x;
  pdl_launch_dependents();
  sts16(ring + q, splat4(0.0f));         // pl.when(program_id == 0)
  sts16(ring + kTile + q, splat4(0.0f));
  pdl_wait();
  float4* o = reinterpret_cast<float4*>(
      out + (size_t)blockIdx.x * tiles * kTile) + threadIdx.x;
  for (int j = 0; j < tiles; ++j, o += kQuads) {
    if (mode <= 1) {                     // acc += 1; out = acc
      const float4 v = add4(lds16(ring + q), 1.0f);
      sts16(ring + q, v);
      *o = v;
    } else if (mode == 2) {              // out = ring; ring += j + 1
      const float4 v = lds16(ring + q);
      *o = v;
      sts16(ring + q, add4(v, (float)(j + 1)));
    } else {                             // buf = j + 1; out = ring[0:8];
      sts16(buf + q, splat4((float)(j + 1)));   // ring[0:8] = buf[8:16]
      sts16(buf + kTile + q, splat4((float)(j + 1)));
      *o = lds16(ring + q);
      sts16(ring + q, lds16(buf + kTile + q));
    }
  }
}

// P1, mode 4: tile j of every grid row as its own launch under PDL, the
// ring [rows, 8, 128] in device memory carried from launch to launch:
// launch j reads it after pdl_wait, so after launch j - 1 has written it.
__global__ void __launch_bounds__(kQuads)
scratch_tile_kernel(float* __restrict__ out, float* __restrict__ ring,
                    int tiles, int j) {
  pdl_launch_dependents();
  pdl_wait();
  float4* r = reinterpret_cast<float4*>(ring + (size_t)blockIdx.x * kTile) +
              threadIdx.x;
  const float4 v = j == 0 ? splat4(0.0f) : *r;
  reinterpret_cast<float4*>(out + ((size_t)blockIdx.x * tiles + j) *
                                      kTile)[threadIdx.x] = v;
  *r = add4(v, (float)(j + 1));
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

// P4: out [TT, R] f32.  mode 0 (and 1, the ring read from a [1, 1, rows,
// R] snapshot: the same memory): concat(ring[off: off + d], x[:TT - d]) *
// 2; mode 2: concat(x[d:], ring[off:off + d]) * 2; mode 3: as 2 on v = x *
// 1.5, rounded to f32 before the * 2.  Thread (c, y) of block b takes row
// t = b blockDim.y + y, whose source row (ring or x) it picks once, and
// the row's units c, c + blockDim.x, ...: a unit is a float4 with kQuad
// (R % 4 == 0, every pointer 16-byte aligned), else one f32.
template <bool kQuad>
__global__ void __launch_bounds__(kShiftThreads)
shift_kernel(int mode, const float* __restrict__ ring,
             const float* __restrict__ x, float* __restrict__ out, int TT,
             int R, int d, int off) {
  pdl_launch_dependents();
  pdl_wait();
  const int t = blockIdx.x * blockDim.y + threadIdx.y;
  if (t >= TT) return;
  const float* src;
  bool x15 = false;                      // mode 3's v = x * 1.5
  if (mode <= 1) {
    src = t < d ? ring + (size_t)(off + t) * R : x + (size_t)(t - d) * R;
  } else if (t < TT - d) {
    src = x + (size_t)(t + d) * R;
    x15 = mode == 3;
  } else {
    src = ring + (size_t)(off + t - (TT - d)) * R;
  }
  float* dst = out + (size_t)t * R;
  if (kQuad) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    for (int c = threadIdx.x; c < (R >> 2); c += blockDim.x) {
      float4 v = __ldg(s4 + c);
      if (x15) v = mul4(v, 1.5f);
      d4[c] = mul4(v, 2.0f);
    }
  } else {
    for (int c = threadIdx.x; c < R; c += blockDim.x) {
      float v = __ldg(src + c);
      if (x15) v = __fmul_rn(v, 1.5f);
      dst[c] = __fmul_rn(v, 2.0f);
    }
  }
}

// kern on [grid, block] in stream s under programmatic stream
// serialization (it may start before the stream's previous kernel ends and
// waits for it at pdl_wait).  A refused launch returns its error: nothing
// retries without the attribute.
template <typename... Params, typename... Args>
cudaError_t launch(void (*kern)(Params...), dim3 grid, dim3 block,
                   cudaStream_t s, Args... args) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = block;
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kern, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
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
  if (((uintptr_t)out | (uintptr_t)ring) & 15)
    return (int)cudaErrorMisalignedAddress;
  if (mode == 4)
    return (int)launch(scratch_tile_kernel, dim3(rows), dim3(kQuads), s,
                       out, ring, tiles, tile);
  return (int)launch(scratch_kernel, dim3(rows), dim3(kQuads), s, out, mode,
                     tiles);
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
// [TT, R] f32, at any alignment: float4 units where R % 4 == 0 and all
// three are 16-byte aligned, else f32 units.  A block is kShiftThreads
// threads over kShiftThreads / min(units a row, kShiftThreads) rows.
int wn_probe_shift(int mode, const float* ring, const float* x, float* out,
                   int TT, int R, int d, int off, void* stream) {
  if (mode < 0 || mode > 3 || TT < 1 || R < 1 || d < 0 || d > TT || off < 0)
    return (int)cudaErrorInvalidValue;
  const bool quad = R % 4 == 0 &&
      (((uintptr_t)ring | (uintptr_t)x | (uintptr_t)out) & 15) == 0;
  const int units = quad ? R / 4 : R;
  const int bx = units < kShiftThreads ? units : kShiftThreads;
  const int by = kShiftThreads / bx;
  const dim3 grid((TT + by - 1) / by), block(bx, by);
  cudaStream_t s = (cudaStream_t)stream;
  return (int)(quad ? launch(shift_kernel<true>, grid, block, s, mode, ring,
                             x, out, TT, R, d, off)
                    : launch(shift_kernel<false>, grid, block, s, mode, ring,
                             x, out, TT, R, d, off));
}

const char* wn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
