// Whole-loop autoregressive WaveNet decode on Hopper (sm_90a).
//
// Replaces wavenet_tpu/ops/pallas/decode_wide.py::_decode_kernel, the TPU's
// whole-loop decoder for wide models (R >= 128, the `full` preset), in its
// unconditional form (no mel, no speaker).  One launch runs num_steps decode
// steps; per step and batch row: f32 embed of (token, prev) -> L gated
// dilated layers with compact ring reads/writes -> ReLU/1x1/ReLU/1x1 head ->
// counter-RNG Gumbel-max sample (argmax when greedy) -> the forced-prime
// override, after the kernel's own argmax has been recorded.  Rings
// [sum_d, B, R] bf16 live in device memory in the JAX layout; the carry
// [B, 2] = (next token, its predecessor) continues a later launch.
//
// What bounds it on the card: each step is a serial chain of L layers, and
// each layer is dependent matrix-vector phases (z, gate, skip+res) whose
// weights (~9.6 MiB at `full`, bf16) are re-read from L2 every step (they
// fit the 50 MB L2, not one SM's 227 KB of shared memory).  One block (one
// SM) runs a batch tile's whole chain, so the step time is that chain's
// latency: per layer, L2 load latency plus one SM's rate of bf16 -> f64
// weight conversions and f64 FMAs for the exact dot products (below), not
// HBM bandwidth.  The design keeps everything else off the critical path:
// the whole loop runs in one launch (no per-step dispatch), activations,
// skip sum and logits stay in shared memory, small batches get one row per
// block (one SM each), a weight loaded once serves every row of a tile (up
// to 8), and sampling is a warp-per-row reduction.  Splitting each layer
// across SMs (clusters / DSMEM), wider loads, wgmma and TMA are later work.
//
// Per-row arithmetic does not depend on the tile size or on the co-batched
// rows: every dot product is the exact f64 sum of that row's bf16 x bf16
// products, rounded once to f32 (dot_col), and everything else is
// elementwise.  A request replayed alone therefore reproduces its
// co-batched tokens bit for bit, and the plain PyTorch version, which
// computes the same exact sums, agrees with the kernel bit for bit up to
// the math library's tanhf/expf/logf.
//
// Numerics recipe (wavenet_tpu/ops/pallas/decode_wide.py:206-255):
//   x = bf16(E_cur[tok] + E_prev[prev])                  (f32 tables)
//   z = (x @ W_cur + old @ W_prev) + b                   (f32; each dot the
//                                                         exact sum, rounded)
//   h = bf16(tanh(z_f) * sigmoid(z_g))
//   skip = (skip + h @ W_skip) + b_skip                  (f32)
//   ring[off_l + (t0+t) mod d_l] <- x  (after the read of `old` there)
//   x = bf16((f32(x) + h @ W_res) + b_res)
//   s = bf16(relu(skip)); s1 = bf16(relu(s @ W1 + b1)); logits = s1 @ W2 + b2
//   scores = logits * f32(1/T) + gumbel(seed, t0+t, q); token = first argmax

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "rng.cuh"

namespace {

constexpr int kMaxThreads = 512;

struct DecodeArgs {
  const int32_t* seeds;          // [B]
  const int32_t* tokens_init;    // [B, 2] (token consumed first, its prev)
  const int32_t* forced;         // [B, num_forced] or null
  const float* ecur;             // [Q, R]
  const float* eprev;            // [Q, R]
  const __nv_bfloat16* wcur;     // [L, R, 2R]
  const __nv_bfloat16* wprev;    // [L, R, 2R]
  const float* b;                // [L, 2R]
  const __nv_bfloat16* wres;     // [L, R, R]
  const float* bres;             // [L, R]
  const __nv_bfloat16* wskip;    // [L, R, S]
  const float* bskip;            // [L, S]
  const __nv_bfloat16* hw1;      // [S, S]
  const float* hb1;              // [S]
  const __nv_bfloat16* hw2;      // [S, Q]
  const float* hb2;              // [Q]
  const int32_t* dils;           // [L]
  const __nv_bfloat16* rings_in; // [sum_d, B, R]
  __nv_bfloat16* rings_out;      // [sum_d, B, R]
  int32_t* tokens_out;           // [B, num_steps]
  int32_t* carry_out;            // [B, 2]
  int L, R, S, Q, sum_d, B, num_steps, t0, num_forced, greedy;
  float inv_temp;
};

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float sigmoidf(float x) {
  return 1.0f / (1.0f + expf(-x));
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

// out[r] = f32(sum over k of inT[k][r] * W[k][o]), the sum taken in f64:
// products of bf16 values are exact there and so is their sum (barring an
// exponent spread of ~30 binades), so out[r] is the correctly rounded f32
// dot product, independent of summation order -- the plain PyTorch
// version (models/wavenet.py _dot) gets the same bits, and this function
// may split the sum over several accumulators.  W is [K, N] bf16 row-major
// ([in, out]); inT is [K][BT] in shared memory, bf16 values held as f64
// (converted once when written: a float -> double conversion runs at a
// quarter of the f64 FMA rate, so converting per product would dominate).
//
// The phase is bound by latency (L2 loads, then a chain of dependent f64
// FMAs), so the weight loads are double-buffered in batches of kHalf (the
// next batch is in flight while the current one is summed) and a row uses
// up to 4 independent accumulators.  K must be a multiple of 2 * kHalf.
constexpr int kHalf = 16;

template <int BT, int NA>
__device__ __forceinline__ void fma_batch(double (&acc)[NA][BT],
                                          const __nv_bfloat16 (&wk)[kHalf],
                                          const double* inT, int k0) {
#pragma unroll
  for (int j = 0; j < kHalf; ++j) {
    const double wj = (double)__bfloat162float(wk[j]);
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

template <int BT>
__device__ __forceinline__ void dot_col(const __nv_bfloat16* __restrict__ W,
                                        int K, int N, int o,
                                        const double* inT, float out[BT]) {
  constexpr int NA = BT >= 4 ? 1 : 4 / BT;   // accumulators per row
  double acc[NA][BT];
#pragma unroll
  for (int a = 0; a < NA; ++a)
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[a][r] = 0.0;
  const __nv_bfloat16* w = W + o;
  __nv_bfloat16 wa[kHalf], wb[kHalf];
  load_batch(wa, w, 0, N);
  for (int k0 = 0; k0 < K; k0 += 2 * kHalf) {
    load_batch(wb, w, k0 + kHalf, N);
    fma_batch<BT, NA>(acc, wa, inT, k0);
    if (k0 + 2 * kHalf < K) load_batch(wa, w, k0 + 2 * kHalf, N);
    fma_batch<BT, NA>(acc, wb, inT, k0 + kHalf);
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    double sum = acc[0][r];
#pragma unroll
    for (int a = 1; a < NA; ++a) sum += acc[a][r];
    out[r] = __double2float_rn(sum);
  }
}

size_t smem_bytes(int bt, int L, int R, int S, int Q) {
  return sizeof(double) * (size_t)bt * (3 * R + 2 * S)
       + sizeof(float) * ((size_t)bt * (4 * R + S + Q) + 3 * bt + 2 * L);
}

template <int BT>
__global__ void __launch_bounds__(kMaxThreads, 1)
decode_wide_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) double smem[];
  const int R = a.R, S = a.S, Q = a.Q, L = a.L, B = a.B;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;

  // matmul inputs: bf16 values held as f64
  double* xT = smem;                 // [R][BT] residual stream
  double* oldT = xT + R * BT;        // [R][BT] ring read of this layer
  double* hT = oldT + R * BT;        // [R][BT] gated output
  double* sT = hT + R * BT;          // [S][BT] bf16(relu(skip))
  double* s1T = sT + S * BT;         // [S][BT] head hidden
  float* zxT = reinterpret_cast<float*>(s1T + S * BT);  // [2R][BT] x @ W_cur
  float* zoT = zxT + 2 * R * BT;     // [2R][BT] old @ W_prev
  float* skipT = zoT + 2 * R * BT;   // [S][BT] f32 skip sum
  float* scoreT = skipT + S * BT;    // [Q][BT] sampling scores
  int* tok = reinterpret_cast<int*>(scoreT + Q * BT);   // [BT]
  int* prev = tok + BT;              // [BT]
  int* seed = prev + BT;             // [BT]
  int* offs = seed + BT;             // [L] ring offsets
  int* dil = offs + L;               // [L] dilations

  // this tile's ring rows into the output buffer (unless updated in place)
  if (a.rings_in != a.rings_out) {
    const int vecs = R / 8;          // 8 bf16 per 16-byte vector
    const size_t total = (size_t)a.sum_d * nrows * vecs;
    const uint4* src = reinterpret_cast<const uint4*>(a.rings_in);
    uint4* dst = reinterpret_cast<uint4*>(a.rings_out);
    for (size_t i = tid; i < total; i += nt) {
      const int v = (int)(i % vecs);
      const size_t rest = i / vecs;
      const int r = (int)(rest % nrows);
      const size_t slot = rest / nrows;
      const size_t off = (slot * B + b0 + r) * vecs + v;
      dst[off] = src[off];
    }
  }
  if (tid == 0) {
    int acc = 0;
    for (int l = 0; l < L; ++l) {
      offs[l] = acc;
      dil[l] = a.dils[l];
      acc += a.dils[l];
    }
  }
  if (tid < BT) {
    const bool ok = tid < nrows;
    tok[tid] = ok ? a.tokens_init[(b0 + tid) * 2] : 0;
    prev[tid] = ok ? a.tokens_init[(b0 + tid) * 2 + 1] : 0;
    seed[tid] = ok ? a.seeds[b0 + tid] : 0;
  }
  __syncthreads();

  for (int t = 0; t < a.num_steps; ++t) {
    const int g = a.t0 + t;          // global step: ring phase and RNG key

    // embed: f32 table rows, one add, one bf16 rounding
    for (int i = tid; i < BT * R; i += nt) {
      const int r = i / R, c = i % R;
      const float e = a.ecur[(size_t)tok[r] * R + c]
                    + a.eprev[(size_t)prev[r] * R + c];
      xT[c * BT + r] = bf16_round(e);      // exact in f64
    }
    for (int i = tid; i < BT * S; i += nt) skipT[i] = 0.0f;
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      const int slot = offs[l] + g % dil[l];
      // read this layer's input from step g - d, then store the current one
      for (int i = tid; i < BT * R; i += nt) {
        const int r = i / R, c = i % R;
        float o = 0.0f;
        if (r < nrows) {
          __nv_bfloat16* p = a.rings_out + ((size_t)slot * B + b0 + r) * R + c;
          o = __bfloat162float(*p);
          *p = __float2bfloat16_rn((float)xT[c * BT + r]);
        }
        oldT[c * BT + r] = o;
      }
      __syncthreads();

      const __nv_bfloat16* wc = a.wcur + (size_t)l * R * 2 * R;
      const __nv_bfloat16* wp = a.wprev + (size_t)l * R * 2 * R;
      // the two dot products of z run side by side on separate threads
      for (int o = tid; o < 4 * R; o += nt) {
        float p[BT];
        const bool cur = o < 2 * R;
        const int col = cur ? o : o - 2 * R;
        dot_col<BT>(cur ? wc : wp, R, 2 * R, col, cur ? xT : oldT, p);
        float* dst = (cur ? zxT : zoT) + col * BT;
#pragma unroll
        for (int r = 0; r < BT; ++r) dst[r] = p[r];
      }
      __syncthreads();

      const float* bl = a.b + (size_t)l * 2 * R;
      for (int i = tid; i < BT * R; i += nt) {
        const int c = i / BT, ig = (R + c) * BT + i % BT;   // gate half
        const float zf = (zxT[i] + zoT[i]) + bl[c];
        const float zg = (zxT[ig] + zoT[ig]) + bl[R + c];
        hT[i] = bf16_round(tanhf(zf) * sigmoidf(zg));
      }
      __syncthreads();

      const __nv_bfloat16* ws = a.wskip + (size_t)l * R * S;
      const __nv_bfloat16* wr = a.wres + (size_t)l * R * R;
      for (int o = tid; o < S + R; o += nt) {
        float p[BT];
        if (o < S) {
          dot_col<BT>(ws, R, S, o, hT, p);
          const float bo = a.bskip[(size_t)l * S + o];
#pragma unroll
          for (int r = 0; r < BT; ++r)
            skipT[o * BT + r] = (skipT[o * BT + r] + p[r]) + bo;
        } else {
          const int c = o - S;
          dot_col<BT>(wr, R, R, c, hT, p);
          const float bo = a.bres[(size_t)l * R + c];
#pragma unroll
          for (int r = 0; r < BT; ++r)
            xT[c * BT + r] = bf16_round(((float)xT[c * BT + r] + p[r]) + bo);
        }
      }
      __syncthreads();
    }

    // head
    for (int i = tid; i < BT * S; i += nt) sT[i] = bf16_round(fmaxf(skipT[i], 0.0f));
    __syncthreads();
    for (int o = tid; o < S; o += nt) {
      float p[BT];
      dot_col<BT>(a.hw1, S, S, o, sT, p);
      const float bo = a.hb1[o];
#pragma unroll
      for (int r = 0; r < BT; ++r)
        s1T[o * BT + r] = bf16_round(fmaxf(p[r] + bo, 0.0f));
    }
    __syncthreads();
    for (int o = tid; o < Q; o += nt) {
      float p[BT];
      dot_col<BT>(a.hw2, S, Q, o, s1T, p);
      const float bo = a.hb2[o];
#pragma unroll
      for (int r = 0; r < BT; ++r) {
        float sc = p[r] + bo;
        if (!a.greedy && r < nrows)
          sc = __fadd_rn(__fmul_rn(sc, a.inv_temp),
                         wn_counter_gumbel(seed[r], g, o));
        scoreT[o * BT + r] = sc;
      }
    }
    __syncthreads();

    // first-index argmax, one warp per row; record, then apply the prime
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < nrows) {
      const int r = warp;
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
      if (lane == 0) {
        int nxt = bi;
        a.tokens_out[(size_t)(b0 + r) * a.num_steps + t] = nxt;
        if (g + 1 < a.num_forced)
          nxt = a.forced[(size_t)(b0 + r) * a.num_forced + g + 1];
        prev[r] = tok[r];
        tok[r] = nxt;
      }
    }
    __syncthreads();
  }

  if (tid < nrows) {
    a.carry_out[(b0 + tid) * 2] = tok[tid];
    a.carry_out[(b0 + tid) * 2 + 1] = prev[tid];
  }
}

template <int BT>
int launch(const DecodeArgs& a, int threads, cudaStream_t stream) {
  const size_t smem = smem_bytes(BT, a.L, a.R, a.S, a.Q);
  cudaError_t e = cudaFuncSetAttribute(
      decode_wide_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.B + BT - 1) / BT;
  decode_wide_kernel<BT><<<grid, threads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

__global__ void counter_bits_kernel(const int32_t* seeds, int B, int t, int Q,
                                    int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * Q) out[i] = (int32_t)wn_counter_bits(seeds[i / Q], t, i % Q);
}

}  // namespace

extern "C" {

// Launch the whole-loop decode on `stream`; returns a cudaError_t code
// (0 on success).  bt in {1, 2, 4, 8} rows per block; threads <= 512.
int wn_decode_wide(const int32_t* seeds, const int32_t* tokens_init,
                   const int32_t* forced, const float* ecur,
                   const float* eprev, const void* wcur, const void* wprev,
                   const float* b, const void* wres, const float* bres,
                   const void* wskip, const float* bskip, const void* hw1,
                   const float* hb1, const void* hw2, const float* hb2,
                   const int32_t* dils, const void* rings_in, void* rings_out,
                   int32_t* tokens_out, int32_t* carry_out, int L, int R,
                   int S, int Q, int sum_d, int B, int num_steps, int t0,
                   int num_forced, int greedy, float inv_temp, int bt,
                   int threads, void* stream) {
  typedef const __nv_bfloat16* W;
  DecodeArgs a{seeds, tokens_init, forced, ecur, eprev,
               (W)wcur, (W)wprev, b, (W)wres, bres, (W)wskip, bskip,
               (W)hw1, hb1, (W)hw2, hb2, dils,
               (W)rings_in, (__nv_bfloat16*)rings_out, tokens_out, carry_out,
               L, R, S, Q, sum_d, B, num_steps, t0, num_forced, greedy,
               inv_temp};
  if (threads < 32 * bt || threads > kMaxThreads || R % (2 * kHalf) != 0 ||
      S % (2 * kHalf) != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bt) {
    case 1: return launch<1>(a, threads, s);
    case 2: return launch<2>(a, threads, s);
    case 4: return launch<4>(a, threads, s);
    case 8: return launch<8>(a, threads, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Shared memory bytes one block of wn_decode_wide needs.
size_t wn_decode_wide_smem(int bt, int L, int R, int S, int Q) {
  return smem_bytes(bt, L, R, S, Q);
}

// The counter-RNG hash bits (as int32) for a [B, Q] grid at step t, so a
// test can pin the device hash against the plain version exactly.
int wn_counter_bits(const int32_t* seeds, int B, int t, int Q, int32_t* out,
                    void* stream) {
  const int n = B * Q, threads = 256;
  counter_bits_kernel<<<(n + threads - 1) / threads, threads, 0,
                        (cudaStream_t)stream>>>(seeds, B, t, Q, out);
  return (int)cudaGetLastError();
}

const char* wn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
