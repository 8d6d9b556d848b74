// Whole-loop autoregressive WaveNet decode on Hopper (sm_90a).
//
// Replaces wavenet_tpu/ops/pallas/decode_wide.py::_decode_kernel, the TPU's
// whole-loop decoder for wide models (R >= 128, the `full` and
// `full_vocoder` presets), in all its forms: unconditional, mel-conditioned
// (has_cond) and speaker-conditioned (has_gc).  One launch runs num_steps decode
// steps; per step and batch row: f32 embed of (token, prev) -> L gated
// dilated layers with compact ring reads/writes -> ReLU/1x1/ReLU/1x1 head ->
// counter-RNG Gumbel-max sample (argmax when greedy) -> the forced-prime
// override, after the kernel's own argmax has been recorded.  Rings
// [sum_d, B, R] bf16 live in device memory in the JAX layout; the carry
// [B, 2] = (next token, its predecessor) continues a later launch.  A
// mel-conditioned launch also reads y [B, num_steps, M] bf16 (this launch's
// steps only, contiguous: a chunked caller passes its chunk's slice) and
// V_cond [L, M, 2R] bf16, and adds y_t @ V_cond[l] into every layer's gate;
// a speaker-conditioned launch reads g [L, B, 2R] f32 (each row's
// time-constant speaker offsets) and adds g[l, row] after that.
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
// to 8), and sampling is a warp-per-row reduction.  The mel term's 2R dot
// products (K = M) are split in two halves of K over the threads that run
// the 4R dot products of x and old (K = R), so each thread's share of the
// z phase grows by about M / 2 products, not by a second round of threads.
// Splitting each layer across SMs (clusters / DSMEM), wider loads, wgmma
// and TMA are later work.
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
//   z = ((x @ W_cur + old @ W_prev) + b) + y_t @ V_cond  (f32; each dot the
//                                                         exact sum, rounded
//                                                         once; y_t and V_cond
//                                                         bf16; the last term
//                                                         only with mel)
//   z = z + g[l, row]                                    (with a speaker)
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

#include "decode_common.cuh"
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
  const __nv_bfloat16* y;        // [B, num_steps, M] or null (no mel)
  const __nv_bfloat16* vcond;    // [L, M, 2R] or null
  const float* g;                // [L, B, 2R] or null (no speaker)
  const __nv_bfloat16* rings_in; // [sum_d, B, R]
  __nv_bfloat16* rings_out;      // [sum_d, B, R]
  int32_t* tokens_out;           // [B, num_steps]
  int32_t* carry_out;            // [B, 2]
  int L, R, S, Q, M, sum_d, B, num_steps, t0, num_forced, greedy;
  float inv_temp;
};

// out[r] = f32 of the exact dot product of column o of W [K, N] with the
// BT rows of inT (decode_common.cuh: dot_part).
template <int BT>
__device__ __forceinline__ void dot_col(const __nv_bfloat16* __restrict__ W,
                                        int K, int N, int o,
                                        const double* inT, float out[BT]) {
  double sum[BT];
  dot_part<BT>(W, 0, K, N, o, inT, sum);
#pragma unroll
  for (int r = 0; r < BT; ++r) out[r] = __double2float_rn(sum[r]);
}

// Split point of the mel dot products' K range: the first half, rounded up
// to whole weight batches.
__host__ __device__ inline int mel_split(int M) {
  const int h = (M / 2 + kHalf - 1) / kHalf * kHalf;
  return h < M ? h : M;
}

size_t smem_bytes(int bt, int L, int R, int S, int Q, int M) {
  return sizeof(double) * (size_t)bt * (3 * R + 2 * S + (M ? M + 4 * R : 0))
       + sizeof(float) * ((size_t)bt * (4 * R + S + Q) + 3 * bt + 2 * L);
}

template <int BT>
__global__ void __launch_bounds__(kMaxThreads, 1)
decode_wide_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) double smem[];
  const int R = a.R, S = a.S, Q = a.Q, L = a.L, B = a.B, M = a.M;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int tid = threadIdx.x, nt = blockDim.x;

  // matmul inputs: bf16 values held as f64
  double* xT = smem;                 // [R][BT] residual stream
  double* oldT = xT + R * BT;        // [R][BT] ring read of this layer
  double* hT = oldT + R * BT;        // [R][BT] gated output
  double* sT = hT + R * BT;          // [S][BT] bf16(relu(skip))
  double* s1T = sT + S * BT;         // [S][BT] head hidden
  double* yT = s1T + S * BT;         // [M][BT] mel features y_t (with mel)
  double* zcT = yT + M * BT;         // [2][2R][BT] halves of y_t @ V_cond
  float* zxT = reinterpret_cast<float*>(zcT + (M ? 4 * R * BT : 0));
                                     // [2R][BT] x @ W_cur
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
    for (int i = tid; i < BT * M; i += nt) {
      const int r = i / M, m = i % M;
      yT[m * BT + r] = r < nrows
          ? (double)__bfloat162float(
                a.y[((size_t)(b0 + r) * a.num_steps + t) * M + m])
          : 0.0;
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
      const __nv_bfloat16* vc = a.vcond + (size_t)l * M * 2 * R;
      const int mh = mel_split(M);
      // the two dot products of z run side by side on separate threads,
      // and with mel each thread also sums one half of a y_t @ V_cond dot
      for (int o = tid; o < 4 * R; o += nt) {
        float p[BT];
        const bool cur = o < 2 * R;
        const int col = cur ? o : o - 2 * R;
        dot_col<BT>(cur ? wc : wp, R, 2 * R, col, cur ? xT : oldT, p);
        float* dst = (cur ? zxT : zoT) + col * BT;
#pragma unroll
        for (int r = 0; r < BT; ++r) dst[r] = p[r];
        if (M) {
          double q[BT];
          dot_part<BT>(vc, cur ? 0 : mh, cur ? mh : M, 2 * R, col, yT, q);
          double* zdst = zcT + (cur ? 0 : 2 * R * BT) + col * BT;
#pragma unroll
          for (int r = 0; r < BT; ++r) zdst[r] = q[r];
        }
      }
      __syncthreads();

      const float* bl = a.b + (size_t)l * 2 * R;
      for (int i = tid; i < BT * R; i += nt) {
        const int c = i / BT, ig = (R + c) * BT + i % BT;   // gate half
        float zf = (zxT[i] + zoT[i]) + bl[c];
        float zg = (zxT[ig] + zoT[ig]) + bl[R + c];
        if (M) {              // the two exact halves add exactly in f64
          zf += __double2float_rn(zcT[i] + zcT[2 * R * BT + i]);
          zg += __double2float_rn(zcT[ig] + zcT[2 * R * BT + ig]);
        }
        const int r = i % BT;
        if (a.g != nullptr && r < nrows) {   // this row's speaker offsets
          const float* gr = a.g + ((size_t)l * B + b0 + r) * 2 * R;
          zf += gr[c];
          zg += gr[R + c];
        }
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
      const int bi = warp_argmax<BT>(scoreT, Q, r, lane);
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
  const size_t smem = smem_bytes(BT, a.L, a.R, a.S, a.Q, a.M);
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
// y [B, num_steps, M] and vcond [L, M, 2R] (bf16) with M > 0 for a
// mel-conditioned model; null and M = 0 otherwise.  g [L, B, 2R] (f32) for
// a speaker-conditioned model, null otherwise.
int wn_decode_wide(const int32_t* seeds, const int32_t* tokens_init,
                   const int32_t* forced, const float* ecur,
                   const float* eprev, const void* wcur, const void* wprev,
                   const float* b, const void* wres, const float* bres,
                   const void* wskip, const float* bskip, const void* hw1,
                   const float* hb1, const void* hw2, const float* hb2,
                   const int32_t* dils, const void* y, const void* vcond,
                   const float* g, const void* rings_in, void* rings_out,
                   int32_t* tokens_out, int32_t* carry_out, int L, int R,
                   int S, int Q, int M, int sum_d, int B, int num_steps,
                   int t0, int num_forced, int greedy, float inv_temp, int bt,
                   int threads, void* stream) {
  typedef const __nv_bfloat16* W;
  DecodeArgs a{seeds, tokens_init, forced, ecur, eprev,
               (W)wcur, (W)wprev, b, (W)wres, bres, (W)wskip, bskip,
               (W)hw1, hb1, (W)hw2, hb2, dils, (W)y, (W)vcond, g,
               (W)rings_in, (__nv_bfloat16*)rings_out, tokens_out, carry_out,
               L, R, S, Q, M, sum_d, B, num_steps, t0, num_forced, greedy,
               inv_temp};
  if (threads < 32 * bt || threads > kMaxThreads || R % (2 * kHalf) != 0 ||
      S % (2 * kHalf) != 0 || M < 0 || (M > 0) != (y != nullptr) ||
      (M > 0) != (vcond != nullptr))
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
size_t wn_decode_wide_smem(int bt, int L, int R, int S, int Q, int M) {
  return smem_bytes(bt, L, R, S, Q, M);
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
