// Whole-loop autoregressive WaveNet decode for narrow models on Hopper
// (sm_90a).
//
// Replaces wavenet_tpu/ops/pallas/decode.py::_decode_kernel, the TPU's
// whole-loop decoder for models with R < 128 (the `tiny`, `small`,
// `fastgen_bench` and `conditional` presets; the port also sends it every
// other width the wide kernel does not take, such as R = 192 or R = 128
// with S = 80, as the reference tries its narrow kernel first), in all its
// forms:
// unconditional, mel-conditioned (has_cond) and speaker-conditioned
// (has_gc).  It computes what decode_wide.cu computes, on the same layout:
// one launch runs num_steps decode steps; per step and batch row: f32 embed
// of (token, prev) -> L gated dilated layers with compact ring reads/writes
// -> ReLU/1x1/ReLU/1x1 head -> counter-RNG Gumbel-max sample (argmax when
// greedy) -> the forced-prime override, after the kernel's own argmax has
// been recorded.  Rings [sum_d, B, R] bf16 live in device memory (the
// reference transposes them to [sum_d, R, B] only to put the batch on TPU
// lanes); the carry [B, 2] = (next token, its predecessor) continues a later
// launch.  A mel-conditioned launch reads y [B, num_steps, M] bf16 (this
// launch's steps) and V_cond [L, M, 2R] bf16; a speaker-conditioned one
// reads g [L, B, 2R] f32, each row's time-constant gate offsets.
//
// Numerics recipe (wavenet_tpu/ops/pallas/decode.py:221-293):
//   x = bf16(E_cur[tok] + E_prev[prev])                  (f32 tables)
//   z = ((x @ W_cur + old @ W_prev) + b)                 (f32; each dot the
//       [+ y_t @ V_cond] [+ g[l, row]]                    exact sum, rounded
//                                                         once)
//   h = bf16(tanh(z_f) * sigmoid(z_g))
//   skip = (skip + h @ W_skip) + b_skip                  (f32)
//   ring[off_l + (t0+t) mod d_l] <- x  (after the read of `old` there)
//   x = bf16((f32(x) + h @ W_res) + b_res)
//   s = bf16(relu(skip)); s1 = bf16(relu(s @ W1 + b1)); logits = s1 @ W2 + b2
//   scores = logits * f32(1/T) + gumbel(seed, t0+t, q); token = first argmax
// Every dot product is the exact f64 sum of bf16 x bf16 products rounded
// once to f32 (decode_common.cuh), so the kernel equals the plain PyTorch
// version bit for bit (up to the math library's tanhf/expf/logf), and a
// row's result depends neither on the tile nor on the co-batched rows.
//
// What makes it the narrow counterpart: at R < 128 a phase has fewer dot
// products than a block has threads (at R = 16 the z phase has 64, the
// skip/residual phase 32).  So each phase splits every dot product's K range
// into segments over the spare threads: a thread sums one (column, segment)
// unit for the tile's rows into an exact f64 partial in shared memory, and
// the phase's epilogue adds the partials of a column (exact in f64: any
// order gives the same bits) and rounds once.  The mel term is a third dot
// product of the z phase, split the same way.  A row's working set is a few
// KB of shared memory (~10 KB at `fastgen_bench` widths), so a block may hold
// up to 16 rows (one argmax warp per row of 512 threads) that share each
// weight load; no condition on R, S or M beyond the shared memory a tile
// needs.
//
// What bounds it on the card: each step is a serial chain of L layers of
// dependent phases whose weights (1.15 MB at `fastgen_bench`, bf16) are
// re-read from L2 every step.  A block's step time is its SM's rate of
// bf16 -> f64 weight conversions (a quarter of the f64 FMA rate; one per
// weight per block per step, shared by the tile's rows) plus one f64 FMA
// per weight and row, and the L2 latency of each phase.  One row per block
// spreads a batch over the SMs (B = 64 takes 64 of 132); more rows per block
// share conversions but serialize the rows' FMAs on one SM (tile policy:
// ops/cuda/decode_common.py tile_rows, measured in PERF.md).  Staging a
// layer's weights in shared memory, splitting a row across SMs (clusters)
// and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "rng.cuh"

namespace {

constexpr int kThreads = 512;  // threads per block (ops/cuda/decode.py)

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
  // the plan (ops/cuda/decode.py plan): K segments per dot product of the
  // four phases (z, skip + residual, head 1, head 2) and the partial-sum
  // units of the largest phase, which size `part` below
  int seg_z, seg_sr, seg_h1, seg_h2, units;
};

// One dot product of a phase: column o of W [K, N] against inT [K][BT].
struct Job {
  const __nv_bfloat16* W;
  const double* in;
  int K, N;
};

// Every (dot product, K segment) unit of a phase with up to three jobs
// (N = 0 for an absent one), spread over the block's threads: part[u][BT]
// holds unit u's exact f64 partial sums, units ordered job, segment,
// column (a warp reads 32 neighbouring columns of one weight row).
template <int BT>
__device__ __forceinline__ void dot_units(const Job& a, const Job& b,
                                          const Job& c, int segs,
                                          double* part, int tid) {
  const int na = a.N * segs, nb = b.N * segs;
  const int total = na + nb + c.N * segs;
  for (int u = tid; u < total; u += kThreads) {
    const bool in_a = u < na, in_b = !in_a && u < na + nb;
    const Job& j = in_a ? a : in_b ? b : c;
    const int v = in_a ? u : in_b ? u - na : u - na - nb;
    const int seg = v / j.N, col = v - seg * j.N;
    const int kseg = (j.K + segs - 1) / segs;
    const int kb = min(j.K, seg * kseg), ke = min(j.K, kb + kseg);
    double sum[BT];
    dot_part<BT>(j.W, kb, ke, j.N, col, j.in, sum);
#pragma unroll
    for (int r = 0; r < BT; ++r) part[u * BT + r] = sum[r];
  }
}

// f32 of the exact dot product of column col, row r, of the job whose units
// start at unit `base` (N columns, segs segments).
template <int BT>
__device__ __forceinline__ float dot_sum(const double* part, int base, int N,
                                         int segs, int col, int r) {
  double t = 0.0;
  for (int s = 0; s < segs; ++s) t += part[(base + s * N + col) * BT + r];
  return __double2float_rn(t);
}

template <int BT>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) double smem[];
  const int R = a.R, S = a.S, Q = a.Q, L = a.L, B = a.B, M = a.M;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int tid = threadIdx.x;

  // the block's shared memory, in the order ops/cuda/decode.py smem_bytes
  // sums it; matmul inputs: bf16 values held as f64
  double* xT = smem;                 // [R][BT] residual stream
  double* oldT = xT + R * BT;        // [R][BT] ring read of this layer
  double* hT = oldT + R * BT;        // [R][BT] gated output
  double* sT = hT + R * BT;          // [S][BT] bf16(relu(skip))
  double* s1T = sT + S * BT;         // [S][BT] head hidden
  double* yT = s1T + S * BT;         // [M][BT] mel features y_t (with mel)
  double* part = yT + M * BT;        // [units][BT] partial sums of a phase
  float* skipT = reinterpret_cast<float*>(part + a.units * BT);
                                     // [S][BT] f32 skip sum
  float* scoreT = skipT + S * BT;    // [Q][BT] sampling scores
  int* tok = reinterpret_cast<int*>(scoreT + Q * BT);   // [BT]
  int* prev = tok + BT;              // [BT]
  int* seed = prev + BT;             // [BT]
  int* offs = seed + BT;             // [L] ring offsets
  int* dil = offs + L;               // [L] dilations

  // this tile's ring rows into the output buffer (unless updated in place):
  // 16-byte vectors when a row's R bf16 values fill whole vectors
  if (a.rings_in != a.rings_out) {
    if (R % 8 == 0) {
      const int vecs = R / 8;
      const size_t total = (size_t)a.sum_d * nrows * vecs;
      const uint4* src = reinterpret_cast<const uint4*>(a.rings_in);
      uint4* dst = reinterpret_cast<uint4*>(a.rings_out);
      for (size_t i = tid; i < total; i += kThreads) {
        const int v = (int)(i % vecs);
        const size_t rest = i / vecs;
        const size_t off = ((rest / nrows) * B + b0 + rest % nrows) * vecs + v;
        dst[off] = src[off];
      }
    } else {
      const size_t total = (size_t)a.sum_d * nrows * R;
      for (size_t i = tid; i < total; i += kThreads) {
        const int c = (int)(i % R);
        const size_t rest = i / R;
        const size_t off = ((rest / nrows) * B + b0 + rest % nrows) * R + c;
        a.rings_out[off] = a.rings_in[off];
      }
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

  const Job none{nullptr, nullptr, 0, 0};
  for (int t = 0; t < a.num_steps; ++t) {
    const int g = a.t0 + t;          // global step: ring phase and RNG key

    // embed: f32 table rows, one add, one bf16 rounding
    for (int i = tid; i < BT * R; i += kThreads) {
      const int r = i / R, c = i % R;
      const float e = a.ecur[(size_t)tok[r] * R + c]
                    + a.eprev[(size_t)prev[r] * R + c];
      xT[c * BT + r] = bf16_round(e);      // exact in f64
    }
    for (int i = tid; i < BT * M; i += kThreads) {
      const int r = i / M, m = i % M;
      yT[m * BT + r] = r < nrows
          ? (double)__bfloat162float(
                a.y[((size_t)(b0 + r) * a.num_steps + t) * M + m])
          : 0.0;
    }
    for (int i = tid; i < BT * S; i += kThreads) skipT[i] = 0.0f;
    __syncthreads();

    for (int l = 0; l < L; ++l) {
      const int slot = offs[l] + g % dil[l];
      // read this layer's input from step g - d, then store the current one
      for (int i = tid; i < BT * R; i += kThreads) {
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

      // z: x @ W_cur, old @ W_prev and (with mel) y_t @ V_cond, split
      const Job jc{a.wcur + (size_t)l * R * 2 * R, xT, R, 2 * R};
      const Job jp{a.wprev + (size_t)l * R * 2 * R, oldT, R, 2 * R};
      const Job jy = M ? Job{a.vcond + (size_t)l * M * 2 * R, yT, M, 2 * R}
                       : none;
      dot_units<BT>(jc, jp, jy, a.seg_z, part, tid);
      __syncthreads();

      const float* bl = a.b + (size_t)l * 2 * R;
      const int up = 2 * R * a.seg_z;       // first unit of old @ W_prev
      for (int i = tid; i < BT * R; i += kThreads) {
        const int c = i / BT, r = i % BT;
        float z[2];
#pragma unroll
        for (int h = 0; h < 2; ++h) {      // filter half, then gate half
          const int col = h * R + c;
          z[h] = (dot_sum<BT>(part, 0, 2 * R, a.seg_z, col, r)
                  + dot_sum<BT>(part, up, 2 * R, a.seg_z, col, r)) + bl[col];
          if (M) z[h] += dot_sum<BT>(part, 2 * up, 2 * R, a.seg_z, col, r);
          if (a.g != nullptr && r < nrows)   // this row's speaker offsets
            z[h] += a.g[((size_t)l * B + b0 + r) * 2 * R + col];
        }
        hT[i] = bf16_round(tanhf(z[0]) * sigmoidf(z[1]));
      }
      __syncthreads();

      // skip and residual: h @ W_skip, h @ W_res, split
      const Job js{a.wskip + (size_t)l * R * S, hT, R, S};
      const Job jr{a.wres + (size_t)l * R * R, hT, R, R};
      dot_units<BT>(js, jr, none, a.seg_sr, part, tid);
      __syncthreads();

      for (int i = tid; i < BT * (S + R); i += kThreads) {
        const int o = i / BT, r = i % BT;
        if (o < S) {
          const float bo = a.bskip[(size_t)l * S + o];
          skipT[i] = (skipT[i] + dot_sum<BT>(part, 0, S, a.seg_sr, o, r)) + bo;
        } else {
          const int c = o - S;
          const float bo = a.bres[(size_t)l * R + c];
          const float p = dot_sum<BT>(part, S * a.seg_sr, R, a.seg_sr, c, r);
          xT[c * BT + r] = bf16_round(((float)xT[c * BT + r] + p) + bo);
        }
      }
      __syncthreads();
    }

    // head
    for (int i = tid; i < BT * S; i += kThreads)
      sT[i] = bf16_round(fmaxf(skipT[i], 0.0f));
    __syncthreads();
    dot_units<BT>(Job{a.hw1, sT, S, S}, none, none, a.seg_h1, part, tid);
    __syncthreads();
    for (int i = tid; i < BT * S; i += kThreads) {
      const int o = i / BT, r = i % BT;
      s1T[i] = bf16_round(
          fmaxf(dot_sum<BT>(part, 0, S, a.seg_h1, o, r) + a.hb1[o], 0.0f));
    }
    __syncthreads();
    dot_units<BT>(Job{a.hw2, s1T, S, Q}, none, none, a.seg_h2, part, tid);
    __syncthreads();
    for (int i = tid; i < BT * Q; i += kThreads) {
      const int o = i / BT, r = i % BT;
      float sc = dot_sum<BT>(part, 0, Q, a.seg_h2, o, r) + a.hb2[o];
      if (!a.greedy && r < nrows)
        sc = __fadd_rn(__fmul_rn(sc, a.inv_temp),
                       wn_counter_gumbel(seed[r], g, o));
      scoreT[i] = sc;
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
int launch(const DecodeArgs& a, size_t smem, cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      decode_kernel<BT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.B + BT - 1) / BT;
  decode_kernel<BT><<<grid, kThreads, smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the narrow whole-loop decode on `stream`; returns a cudaError_t
// code (0 on success).  bt in {1, 2, 4, 8, 16} rows per block; seg_z,
// seg_sr, seg_h1, seg_h2 and units the plan and smem its shared memory
// bytes per block (ops/cuda/decode.py plan and smem_bytes).  y
// [B, num_steps, M] and vcond [L, M, 2R] (bf16) with M > 0 for a
// mel-conditioned model, null and M = 0 otherwise; g [L, B, 2R] (f32) for a
// speaker-conditioned model, null otherwise.
int wn_decode(const int32_t* seeds, const int32_t* tokens_init,
              const int32_t* forced, const float* ecur, const float* eprev,
              const void* wcur, const void* wprev, const float* b,
              const void* wres, const float* bres, const void* wskip,
              const float* bskip, const void* hw1, const float* hb1,
              const void* hw2, const float* hb2, const int32_t* dils,
              const void* y, const void* vcond, const float* g,
              const void* rings_in, void* rings_out, int32_t* tokens_out,
              int32_t* carry_out, int L, int R, int S, int Q, int M,
              int sum_d, int B, int num_steps, int t0, int num_forced,
              int greedy, float inv_temp, int bt, int seg_z, int seg_sr,
              int seg_h1, int seg_h2, int units, int smem, void* stream) {
  typedef const __nv_bfloat16* W;
  DecodeArgs a{seeds, tokens_init, forced, ecur, eprev,
               (W)wcur, (W)wprev, b, (W)wres, bres, (W)wskip, bskip,
               (W)hw1, hb1, (W)hw2, hb2, dils, (W)y, (W)vcond, g,
               (W)rings_in, (__nv_bfloat16*)rings_out, tokens_out, carry_out,
               L, R, S, Q, M, sum_d, B, num_steps, t0, num_forced, greedy,
               inv_temp, seg_z, seg_sr, seg_h1, seg_h2, units};
  if (R < 1 || S < 1 || Q < 1 || L < 1 || M < 0 || B < 1 || num_steps < 1 ||
      (M > 0) != (y != nullptr) || (M > 0) != (vcond != nullptr) ||
      seg_z < 1 || seg_sr < 1 || seg_h1 < 1 || seg_h2 < 1 || units < 1 ||
      smem < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bt) {
    case 1: return launch<1>(a, smem, s);
    case 2: return launch<2>(a, smem, s);
    case 4: return launch<4>(a, smem, s);
    case 8: return launch<8>(a, smem, s);
    case 16: return launch<16>(a, smem, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* wn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
