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
// launch's steps); a speaker-conditioned one reads g [L, B, 2R] f32, each
// row's time-constant gate offsets.  The weights come packed
// (ops/cuda/decode.py pack_layers): each layer's matrices and biases in one
// contiguous blob in the order the kernel's lanes read them, the head's in
// another.
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
// What bounds it on the card: each step is a serial chain of L layers over
// weights (1.15 MB at `fastgen_bench`, bf16) re-read every step.  At R = 64
// one block (one batch row on one SM) widens 28,672 weights a layer from
// bf16 to f64; the conversion runs at 16 a clock on an SM (~1 us a layer),
// and the shared-memory reads of the weights and inputs and the copy of
// the next layer's blob take about as long again.  The rest is latency:
// the phases' dependent chains, their barriers, and any L2 load a phase
// waits for.  The design before this one split each dot product's K range
// over threads into partial sums in shared memory that epilogues re-read:
// five barriers and five L2 round trips a layer (old; the z weights; b and
// g; the skip and residual weights; their biases), 5.3 us a layer.
//
// The design:
//   staging   each layer's weights and biases (one blob) are copied into
//             shared memory one layer ahead, into two buffers: one
//             thread's bulk copies (cp.async.bulk) complete on the buffer's
//             mbarrier, which the same thread waits on before the barrier
//             that ends the layer before; a blob that does not fit two
//             buffers beside the rest is read in place (kStage, a template
//             parameter).  The head's blob stays resident where it fits too.
//   old, g    the next layer's ring rows, its speaker offsets and (at a
//             step's last layer) the next step's mel features are loaded
//             as raw bits into registers as a layer starts and stored to
//             shared memory as it ends: no phase waits on L2 for them, and
//             no copy reads a ring slot ahead of the store that wrote it
//             (a layer's x goes into its slot in its phase A; a model of one
//             layer loads that slot after the store).
//   phase A   z and the gate: a warp owns whole gate channels, kUnits at a
//             time (both their z_f and z_g columns); a channel's kSeg lanes
//             split K, and the exact f64 partials of x @ W_cur and
//             old @ W_prev, then of y_t @ V_cond, are summed by a
//             transposed butterfly of shuffles (each lane ends with one of
//             the sums); the same warp then applies the gate.
//   phase B   skip and residual: a warp owns whole columns of
//             [W_skip | W_res], kUnits at a time and up to 4 groups of them
//             at once (independent chains that share the lane's input
//             reads; 3 at 8 rows, 1 at 16: registers), summed the same way;
//             each of a column's lanes updates one (column, row) of the f32
//             skip sum or the next x.
//   Two block barriers a layer and no partial sums in shared memory; the
//   head is two more phases of phase B's shape.  A lane loads its 8 weights
//   of a K block as one 16-byte vector, and its K rows interleave with the
//   unit's other lanes' so that the f64 input reads are conflict-free too.
//   The small jobs of a layer (the copy, the next layer's loads, the ring
//   write) go to different warps.
// Tried, measured slower and not kept (PERF.md): widening by integer field
// moves (bf16_exact.cuh bf2d) or half each way; phase A's weights staged as
// the high words of their f64 values (no widening, but twice the bytes to
// copy and read); the stage copied by every thread's cp.async instead of
// one thread's bulk copies.  Rows per block (1-16; ops/cuda/decode_common.py
// tile_rows) share each weight's widening; one row per block spreads a
// batch over the SMs.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>
#include <string.h>

#include "decode_common.cuh"
#include "rng.cuh"

namespace {

constexpr int kThreads = 512;          // threads per block (16 warps)
constexpr int kWarps = kThreads / 32;
constexpr int kSeg = 8;                // lanes splitting one unit's K range
constexpr int kUnits = 32 / kSeg;      // units a warp owns at once
constexpr int kBlk = 8 * kSeg;         // K rows of one block (8 per lane)
constexpr int kSlots = 6;              // a channel's gate sums per row
constexpr int kPre = 2;                // next-layer loads a thread holds
constexpr uint32_t kChunk = 32768;     // bytes of one bulk copy
// the small jobs of a layer go to different warps: the stage copies (warp
// 15), the next layer's loads (threads from warp 8 on), the ring write
// (from warp 12 on)
constexpr int kIssuer = kThreads - 32;
constexpr int kLoadFrom = kThreads / 2, kRingFrom = 3 * kThreads / 4;

// utils/decode_phases.py builds this file with one part of a layer's work
// taken out (-D WN_PHASE_NO_...), to time what each part costs a step; the
// tokens are then wrong (no variant waits for a copy it did not start).
#ifdef WN_PHASE_NO_RING
constexpr bool kRing = false;          // no ring read or write
#else
constexpr bool kRing = true;
#endif
#ifdef WN_PHASE_NO_Z
constexpr bool kZ = false;             // no z products
#else
constexpr bool kZ = true;
#endif
#ifdef WN_PHASE_NO_SKIP_RES
constexpr bool kSkipRes = false;       // no skip and residual products
#else
constexpr bool kSkipRes = true;
#endif
#ifdef WN_PHASE_NO_EPILOGUE_LOADS
constexpr bool kEpiLoads = false;      // no biases or speaker offsets
#else
constexpr bool kEpiLoads = true;
#endif
#ifdef WN_PHASE_NO_COPIES
constexpr bool kCopies = false;        // no staging copies
#else
constexpr bool kCopies = true;
#endif

typedef __nv_bfloat16 bf16;

// The launch plan (ops/cuda/decode.py plan, the only place it is made):
// whether the layer blobs are staged and the head resident; element offsets in a layer
// blob (phase B's weights, the f32 biases, its length) and in the head
// blob (W2's weights, the f32 biases, its length); byte offsets of the
// shared-memory arrays, and their total.
struct Plan {
  int stage, head_res;
  int wb, bias, blk;
  int h2, hbias, hblk;
  int x, h, s, s1, z, skip, score, gs, tok, mbar, stg, head, smem;
};
constexpr int kPlanInts = sizeof(Plan) / sizeof(int);

struct DecodeArgs {
  const int32_t* seeds;          // [B]
  const int32_t* tokens_init;    // [B, 2] (token consumed first, its prev)
  const int32_t* forced;         // [B, num_forced] or null
  const float* ecur;             // [Q, R]
  const float* eprev;            // [Q, R]
  const bf16* pack;              // [L, blk] the layer blobs
  const bf16* head;              // [hblk] the head's blob
  const int32_t* dils;           // [L]
  const bf16* y;                 // [B, num_steps, M] or null (no mel)
  const float* g;                // [L, B, 2R] or null (no speaker)
  const bf16* rings_in;          // [sum_d, B, R]
  bf16* rings_out;               // [sum_d, B, R]
  int32_t* tokens_out;           // [B, num_steps]
  int32_t* carry_out;            // [B, 2]
  int L, R, S, Q, M, sum_d, B, num_steps, t0, num_forced, greedy;
  float inv_temp;
  Plan p;
};

__host__ __device__ inline int cdiv(int a, int b) { return (a + b - 1) / b; }

// ---------------------------------------------------------------------------
// Staging: bulk copies completing on an mbarrier.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar));
}

__device__ __forceinline__ void mbar_expect(uint32_t mbar, uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
      ::"r"(mbar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t mbar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  } while (!done);
}

// Start copying `bytes` (a multiple of 16) from src to shared dst: one
// thread's bulk copies, completing on mbar (which then expects them).  (The
// buffer's earlier readers are past a block barrier, which orders their
// reads before the copy.)
__device__ __forceinline__ void stage_copy(void* dst, const void* src,
                                           uint32_t bytes, uint32_t mbar,
                                           int tid) {
  if (tid == kIssuer) {
    mbar_expect(mbar, bytes);
    for (uint32_t o = 0; o < bytes; o += kChunk)
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::"
          "bytes [%0], [%1], %2, [%3];\n"
          ::"r"(smem_addr((char*)dst + o)), "l"((const char*)src + o),
          "r"(min(kChunk, bytes - o)), "r"(mbar) : "memory");
  }
}

// Wait until a buffer's copies have landed, before the block barrier that
// precedes their reads: the issuing thread waits on the buffer's mbarrier,
// and the barrier then orders the copies before every thread's reads.
__device__ __forceinline__ void stage_wait(uint32_t mbar, uint32_t parity,
                                           int tid) {
  if (tid == kIssuer) mbar_wait(mbar, parity);
}

// ---------------------------------------------------------------------------
// The lanes' dot products.  A phase's units (gate channels, or output
// columns) go to the warps kUnits at a time (a group): lane q * kSeg + s
// takes unit q of the group and, of each K block of kBlk rows, the 8 rows
// 16j + 2s + e (j < 4, e < 2), so that the kSeg lanes of a unit read their
// input row pairs from 16 contiguous bytes each.  The packed weights hold,
// per group, block and column, every lane's 8 weights as one 16-byte
// vector, [32 lanes][8] (a warp's load: 512 contiguous bytes).

// The two bf16 weights of one word of a lane's vector widened to f64,
// exactly (through f32: the conversion).
__device__ __forceinline__ void widen2(uint32_t u, double& lo, double& hi) {
  lo = (double)__uint_as_float(u << 16);
  hi = (double)__uint_as_float(u & 0xffff0000u);
}

__device__ __forceinline__ uint32_t word(const uint4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

template <bool kGlobal>
__device__ __forceinline__ uint4 load16(const bf16* p) {
  if constexpr (kGlobal)
    return __ldg(reinterpret_cast<const uint4*>(p));
  else
    return *reinterpret_cast<const uint4*>(p);
}

// Where row k, batch row r of an input array ([K][BT] f64 rows: x, old,
// y, h, relu(skip), s1) lies.  One row: at k, so that a lane's row pair is
// one 16-byte load.  More rows: a 64-row block holds, for each of its 8
// (j, e) and each pair of batch rows, the 8 lanes' values side by side
// (row 16 j + 2 s + e of lane s), so that a quarter-warp's 16-byte loads
// are 128 contiguous bytes (rows k and k + 1 of [K][BT] would lie 16 BT
// bytes apart: a 2-way or worse bank conflict).
template <int BT>
__device__ __forceinline__ int ix(int k, int r) {
  if constexpr (BT == 1) {
    return k;
  } else {
    const int kk = k & (kBlk - 1), j = kk >> 4, s = (kk >> 1) & 7;
    return (k - kk) * BT + ((2 * j + (kk & 1)) * (BT / 2) + (r >> 1)) * 16
           + 2 * s + (r & 1);
  }
}

// This lane's row pair j of one block (in: the block's first row): v0[r]
// and v1[r], the values of rows k and k + 1, k = 16 j + 2 s.
template <int BT>
__device__ __forceinline__ void row_pair(const double* in, int j, int s,
                                         double (&v0)[BT], double (&v1)[BT]) {
  if constexpr (BT == 1) {
    const double2 d =
        *reinterpret_cast<const double2*>(in + 16 * j + 2 * s);
    v0[0] = d.x;
    v1[0] = d.y;
  } else {
#pragma unroll
    for (int e = 0; e < 2; ++e)
#pragma unroll
      for (int p = 0; p < BT / 2; ++p) {
        const double2 d = *reinterpret_cast<const double2*>(
            in + ((2 * j + e) * (BT / 2) + p) * 16 + 2 * s);
        (e ? v1 : v0)[2 * p] = d.x;
        (e ? v1 : v0)[2 * p + 1] = d.y;
      }
  }
}

// The column phases (skip/residual, head): NG of a warp's groups at once,
// grp, grp + kWarps, ... (one past ngrp recomputes the last group, whose
// sums the caller drops), for independent chains of FMAs: this lane's
// partial over nb blocks of each group's weights (w + group * sz:
// [nb][32][8]) against inT, summed over the unit's lanes (every lane of the
// unit ends with the exact sum, out[k]).
template <int BT, bool kGlobal, int NG>
__device__ __forceinline__ void col_dots(const bf16* w, size_t sz, int grp,
                                         int ngrp, const double* in, int nb,
                                         int lane, double (&out)[NG][BT]) {
  const int s = lane % kSeg;
  const bf16* wk[NG];
#pragma unroll
  for (int k = 0; k < NG; ++k) {
    wk[k] = w + min(grp + k * kWarps, ngrp - 1) * sz + lane * 8;
#pragma unroll
    for (int r = 0; r < BT; ++r) out[k][r] = 0.0;
  }
  for (int b = 0; b < nb; ++b) {
    uint4 v[NG];
#pragma unroll
    for (int k = 0; k < NG; ++k)
      v[k] = load16<kGlobal>(wk[k] + (size_t)b * 32 * 8);
    const double* blk = in + (size_t)b * kBlk * BT;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      double x0[BT], x1[BT];
      row_pair<BT>(blk, j, s, x0, x1);
#pragma unroll
      for (int k = 0; k < NG; ++k) {
        double w0, w1;
        widen2(word(v[k], j), w0, w1);
#pragma unroll
        for (int r = 0; r < BT; ++r)
          out[k][r] = fma(x1[r], w1, fma(x0[r], w0, out[k][r]));
      }
    }
  }
#pragma unroll
  for (int o = kSeg / 2; o > 0; o >>= 1)
#pragma unroll
    for (int k = 0; k < NG; ++k)
#pragma unroll
      for (int r = 0; r < BT; ++r)
        out[k][r] += __shfl_xor_sync(0xffffffffu, out[k][r], o);
}

// A column phase over ngrp groups: each warp's groups NG at a time, then
// the epilogue epi(group, row, sum) once for every (group, row) that
// exists, its unit's lanes taking one pair each (the same code with their
// own data, so the pairs run side by side).  kOn: the products (else zero
// sums: the phase tool's variants).
template <int BT, bool kGlobal, bool kOn, int NG, class Epi>
__device__ __forceinline__ void col_phase_ng(const bf16* w, size_t sz,
                                             int ngrp, const double* in,
                                             int nb, int warp, int lane,
                                             Epi epi) {
  const int s = lane % kSeg;
  for (int grp = warp; grp < ngrp; grp += kWarps * NG) {
    double sum[NG][BT];
    if constexpr (kOn) {
      col_dots<BT, kGlobal, NG>(w, sz, grp, ngrp, in, nb, lane, sum);
    } else {
#pragma unroll
      for (int k = 0; k < NG; ++k)
#pragma unroll
        for (int r = 0; r < BT; ++r) sum[k][r] = 0.0;
    }
#pragma unroll
    for (int m = 0; m < (NG * BT + kSeg - 1) / kSeg; ++m) {
      const int e = s + m * kSeg;             // pair k * BT + r
      double v = 0.0;
#pragma unroll
      for (int k = 0; k < NG; ++k)
#pragma unroll
        for (int r = 0; r < BT; ++r)
          if (k * BT + r == e) v = sum[k][r];
      const int gk = grp + (e / BT) * kWarps;
      if (e < NG * BT && gk < ngrp) epi(gk, e % BT, v);
    }
  }
}

// NG as the groups per warp ask, up to kMax: each group more shares the
// lane's input reads, whose shared-memory wavefronts (counted) bound a
// phase at 4-8 rows; 16 rows spill registers even at one group.  (At 8 rows
// three groups spill a little and still measured faster than one or two:
// PERF.md.)
template <int BT, bool kGlobal, bool kOn = true, class Epi>
__device__ __forceinline__ void col_phase(const bf16* w, size_t sz, int ngrp,
                                          const double* in, int nb, int warp,
                                          int lane, Epi epi) {
  constexpr int kMax = BT <= 4 ? 4 : BT <= 8 ? 3 : 1;
  const int per = min(cdiv(ngrp, kWarps), kMax);
  if (kMax == 1 || per <= 1)
    col_phase_ng<BT, kGlobal, kOn, 1>(w, sz, ngrp, in, nb, warp, lane, epi);
  else if (kMax == 2 || per == 2)
    col_phase_ng<BT, kGlobal, kOn, (kMax > 1 ? 2 : 1)>(w, sz, ngrp, in, nb,
                                                       warp, lane, epi);
  else if (per == 3)
    col_phase_ng<BT, kGlobal, kOn, (kMax > 2 ? 3 : 1)>(w, sz, ngrp, in, nb,
                                                       warp, lane, epi);
  else
    col_phase_ng<BT, kGlobal, kOn, (kMax > 3 ? 4 : 1)>(w, sz, ngrp, in, nb,
                                                       warp, lane, epi);
}

// One level of the transposed butterfly over a unit's lanes: the lanes
// whose bit o is set keep the upper half of their N values, the others the
// lower half, each adding its partner's copy of the half it keeps.
template <int BT, int N>
__device__ __forceinline__ void halve(double (&v)[N][BT], int s, int o) {
  const bool hi = (s & o) != 0;
#pragma unroll
  for (int i = 0; i < N / 2; ++i)
#pragma unroll
    for (int r = 0; r < BT; ++r) {
      const double send = hi ? v[i][r] : v[i + N / 2][r];
      const double keep = hi ? v[i + N / 2][r] : v[i][r];
      v[i][r] = keep + __shfl_xor_sync(0xffffffffu, send, o);
    }
}

// v[i] summed over the unit's kSeg lanes: the halvings hand each lane one
// of the N values and the levels left add the lanes that hold the same one,
// so lane s ends with the sum of value s / 2 (N = 4) or s / 4 (N = 2) in
// v[0].
template <int BT, int N>
__device__ __forceinline__ void gate_reduce(double (&v)[N][BT], int s) {
  static_assert(kSeg == 8 && (N == 2 || N == 4), "three levels");
  halve<BT, N>(v, s, 4);
  if constexpr (N == 4)
    halve<BT, 2>(reinterpret_cast<double(&)[2][BT]>(v), s, 2);
#pragma unroll
  for (int o = N == 4 ? 1 : 2; o > 0; o >>= 1)
#pragma unroll
    for (int r = 0; r < BT; ++r)
      v[0][r] += __shfl_xor_sync(0xffffffffu, v[0][r], o);
}

// Phase A's products for one group over NP parts of nb K blocks each: this
// lane's partials of its channel's z_f and z_g columns (v[2 part],
// v[2 part + 1]), then summed (gate_reduce).  The parts are x and old
// (NP = 2), or y (NP = 1, with mel: a second call, so that no more than
// four sums a row are live at once).  wg: the parts' weights [blocks][2
// columns][32][8] bf16; xin: their input rows.
template <int BT, bool kGlobal, int NP>
__device__ __forceinline__ void gate_dot(const bf16* wg, const double* xin,
                                         int nb, int lane,
                                         double (&v)[2 * NP][BT]) {
#pragma unroll
  for (int i = 0; i < 2 * NP; ++i)
#pragma unroll
    for (int r = 0; r < BT; ++r) v[i][r] = 0.0;
  const int s = lane % kSeg;
#pragma unroll
  for (int part = 0; part < NP; ++part) {
    for (int b = 0; b < nb; ++b) {
      const int blk = part * nb + b;
      uint4 wv[2];
#pragma unroll
      for (int c = 0; c < 2; ++c)
        wv[c] = load16<kGlobal>(wg + ((size_t)(blk * 2 + c) * 32 + lane) * 8);
      const double* in = xin + (size_t)blk * kBlk * BT;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        double x0[BT], x1[BT];
        row_pair<BT>(in, j, s, x0, x1);
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          double w0, w1;
          widen2(word(wv[c], j), w0, w1);
#pragma unroll
          for (int r = 0; r < BT; ++r)
            v[2 * part + c][r] =
                fma(x1[r], w1, fma(x0[r], w0, v[2 * part + c][r]));
        }
      }
    }
  }
  gate_reduce<BT, 2 * NP>(v, s);
}

// ---------------------------------------------------------------------------

template <int BT, bool kStage>
__global__ void __launch_bounds__(kThreads, 1)
decode_kernel(const DecodeArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Plan& p = a.p;
  const int R = a.R, S = a.S, Q = a.Q, L = a.L, B = a.B, M = a.M;
  const int b0 = blockIdx.x * BT;
  const int nrows = min(BT, B - b0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int q = lane / kSeg, s = lane % kSeg;
  const bool gc = a.g != nullptr;
  const int nbR = cdiv(R, kBlk), nbS = cdiv(S, kBlk), nbM = cdiv(M, kBlk);
  const int gA = cdiv(R, kUnits), gB = cdiv(S + R, kUnits);
  const int g1 = cdiv(S, kUnits), g2 = cdiv(Q, kUnits);
  // bf16 elements of one group's weights: phase A, phase B, a head phase
  const size_t szA = (size_t)(2 * nbR + nbM) * 2 * 32 * 8;
  const size_t szB = (size_t)nbR * 32 * 8, szH = (size_t)nbS * 32 * 8;

  // the shared-memory arrays (ops/cuda/decode.py layout): f64 rows [K][BT]
  // zero-padded to whole blocks, then f32 arrays, ints, the mbarriers, the
  // stage buffers and the resident head
  double* xT = reinterpret_cast<double*>(smem + p.x);   // x, old, y
  double* oldT = xT + (size_t)nbR * kBlk * BT;
  double* yT = oldT + (size_t)nbR * kBlk * BT;
  double* hT = reinterpret_cast<double*>(smem + p.h);   // gated output
  double* sT = reinterpret_cast<double*>(smem + p.s);   // bf16(relu(skip))
  double* s1T = reinterpret_cast<double*>(smem + p.s1); // head hidden
  float* zT = reinterpret_cast<float*>(smem + p.z);     // [R][kSlots][BT]
  float* skipT = reinterpret_cast<float*>(smem + p.skip);   // [S][BT]
  float* scoreT = reinterpret_cast<float*>(smem + p.score); // [Q][BT]
  float* gsT = reinterpret_cast<float*>(smem + p.gs);   // [BT][2R]
  int* tok = reinterpret_cast<int*>(smem + p.tok);      // [BT]
  int* prev = tok + BT;                                 // [BT]
  int* seed = prev + BT;                                // [BT]
  int* offs = seed + BT;                                // [L] ring offsets
  int* dil = offs + L;              // [L] d - 1 (d a power of two), or -d
  const uint32_t mbar = smem_addr(smem + p.mbar);       // 2 stages, head
  bf16* stg = reinterpret_cast<bf16*>(smem + p.stg);    // [2][blk]
  const bf16* head = p.head_res ? reinterpret_cast<const bf16*>(smem + p.head)
                                : a.head;

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
  // every array before the ints starts at zero (the f64 rows' padding and
  // the rows past nrows stay so)
  for (int i = tid; i < p.tok / 16; i += kThreads)
    reinterpret_cast<uint4*>(smem)[i] = make_uint4(0, 0, 0, 0);
  if (tid == 0) {
    int acc = 0;
    for (int l = 0; l < L; ++l) {
      offs[l] = acc;
      // g mod d as g & (d - 1) where d is a power of two (else -d)
      dil[l] = (a.dils[l] & (a.dils[l] - 1)) ? -a.dils[l] : a.dils[l] - 1;
      acc += a.dils[l];
    }
    for (int i = 0; i < 3; ++i) mbar_init(mbar + 8 * i);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < BT) {
    const bool ok = tid < nrows;
    tok[tid] = ok ? a.tokens_init[(b0 + tid) * 2] : 0;
    prev[tid] = ok ? a.tokens_init[(b0 + tid) * 2 + 1] : 0;
    seed[tid] = ok ? a.seeds[b0 + tid] : 0;
  }
  __syncthreads();

  const int layers = L * a.num_steps;       // layers this launch runs
  if (p.head_res && kCopies)
    stage_copy(smem + p.head, a.head, 2u * p.hblk, mbar + 16, tid);
  if (kStage && kCopies) stage_copy(stg, a.pack, 2u * p.blk, mbar, tid);

  // The next layer's operands: `old` from its ring slot, its speaker
  // offsets and, at a step's last layer, the next step's mel features.
  // Their raw bits are loaded as a layer starts and held in registers, so
  // no instruction waits for them until they are stored, as it ends.
  const int no = nrows * R, ng = gc ? nrows * 2 * R : 0, ny = nrows * M;
  const unsigned short* ring16 =
      reinterpret_cast<const unsigned short*>(a.rings_out);
  const uint32_t* g32 = reinterpret_cast<const uint32_t*>(a.g);
  const unsigned short* y16 = reinterpret_cast<const unsigned short*>(a.y);
  // (a tile's ring rows are contiguous: value i of slot `slot` is at
  // slot * B * R + b0 * R + i)
  auto old_at = [&](int i, int slot) {
    return ring16[((size_t)slot * B + b0) * R + i];
  };
  auto g_at = [&](int i, int l) {            // [row][2R] of layer l
    return g32[((size_t)l * B + b0) * 2 * R + i];
  };
  auto y_at = [&](int i, int t) {            // row i / M, feature i % M
    return y16[((size_t)(b0 + i / M) * a.num_steps + t) * M + i % M];
  };
  auto put_old = [&](int i, unsigned short v) {
    oldT[ix<BT>(i % R, i / R)] = __uint_as_float((uint32_t)v << 16);
  };
  auto put_y = [&](int i, unsigned short v) {
    yT[ix<BT>(i % M, i / M)] = __uint_as_float((uint32_t)v << 16);
  };
  // layer l's ring slot at global step gg
  auto slot_of = [&](int l, int gg) {
    const int m = dil[l];
    return offs[l] + (m >= 0 ? gg & m : gg % -m);
  };
  // the embed of row r's (tok, prev) into x, by one whole warp
  auto embed_row = [&](int r) {
    const int tk = tok[r], pv = prev[r];
    for (int c = lane; c < R; c += 32)
      xT[ix<BT>(c, r)] = bf16_round(a.ecur[(size_t)tk * R + c]
                                  + a.eprev[(size_t)pv * R + c]);
  };

  // layer 0 of the first step: its operands, then x
  if (kRing)
    for (int i = tid; i < no; i += kThreads)
      put_old(i, old_at(i, slot_of(0, a.t0)));
  if (kEpiLoads)
    for (int i = tid; i < ng; i += kThreads)
      gsT[i] = __uint_as_float(g_at(i, 0));
  for (int i = tid; i < ny; i += kThreads) put_y(i, y_at(i, 0));
  if (warp < BT) embed_row(warp);
  if (kStage && kCopies) stage_wait(mbar, 0, tid);
  if (p.head_res && kCopies) stage_wait(mbar + 16, 0, tid);
  __syncthreads();

  const int ptid = (tid + kThreads - kLoadFrom) % kThreads;   // loaders
  const int rtid = (tid + kThreads - kRingFrom) % kThreads;   // ring write
  // where this thread's loads and ring writes go, worked out once: the
  // shared-memory index of its old values and of its x values to write, the
  // offset of its mel features (before the step) and their index
  int om[kPre], xm[kPre], ym[kPre];
  size_t yo[kPre];
#pragma unroll
  for (int j = 0; j < kPre; ++j) {
    const int i = ptid + j * kThreads, k = rtid + j * kThreads;
    om[j] = ix<BT>(i % R, i / R);
    xm[j] = ix<BT>(k % R, k / R);
    yo[j] = M ? ((size_t)(b0 + i / M) * a.num_steps) * M + i % M : 0;
    ym[j] = M ? ix<BT>(i % M, i / M) : 0;
  }
  int it = 0;                    // layers run so far: the stage buffer
  for (int t = 0; t < a.num_steps; ++t) {
    const int g = a.t0 + t;          // global step: ring phase and RNG key
    for (int l = 0; l < L; ++l, ++it) {
      const bool last = l + 1 == L;
      // the blob: staged (buffer it & 1; the next layer's copy starts into
      // the other, free since the barrier before this phase), or in place
      const bf16* w = kStage ? stg + (size_t)(it & 1) * p.blk
                             : a.pack + (size_t)l * p.blk;
      if constexpr (kStage) {
        if (kCopies && it + 1 < layers)
          stage_copy(stg + (size_t)((it + 1) & 1) * p.blk,
                     a.pack + (size_t)(last ? 0 : l + 1) * p.blk,
                     2u * p.blk, mbar + 8 * ((it + 1) & 1), tid);
      }
      const float* bias = reinterpret_cast<const float*>(w + p.bias);

      // the next layer's operands start to load now, unless the next layer
      // is this one a step on (one layer), whose ring slot this phase A may
      // write: then after it
      const int ln = last ? 0 : l + 1;
      const int nslot = slot_of(ln, last ? g + 1 : g);
      const bool more = it + 1 < layers;
      const int mo = more && kRing ? no : 0, mg = more && kEpiLoads ? ng : 0;
      const int my = more && last ? ny : 0;
      unsigned short po[kPre], py[kPre];
      uint32_t pg[kPre];
      auto load_next = [&]() {
#pragma unroll
        for (int j = 0; j < kPre; ++j) {
          const int i = ptid + j * kThreads;
          if (i < mo) po[j] = old_at(i, nslot);
          if (i < mg) pg[j] = g_at(i, ln);
          if (i < my) py[j] = y16[yo[j] + (size_t)(t + 1) * M];
        }
      };
      const bool early = ln != l;
      if (early) load_next();

      // ---- phase A: z and the gate.  This layer's input x goes into its
      // ring slot first (whose old row was read before this layer began).
      if (kRing) {
        const int slot = slot_of(l, g);
        bf16* dst = a.rings_out + ((size_t)slot * B + b0) * R;
#pragma unroll
        for (int j = 0; j < kPre; ++j)
          if (rtid + j * kThreads < nrows * R)
            dst[rtid + j * kThreads] = __float2bfloat16_rn((float)xT[xm[j]]);
        for (int i = rtid + kPre * kThreads; i < nrows * R; i += kThreads)
          dst[i] = __float2bfloat16_rn((float)xT[ix<BT>(i % R, i / R)]);
      }
      for (int grp = warp; grp < gA; grp += kWarps) {
        const bf16* wg = w + grp * szA;
        const int c = grp * kUnits + q;          // this lane's channel
        // the lane's sums to zT: slot s / 2 of x and old (held twice), then
        // with mel slot 4 + s / 4 of y (held four times)
        {
          double v[4][BT];
          if constexpr (kZ) {
            gate_dot<BT, !kStage, 2>(wg, xT, nbR, lane, v);
          } else {
#pragma unroll
            for (int r = 0; r < BT; ++r) v[0][r] = 0.0;
          }
          if (c < R && (s & 1) == 0)
#pragma unroll
            for (int r = 0; r < BT; ++r)
              zT[((size_t)c * kSlots + (s >> 1)) * BT + r] =
                  __double2float_rn(v[0][r]);
        }
        if (M) {
          double v[2][BT];
          if constexpr (kZ) {
            gate_dot<BT, !kStage, 1>(wg + (size_t)2 * nbR * 2 * 32 * 8, yT,
                                     nbM, lane, v);
          } else {
#pragma unroll
            for (int r = 0; r < BT; ++r) v[0][r] = 0.0;
          }
          if (c < R && (s & 3) == 0)
#pragma unroll
            for (int r = 0; r < BT; ++r)
              zT[((size_t)c * kSlots + 4 + (s >> 2)) * BT + r] =
                  __double2float_rn(v[0][r]);
        }
        __syncwarp();
        // the gate: z = ((x @ W_cur + old @ W_prev) + b) [+ y @ V] [+ g]
        if (c < R)
          for (int r = s; r < BT; r += kSeg) {
            const float* zc = zT + (size_t)c * kSlots * BT + r;
            float zf = (zc[0] + zc[2 * BT]) + (kEpiLoads ? bias[c] : 0.0f);
            float zg = (zc[BT] + zc[3 * BT])
                       + (kEpiLoads ? bias[R + c] : 0.0f);
            if (M) {
              zf += zc[4 * BT];
              zg += zc[5 * BT];
            }
            if (gc) {                   // this row's speaker offsets
              zf += gsT[r * 2 * R + c];
              zg += gsT[r * 2 * R + R + c];
            }
            hT[ix<BT>(c, r)] = bf16_round(tanhf(zf) * sigmoidf(zg));
          }
      }
      __syncthreads();

      // ---- phase B: skip and residual
      if (!early) load_next();
      col_phase<BT, !kStage, kSkipRes>(
          w + p.wb, szB, gB, hT, nbR, warp, lane,
          [&](int grp, int r, double sum) {
            const int u = grp * kUnits + q;        // this lane's column
            if (u < S) {
              float& sk = skipT[u * BT + r];
              sk = (sk + __double2float_rn(sum))
                   + (kEpiLoads ? bias[2 * R + u] : 0.0f);
              if (last) sT[ix<BT>(u, r)] = bf16_round(fmaxf(sk, 0.0f));
            } else if (u < S + R) {
              const int c = u - S;
              double* x = xT + ix<BT>(c, r);
              *x = bf16_round(((float)*x + __double2float_rn(sum))
                              + (kEpiLoads ? bias[2 * R + S + c] : 0.0f));
            }
          });
      // the next layer's operands into place
#pragma unroll
      for (int j = 0; j < kPre; ++j) {
        const int i = ptid + j * kThreads;
        if (i < mo) oldT[om[j]] = __uint_as_float((uint32_t)po[j] << 16);
        if (i < mg) gsT[i] = __uint_as_float(pg[j]);
        if (i < my) yT[ym[j]] = __uint_as_float((uint32_t)py[j] << 16);
      }
      for (int i = ptid + kPre * kThreads; i < max(mo, max(mg, my));
           i += kThreads) {
        if (i < mo) put_old(i, old_at(i, nslot));
        if (i < mg) gsT[i] = __uint_as_float(g_at(i, ln));
        if (i < my) put_y(i, y_at(i, t + 1));
      }
      if (kStage && kCopies && more)     // the next layer's blob
        stage_wait(mbar + 8 * ((it + 1) & 1), ((it + 1) >> 1) & 1, tid);
      __syncthreads();
    }

    // ---- head: s1 = bf16(relu(s @ W1 + b1)), then the scores
    const float* hb = reinterpret_cast<const float*>(head + p.hbias);
    col_phase<BT, false>(head, szH, g1, sT, nbS, warp, lane,
                         [&](int grp, int r, double sum) {
      const int o = grp * kUnits + q;
      if (o < S)
        s1T[ix<BT>(o, r)] =
            bf16_round(fmaxf(__double2float_rn(sum) + hb[o], 0.0f));
    });
    __syncthreads();
    col_phase<BT, false>(head + p.h2, szH, g2, s1T, nbS, warp, lane,
                         [&](int grp, int r, double sum) {
      const int o = grp * kUnits + q;
      if (o < Q) {
        float sc = __double2float_rn(sum) + hb[S + o];
        if (!a.greedy && r < nrows)
          sc = __fadd_rn(__fmul_rn(sc, a.inv_temp),
                         wn_counter_gumbel(seed[r], g, o));
        scoreT[o * BT + r] = sc;
      }
    });
    __syncthreads();

    // first-index argmax, one warp per row: record, apply the prime, embed
    // the next step's x; the skip sums start again
    if (warp < BT) {
      const int r = warp;
      const int bi = warp_argmax<BT>(scoreT, Q, r, lane);
      if (lane == 0 && r < nrows) {
        int nxt = bi;
        a.tokens_out[(size_t)(b0 + r) * a.num_steps + t] = nxt;
        if (g + 1 < a.num_forced)
          nxt = a.forced[(size_t)(b0 + r) * a.num_forced + g + 1];
        prev[r] = tok[r];
        tok[r] = nxt;
      }
      __syncwarp();
      if (t + 1 < a.num_steps) embed_row(r);
    }
    for (int i = tid; i < S * BT; i += kThreads) skipT[i] = 0.0f;
    __syncthreads();
  }

  if (tid < nrows) {
    a.carry_out[(b0 + tid) * 2] = tok[tid];
    a.carry_out[(b0 + tid) * 2 + 1] = prev[tid];
  }
}

template <int BT>
int launch(const DecodeArgs& a, cudaStream_t stream) {
  void (*kern)(const DecodeArgs) =
      a.p.stage ? decode_kernel<BT, true> : decode_kernel<BT, false>;
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, a.p.smem);
  if (e != cudaSuccess) return (int)e;
  const int grid = (a.B + BT - 1) / BT;
  kern<<<grid, kThreads, a.p.smem, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launch the narrow whole-loop decode on `stream`; returns a cudaError_t
// code (0 on success).  pack [L, blk] and head [hblk] bf16: the packed
// layer and head blobs (ops/cuda/decode.py pack_layers); bt in {1, 2, 4, 8,
// 16} rows per block; plan: the Plan above as nplan ints
// (ops/cuda/decode.py plan).  y [B, num_steps, M] (bf16) with M > 0 for a
// mel-conditioned model, null and M = 0 otherwise; g [L, B, 2R] (f32) for
// a speaker-conditioned model, null otherwise.
int wn_decode(const int32_t* seeds, const int32_t* tokens_init,
              const int32_t* forced, const float* ecur, const float* eprev,
              const void* pack, const void* head, const int32_t* dils,
              const void* y, const float* g, const void* rings_in,
              void* rings_out, int32_t* tokens_out, int32_t* carry_out,
              int L, int R, int S, int Q, int M, int sum_d, int B,
              int num_steps, int t0, int num_forced, int greedy,
              float inv_temp, int bt, const int32_t* plan, int nplan,
              void* stream) {
  typedef const bf16* W;
  if (plan == nullptr || nplan != kPlanInts) return (int)cudaErrorInvalidValue;
  Plan p;
  memcpy(&p, plan, sizeof(Plan));
  DecodeArgs a{seeds, tokens_init, forced, ecur, eprev, (W)pack, (W)head,
               dils, (W)y, g, (W)rings_in, (bf16*)rings_out, tokens_out,
               carry_out, L, R, S, Q, M, sum_d, B, num_steps, t0, num_forced,
               greedy, inv_temp, p};
  if (R < 1 || S < 1 || Q < 1 || L < 1 || M < 0 || B < 1 || num_steps < 1 ||
      (M > 0) != (y != nullptr) || p.smem < 1 || p.smem > 232448 ||
      p.blk % 8 || p.hblk % 8 || p.bias % 2 ||
      p.hbias % 2 || p.stg % 16 ||
      p.head % 16 || p.mbar % 8 || p.tok % 16)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bt) {
    case 1: return launch<1>(a, s);
    case 2: return launch<2>(a, s);
    case 4: return launch<4>(a, s);
    case 8: return launch<8>(a, s);
    case 16: return launch<16>(a, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* wn_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
