// Whole-loop autoregressive WaveNet decode on Hopper (sm_90a), one batch
// tile's layer chain split over a thread-block cluster.
//
// Replaces wavenet_tpu/ops/pallas/decode_wide.py::_decode_kernel, the TPU's
// whole-loop decoder for wide models (R >= 128, the `full` and
// `full_vocoder` presets), in all its forms: unconditional, mel-conditioned
// (has_cond) and speaker-conditioned (has_gc).  One launch runs num_steps
// decode steps; per step and batch row: f32 embed of (token, prev) -> L
// gated dilated layers with compact ring reads/writes -> ReLU/1x1/ReLU/1x1
// head -> counter-RNG Gumbel-max sample (argmax when greedy) -> the
// forced-prime override, after the kernel's own argmax has been recorded.
// Rings [sum_d, B, R] bf16 live in device memory in the JAX layout; the
// carry [B, 2] = (next token, its predecessor) continues a later launch.  A
// mel-conditioned launch also reads y [B, num_steps, M] bf16 (this launch's
// steps only, contiguous: a chunked caller passes its chunk's slice) and
// V_cond [L, M, 2R] bf16, and adds y_t @ V_cond[l] into every layer's gate;
// a speaker-conditioned launch reads g [L, B, 2R] f32 (each row's
// time-constant speaker offsets) and adds g[l, row] after that.
//
// What bounds it on the card: each step is a serial chain of L layers,
// each of dependent matrix-vector phases (z, gate, skip + residual) over
// weights (~9.4 MB at `full`, bf16) that are re-read every step: they fit
// the 50 MB L2, not one SM.  The step time is that chain's latency, not
// bytes or operations.  Run on one SM per row (the design until this one),
// a step was one SM's rate of weight widenings and f64 FMAs for all
// ~4.7 M weights, plus an L2 round trip per phase.
//
// The design: a cluster of C CTAs (C = 16 by default, ops/cuda/
// decode_wide.py plan_clusters) runs the chain of one tile of up to 8 rows,
// each CTA owning R/C gate channels:
//   z, gate   the z_f and z_g columns of its channels (x, old and y_t in
//             full in every CTA), so its slice of h never leaves it;
//   skip, res the rows of W_skip and W_res its h slice multiplies: exact
//             f64 partial sums of all S + R columns, sent where they are
//             reduced (a skip column's to the CTA owning it) by st.async
//             into distributed shared memory, completing on the receiver's
//             mbarrier;
//   reduce    each CTA adds the C partials of its S/C skip columns and of
//             residual columns by one of two exchanges (kScatter, a
//             template parameter; ops/cuda/decode_wide.py plan_clusters
//             picks one):
//     all-reduce  a residual column's partials go to every CTA, which adds
//                 them for all R columns, so each holds all of the next x:
//                 one exchange a layer, in two buffers by layer parity of
//                 C x R partials each (a buffer is re-armed before its CTA
//                 sends the partials that let the others run on to its
//                 next use).  The faster at one row per cluster;
//     scatter     a residual column's partials go to the CTA owning it,
//                 which adds them for its R/C columns and sends that slice
//                 of the next x to every other CTA: two exchanges a layer,
//                 in single buffers of R partials and R values of x (the x
//                 slices a CTA receives say that every CTA is done with
//                 the layer's partials), the head's relu(skip) and s1 over
//                 the layer's arrays (written only once the writer has
//                 every x slice).  A tenth of the all-reduce's messages and
//                 sums: the faster at two rows per cluster and more, and
//                 its buffers do not grow with C x R, so it takes the
//                 widths whose all-reduce buffers do not fit;
//   head      S/C of W1's columns and a ragged Q/C share of the logits.
// No layer has a cluster barrier: each CTA waits on its own mbarriers for
// the senders' bytes.  The step's head has 3 cluster barriers (relu(skip),
// s1, the (score, index) argmax candidates).  Two cluster barriers a
// layer (h and x exchanged) measured slower than either exchange; the
// phases' own latency (load, widen, FMA chains of a few dozen steps, and
// the code each runs) is most of a layer (utils/decode_phases.py times the
// kernel with each part removed).
// A CTA's share of a layer (7,168 weights at `full` with C = 16, packed
// contiguously by pack_shares) with its ring rows and speaker offsets is
// staged in shared memory by cp.async two layers ahead (two buffers); a
// share that does not fit two buffers is read in place (kStage, a
// template parameter, so each kernel holds only the code its loop runs).
// Within a CTA the z phase splits every dot product's K range over the
// threads into exact f64 partials (decode_common.cuh dot_part, or
// dot_staged from shared memory) that an epilogue adds, as the narrow
// kernel does.  Weights are widened by integer operations (bf16_exact.cuh).
// The candidates are merged in rank order with a strict comparison, which
// keeps warp_argmax's first-index tie-break, and every CTA ends the step
// knowing the token.  The Gumbel term is keyed by (seed, step, class), so
// each CTA adds it to its own logits.
//
// The ring hazard: a layer reads `old` from slot off_l + g mod d_l and
// writes its input x to the same slot.  Every CTA reads the whole old row
// (R values, copied before its z phase); a CTA writes its own slice of x
// only after it has every CTA's partials of that layer (of its columns,
// with the scatter), which each sent after its z phase.  A step's ring writes reach the next step's first
// copies through the head's cluster barriers.  The launch's copy of
// rings_in to rings_out is split over the cluster, which synchronises
// before step 0.
//
// Per-row arithmetic depends neither on C nor on the rows per cluster: every
// dot product is the exact f64 sum of that row's bf16 x bf16 products,
// rounded once to f32 (partials added in any order give the same bits),
// and everything else is elementwise.  A request replayed alone therefore
// reproduces its co-batched tokens bit for bit, and the plain PyTorch
// version, which computes the same exact sums, agrees with the kernel bit
// for bit up to the math library's tanhf/expf/logf.
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

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_common.cuh"
#include "rng.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 16;
constexpr size_t kMaxSmem = 232448;    // 227 KiB per block

// utils/decode_phases.py builds this file with one part of a layer's work
// taken out (-D WN_PHASE_NO_...), to time what each part costs a step; the
// tokens are then wrong, and each variant keeps the exchange's protocol
// (bytes still expected are not waited for), so none can wait forever.
#ifdef WN_PHASE_NO_EXCHANGE
constexpr bool kExchange = false;      // no partials or x slices sent
#else
constexpr bool kExchange = true;
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
#ifdef WN_PHASE_NO_COPIES
constexpr bool kCopies = false;        // no staging of later layers
#else
constexpr bool kCopies = true;
#endif

struct DecodeArgs {
  const int32_t* seeds;          // [B]
  const int32_t* tokens_init;    // [B, 2] (token consumed first, its prev)
  const int32_t* forced;         // [B, num_forced] or null
  const float* ecur;             // [Q, R]
  const float* eprev;            // [Q, R]
  const __nv_bfloat16* pack;     // [L, C, blk]: each CTA's layer share
  const __nv_bfloat16* hw1;      // [S, S]
  const float* hb1;              // [S]
  const __nv_bfloat16* hw2;      // [S, Q]
  const float* hb2;              // [Q]
  const int32_t* dils;           // [L]
  const __nv_bfloat16* y;        // [B, num_steps, M] or null (no mel)
  const float* g;                // [L, B, 2R] or null (no speaker)
  const __nv_bfloat16* rings_in; // [sum_d, B, R]
  __nv_bfloat16* rings_out;      // [sum_d, B, R]
  int32_t* tokens_out;           // [B, num_steps]
  int32_t* carry_out;            // [B, 2]
  int L, R, S, Q, M, sum_d, B, num_steps, t0, num_forced, greedy;
  float inv_temp;
  int C, stage, scatter;         // CTAs per cluster; shares staged in
                                 // shared memory, or read in place; the
                                 // scatter exchange, or the all-reduce
};

// First column of rank c's share of n columns over C ranks (ragged when C
// does not divide n).
__host__ __device__ inline int share_lo(int n, int c, int C) {
  return (int)((long long)n * c / C);
}

__host__ __device__ inline size_t align16(size_t x) {
  return (x + 15) & ~(size_t)15;
}

// A CTA's share of one layer in the packed weights (ops/cuda/decode_wide.py
// pack_shares), blk bf16 elements at [l][rank]: W_cur and W_prev [R][2hc]
// each (its z_f then its z_g columns), V_cond [M][2hc], the rows of
// W_skip [hc][S] and W_res [hc][R] that its h slice multiplies, then the
// biases as f32 (b's z_f and z_g channels, all of b_res, its b_skip
// columns: 2hc + R + sc), padded to 16 bytes.
struct Share {
  int wp, vc, ws, wr, bias, blk;   // element offsets; the block's length
};

__host__ __device__ inline Share share_layout(int C, int R, int S, int M) {
  const int hc = R / C, sc = S / C;
  Share o;
  o.wp = R * 2 * hc;
  o.vc = 2 * o.wp;
  o.ws = o.vc + M * 2 * hc;
  o.wr = o.ws + hc * S;
  o.bias = o.wr + hc * R;
  o.blk = (o.bias + 2 * (2 * hc + R + sc) + 7) / 8 * 8;
  return o;
}

// One stage buffer: what a CTA reads of layer l from device memory, copied
// one layer ahead: its share (blk elements), the tile's ring rows `old`
// [bt][R] bf16 and, with a speaker, the rows' offsets [bt][2hc] f32.
struct StageLayout {
  size_t old, g, total;
};

__host__ __device__ inline StageLayout stage_layout(int bt, int C, int R,
                                                    int S, int M, int gc) {
  StageLayout o;
  o.old = 2 * (size_t)share_layout(C, R, S, M).blk;
  o.g = o.old + align16(2 * (size_t)bt * R);
  o.total = o.g + (gc ? align16(4 * (size_t)bt * 2 * (R / C)) : 0);
  return o;
}

// Byte offsets of a CTA's shared-memory arrays (ops/cuda/decode_wide.py
// smem_bytes mirrors `total`).
struct Layout {
  size_t x, old, h, s, s1, y, part, rpart, spart, stage, skip, score,
      cand_s, cand_i, mbar, tok, prev, seed, offs, dil, total;
};

__host__ __device__ inline Layout layout(int bt, int C, int threads,
                                         int stage, int scatter, int gc,
                                         int L, int R, int S, int Q, int M) {
  const int hc = R / C, sc = S / C, qc = (Q + C - 1) / C;
  int units = threads;              // partial-sum rows of the widest phase
  const int widths[3] = {(M ? 3 : 2) * 2 * hc, sc, qc};
  for (int i = 0; i < 3; ++i) units = widths[i] > units ? widths[i] : units;
  Layout o;
  size_t p = 0;
  auto take = [&](size_t bytes) {
    const size_t at = p;
    p = align16(p + bytes);
    return at;
  };
  o.x = take(8 * (size_t)R * bt);
  if (scatter) {
    // the arrays only the layers use, then the head's over them; the
    // exchange [C][hc][bt] and [C][sc][bt]
    const size_t layers = p;
    o.old = take(8 * (size_t)R * bt);
    o.h = take(8 * (size_t)hc * bt);
    o.y = take(8 * (size_t)M * bt);
    o.rpart = take(8 * (size_t)R * bt);
    o.spart = take(8 * (size_t)C * sc * bt);
    const size_t end = p;
    p = layers;
    o.s = take(8 * (size_t)S * bt);
    o.s1 = take(8 * (size_t)S * bt);
    if (p < end) p = end;
    o.part = take(8 * (size_t)units * bt);
  } else {
    // the exchange [2][C][R][bt] and [2][C][sc][bt]
    o.old = take(8 * (size_t)R * bt);
    o.h = take(8 * (size_t)hc * bt);
    o.s = take(8 * (size_t)S * bt);
    o.s1 = take(8 * (size_t)S * bt);
    o.y = take(8 * (size_t)M * bt);
    o.part = take(8 * (size_t)units * bt);
    o.rpart = take(8 * 2 * (size_t)C * R * bt);
    o.spart = take(8 * 2 * (size_t)C * sc * bt);
  }
  o.stage = take(stage ? 2 * stage_layout(bt, C, R, S, M, gc).total : 0);
  o.skip = take(4 * (size_t)sc * bt);
  o.score = take(4 * (size_t)qc * bt);
  o.cand_s = take(4 * (size_t)C * bt);
  o.cand_i = take(4 * (size_t)C * bt);
  o.mbar = take(8 * 2);
  o.tok = take(4 * (size_t)bt);
  o.prev = take(4 * (size_t)bt);
  o.seed = take(4 * (size_t)bt);
  o.offs = take(4 * (size_t)L);
  o.dil = take(4 * (size_t)L);
  o.total = p;
  return o;
}

// ---------------------------------------------------------------------------
// Staging: cp.async of 16 bytes.

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait for this thread's copies but the last `pending` (0 or 1) groups.
__device__ __forceinline__ void cp_async_wait(int pending) {
  if (pending)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// ---------------------------------------------------------------------------
// The layer exchange: st.async of f64 values into another CTA's shared
// memory, completing bytes on that CTA's mbarrier.

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

// The shared::cluster address of local address `a` in CTA `rank`.
__device__ __forceinline__ uint32_t map_rank(uint32_t a, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(r) : "r"(a), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_async(uint32_t addr, double v,
                                         uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b64 [%0], %1, "
      "[%2];\n" ::"r"(addr), "l"(__double_as_longlong(v)), "r"(mbar)
      : "memory");
}

// Two f64 (16 bytes) at addr, addr + 8.
__device__ __forceinline__ void st_async2(uint32_t addr, double v0,
                                          double v1, uint32_t mbar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b64 [%0], "
      "{%1, %2}, [%3];\n" ::"r"(addr), "l"(__double_as_longlong(v0)),
      "l"(__double_as_longlong(v1)), "r"(mbar)
      : "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(mbar));
}

// The barrier's next phase expects `bytes` (this CTA's one arrival).
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
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(mbar), "r"(parity) : "memory");
  } while (!done);
}

// One dot-product job of a phase: columns 0..ncols-1 of W [K][ld] (a
// share, packed) against inT [K][BT].
struct Job {
  const __nv_bfloat16* W;
  const double* in;
  int K, ld, ncols;
};

// sum[r] = sum over k in [kb, ke) of inT[k][r] * W[k][o] for a W in
// shared memory (a staged share), exact in f64: U weights and row vectors
// loaded before their FMAs (U independent accumulators), no deeper
// batching, so the loop stays short.
template <int BT>
__device__ __forceinline__ void dot_staged(const __nv_bfloat16* W, int kb,
                                           int ke, int N, int o,
                                           const double* inT,
                                           double sum[BT]) {
  constexpr int U = BT >= 4 ? 2 : 4;
  double acc[U][BT];
#pragma unroll
  for (int h = 0; h < U; ++h)
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[h][r] = 0.0;
  int k = kb;
  for (; k + U <= ke; k += U) {
    double wj[U], v[U][BT];
#pragma unroll
    for (int h = 0; h < U; ++h) {
      wj[h] = bf2d_v(W[(k + h) * N + o]);
      load_rows<BT>(inT + (k + h) * BT, v[h]);
    }
#pragma unroll
    for (int h = 0; h < U; ++h)
#pragma unroll
      for (int r = 0; r < BT; ++r)
        acc[h][r] = fma(v[h][r], wj[h], acc[h][r]);
  }
  for (; k < ke; ++k) {
    const double wj = bf2d_v(W[k * N + o]);
    double v[BT];
    load_rows<BT>(inT + k * BT, v);
#pragma unroll
    for (int r = 0; r < BT; ++r) acc[0][r] = fma(v[r], wj, acc[0][r]);
  }
#pragma unroll
  for (int r = 0; r < BT; ++r) {
    double t = acc[0][r];
#pragma unroll
    for (int h = 1; h < U; ++h) t += acc[h][r];
    sum[r] = t;
  }
}

// Every (column, K segment) unit of up to three jobs (ncols = 0 for an
// absent one) over the CTA's threads: part[u][BT] holds unit u's exact f64
// partial sums, units ordered job, segment, column.  kStaged: the jobs'
// weights are in shared memory (else in device memory: batched loads).
template <int BT, bool kStaged>
__device__ __forceinline__ void dot_units(const Job& a, const Job& b,
                                          const Job& c, int segs,
                                          double* part, int tid, int nt) {
  const int na = a.ncols * segs, nb = b.ncols * segs;
  const int total = na + nb + c.ncols * segs;
  for (int u = tid; u < total; u += nt) {
    // the unit's job, field by field (selects, not a reference: the jobs
    // stay in registers)
    const bool in_a = u < na, in_b = !in_a && u < na + nb;
    const __nv_bfloat16* W = in_a ? a.W : in_b ? b.W : c.W;
    const double* in = in_a ? a.in : in_b ? b.in : c.in;
    const int K = in_a ? a.K : in_b ? b.K : c.K;
    const int ld = in_a ? a.ld : in_b ? b.ld : c.ld;
    const int ncols = in_a ? a.ncols : in_b ? b.ncols : c.ncols;
    const int v = in_a ? u : in_b ? u - na : u - na - nb;
    const int seg = v / ncols, col = v - seg * ncols;
    const int kseg = (K + segs - 1) / segs;
    const int kb = min(K, seg * kseg), ke = min(K, kb + kseg);
    double sum[BT];
    if constexpr (kStaged)
      dot_staged<BT>(W, kb, ke, ld, col, in, sum);
    else
      dot_part<BT>(W, kb, ke, ld, col, in, sum);
#pragma unroll
    for (int r = 0; r < BT; ++r) part[u * BT + r] = sum[r];
  }
}

// K segments of a phase whose jobs have `cols` columns in all: as many as
// the threads allow, at least one.
__device__ __forceinline__ int segments(int cols, int nt) {
  return max(1, nt / max(cols, 1));
}

// The exact sum over segments of column col, row r, of the job whose units
// start at unit `off` and have ncols columns.
template <int BT>
__device__ __forceinline__ double unit_sum(const double* part, int off,
                                           int ncols, int segs, int col,
                                           int r) {
  double s = 0.0;
#pragma unroll 4
  for (int q = 0; q < segs; ++q) s += part[(off + q * ncols + col) * BT + r];
  return s;
}

// kStage: each layer's share is staged in shared memory (else read in
// place); kScatter: the scatter exchange (else the all-reduce).  Template
// parameters, so that each kernel holds only the code its loop runs (a
// smaller loop measured faster on the card).
template <int BT, bool kStage, bool kScatter>
__global__ void __launch_bounds__(kMaxThreads, 1)
decode_wide_kernel(const DecodeArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  const int R = a.R, S = a.S, Q = a.Q, L = a.L, B = a.B, M = a.M, C = a.C;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int rank = (int)cluster.block_rank();
  const int b0 = (blockIdx.x / C) * BT;
  const int nrows = min(BT, B - b0);
  const int hc = R / C, lo = rank * hc;          // gate channels
  const int sc = S / C, slo = rank * sc;         // skip and W1 columns
  const int qlo = share_lo(Q, rank, C);          // logits
  const int qc = share_lo(Q, rank + 1, C) - qlo;
  const bool gc = a.g != nullptr;
  const Layout ly = layout(BT, C, nt, kStage, kScatter, gc, L, R, S, Q, M);
  const StageLayout sl = stage_layout(BT, C, R, S, M, gc);

  double* xT = reinterpret_cast<double*>(smem + ly.x);     // [R][BT]
  double* oldT = reinterpret_cast<double*>(smem + ly.old); // [R][BT]
  double* hT = reinterpret_cast<double*>(smem + ly.h);     // [hc][BT]
  double* sT = reinterpret_cast<double*>(smem + ly.s);     // [S][BT]
  double* s1T = reinterpret_cast<double*>(smem + ly.s1);   // [S][BT]
  double* yT = reinterpret_cast<double*>(smem + ly.y);     // [M][BT]
  double* part = reinterpret_cast<double*>(smem + ly.part);
  // the exchange: every CTA's partial sums of the residual columns this
  // CTA reduces and of its skip columns, all-reduce: all R residual
  // columns [2][C][R][BT] and [2][C][sc][BT] (two buffers by layer
  // parity); scatter: its own [C][hc][BT] and [C][sc][BT]
  double* rpart = reinterpret_cast<double*>(smem + ly.rpart);
  double* spart = reinterpret_cast<double*>(smem + ly.spart);
  unsigned char* stg = smem + ly.stage;                    // two buffers
  float* skipT = reinterpret_cast<float*>(smem + ly.skip);   // [sc][BT]
  float* scoreT = reinterpret_cast<float*>(smem + ly.score); // [qc][BT]
  float* cand_s = reinterpret_cast<float*>(smem + ly.cand_s);  // [C][BT]
  int* cand_i = reinterpret_cast<int*>(smem + ly.cand_i);      // [C][BT]
  // all-reduce: one per buffer; scatter: the partials', the x slices'
  const uint32_t mbar = smem_addr(smem + ly.mbar);
  int* tok = reinterpret_cast<int*>(smem + ly.tok);
  int* prev = reinterpret_cast<int*>(smem + ly.prev);
  int* seed = reinterpret_cast<int*>(smem + ly.seed);
  int* offs = reinterpret_cast<int*>(smem + ly.offs);
  int* dil = reinterpret_cast<int*>(smem + ly.dil);
  typedef __nv_bfloat16 bf16;

  const Share sh = share_layout(C, R, S, M);
  const int nz = 2 * hc;
  // bytes each CTA receives per layer: C partials of R + sc columns
  // (all-reduce) or hc + sc (scatter), and the C - 1 other x slices
  const uint32_t xbytes = 8u * C * BT * ((kScatter ? hc : R) + sc);
  const uint32_t sbytes = 8u * (C - 1) * hc * BT;
  // start the cp.async copies of layer l (ring slot `slot`) into stage
  // buffer buf: the share, the ring rows, the speaker offsets
  auto stage_layer = [&](int l, int slot, int buf) {
    unsigned char* p = stg + (size_t)buf * sl.total;
    const uint4* src = reinterpret_cast<const uint4*>(
        a.pack + ((size_t)l * C + rank) * sh.blk);
    for (int i = tid; i < sh.blk / 8; i += nt)
      cp_async16(p + 16 * (size_t)i, src + i);
    const uint4* rows = reinterpret_cast<const uint4*>(
        a.rings_out + ((size_t)slot * B + b0) * R);   // adjacent rows
    for (int i = tid; i < nrows * R / 8; i += nt)
      cp_async16(p + sl.old + 16 * (size_t)i, rows + i);
    if (gc) {        // two runs of hc offsets per row: z_f's, then z_g's
      const float* gl = a.g + ((size_t)l * B + b0) * 2 * R + lo;
      const int per = hc / 4;
      for (int i = tid; i < nrows * 2 * per; i += nt) {
        const int r = i / (2 * per), h = (i / per) % 2, q = i % per;
        cp_async16(p + sl.g + 4 * ((size_t)r * nz + h * hc + 4 * q),
                   gl + (size_t)r * 2 * R + h * R + 4 * q);
      }
    }
    cp_async_commit();
  };

  // this tile's ring rows into the output buffer (unless updated in
  // place), split over the cluster
  if (a.rings_in != a.rings_out) {
    const int vecs = R / 8;          // 8 bf16 per 16-byte vector
    const size_t total = (size_t)a.sum_d * nrows * vecs;
    const uint4* src = reinterpret_cast<const uint4*>(a.rings_in);
    uint4* dst = reinterpret_cast<uint4*>(a.rings_out);
    for (size_t i = (size_t)rank * nt + tid; i < total; i += (size_t)C * nt) {
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
    for (int b = 0; b < 2; ++b) {    // both expect their layer's bytes
      mbar_init(mbar + 8 * b);
      mbar_expect(mbar + 8 * b, kScatter && b ? sbytes : xbytes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  if (tid < BT) {
    const bool ok = tid < nrows;
    tok[tid] = ok ? a.tokens_init[(b0 + tid) * 2] : 0;
    prev[tid] = ok ? a.tokens_init[(b0 + tid) * 2 + 1] : 0;
    seed[tid] = ok ? a.seeds[b0 + tid] : 0;
  }
  cluster.sync();          // rings copied and barriers set in every CTA
  // layer l's copies go to stage buffer l & 1 two layers ahead: those of
  // layers 0 and 1 before a step (here, then in the head), those of layer
  // l + 2 once layer l's buffer is free
  if constexpr (kStage)
    for (int l = 0; l < 2 && l < L; ++l)
      stage_layer(l, offs[l] + a.t0 % dil[l], l);

  // z, head 1 and head 2 segments
  const int seg_z = segments((M ? 3 : 2) * nz, nt);
  const int seg_h1 = segments(sc, nt), seg_h2 = segments(qc, nt);
  const Job none{nullptr, nullptr, 0, 0, 0};
  int it = 0;              // layers run so far: stage and exchange buffer
  // prepare(l, t, it): where layer l of step t reads its share and speaker
  // offsets (stage buffer it & 1, or in place) and the tile's old rows
  // from ring slot `slot` in oldT; local to the CTA
  const bf16* w = nullptr;           // the share
  const float* gf = nullptr;         // row r's speaker offsets at r * gld
  int gld = 0, goff = 0, slot = 0;   // (z_g's at goff after z_f's)
  auto prepare = [&](int l, int t, int it) {
    slot = offs[l] + (a.t0 + t) % dil[l];
    const bf16* oldp;                // the tile's old rows, [row][R]
    if constexpr (kStage) {
      cp_async_wait(l == 0 && L > 1);   // layer 1's copies may be pending
      __syncthreads();
      const unsigned char* p = stg + (size_t)(it & 1) * sl.total;
      w = reinterpret_cast<const bf16*>(p);
      gf = reinterpret_cast<const float*>(p + sl.g);
      gld = nz;
      goff = hc;
      oldp = reinterpret_cast<const bf16*>(p + sl.old);
    } else {
      w = a.pack + ((size_t)l * C + rank) * sh.blk;
      gf = gc ? a.g + ((size_t)l * B + b0) * 2 * R + lo : nullptr;
      gld = 2 * R;
      goff = R;
      oldp = a.rings_out + ((size_t)slot * B + b0) * R;
    }
    // the row layer l reads from step g - d (every CTA, all of it)
    for (int i = tid; i < BT * R; i += nt) {
      const int r = i / R, c = i % R;
      oldT[c * BT + r] = r < nrows ? bf2d_v(oldp[r * R + c]) : 0.0;
    }
    __syncthreads();
  };

  for (int t = 0; t < a.num_steps; ++t) {
    const int g = a.t0 + t;          // global step: ring phase and RNG key

    // embed: f32 table rows, one add, one bf16 rounding (the whole row)
    for (int i = tid; i < BT * R; i += nt) {
      const int r = i / R, c = i % R;
      const float e = a.ecur[(size_t)tok[r] * R + c]
                    + a.eprev[(size_t)prev[r] * R + c];
      xT[c * BT + r] = bf16_round(e);      // exact in f64
    }
    for (int i = tid; i < BT * M; i += nt) {
      const int r = i / M, m = i % M;
      yT[m * BT + r] = r < nrows
          ? bf2d_v(a.y[((size_t)(b0 + r) * a.num_steps + t) * M + m])
          : 0.0;
    }
    for (int i = tid; i < BT * sc; i += nt) skipT[i] = 0.0f;

    for (int l = 0; l < L; ++l, ++it) {
      if (l == 0) prepare(0, t, it);   // later layers: during the exchange
      const int ring = slot;           // this layer's ring slot
      const Job zc{w, xT, R, nz, nz}, zp{w + sh.wp, oldT, R, nz, nz};
      const Job zv{w + sh.vc, yT, M, nz, M ? nz : 0};
      const bf16* ws = w + sh.ws;      // [hc][S]
      const bf16* wr = w + sh.wr;      // [hc][R]
      const float* bias = reinterpret_cast<const float*>(w + sh.bias);
      const float *bf = bias, *bg = bias + hc, *br = bias + 2 * hc,
                  *bs = bias + 2 * hc + R;

      // z: x @ W_cur, old @ W_prev and y_t @ V_cond of this CTA's channels
      if constexpr (kZ)
        dot_units<BT, kStage>(zc, zp, M ? zv : none, seg_z, part, tid, nt);
      __syncthreads();
      // the gate: this CTA's slice of h, which stays here
      for (int i = tid; i < hc * BT; i += nt) {
        const int j = i / BT, r = i % BT;
        float zf = (__double2float_rn(unit_sum<BT>(part, 0, nz, seg_z, j, r))
                    + __double2float_rn(unit_sum<BT>(part, nz * seg_z, nz,
                                                     seg_z, j, r)))
                   + bf[j];
        float zg = (__double2float_rn(unit_sum<BT>(part, 0, nz, seg_z,
                                                   hc + j, r))
                    + __double2float_rn(unit_sum<BT>(part, nz * seg_z, nz,
                                                     seg_z, hc + j, r)))
                   + bg[j];
        if (M) {               // the mel dot, exact over its segments
          zf += __double2float_rn(unit_sum<BT>(part, 2 * nz * seg_z, nz,
                                               seg_z, j, r));
          zg += __double2float_rn(unit_sum<BT>(part, 2 * nz * seg_z, nz,
                                               seg_z, hc + j, r));
        }
        if (gc && r < nrows) {   // this row's speaker offsets
          zf += gf[r * gld + j];
          zg += gf[r * gld + goff + j];
        }
        hT[i] = bf16_round(tanhf(zf) * sigmoidf(zg));
      }
      __syncthreads();

      // skip and residual over this CTA's h slice (K = hc): exact partial
      // sums of every column, each sent where it is reduced: a skip
      // column's to the CTA that owns it, a residual column's to every CTA
      // (all-reduce) or to the one that owns it (scatter)
      const int buf = kScatter ? 0 : it & 1;
      const uint32_t mb = mbar + 8 * buf;
      // a thread sums one column; a message carries it for one row (two
      // columns a message was slower), or for two rows
      for (int o = tid; o < S + R; o += nt) {
        const bool skip = o < S;
        const int col = skip ? o : o - S;
        double p[BT];
        if constexpr (!kSkipRes) {
#pragma unroll
          for (int r = 0; r < BT; ++r) p[r] = 0.0;
        } else if constexpr (kStage) {
          dot_staged<BT>(skip ? ws : wr, 0, hc, skip ? S : R, col, hT, p);
        } else {
          dot_part<BT>(skip ? ws : wr, 0, hc, skip ? S : R, col, hT, p);
        }
        // skip: to the CTA that owns the column; residual: to every CTA,
        // or (scatter) to the one that owns it
        const int q0 = skip ? col / sc : kScatter ? col / hc : 0;
        const int q1 = skip || kScatter ? q0 + 1 : C;
        const uint32_t dst = smem_addr(
            skip ? spart + (((size_t)buf * C + rank) * sc + col - q0 * sc)
                               * BT
            : kScatter ? rpart + ((size_t)rank * hc + col - q0 * hc) * BT
                       : rpart + (((size_t)buf * C + rank) * R + col) * BT);
        for (int q = q0; kExchange && q < q1; ++q) {
          const uint32_t rd = map_rank(dst, q), rm = map_rank(mb, q);
          if constexpr (BT == 1) {
            st_async(rd, p[0], rm);
          } else {
#pragma unroll
            for (int r = 0; r < BT; r += 2)
              st_async2(rd + 8 * r, p[r], p[r + 1], rm);
          }
        }
      }
      if (l + 1 < L) prepare(l + 1, t, it + 1);   // while the sums travel
      if constexpr (kExchange)
        mbar_wait(mb, kScatter ? it & 1 : (it >> 1) & 1);
      __syncthreads();                // every thread is past the wait
      if (kExchange && tid == 0)
        mbar_expect(mb, xbytes);      // the buffer's next layer

      // reduce: every residual column (x everywhere) or, with the scatter,
      // this CTA's; this CTA's skip columns; this layer's input x slice
      // into the ring first
      if constexpr (kScatter) {
        for (int i = tid; i < hc * BT; i += nt) {
          const int c = lo + i / BT, r = i % BT;
          double s4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
          for (int q = 0; q < C; ++q)
            s4[q & 3] += rpart[(size_t)q * hc * BT + i];
          const float p =
              __double2float_rn((s4[0] + s4[1]) + (s4[2] + s4[3]));
          double* x = xT + (size_t)c * BT + r;
          if (r < nrows)
            a.rings_out[((size_t)ring * B + b0 + r) * R + c] =
                __float2bfloat16_rn((float)*x);
          *x = bf16_round(((float)*x + p) + br[c]);
        }
      } else {
        const double* rp = rpart + (size_t)buf * C * R * BT;
        for (int i = tid; i < R * BT; i += nt) {
          const int c = i / BT, r = i % BT;
          double s4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
          for (int q = 0; q < C; ++q)
            s4[q & 3] += rp[(size_t)q * R * BT + i];
          const float p =
              __double2float_rn((s4[0] + s4[1]) + (s4[2] + s4[3]));
          if (c >= lo && c < lo + hc && r < nrows)
            a.rings_out[((size_t)ring * B + b0 + r) * R + c] =
                __float2bfloat16_rn((float)xT[i]);
          xT[i] = bf16_round(((float)xT[i] + p) + br[c]);
        }
      }
      const double* sp = spart + (size_t)buf * C * sc * BT;
      for (int i = tid; i < sc * BT; i += nt) {
        double s4[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll 4
        for (int q = 0; q < C; ++q)
          s4[q & 3] += sp[(size_t)q * sc * BT + i];
        const float p = __double2float_rn((s4[0] + s4[1]) + (s4[2] + s4[3]));
        skipT[i] = (skipT[i] + p) + bs[i / BT];
      }
      __syncthreads();
      if constexpr (kScatter && kExchange) {
        // this CTA's slice of the next x to every other CTA (which also
        // says that this CTA is done with the layer's partials)
        for (int u = tid; u < (C - 1) * hc; u += nt) {
          const int q = u / hc + (u / hc >= rank), j = u % hc;
          const double* v = xT + (lo + j) * BT;
          const uint32_t rd = map_rank(smem_addr(v), q);
          const uint32_t rm = map_rank(mbar + 8, q);
          if constexpr (BT == 1) {
            st_async(rd, v[0], rm);
          } else {
#pragma unroll
            for (int r = 0; r < BT; r += 2)
              st_async2(rd + 8 * r, v[r], v[r + 1], rm);
          }
        }
      }
      if (kStage && kCopies && l + 2 < L)   // this layer's buffer is free
        stage_layer(l + 2, offs[l + 2] + g % dil[l + 2], it & 1);
      if constexpr (kScatter) {
        // the next x, whole (before the next layer, or the head's writes
        // into the layer arrays of other CTAs)
        if constexpr (kExchange) mbar_wait(mbar + 8, it & 1);
        __syncthreads();
        if (kExchange && tid == 0) mbar_expect(mbar + 8, sbytes);
      }
    }

    // head: relu(skip) slices to every CTA, then s1, then the logits
    for (int i = tid; i < sc * BT; i += nt) {
      const int j = i / BT, r = i % BT;
      const double v = bf16_round(fmaxf(skipT[i], 0.0f));
      for (int q = 0; q < C; ++q)
        cluster.map_shared_rank(sT, q)[(slo + j) * BT + r] = v;
    }
    cluster.sync();          // also orders this step's ring writes before
    if (kStage && t + 1 < a.num_steps)      // the next step's copies
      for (int l = 0; l < 2 && l < L; ++l)
        stage_layer(l, offs[l] + (g + 1) % dil[l], (it + l) & 1);
    dot_units<BT, false>(Job{a.hw1 + slo, sT, S, S, sc}, none, none, seg_h1,
                         part, tid, nt);
    __syncthreads();
    for (int i = tid; i < sc * BT; i += nt) {
      const int j = i / BT, r = i % BT;
      const float p = __double2float_rn(unit_sum<BT>(part, 0, sc, seg_h1, j,
                                                     r));
      const double v = bf16_round(fmaxf(p + a.hb1[slo + j], 0.0f));
      for (int q = 0; q < C; ++q)
        cluster.map_shared_rank(s1T, q)[(slo + j) * BT + r] = v;
    }
    cluster.sync();
    dot_units<BT, false>(Job{a.hw2 + qlo, s1T, S, Q, qc}, none, none, seg_h2,
                         part, tid, nt);
    __syncthreads();
    for (int i = tid; i < qc * BT; i += nt) {
      const int j = i / BT, r = i % BT;
      float s = __double2float_rn(unit_sum<BT>(part, 0, qc, seg_h2, j, r))
                + a.hb2[qlo + j];
      if (!a.greedy && r < nrows)
        s = __fadd_rn(__fmul_rn(s, a.inv_temp),
                      wn_counter_gumbel(seed[r], g, qlo + j));
      scoreT[j * BT + r] = s;
    }
    __syncthreads();

    // first-index argmax of this CTA's share, one warp per row, to every
    // CTA; then every CTA merges the candidates in rank order
    const int warp = tid >> 5, lane = tid & 31;
    if (warp < nrows) {
      const int r = warp;
      const int bi = warp_argmax<BT>(scoreT, qc, r, lane);
      if (lane == 0) {
        const float v = bi < qc ? scoreT[bi * BT + r] : -INFINITY;
        const int idx = bi < qc ? qlo + bi : -1;
        for (int q = 0; q < C; ++q) {
          cluster.map_shared_rank(cand_s, q)[rank * BT + r] = v;
          cluster.map_shared_rank(cand_i, q)[rank * BT + r] = idx;
        }
      }
    }
    cluster.sync();
    if (tid < nrows) {
      const int r = tid;
      float best = -INFINITY;
      int bi = -1;
      for (int q = 0; q < C; ++q) {    // ascending ranks hold ascending q
        const int i = cand_i[q * BT + r];
        const float v = cand_s[q * BT + r];
        if (i >= 0 && (bi < 0 || v > best)) {
          best = v;
          bi = i;
        }
      }
      int nxt = bi;
      if (rank == 0) a.tokens_out[(size_t)(b0 + r) * a.num_steps + t] = nxt;
      if (g + 1 < a.num_forced)
        nxt = a.forced[(size_t)(b0 + r) * a.num_forced + g + 1];
      prev[r] = tok[r];
      tok[r] = nxt;
    }
    __syncthreads();
  }

  if (rank == 0 && tid < nrows) {
    a.carry_out[(b0 + tid) * 2] = tok[tid];
    a.carry_out[(b0 + tid) * 2 + 1] = prev[tid];
  }
  cluster.sync();          // no CTA leaves while another may still store
}

typedef void (*KernelFn)(const DecodeArgs);

template <bool kScatter>
KernelFn kernel_for(int bt, int stage) {
  switch (2 * bt + (stage != 0)) {
    case 2: return decode_wide_kernel<1, false, kScatter>;
    case 3: return decode_wide_kernel<1, true, kScatter>;
    case 4: return decode_wide_kernel<2, false, kScatter>;
    case 5: return decode_wide_kernel<2, true, kScatter>;
    case 8: return decode_wide_kernel<4, false, kScatter>;
    case 9: return decode_wide_kernel<4, true, kScatter>;
    case 16: return decode_wide_kernel<8, false, kScatter>;
    case 17: return decode_wide_kernel<8, true, kScatter>;
    default: return nullptr;
  }
}

KernelFn kernel_for(int bt, int stage, int scatter) {
  return scatter ? kernel_for<true>(bt, stage) : kernel_for<false>(bt, stage);
}

cudaError_t configure(KernelFn kern, const DecodeArgs& a, int bt,
                      int threads, cudaStream_t stream,
                      cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  const size_t smem = layout(bt, a.C, threads, a.stage, a.scatter,
                             a.g != nullptr, a.L, a.R, a.S, a.Q, a.M).total;
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  const void* f = reinterpret_cast<const void*>(kern);
  cudaError_t e = cudaFuncSetAttribute(
      f, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return e;
  if (a.C > 8) {
    e = cudaFuncSetAttribute(
        f, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
  }
  const int clusters = (a.B + bt - 1) / bt;
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(clusters * a.C, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = a.C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// Clusters of this shape the card holds at once in *n (0: it cannot run).
cudaError_t max_clusters(KernelFn kern, const DecodeArgs& a, int bt,
                         int threads, cudaStream_t stream, int* n,
                         cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr) {
  cudaError_t e = configure(kern, a, bt, threads, stream, cfg, attr);
  if (e != cudaSuccess) return e;
  return cudaOccupancyMaxActiveClusters(
      n, reinterpret_cast<const void*>(kern), cfg);
}

// The plan's shape is one the kernel takes: C divides R and S into shares
// of whole 16-byte copies (R / C a multiple of 8, S / C even), a warp per
// row.
bool valid(const DecodeArgs& a, int bt, int threads) {
  return threads >= 32 * bt && threads <= kMaxThreads && threads % 32 == 0 &&
         a.C >= 2 && a.C <= kMaxCluster && a.R % a.C == 0 &&
         a.S % a.C == 0 && a.Q >= a.C && (a.R / a.C) % 8 == 0 &&
         (a.S / a.C) % 2 == 0 && a.R % (2 * kHalf) == 0 && a.M >= 0 &&
         (a.M > 0) == (a.y != nullptr);
}

__global__ void counter_bits_kernel(const int32_t* seeds, int B, int t, int Q,
                                    int32_t* out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i < B * Q) out[i] = (int32_t)wn_counter_bits(seeds[i / Q], t, i % Q);
}

DecodeArgs shape_args(int L, int R, int S, int Q, int M, int gc,
                      int cluster, int stage, int scatter) {
  // a launch's shape without its tensors: valid() and the layout read only
  // whether the mel and speaker operands are present
  static const __nv_bfloat16 mark[1] = {};
  DecodeArgs a{};
  a.L = L; a.R = R; a.S = S; a.Q = Q; a.M = M; a.C = cluster; a.stage = stage;
  a.scatter = scatter;
  a.B = 1;
  if (M > 0) a.y = mark;
  if (gc) a.g = reinterpret_cast<const float*>(mark);
  return a;
}

}  // namespace

extern "C" {

// Launch the whole-loop decode on `stream`; returns a cudaError_t code
// (0 on success).  pack [L, cluster, blk] bf16: each CTA's layer shares
// (ops/cuda/decode_wide.py pack_shares, `Share` above).  bt in {1, 2, 4,
// 8} rows per cluster; cluster CTAs per cluster (2-16; above 8 a
// non-portable size); threads per CTA <= 512; stage 1 stages each layer's
// share in shared memory; scatter 1 takes the scatter exchange, 0 the
// all-reduce.  y [B, num_steps, M] (bf16) with M > 0 for a
// mel-conditioned model (V_cond is in the pack); null and M = 0 otherwise.
// g [L, B, 2R] (f32) for a speaker-conditioned model, null otherwise.  A
// shape the card cannot hold (shared memory, cluster size) returns an
// error: nothing retries.
int wn_decode_wide(const int32_t* seeds, const int32_t* tokens_init,
                   const int32_t* forced, const float* ecur,
                   const float* eprev, const void* pack, const void* hw1,
                   const float* hb1, const void* hw2, const float* hb2,
                   const int32_t* dils, const void* y, const float* g,
                   const void* rings_in, void* rings_out,
                   int32_t* tokens_out, int32_t* carry_out, int L, int R,
                   int S, int Q, int M, int sum_d, int B, int num_steps,
                   int t0, int num_forced, int greedy, float inv_temp, int bt,
                   int cluster, int threads, int stage, int scatter,
                   void* stream) {
  typedef const __nv_bfloat16* W;
  DecodeArgs a{seeds, tokens_init, forced, ecur, eprev, (W)pack,
               (W)hw1, hb1, (W)hw2, hb2, dils, (W)y, g,
               (W)rings_in, (__nv_bfloat16*)rings_out, tokens_out, carry_out,
               L, R, S, Q, M, sum_d, B, num_steps, t0, num_forced, greedy,
               inv_temp, cluster, stage, scatter};
  const KernelFn kern = kernel_for(bt, stage, scatter);
  if (!valid(a, bt, threads) || kern == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  int n = 0;
  cudaError_t e = max_clusters(kern, a, bt, threads, (cudaStream_t)stream,
                               &n, &cfg, attr);
  if (e != cudaSuccess) return (int)e;
  if (n < 1) return (int)cudaErrorInvalidConfiguration;  // does not fit
  e = cudaLaunchKernelEx(&cfg, kern, a);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Shared memory bytes one CTA of wn_decode_wide needs (gc: a speaker
// model's launch), and the bf16 elements of one share in the pack.
size_t wn_decode_wide_smem(int bt, int cluster, int threads, int stage,
                           int scatter, int gc, int L, int R, int S, int Q,
                           int M) {
  return layout(bt, cluster, threads, stage, scatter, gc, L, R, S, Q, M)
      .total;
}

int wn_decode_wide_share(int cluster, int R, int S, int M) {
  return share_layout(cluster, R, S, M).blk;
}

// Clusters of the plan's shape that the card holds at once in *n; returns
// a cudaError_t code (an invalid shape included).
int wn_decode_wide_max_clusters(int bt, int cluster, int threads, int stage,
                                int scatter, int gc, int L, int R, int S,
                                int Q, int M, int* n) {
  const DecodeArgs a = shape_args(L, R, S, Q, M, gc, cluster, stage, scatter);
  const KernelFn kern = kernel_for(bt, stage, scatter);
  if (!valid(a, bt, threads) || kern == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[1];
  return (int)max_clusters(kern, a, bt, threads, nullptr, n, &cfg, attr);
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
