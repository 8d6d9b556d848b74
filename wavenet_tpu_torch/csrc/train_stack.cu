// Fused training stack of WaveNet on Hopper (sm_90a): one layer group's
// forward and backward.
//
// Replaces wavenet_tpu/ops/pallas/train_stack.py::_fwd_kernel and
// ::_bwd_kernel, unconditional, mel-conditioned (their has_cond form) and
// speaker-conditioned (has_gc), alone or together: the same per-group
// contract and numerics, a different schedule.
//
//   forward  (x_in, skip_in[, y][, g]) -> (skip_out, x_out), per layer l:
//     xcat = [bf16(x) | bf16(x)[t - d]]                (zero for t < d)
//     z    = xcat @ Wz + b                              (f32 accumulate)
//     z    = z + y @ V_cond[l]                          (with mel; y bf16)
//     z    = z + g[b, l]                                (with a speaker, f32)
//     h    = bf16(tanh(z_f) * sigmoid(z_g))
//     o    = h @ [W_res | W_skip]
//     x    = (x + o_res) + b_res                        (f32 carry)
//     skip = (skip + o_skip) + b_skip
//   x_out = bf16(x) once, at the end of the group (held in f32).
//   backward (dskip, dx_out) -> (dx_in, dWz, db, dWrs, db_res[, dV_cond,
//   dy][, dg]), layers in reverse, every cotangent in f32:
//     dcat = [dx | dskip]; dh = dcat @ Wrs^T; dz = [dh*sg*(1-tf^2) | dh*tf*sg*(1-sg)]
//     dboth = dz @ Wz^T; dx = (dx + dboth_cur) + dboth_prev[t + d]
//     dWz += xcat^T dz; db += sum dz; dWrs += h^T dcat; db_res += sum dx
//     with mel: dV_cond[l] = y^T dz; dy += dz @ V_cond[l]^T
//     with a speaker: dg[b, l] = sum over the row b's T steps of dz
//
// What bounds it on this card: arithmetic.  At `full` (L = 40, R = 128,
// S = 256, B = 8, T = 8192) the forward is ~0.6 TFLOP and the backward
// ~1.5 TFLOP of dense products over B*T = 65,536 rows, against ~0.8 GB of
// activations per direction; that is far above the H100's balance point.
// Summed exactly (below), the forward's products take ~9 ms at the f64
// tensor cores' peak (67 TFLOP/s).
//
// What the design does about it, and what it leaves for later:
//   * The TPU walks time tiles of one batch row in sequence on one core and
//     carries each layer's causal context in rings.  Here every row tile
//     is its own block (B*T / TM blocks per layer launch, all SMs busy),
//     and the causal operand x[t - d] is read straight from the layer's
//     input in device memory, so there are no rings and no snapshots.  The
//     price is one launch per layer and the layer inputs kept in device
//     memory: the forward stores each layer's bf16 input, [Lg + 1, B, T, R]
//     per group (the TPU's `xs` stash; ~0.75 GB at `full`), which the
//     backward reads instead of recomputing the group.
//   * The transposed causal shift (dx[t] += dprev[t + d]) reads rows that
//     another block writes, so it is its own elementwise pass.
//   * The mel term is one more block product in each layer kernel, summed
//     in its own accumulator and added after the bias; the tile's y rows
//     are staged beside xcat.  dy is summed over the
//     group's layers in reverse order by a read-modify-write in the layer
//     kernel's epilogue: one block owns a row per launch, so there are no
//     atomics and the order is fixed.
//   * The speaker term g [B, Lg, 2R] is time-constant: each tile row m adds
//     the offset of its own batch row m / T (a tile spans two batch rows
//     whenever T is not a multiple of its rows).  dg is a column sum of dz segmented by
//     batch row: partial sums over splits that never straddle two rows,
//     then each row's splits added in order.
//   * Weight gradients are reductions over all B*T rows.  They run as
//     fixed-order split-K: each block sums its share of rows into a private
//     partial, and a second pass adds the partials in split order.  No
//     float atomics, so two runs give the same bits (exact resume).
//   * The bias gradients (db, db_res, db_skip, dg) are column sums of f32
//     tensors already in device memory, in the same fixed order: each
//     split of rows_per_split rows summed row by row, then the splits in
//     order.  Nothing but bytes bounds them (~4.4 GB a `full` step, 1.3 ms
//     at 3.35 TB/s), and a split's column is one serial chain, so the
//     parallelism is fixed at splits x columns: 8,192 chains for db_res
//     at `full`, too few to keep HBM busy with one load a thread in
//     flight.  colsum_kernel decouples the loads from the chains: one warp
//     a (split, 32-column strip) streams the split through an 8-stage ring
//     of 16-byte cp.async copies in shared memory (28 KiB in flight a
//     warp) while each lane adds its column from the ring in row order;
//     the strip's last block to finish (an integer arrival count, reset by
//     that block) adds the strip's partials in split order through the
//     same ring.  One launch sums a layer's db and db_res (dz's strips,
//     then dx's: 768 warps at `full`, where db_res alone would leave SMs
//     idle), one more dg, and one a group db_skip.
//   * Every product runs on the tensor cores, warp-level mma.sync.
//   * Products of two bf16 operands (mma_pass: the forward's z = xcat @ Wz,
//     y @ V_cond and h @ [W_res | W_skip], and the backward's recompute of z)
//     are summed exactly: m16n8k4 MMAs on the f64 tensor cores, where every
//     bf16 product is exact and so is their sum (mma_pass), rounded to f32
//     once.  The plain version sums the same products in float64, so the two
//     give the same bits.  An f32 sum in any other order than the plain
//     version's would not, and the stack's bf16 roundings of h and of each
//     layer's input carry such last-bit differences through 40 layers into a
//     skip sum ~2% apart (utils/stack_drift.py): the reference suite's bands
//     hold only for equal forwards.  The A operand is a bf16 tile staged by
//     cp.async straight from device memory (xcat, y) or written from
//     registers (h), widened to f64 as its fragments are read; W stays in its
//     stored k-major layout, loaded a stage ahead into registers and widened
//     once into two f64 stages of 16 rows; both in layouts whose fragment
//     reads hit distinct banks.  z and the gate are one device function
//     (z_gate) for both layer kernels: each warp holds z_f and z_g of the
//     same 32 gate columns, applies the gate in registers and hands tanh and
//     sigmoid to its kernel's epilogue (the forward keeps h for its output
//     product, the backward stores them for dz), so z never goes through
//     shared memory and the recomputed h equals the forward's bit for bit.  A
//     forward block needs 82 KiB of shared memory at `full` (93 KiB with
//     mel): two blocks per SM.
//   * A layer block's row tile is a template parameter (Warps<TM>): 64
//     rows at every preset, 32 or 16 where the widths make a block of 64
//     rows larger than an SM's 227 KiB (every shared-memory term but the
//     W stages is TM x a row's width: at R = S = 256 the backward's 64-row
//     block needs 272 KiB, its 32-row one 144 KiB).  The 8 warps keep
//     their 16-row slabs and split a pass's 128 columns among more column
//     groups, so each warp holds TM / 8 n8 tiles; each output element's
//     sum, and so every result, is the same at every tile.  Widths that
//     are not multiples of 4 are zero-padded by the wrapper
//     (ops/cuda/train_stack.py: pad_ops), which changes no bit of the
//     forward's real channels.
//   * The backward's products that carry an f32 cotangent (mma_pass_t:
//     dh = dcat @ Wrs^T, dboth = dz @ Wz^T, with mel dy = dz @ V_cond^T,
//     and the weight gradients dWz = xcat^T dz, dWrs = h^T dcat, dV_cond
//     = y^T dz) run as m16n8k16 MMAs with bf16 operands and f32 sums.
//     The reference keeps those cotangents f32
//     (rounding them to bf16 hurt convergence), so each f32 operand is
//     split in registers, as its fragment is loaded, into three bf16
//     terms, hi = bf16(a), mid = bf16(a - hi), lo = bf16(a - hi - mid),
//     and each tile takes three MMAs in a fixed order (lo, mid, hi).  The
//     other operand is bf16-exact, so every partial product is exact and
//     the sum carries the cotangent's 24 bits.  The tensor cores' own
//     f32 accumulation is not round-to-nearest, so each pass sums one
//     staged slice of the contraction at a time in a fresh accumulator
//     and adds it to an f32 total in registers.  The bf16 operand is
//     staged by cp.async in two stages; the f32 one stays where the
//     kernel holds it (the layer kernel's tiles) or is staged as f32 (the
//     weight gradients').  Three bf16 passes per product put the
//     backward's bound at ~4.0 ms at `full`, B = 8, T = 8192 (operations
//     at the bf16 peak).
//   * What is left: one launch per layer moves the layer's activations
//     through device memory, ~235 MB per layer of the forward at `full`,
//     B = 8, T = 8192 (x in, the f32 carry and skip in and out, the stash
//     out), ~2.8 ms of the stack at 3.35 TB/s, in each block's epilogue,
//     which overlaps the MMAs of the other block on its SM only.
//
// The plain PyTorch versions (ops/cuda/train_stack.py:
// group_fwd_reference, group_bwd_reference) follow the same recipe.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "bf16_exact.cuh"
#include "gate.cuh"
#include "mma_async.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // 8 warps
constexpr int kKC = 32;         // contraction rows of W staged at a time
constexpr int kNP = 128;        // output columns per pass
constexpr int kStage = kKC * kNP;   // bf16 elements of one W stage
constexpr int kWM = 32;         // rows staged at a time in the weight grads

// ---------------------------------------------------------------------------
// tensor-core building blocks
// ---------------------------------------------------------------------------

constexpr int kPL = 72;    // wgrad P_s row stride (bf16): ldmatrix rows on
                           // distinct banks
constexpr int kQL = 132;   // wgrad Q_s row stride (f32): B-fragment reads
                           // on distinct banks

// d += a . b, one m16n8k16 tile: a row-major bf16 [16][16] (4 regs), b
// column-major bf16 [16][8] (2 regs), c and d f32 [16][8] (4 regs).
__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4],
                                         const uint32_t b[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t bf16x2_bits(__nv_bfloat162 v) {
  return *reinterpret_cast<uint32_t*>(&v);
}

// Split the f32 pair (x0, x1) into three bf16 pairs, hi + mid + lo: each
// term is the rounding of what the terms before it left, so the three
// carry the pair's 24 significand bits (x0 in the low halves).
__device__ __forceinline__ void split3(float x0, float x1, uint32_t& hi,
                                       uint32_t& mid, uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(h);
  x1 -= __high2float(h);
  const __nv_bfloat162 m = __floats2bfloat162_rn(x0, x1);
  x0 -= __low2float(m);
  x1 -= __high2float(m);
  hi = bf16x2_bits(h);
  mid = bf16x2_bits(m);
  lo = bf16x2_bits(__floats2bfloat162_rn(x0, x1));
}

// ---------------------------------------------------------------------------
// products of two bf16 operands, summed exactly: the forward and the
// recompute of z
// ---------------------------------------------------------------------------

// Row stride (elements) of a bf16 A tile with K contraction columns: K
// plus 8, so that the eight rows a fragment load reads start on distinct
// banks.
__host__ __device__ __forceinline__ int tile_ld(int K) { return K + 8; }

// Contraction rows of W per f64 stage (two stages of [kKD][128] f64): 16
// in the forward (32 KiB) and where the backward's f32 tiles leave room,
// else 8 (16 KiB, the space mma_pass_t's two bf16 stages take).
constexpr int kKD = 16, kKDs = 8;
constexpr size_t kWD = 2 * kKD * kNP * sizeof(double);
static_assert(kKDs * sizeof(double) == kKC * sizeof(bf16), "W stage sizes");

// Where element (k, c) of a staged [kKD][128] f64 slice of W (k-major, as
// stored) lies: column c XOR 4 (k mod 4), so the four rows of a B-fragment
// load hit distinct banks and four neighbouring columns stay together.
__device__ __forceinline__ int wsd(int k, int c) {
  return k * kNP + (c ^ ((k & 3) << 2));
}

// The warps of a layer block over its row tile of TM rows (64, 32 or 16)
// and a pass's 128 columns: TM / 16 slabs of 16 rows by 128 TM / 16
// columns, warp w owning rows 16 (w % (TM / 16)) + [0, 16) and the
// columns of its column group w / (TM / 16), TM / 8 n8 tiles.  At 64 rows
// that is 4 x 2 warps of eight tiles; at 32, 2 x 4 of four; at 16, 1 x 8
// of two.  Each output element's sum is the same at every TM.
template <int TM>
struct Warps {
  static_assert(TM == 64 || TM == 32 || TM == 16, "row tile");
  static constexpr int kSlabs = TM / 16;
  static constexpr int kNT = TM / 8;       // n8 tiles a warp
  __device__ static int slab() { return (threadIdx.x >> 5) % kSlabs; }
  __device__ static int group() { return (threadIdx.x >> 5) / kSlabs; }
};

// The stage column of n8 tile j of this thread's warp in mma_pass: warp w
// owns columns 8 kNT group(w) + [0, 8 kNT); with kGate, tiles
// [0, kNT / 2) are columns 4 kNT group(w) + [0, 4 kNT) of the pass's
// first half (z_f) and the other tiles the same columns of its second
// half (z_g).
template <bool kGate, int TM>
__device__ __forceinline__ int pass_col(int j) {
  constexpr int kNT = Warps<TM>::kNT, kH = kNT / 2;
  const int wc = Warps<TM>::group();
  return kGate ? (j / kH) * 64 + wc * (kH * 8) + (j % kH) * 8
               : wc * (kNT * 8) + j * 8;
}

// One pass of out = A . W over a TM-row by 128-column output tile on the
// f64 tensor cores, both operands bf16: every product is exact in f64, and
// so is their sum while the terms lie within ~2^37 of each other (a bf16
// product carries 16 significand bits; beyond that f64 rounds 29 bits
// below f32's last), rounded to f32 once.  Any such summation gives the
// same f32, whatever its order, so the plain version (a float64 product
// rounded to float32) gives the same bits; an f32 sum in another order
// than the plain version's would not, and a 40-layer stack carries such
// last-bit differences into its bf16 roundings (utils/stack_drift.py).
// A: [TM][tile_ld(K)] bf16 in shared memory (stage_rows), widened to f64
// as its fragments are read.  W(k, n) = w[k * ldw + n]: stage column c is
// W's column n0 + c, or with kGate n0 + c for c < 64 and n1 + c - 64
// above; it reads as zero where n0 + c (kGate: n0 + c % 64) reaches lim.
// K is a multiple of 4.  Warp w owns rows 16 slab(w) + [0, 16) and kNT
// n8 tiles at stage columns pass_col(j), out[j] the C fragment of tile j
// (Warps<TM>).
// W is widened to f64 once, as it is staged: each thread loads its share
// of the next stage into registers while the warps multiply the current
// one, then stores it widened into the other of two stages of [kD][128]
// f64 (W_s, laid out by wsd), one barrier a stage.
// Waits for the caller's committed copies and starts with a barrier, so
// the caller's writes to A_s are seen; the caller may write A_s or W_s
// again only after another barrier.
template <bool kGate, int kD, int TM>
__device__ __forceinline__ void mma_pass(const bf16* A_s, int K,
                                         const bf16* __restrict__ w, int ldw,
                                         int n0, int n1, int lim, double* W_s,
                                         float out[][4]) {
  constexpr int kNT = Warps<TM>::kNT;
  const int tid = threadIdx.x, lane = tid & 31, g = lane >> 2, t = lane & 3;
  double acc[kNT][4];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.0;
  // this thread's share of a stage: rows sk + 8 i, columns sc + [0, 4)
  constexpr int kN = kD / 8;
  const int sk = tid >> 5, sc = (tid & 31) * 4, scc = kGate ? sc & 63 : sc;
  const bool col_ok = n0 + scc < lim;
  const bf16* const src = w + (kGate && sc >= 64 ? n1 : n0) + scc;
  double* const dst = W_s + wsd(sk, sc);     // wsd(sk + 8 i, sc) - 8 i kNP
  uint2 pre[kN];
  auto fetch = [&](int k0) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      const int k = k0 + sk + 8 * i;
      pre[i] = col_ok && k < K
                   ? *reinterpret_cast<const uint2*>(src + (size_t)k * ldw)
                   : make_uint2(0u, 0u);
    }
  };
  auto put = [&](int buf) {
#pragma unroll
    for (int i = 0; i < kN; ++i) {
      double* d = dst + (buf * kD + 8 * i) * kNP;
      *reinterpret_cast<double2*>(d) =
          make_double2(bf2d(pre[i].x & 0xffffu), bf2d(pre[i].x >> 16));
      *reinterpret_cast<double2*>(d + 2) =
          make_double2(bf2d(pre[i].y & 0xffffu), bf2d(pre[i].y >> 16));
    }
  };
  // this thread's A elements: rows g and g + 8 of the warp's slab at
  // column t of each k4 step; its B elements: row t of each k4 step at
  // column g of each n8 tile
  const int ld = tile_ld(K);
  const uint16_t* a_row = reinterpret_cast<const uint16_t*>(A_s) +
                          (Warps<TM>::slab() * 16 + g) * ld + t;
  int b_col[kNT];
#pragma unroll
  for (int j = 0; j < kNT; ++j)
    b_col[j] = (pass_col<kGate, TM>(j) + g) ^ (t << 2);
  const double* const b_row = W_s + t * kNP;
  const int ns = (K + kD - 1) / kD;
  cp_async_wait0();
  __syncthreads();
  fetch(0);
  put(0);
  for (int s = 0; s < ns; ++s) {
    __syncthreads();
    if (s + 1 < ns) fetch((s + 1) * kD);
    const double* Wb = b_row + (s & 1) * kD * kNP;
#pragma unroll
    for (int kk = 0; kk < kD; kk += 4) {
      const int k = s * kD + kk;
      if (k >= K) break;
      const double a0 = bf2d(a_row[k]), a1 = bf2d(a_row[8 * ld + k]);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
        mma_f64(acc[j], a0, a1, Wb[kk * kNP + b_col[j]]);
    }
    if (s + 1 < ns) put((s + 1) & 1);
  }
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) out[j][v] = (float)acc[j][v];
}

// Stage rows [m0, m0 + TM) of a bf16 operand with K columns (a multiple
// of kC) into dst [TM][tile_ld(K)] by cp.async, kC columns a copy (8: 16
// bytes, where every source chunk is 16-byte aligned; else 4): src(m, k)
// is the address of columns [k, k + kC) of row m, or null for zeros.
// Rows past M are zero.  Not committed.
template <int kC, int TM, class Src>
__device__ __forceinline__ void stage_rows(bf16* dst, int K, int m0, int M,
                                           const bf16* base, Src src) {
  const int ld = tile_ld(K), nc = K / kC;
  for (int e = threadIdx.x; e < TM * nc; e += kThreads) {
    const int r = e / nc, k = (e - r * nc) * kC, m = m0 + r;
    const bf16* p = m < M ? src(m, k) : nullptr;
    if (kC == 8)
      cp_async16(dst + r * ld + k, p ? p : base, p != nullptr);
    else
      cp_async8(dst + r * ld + k, p ? p : base, p != nullptr);
  }
}

// The tile's xcat = [x | x[t - d]] (zero for t % T < d) from the layer
// input xs [M][R] bf16.
template <int TM>
__device__ __forceinline__ void stage_xcat(bf16* dst,
                                           const bf16* __restrict__ xs,
                                           int m0, int M, int T, int R,
                                           int d) {
  auto src = [=](int m, int k) -> const bf16* {
    if (k < R) return xs + (size_t)m * R + k;
    return m % T < d ? nullptr : xs + (size_t)(m - d) * R + (k - R);
  };
  if (R % 8 == 0)
    stage_rows<8, TM>(dst, 2 * R, m0, M, xs, src);
  else
    stage_rows<4, TM>(dst, 2 * R, m0, M, xs, src);
}

// The tile's mel features y [M][nm] bf16.
template <int TM>
__device__ __forceinline__ void stage_y(bf16* dst, const bf16* __restrict__ y,
                                        int m0, int M, int nm) {
  auto src = [=](int m, int k) -> const bf16* {
    return y + (size_t)m * nm + k;
  };
  if (nm % 8 == 0)
    stage_rows<8, TM>(dst, nm, m0, M, y, src);
  else
    stage_rows<4, TM>(dst, nm, m0, M, y, src);
}

// z and the gate over the tile, one function for both layer kernels, so
// the backward's recomputed h equals the forward's bit for bit:
//   z  = (xcat @ Wz + b) [+ y @ V_cond] [+ g[m / T]]    (f32, this order)
//   epi(r, c, tanh(z_f), sigmoid(z_g)) at tile row r and gate columns
//   c, c + 1 (c < R; float2 pairs), each pair once.
// xc_s / y_s: the tile's xcat and (nm > 0) y, staged and committed.  A
// pass takes 64 gate columns [c0, c0 + 64): its two halves are their z_f
// and z_g columns (mma_pass<true>), so every thread holds both z of its
// gate columns and z stays in registers.  The mel term is summed in its
// own accumulator; gl: the layer's speaker offsets (row b at gl + b gs).
template <int kD, int TM, class Epi>
__device__ __forceinline__ void z_gate(const bf16* xc_s, const bf16* y_s,
                                       double* W_s,
                                       const bf16* __restrict__ wz,
                                       const float* __restrict__ b,
                                       const bf16* __restrict__ vc,
                                       const float* __restrict__ gl, int gs,
                                       int m0, int M, int T, int R, int nm,
                                       Epi epi) {
  constexpr int kNT = Warps<TM>::kNT, kH = kNT / 2;
  const int R2 = 2 * R, lane = threadIdx.x & 31;
  const int r0 = Warps<TM>::slab() * 16 + (lane >> 2);   // and r0 + 8
  const int cb = (lane & 3) * 2;
  for (int c0 = 0; c0 < R; c0 += kNP / 2) {
    float z[kNT][4];
    mma_pass<true, kD, TM>(xc_s, R2, wz, R2, c0, R + c0, R, W_s, z);
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int c = c0 + pass_col<true, TM>(j % kH) + cb;
      const int n = (j / kH) * R + c;
      if (c >= R) continue;
      const float2 bv = *reinterpret_cast<const float2*>(b + n);
      z[j][0] += bv.x;
      z[j][1] += bv.y;
      z[j][2] += bv.x;
      z[j][3] += bv.y;
    }
    if (nm) {
      float zy[kNT][4];
      mma_pass<true, kD, TM>(y_s, nm, vc, R2, c0, R + c0, R, W_s, zy);
#pragma unroll
      for (int j = 0; j < kNT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) z[j][v] += zy[j][v];
    }
    if (gl) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + 8 * h;
        if (m >= M) continue;
        const float* gr = gl + (size_t)(m / T) * gs;
#pragma unroll
        for (int j = 0; j < kNT; ++j) {
          const int c = c0 + pass_col<true, TM>(j % kH) + cb;
          if (c >= R) continue;
          const float2 gv =
              *reinterpret_cast<const float2*>(gr + (j / kH) * R + c);
          z[j][2 * h] += gv.x;
          z[j][2 * h + 1] += gv.y;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kH; ++j) {
      const int c = c0 + pass_col<true, TM>(j) + cb;
      if (c >= R) continue;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        epi(r0 + 8 * h, c,
            make_float2(tanhf(z[j][2 * h]), tanhf(z[j][2 * h + 1])),
            make_float2(sigmoidf(z[j + kH][2 * h]),
                        sigmoidf(z[j + kH][2 * h + 1])));
    }
  }
}

// ---------------------------------------------------------------------------
// forward: one layer over all B*T rows
// ---------------------------------------------------------------------------

// One block a tile of TM rows (Warps<TM>).
template <int TM>
__global__ void __launch_bounds__(kThreads, 2)
fwd_layer_kernel(const bf16* __restrict__ xs_in, float* __restrict__ carry,
                 bf16* __restrict__ xs_out, float* __restrict__ x_out,
                 const float* skip_in, float* skip_out,
                 const bf16* __restrict__ wz, const float* __restrict__ b,
                 const bf16* __restrict__ wrs, const float* __restrict__ bres,
                 const float* __restrict__ bskip, const bf16* __restrict__ y,
                 const bf16* __restrict__ vc, const float* __restrict__ gl,
                 int gs, int M, int T, int R, int S, int nm, int d) {
  extern __shared__ float smem[];
  const int NO = R + S, ldh = tile_ld(R);
  constexpr int kNT = Warps<TM>::kNT;
  bf16* xc_s = reinterpret_cast<bf16*>(smem);   // xcat [TM][tile_ld(2R)]
  bf16* h_s = xc_s + TM * tile_ld(2 * R);       // h [TM][tile_ld(R)]
  bf16* y_s = h_s + TM * ldh;                   // y [TM][tile_ld(nm)]
  double* W_s = reinterpret_cast<double*>(y_s + TM * (nm ? tile_ld(nm) : 0));
  const int m0 = blockIdx.x * TM;
  stage_xcat<TM>(xc_s, xs_in, m0, M, T, R, d);
  if (nm) stage_y<TM>(y_s, y, m0, M, nm);
  cp_async_commit();
  z_gate<kKD, TM>(xc_s, y_s, W_s, wz, b, vc, gl, gs, m0, M, T, R, nm,
         [&](int r, int c, float2 tf, float2 sg) {
           *reinterpret_cast<__nv_bfloat162*>(h_s + r * ldh + c) =
               __floats2bfloat162_rn(tf.x * sg.x, tf.y * sg.y);
         });
  // o = h @ [W_res | W_skip]; the C fragments' column pairs as float2.
  // Every carry and skip element is read before any is written: skip_out
  // may be skip_in, so a store would hold back the loads after it.
  const int lane = threadIdx.x & 31, cb = (lane & 3) * 2;
  const int r0 = Warps<TM>::slab() * 16 + (lane >> 2);
  float acc[kNT][4];
  for (int n0 = 0; n0 < NO; n0 += kNP) {
    mma_pass<false, kKD, TM>(h_s, R, wrs, NO, n0, 0, NO, W_s, acc);
    float2 in[kNT][2];   // the carry (n < R) or skip (n >= R) at each pair
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + pass_col<false, TM>(j) + cb;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + 8 * h;
        in[j][h] = m >= M || n >= NO ? make_float2(0.f, 0.f)
                   : n < R ? *reinterpret_cast<const float2*>(
                                 carry + (size_t)m * R + n)
                           : *reinterpret_cast<const float2*>(
                                 skip_in + (size_t)m * S + (n - R));
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j) {
      const int n = n0 + pass_col<false, TM>(j) + cb;
      if (n >= NO) continue;
      const float2 bv = *reinterpret_cast<const float2*>(
          n < R ? bres + n : bskip + (n - R));
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = m0 + r0 + 8 * h;
        if (m >= M) continue;
        const float2 v = make_float2((in[j][h].x + acc[j][2 * h]) + bv.x,
                                     (in[j][h].y + acc[j][2 * h + 1]) + bv.y);
        if (n < R) {
          const size_t o = (size_t)m * R + n;
          const __nv_bfloat162 xb = __floats2bfloat162_rn(v.x, v.y);
          *reinterpret_cast<float2*>(carry + o) = v;
          *reinterpret_cast<__nv_bfloat162*>(xs_out + o) = xb;
          if (x_out)
            *reinterpret_cast<float2*>(x_out + o) = __bfloat1622float2(xb);
        } else {
          *reinterpret_cast<float2*>(skip_out + (size_t)m * S + (n - R)) = v;
        }
      }
    }
  }
}

__global__ void init_carry_kernel(const float* __restrict__ x_in,
                                  float* __restrict__ carry,
                                  bf16* __restrict__ xs0, size_t n) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  carry[e] = x_in[e];
  xs0[e] = __float2bfloat16_rn(x_in[e]);
}


// ---------------------------------------------------------------------------
// products with an f32 cotangent: the backward
// ---------------------------------------------------------------------------

// Where column k of row r of an f32 tile with row stride K lies in shared
// memory: bits 2-4 of k XOR the row's low three bits inside the row's
// whole 32-column blocks (the tail stays in place), so the eight rows of
// an A fragment read distinct banks.
__device__ __forceinline__ int swz(int r, int k, int K) {
  return k < (K & ~31) ? k ^ ((r & 7) << 2) : k;
}

// Where column k of row n of a staged [128][32] bf16 slice of W lies: its
// 16-byte unit k / 8 XOR bits 1-2 of n, so B-fragment reads of eight rows
// hit distinct banks.
__device__ __forceinline__ int wsw(int n, int k) {
  return n * kKC + ((((k >> 3) ^ (n >> 1)) & 3) << 3) + (k & 7);
}

// One pass of acc = A . W^T over a TM-row by 128-column output tile on
// the tensor cores.  A: f32 [TM][K] in shared memory, laid out by swz;
// W(n, k) = w[n * ldw + k] bf16, columns n = n0 + c for c < 128, rows
// n >= N read as zero.  Warp w owns rows 16 slab(w) + [0, 16) and columns
// 8 kNT group(w) + [0, 8 kNT): kNT n8 tiles (Warps<TM>), acc[j] the C
// fragment of tile j (frag_row / frag_col).  The A fragment is split hi/mid/lo in registers
// (split3) and each tile takes three MMAs into a per-stage sum added to
// acc; W is staged as bf16 by cp.async in two stages of [128][32] (W_s:
// 16 KiB), one barrier a stage.
// K is a multiple of 4; a last slice past K's whole 32-column blocks is
// read unswizzled and masked (both operands zero past K).  Starts with a
// barrier, so the caller's writes to A_s are seen; the caller may write
// A_s or W_s again only after another barrier.
template <int TM>
__device__ __forceinline__ void mma_pass_t(const float* A_s, int K,
                                           const bf16* __restrict__ w,
                                           int ldw, int N, int n0, bf16* W_s,
                                           float acc[][4]) {
  constexpr int kNT = Warps<TM>::kNT;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int j = 0; j < kNT; ++j)
#pragma unroll
    for (int v = 0; v < 4; ++v) acc[j][v] = 0.f;
  // this thread's copies: slice rows cn + 32 i, columns ck + [0, 4)
  const int cn = tid >> 3, ck = (tid & 7) * 4;
  bf16* const cdst = W_s + wsw(cn, ck);   // wsw(cn + 32 i, ck) - 32 i kKC
  const bf16* const csrc = w + (size_t)(n0 + cn) * ldw + ck;
  auto stage = [&](int buf, int k0) {
    const bool kok = k0 + ck < K;
#pragma unroll
    for (int i = 0; i < kNP / 32; ++i) {
      const bool ok = kok && n0 + cn + 32 * i < N;
      cp_async8(cdst + buf * kStage + i * 32 * kKC,
                ok ? csrc + (size_t)32 * i * ldw + k0 : w, ok);
    }
  };
  // this thread's fragment reads: A rows r0 and r0 + 8 (both r = g mod 8)
  // at slice columns a_col[k16][h] = 16 k16 + 8 h + 2 t, swizzled; B row
  // c0 + 8 j of the slice at columns 8 u + 2 t: b_base + 8 j kKC + b_off[u]
  const int r0 = Warps<TM>::slab() * 16 + g;
  const float* const a_row = A_s + r0 * K;
  int a_col[2][2], b_off[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    a_col[u >> 1][u & 1] = (8 * u + 2 * t) ^ (g << 2);
    b_off[u] = (((u ^ (g >> 1)) & 3) << 3) + 2 * t;
  }
  const int b_base = (Warps<TM>::group() * kNT * 8 + g) * kKC;
  const int ns = (K + kKC - 1) / kKC, nsw = K / kKC;
  __syncthreads();
  stage(0, 0);
  cp_async_commit();
  for (int s = 0; s < ns; ++s) {
    cp_async_wait0();
    __syncthreads();
    if (s + 1 < ns) {
      stage((s + 1) & 1, (s + 1) * kKC);
      cp_async_commit();
    }
    const bf16* Wb = W_s + (s & 1) * kStage + b_base;
    float2 a[2][4];
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int roff = (q & 1) * 8 * K;
        if (s < nsw) {
          a[k16][q] = *reinterpret_cast<const float2*>(
              a_row + roff + s * kKC + a_col[k16][q >> 1]);
        } else {
          const int kc = s * kKC + 16 * k16 + 8 * (q >> 1) + 2 * t;
          a[k16][q] = kc < K ? *reinterpret_cast<const float2*>(
                                   a_row + roff + kc)
                             : make_float2(0.f, 0.f);
        }
      }
    float sacc[kNT][4] = {};   // this stage's sum
#pragma unroll
    for (int k16 = 0; k16 < 2; ++k16) {
      if (s * kKC + 16 * k16 >= K) break;
      uint32_t hi[4], mid[4], lo[4];
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split3(a[k16][q].x, a[k16][q].y, hi[q], mid[q], lo[q]);
#pragma unroll
      for (int j = 0; j < kNT; ++j) {
        const uint32_t b[2] = {
            *reinterpret_cast<const uint32_t*>(Wb + j * 8 * kKC +
                                               b_off[2 * k16]),
            *reinterpret_cast<const uint32_t*>(Wb + j * 8 * kKC +
                                               b_off[2 * k16 + 1])};
        mma_bf16(sacc[j], lo, b);       // fixed order: lo, mid, hi
        mma_bf16(sacc[j], mid, b);
        mma_bf16(sacc[j], hi, b);
      }
    }
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[j][v] += sacc[j][v];
  }
}

// The tile row and column (within the TM x 128 pass) of element v of the
// C fragment of n8 tile j in mma_pass_t.
template <int TM>
__device__ __forceinline__ int frag_row(int v) {
  return Warps<TM>::slab() * 16 + ((threadIdx.x & 31) >> 2) + (v >> 1) * 8;
}

template <int TM>
__device__ __forceinline__ int frag_col(int j, int v) {
  return Warps<TM>::group() * Warps<TM>::kNT * 8 + j * 8 +
         (threadIdx.x & 3) * 2 + (v & 1);
}

// ---------------------------------------------------------------------------
// backward: one layer over all B*T rows
// ---------------------------------------------------------------------------

// Bytes of the bf16 tiles of xcat and y (z_gate) in a backward block of
// TM rows.
__host__ __device__ __forceinline__ size_t bwd_tile_bytes(int R, int nm,
                                                          int TM) {
  return (size_t)TM * (tile_ld(2 * R) + (nm ? tile_ld(nm) : 0)) *
         sizeof(bf16);
}

// Bytes of a backward block's a_s: f32 [TM][max(2R, R + S)] (dcat, dz),
// or the bf16 tiles where those are larger.
__host__ __device__ __forceinline__ size_t bwd_tiles(int R, int S, int nm,
                                                     int TM) {
  const int la = 2 * R > R + S ? 2 * R : R + S;
  const size_t f = (size_t)TM * la * sizeof(float);
  const size_t t = bwd_tile_bytes(R, nm, TM);
  return f > t ? f : t;
}

// Recompute z and h from the stored layer input (z_gate, the forward's
// code), then dh, dz and dboth = dz @ Wz^T (mma_pass_t).  Writes h (bf16)
// and dz for the weight gradients, dx_out = dx_in + dboth_cur, and
// dprev = dboth_prev for the shift pass.  With mel (nm > 0) also
// dy = dz @ V_cond^T, added to dy unless dy_first; with a speaker (gl)
// the recompute adds the row's offset.  One block a tile of TM rows
// (Warps<TM>).
template <int TM>
__global__ void __launch_bounds__(kThreads)
bwd_layer_kernel(const bf16* __restrict__ xs_in,
                 const float* __restrict__ dx_in,
                 const float* __restrict__ dskip, float* __restrict__ dx_out,
                 float* __restrict__ dprev, float* __restrict__ dz_g,
                 bf16* __restrict__ h_g, const bf16* __restrict__ wz,
                 const float* __restrict__ b, const bf16* __restrict__ wrs,
                 const bf16* __restrict__ y, const bf16* __restrict__ vc,
                 const float* __restrict__ gl, int gs,
                 float* __restrict__ dy, int dy_first, int M, int T, int R,
                 int S, int nm, int d) {
  extern __shared__ float smem[];
  constexpr int kNT = Warps<TM>::kNT;
  const int R2 = 2 * R, NO = R + S;
  // a_s: the bf16 tiles of xcat and y, then dcat [TM][R+S], then dz
  // [TM][2R] (both f32, by swz); z_s: (tanh, sigmoid), then dz; then the
  // two W stages
  float* a_s = smem;
  float* z_s = a_s + bwd_tiles(R, S, nm, TM) / sizeof(float);
  bf16* Wb_s = reinterpret_cast<bf16*>(z_s + TM * R2);
  bf16* xc_s = reinterpret_cast<bf16*>(a_s);
  bf16* y_s = xc_s + TM * tile_ld(R2);
  const int m0 = blockIdx.x * TM;
  const int tid = threadIdx.x;

  stage_xcat<TM>(xc_s, xs_in, m0, M, T, R, d);
  if (nm) stage_y<TM>(y_s, y, m0, M, nm);
  cp_async_commit();
  auto epi = [&](int r, int c, float2 tf, float2 sg) {
    *reinterpret_cast<float2*>(z_s + r * R2 + c) = tf;
    *reinterpret_cast<float2*>(z_s + r * R2 + R + c) = sg;
    if (m0 + r < M)
      *reinterpret_cast<__nv_bfloat162*>(h_g + (size_t)(m0 + r) * R + c) =
          __floats2bfloat162_rn(tf.x * sg.x, tf.y * sg.y);
  };
  // the deep f64 W stages where a_s has room past the tiles, else W_s
  const size_t tiles = bwd_tile_bytes(R, nm, TM);
  if (bwd_tiles(R, S, nm, TM) >= tiles + kWD)
    z_gate<kKD, TM>(xc_s, y_s,
                reinterpret_cast<double*>(reinterpret_cast<char*>(a_s) + tiles),
                wz, b, vc, gl, gs, m0, M, T, R, nm, epi);
  else
    z_gate<kKDs, TM>(xc_s, y_s, reinterpret_cast<double*>(Wb_s), wz, b, vc, gl,
                 gs, m0, M, T, R, nm, epi);
  __syncthreads();   // xcat and y are spent: dcat's copies overwrite them
  // dcat = [dx | dskip] by cp.async, 4 columns a copy (swz moves whole
  // groups of 4), zero past row M
  for (int e = tid; e < TM * NO / 4; e += kThreads) {
    const int r = e / (NO / 4), j = (e - r * (NO / 4)) * 4, m = m0 + r;
    const bool ok = m < M;
    cp_async16(&a_s[r * NO + swz(r, j, NO)],
               !ok ? dskip
               : j < R ? dx_in + (size_t)m * R + j
                       : dskip + (size_t)m * S + (j - R),
               ok);
  }
  cp_async_commit();
  cp_async_wait0();
  float acc[kNT][4];
  for (int n0 = 0; n0 < R; n0 += kNP) {
    mma_pass_t<TM>(a_s, NO, wrs, NO, R, n0, Wb_s, acc);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int r = frag_row<TM>(v), c = n0 + frag_col<TM>(j, v);
        const int m = m0 + r;
        if (c >= R) continue;
        const float dh = acc[j][v];
        const float tf = z_s[r * R2 + c], sg = z_s[r * R2 + R + c];
        const float dzf = dh * sg * (1.f - tf * tf);
        const float dzg = dh * tf * sg * (1.f - sg);
        z_s[r * R2 + c] = dzf;
        z_s[r * R2 + R + c] = dzg;
        if (m < M) {
          dz_g[(size_t)m * R2 + c] = dzf;
          dz_g[(size_t)m * R2 + R + c] = dzg;
        }
      }
  }
  // dz, the A operand of the remaining products, moves to a_s (dcat is
  // spent) in the swizzled layout
  __syncthreads();
  for (int e = tid; e < TM * R2 / 4; e += kThreads) {
    const int r = e / (R2 / 4), c = (e - r * (R2 / 4)) * 4;
    *reinterpret_cast<float4*>(&a_s[r * R2 + swz(r, c, R2)]) =
        *reinterpret_cast<const float4*>(&z_s[r * R2 + c]);
  }
  for (int n0 = 0; n0 < R2; n0 += kNP) {
    mma_pass_t<TM>(a_s, R2, wz, R2, R2, n0, Wb_s, acc);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + frag_row<TM>(v), n = n0 + frag_col<TM>(j, v);
        if (m >= M || n >= R2) continue;
        if (n < R) {
          const size_t o = (size_t)m * R + n;
          dx_out[o] = dx_in[o] + acc[j][v];
        } else {
          dprev[(size_t)m * R + (n - R)] = acc[j][v];
        }
      }
  }
  for (int n0 = 0; n0 < nm; n0 += kNP) {
    mma_pass_t<TM>(a_s, R2, vc, R2, nm, n0, Wb_s, acc);
#pragma unroll
    for (int j = 0; j < kNT; ++j)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int m = m0 + frag_row<TM>(v), n = n0 + frag_col<TM>(j, v);
        if (m >= M || n >= nm) continue;
        const size_t o = (size_t)m * nm + n;
        dy[o] = dy_first ? acc[j][v] : dy[o] + acc[j][v];
      }
  }
}

// The transposed causal shift: dx[t] += dprev[t + d] within each sequence.
__global__ void shift_add_kernel(float* __restrict__ dx,
                                 const float* __restrict__ dprev, int M,
                                 int T, int R, int d) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= (size_t)M * R) return;
  const int m = (int)(e / R);
  if (m % T + d < T) dx[e] += dprev[e + (size_t)d * R];
}

// Weight-gradient partials: part[s][i][j] = sum over the rows m of split s
// of P(m, i) * Q(m, j).  kMode 0: P = xcat (2R), Q = dz (2R) -> dWz.
// kMode 1: P = h (R), Q = [dx | dskip] (R + S) -> dWrs.
// kMode 2: P = y (nm), Q = dz (2R) -> dV_cond.
// A block owns the [64 x 128] output tile (i0, j0) as C = P^T Q on the
// tensor cores, the rows m the contraction: P (bf16) and Q (f32) are
// staged 32 rows at a time by cp.async in two stages, P's A fragments
// read transposed by ldmatrix, Q's B fragments split hi/mid/lo in
// registers (split3), each stage's MMAs summed apart and added to acc, one
// barrier a stage.  Warp w owns all 64 columns i
// and the columns j0 + 16 w + [0, 16): four m16 by two n8 tiles.
template <int kMode>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const bf16* __restrict__ xs, const float* __restrict__ dz,
             const bf16* __restrict__ h, const float* __restrict__ dx,
             const float* __restrict__ dskip, const bf16* __restrict__ y,
             int M, int T, int R, int S, int nm, int d, int rows_per_split,
             float* __restrict__ part) {
  __shared__ __align__(16) bf16 P_s[2][kWM * kPL];
  __shared__ __align__(16) float Q_s[2][kWM * kQL];
  const int NP = kMode == 0 ? 2 * R : kMode == 1 ? R : nm;
  const int NQ = kMode == 1 ? R + S : 2 * R;
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * kNP;
  const int s = blockIdx.z;
  const int mb = s * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  const int tid = threadIdx.x, lane = tid & 31, wp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[4][2][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 2; ++b)
#pragma unroll
      for (int v = 0; v < 4; ++v) acc[a][b][v] = 0.f;

  auto stage = [&](int buf, int m0) {
    for (int e = tid; e < kWM * 16; e += kThreads) {   // 4 bf16 per copy
      const int mm = e >> 4, ii = (e & 15) * 4, m = m0 + mm, i = i0 + ii;
      const bf16* src = xs;
      bool ok = m < me && i < NP;
      if (ok) {
        if (kMode == 0) {
          if (i < R)
            src = xs + (size_t)m * R + i;
          else if (m % T < d)
            ok = false;
          else
            src = xs + (size_t)(m - d) * R + (i - R);
        } else {
          src = kMode == 1 ? h + (size_t)m * R + i : y + (size_t)m * nm + i;
        }
      }
      cp_async8(&P_s[buf][mm * kPL + ii], src, ok);
    }
    for (int e = tid; e < kWM * kNP / 4; e += kThreads) {   // 4 f32 per copy
      const int mm = e >> 5, jj = (e & 31) * 4, m = m0 + mm, j = j0 + jj;
      const bool ok = m < me && j < NQ;
      const float* src = dz;
      if (ok)
        src = kMode != 1 ? dz + (size_t)m * NQ + j
              : j < R    ? dx + (size_t)m * R + j
                         : dskip + (size_t)m * S + (j - R);
      cp_async16(&Q_s[buf][mm * kQL + jj], src, ok);
    }
  };

  const int ns = (me - mb + kWM - 1) / kWM;
  stage(0, mb);
  cp_async_commit();
  for (int st = 0; st < ns; ++st) {
    cp_async_wait0();
    __syncthreads();
    if (st + 1 < ns) {
      stage((st + 1) & 1, mb + (st + 1) * kWM);
      cp_async_commit();
    }
    const bf16* P = P_s[st & 1];
    const float* Q = Q_s[st & 1];
    float sacc[4][2][4] = {};   // this stage's sum
#pragma unroll
    for (int kk = 0; kk < kWM; kk += 16) {
      uint32_t bh[2][2], bm[2][2], bl[2][2];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int c = wp * 16 + nt * 8 + g;
#pragma unroll
        for (int q = 0; q < 2; ++q) {
          const int r = kk + q * 8 + 2 * t;
          split3(Q[r * kQL + c], Q[(r + 1) * kQL + c], bh[nt][q], bm[nt][q],
                 bl[nt][q]);
        }
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt) {
        // lanes 8 q + r address row kk + 8 (q / 2) + r, columns
        // 16 mt + 8 (q % 2) + [0, 8) of P_s: the four 8 x 8 blocks of
        // the A fragment, transposed
        const int q = lane >> 3;
        const unsigned addr = (unsigned)__cvta_generic_to_shared(
            &P[(kk + (q >> 1) * 8 + (lane & 7)) * kPL + mt * 16 +
               (q & 1) * 8]);
        uint32_t a[4];
        asm volatile(
            "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 "
            "{%0,%1,%2,%3}, [%4];\n"
            : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
            : "r"(addr));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(sacc[mt][nt], a, bl[nt]);  // fixed order: lo, mid, hi
          mma_bf16(sacc[mt][nt], a, bm[nt]);
          mma_bf16(sacc[mt][nt], a, bh[nt]);
        }
      }
    }
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[mt][nt][v] += sacc[mt][nt][v];
  }
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int v = 0; v < 4; ++v) {
        const int ii = i0 + mt * 16 + g + (v >> 1) * 8;
        const int jj = j0 + wp * 16 + nt * 8 + 2 * t + (v & 1);
        if (ii < NP && jj < NQ)
          part[((size_t)s * NP + ii) * NQ + jj] = acc[mt][nt][v];
      }
}

// out[e] = sum over j, in order, of part[j][e], for e < n.
__global__ void reduce_splits_kernel(const float* __restrict__ part, int nsr,
                                     size_t n, float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int j = 0; j < nsr; ++j) acc += part[j * n + e];
  out[e] = acc;
}

// The column sums' ring: a strip of kCW columns (one warp, a lane a
// column), kCR rows a stage, kCS stages (32 KiB).
constexpr int kCW = 32, kCR = 32, kCS = 8;
typedef float ColRing[kCS][kCR][kCW];

// Wait until at most N of this thread's committed cp.async groups are
// still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Lane l's sum, 0 + row 0 + row 1 + ... in f32, of column l of the strip
// src[m * ld + l] for m < rows (cols of the 32 columns are real, a
// multiple of 4; src and ld give 16-byte rows).  Lane l copies 16-byte
// chunk l % 8 of rows l / 8 + 4 i of each stage; kCS - 1 stages are in
// flight while one is added.  The warp leaves the ring free.
__device__ __forceinline__ float strip_sum(const float* src, size_t ld,
                                           int rows, int cols,
                                           ColRing& ring) {
  const int lane = threadIdx.x, q = lane & 7;
  const bool real = 4 * q < cols;
  const int stages = (rows + kCR - 1) / kCR;
  auto issue = [&](int st) {             // commits a group, maybe empty
    if (st < stages)
      for (int r = lane >> 3; r < kCR; r += 4) {
        const int m = st * kCR + r;
        const bool ok = real && m < rows;
        cp_async16(&ring[st % kCS][r][4 * q],
                   ok ? src + (size_t)m * ld + 4 * q : src, ok);
      }
    cp_async_commit();
  };
  for (int st = 0; st < kCS - 1; ++st) issue(st);
  float acc = 0.f;
  for (int st = 0; st < stages; ++st) {
    cp_async_wait<kCS - 2>();            // stage st has landed
    __syncwarp();                        // for every lane; and stage
    issue(st + kCS - 1);                 // st - 1 is read: refill its slot
    const float(*tile)[kCW] = ring[st % kCS];
    const int n = min(kCR, rows - st * kCR);
#pragma unroll
    for (int r = 0; r < kCR; ++r)
      if (r < n) acc += tile[r][lane];
  }
  cp_async_wait0();
  __syncwarp();
  return acc;
}

// One tensor of a column-sum launch: src [B T][N] (N a multiple of 4,
// src 16-byte aligned) summed per batch row i into out[i * out_stride + n].
// A launch sums one or two (N = 0: none) over the same rows.
struct ColSum {
  const float* src;
  float* out;
  int N;
  size_t out_stride;
};

// Column sums of a and b per batch row, in the fixed order: split
// s = i nsr + j sums rows [i T + j rps, min(i T + (j + 1) rps, (i + 1) T))
// of batch row i (no split straddles two; B = 1, T = M: splits of all
// rows), then batch row i's nsr partials are added in split order.  Strip
// k is columns [32 k, 32 k + 32) of a, or past a's strips, of b; block
// (s, k) sums strip k of split s into part[k][s][32], and the last of
// batch row i's nsr blocks of strip k (count[i * strips + k], zero before
// the launch and again after it) adds them.
__global__ void __launch_bounds__(kCW)
    colsum_kernel(ColSum a, ColSum b, int T, int rows_per_split, int nsr,
                  float* part, unsigned* count) {
  __shared__ __align__(16) ColRing ring;
  const int s = blockIdx.x, k = blockIdx.y, lane = threadIdx.x;
  const int row = s / nsr, j = s % nsr;
  const int ka = (a.N + kCW - 1) / kCW;
  const ColSum t = k < ka ? a : b;
  const int c0 = (k < ka ? k : k - ka) * kCW, cols = min(kCW, t.N - c0);
  const int rows = min(rows_per_split, T - j * rows_per_split);
  const float acc = strip_sum(
      t.src + ((size_t)row * T + (size_t)j * rows_per_split) * t.N + c0, t.N,
      rows, cols, ring);
  float* strip = part + (size_t)k * gridDim.x * kCW;
  strip[(size_t)s * kCW + lane] = acc;
  __threadfence();                       // the partial, before the count
  __syncwarp();
  unsigned* arrived = count + (size_t)row * gridDim.y + k;
  unsigned last = 0;
  if (lane == 0) last = atomicAdd(arrived, 1u) == (unsigned)nsr - 1;
  if (!__shfl_sync(0xffffffffu, last, 0)) return;
  __threadfence();                       // every partial, before the reads
  if (lane == 0) *arrived = 0;
  // 16-byte copies that skip L1 (cp.async.cg) read what the other blocks
  // wrote
  const float sum = strip_sum(strip + (size_t)row * nsr * kCW, kCW, nsr,
                              cols, ring);
  if (lane < cols) t.out[(size_t)row * t.out_stride + c0 + lane] = sum;
}

inline unsigned blocks_for(size_t n, int per) {
  return (unsigned)((n + per - 1) / per);
}

// The least shared memory a forward block of TM rows needs: the bf16
// tiles of xcat, h and (nm > 0) y, and two f64 W stages (32 KiB).  The
// caller plans the size it passes (ops/cuda/train_stack.py: _fwd_smem); a
// smaller one is refused.
size_t fwd_smem_needed(int R, int nm, int TM) {
  return (size_t)TM * (tile_ld(2 * R) + tile_ld(R) + (nm ? tile_ld(nm) : 0)) *
             sizeof(bf16) +
         kWD;
}

// The least shared memory a backward block of TM rows needs: a_s, the
// larger of f32 [TM][max(2R, R + S)] and the bf16 tiles of xcat and y
// (bwd_tiles), z_s [TM][2R] and two W stages (16 KiB), as
// ops/cuda/train_stack.py: _bwd_smem plans it.
size_t bwd_smem_needed(int R, int S, int nm, int TM) {
  return bwd_tiles(R, S, nm, TM) + (size_t)TM * 2 * R * sizeof(float) +
         2 * kStage * sizeof(bf16);
}

// The layer kernels of a row tile of 64, 32 or 16 rows; null for another.
// Every tile gives each output element the same sum, so the caller picks
// the largest whose block fits (ops/cuda/train_stack.py: fwd_rows,
// bwd_rows); 64 rows at every preset.
using FwdKernel = decltype(&fwd_layer_kernel<64>);
using BwdKernel = decltype(&bwd_layer_kernel<64>);

FwdKernel fwd_kernel(int rows) {
  return rows == 64   ? fwd_layer_kernel<64>
         : rows == 32 ? fwd_layer_kernel<32>
         : rows == 16 ? fwd_layer_kernel<16>
                      : nullptr;
}

BwdKernel bwd_kernel(int rows) {
  return rows == 64   ? bwd_layer_kernel<64>
         : rows == 32 ? bwd_layer_kernel<32>
         : rows == 16 ? bwd_layer_kernel<16>
                      : nullptr;
}

// The error of the last launch, if any; else the launch is counted in *n.
inline int counted(int* n) {
  const int rc = (int)cudaGetLastError();
  if (!rc) ++*n;
  return rc;
}

// Column sums of a and b (b.N = 0: a alone), each [B T, N] summed per
// batch row (B = 1, T = M for the sums over all rows), fixed order, one
// launch.  part holds 32 B ceil(T / rows_per_split) (ceil(a.N / 32) +
// ceil(b.N / 32)) floats, 16-byte aligned; count B (ceil(a.N / 32) +
// ceil(b.N / 32)) zeros, left zero.
int colsum(ColSum a, ColSum b, int B, int T, int rows_per_split, float* part,
           unsigned* count, cudaStream_t st, int* n) {
  if (a.N % 4 || b.N % 4 || (uintptr_t)a.src % 16 || (uintptr_t)b.src % 16 ||
      (uintptr_t)part % 16)
    return (int)cudaErrorInvalidValue;
  // as many resident blocks an SM as its shared memory holds
  const int rc = (int)cudaFuncSetAttribute(
      colsum_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
      (int)cudaSharedmemCarveoutMaxShared);
  if (rc) return rc;
  const int nsr = (T + rows_per_split - 1) / rows_per_split;
  colsum_kernel<<<dim3(B * nsr, blocks_for(a.N, kCW) + blocks_for(b.N, kCW)),
                  kCW, 0, st>>>(a, b, T, rows_per_split, nsr, part, count);
  return counted(n);
}

}  // namespace

extern "C" {

// Every entry point adds the device kernels it launched to *launched.

// Forward of one layer group.  dils: host array [Lg].  skip_out may equal
// skip_in (then the skip sum is updated in place).  xs [Lg + 1, M, R] bf16
// receives every layer's input (and the group output last); carry [M, R]
// is f32 scratch.  With mel, y [M, nm] and vc [Lg, nm, 2R] (bf16), nm a
// multiple of 4; else null and nm = 0.  With a speaker, g [M / T, Lg, 2R]
// f32 (each batch row's offsets); else null.  rows: the row tile of a
// layer block (64, 32 or 16); smem: the bytes of shared memory it gets
// (at least fwd_smem_needed).  R, S and nm are multiples of 4, and the
// bf16 operands xs, wz, wrs, y and vc 8-byte aligned (16 where R or nm is
// a multiple of 8): the cp.async copies.
int wn_ts_group_fwd(const float* x_in, const float* skip_in, float* skip_out,
                    float* x_out, bf16* xs, float* carry, const bf16* wz,
                    const float* b, const bf16* wrs, const float* bres,
                    const float* bskip, const bf16* y, const bf16* vc,
                    const float* g, const int* dils, int Lg, int M, int T,
                    int R, int S, int nm, int rows, int smem, int* launched,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t MR = (size_t)M * R;
  const FwdKernel layer = fwd_kernel(rows);
  if (!layer || smem < 0 || (size_t)smem < fwd_smem_needed(R, nm, rows) ||
      R % 4 || S % 4 || nm < 0 || nm % 4 || (nm > 0) != (y != nullptr) ||
      (nm > 0) != (vc != nullptr) || T <= 0 || M % T)
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(
      layer, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (rc) return rc;
  // two blocks per SM: ask for the largest shared-memory carveout
  rc = (int)cudaFuncSetAttribute(layer,
                                 cudaFuncAttributePreferredSharedMemoryCarveout,
                                 (int)cudaSharedmemCarveoutMaxShared);
  if (rc) return rc;
  init_carry_kernel<<<blocks_for(MR, 256), 256, 0, st>>>(x_in, carry, xs, MR);
  if ((rc = counted(launched))) return rc;
  const int R2 = 2 * R;
  for (int l = 0; l < Lg; ++l) {
    layer<<<blocks_for(M, rows), kThreads, smem, st>>>(
        xs + l * MR, carry, xs + (l + 1) * MR, l == Lg - 1 ? x_out : nullptr,
        l == 0 ? skip_in : skip_out, skip_out, wz + (size_t)l * R2 * R2,
        b + (size_t)l * R2, wrs + (size_t)l * R * (R + S), bres + (size_t)l * R,
        bskip + (size_t)l * S, y, vc ? vc + (size_t)l * nm * R2 : nullptr,
        g ? g + (size_t)l * R2 : nullptr, Lg * R2, M, T, R, S, nm, dils[l]);
    if ((rc = counted(launched))) return rc;
  }
  return 0;
}

// Backward of one layer group.  xs: the forward's stash; dskip [M, S] and
// dx_ct [M, R]: cotangents of the group's skip and x outputs.  Writes
// dx_in [M, R], dwz [Lg, 2R, 2R], db [Lg, 2R], dwrs [Lg, R, R + S],
// dbres [Lg, R]; with mel (y [M, nm], vc [Lg, nm, 2R] bf16) also
// dvc [Lg, nm, 2R] and dy [M, nm]; with a speaker (g [M / T, Lg, 2R] f32)
// also dg [M / T, Lg, 2R].  Scratch: dxa, dxb, dprev [M, R]; dz [M, 2R];
// h [M, R] bf16; part [nsplit * max(4R^2, R(R+S), 2R nm)]; the column
// sums' bpart and count (colsum) for db and db_res in one launch, and
// with a speaker for dg's (M / T) * ceil(T / rows_per_split) splits too,
// count zeros and left zero.  rows: the row tile of a
// layer block (64, 32 or 16); smem: the bytes of shared memory it gets (at
// least bwd_smem_needed).  R, S and nm are multiples of 4, every f32
// operand 16-byte aligned and every bf16 one 8-byte aligned (the cp.async
// copies).
int wn_ts_group_bwd(const bf16* xs, const float* dskip, const float* dx_ct,
                    const bf16* wz, const float* b, const bf16* wrs,
                    const bf16* y, const bf16* vc, const float* g,
                    const int* dils, int Lg, int M, int T, int R, int S,
                    int nm, float* dx_in, float* dwz, float* db, float* dwrs,
                    float* dbres, float* dvc, float* dy, float* dg,
                    float* dxa, float* dxb, float* dprev, float* dz, bf16* h,
                    float* part, float* bpart, unsigned* count,
                    int rows_per_split, int rows, int smem, int* launched,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t MR = (size_t)M * R;
  const int R2 = 2 * R, NO = R + S;
  const int nsplit = (M + rows_per_split - 1) / rows_per_split;
  const BwdKernel layer = bwd_kernel(rows);
  if (!layer || smem < 0 || (size_t)smem < bwd_smem_needed(R, S, nm, rows) ||
      R % 4 || S % 4 || nm < 0 || nm % 4 ||
      (nm > 0) != (y && vc && dvc && dy) || (g != nullptr) != (dg != nullptr) ||
      T <= 0 || M % T)
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(
      layer, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc) return rc;
  const float* din = dx_ct;
  for (int k = 0, l = Lg - 1; l >= 0; --l, ++k) {
    const int d = dils[l];
    float* dout = l == 0 ? dx_in : (k % 2 ? dxb : dxa);
    const bf16* vcl = vc ? vc + (size_t)l * nm * R2 : nullptr;
    const float* gl = g ? g + (size_t)l * R2 : nullptr;
    layer<<<blocks_for(M, rows), kThreads, smem, st>>>(
        xs + l * MR, din, dskip, dout, dprev, dz, h, wz + (size_t)l * R2 * R2,
        b + (size_t)l * R2, wrs + (size_t)l * R * NO, y, vcl, gl, Lg * R2, dy,
        k == 0, M, T, R, S, nm, d);
    if ((rc = counted(launched))) return rc;
    shift_add_kernel<<<blocks_for(MR, 256), 256, 0, st>>>(dout, dprev, M, T,
                                                          R, d);
    if ((rc = counted(launched))) return rc;

    wgrad_kernel<0><<<dim3(blocks_for(R2, 64), blocks_for(R2, kNP), nsplit),
                      kThreads, 0, st>>>(xs + l * MR, dz, h, din, dskip, y, M,
                                         T, R, S, nm, d, rows_per_split, part);
    if ((rc = counted(launched))) return rc;
    const size_t nz = (size_t)R2 * R2;
    reduce_splits_kernel<<<blocks_for(nz, 256), 256, 0, st>>>(
        part, nsplit, nz, dwz + l * nz);
    if ((rc = counted(launched))) return rc;

    wgrad_kernel<1><<<dim3(blocks_for(R, 64), blocks_for(NO, kNP), nsplit),
                      kThreads, 0, st>>>(xs + l * MR, dz, h, din, dskip, y, M,
                                         T, R, S, nm, d, rows_per_split, part);
    if ((rc = counted(launched))) return rc;
    const size_t nrs = (size_t)R * NO;
    reduce_splits_kernel<<<blocks_for(nrs, 256), 256, 0, st>>>(
        part, nsplit, nrs, dwrs + l * nrs);
    if ((rc = counted(launched))) return rc;

    if (nm) {
      wgrad_kernel<2><<<dim3(blocks_for(nm, 64), blocks_for(R2, kNP), nsplit),
                        kThreads, 0, st>>>(xs + l * MR, dz, h, din, dskip, y,
                                           M, T, R, S, nm, d, rows_per_split,
                                           part);
      if ((rc = counted(launched))) return rc;
      const size_t nv = (size_t)nm * R2;
      reduce_splits_kernel<<<blocks_for(nv, 256), 256, 0, st>>>(
          part, nsplit, nv, dvc + l * nv);
      if ((rc = counted(launched))) return rc;
    }

    if ((rc = colsum({dz, db + (size_t)l * R2, R2, 0},
                     {din, dbres + (size_t)l * R, R, 0}, 1, M, rows_per_split,
                     bpart, count, st, launched)))
      return rc;
    if (g && (rc = colsum({dz, dg + (size_t)l * R2, R2, (size_t)Lg * R2}, {},
                          M / T, T, rows_per_split, bpart, count, st,
                          launched)))
      return rc;
    din = dout;
  }
  return 0;
}

// Column sums of a [M, Na] and, unless b is null, b [M, Nb] per batch row
// of T rows (T = M: over all rows; the skip-bias gradient) into
// out_a [M / T, Na] and out_b [M / T, Nb], fixed order, one launch
// (colsum's operands).
int wn_ts_colsum(const float* a, int Na, float* out_a, const float* b,
                 int Nb, float* out_b, int M, int T, float* bpart,
                 unsigned* count, int rows_per_split, int* launched,
                 void* stream) {
  if (T <= 0 || M % T || (b == nullptr) != (Nb == 0))
    return (int)cudaErrorInvalidValue;
  return colsum({a, out_a, Na, (size_t)Na}, {b, out_b, Nb, (size_t)Nb},
                M / T, T, rows_per_split, bpart, count, (cudaStream_t)stream,
                launched);
}

const char* wn_ts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
