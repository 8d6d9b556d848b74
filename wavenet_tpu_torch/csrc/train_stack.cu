// Fused training stack of WaveNet on Hopper (sm_90a): one layer group's
// forward and backward.
//
// Replaces wavenet_tpu/ops/pallas/train_stack.py::_fwd_kernel and
// ::_bwd_kernel, unconditional and mel-conditioned (their has_cond form;
// no speaker conditioning): the same per-group contract and numerics, a
// different schedule.
//
//   forward  (x_in, skip_in[, y]) -> (skip_out, x_out), per layer l:
//     xcat = [bf16(x) | bf16(x)[t - d]]                (zero for t < d)
//     z    = xcat @ Wz + b                              (f32 accumulate)
//     z    = z + y @ V_cond[l]                          (with mel; y bf16)
//     h    = bf16(tanh(z_f) * sigmoid(z_g))
//     o    = h @ [W_res | W_skip]
//     x    = (x + o_res) + b_res                        (f32 carry)
//     skip = (skip + o_skip) + b_skip
//   x_out = bf16(x) once, at the end of the group (held in f32).
//   backward (dskip, dx_out) -> (dx_in, dWz, db, dWrs, db_res[, dV_cond,
//   dy]), layers in reverse, every cotangent in f32:
//     dcat = [dx | dskip]; dh = dcat @ Wrs^T; dz = [dh*sg*(1-tf^2) | dh*tf*sg*(1-sg)]
//     dboth = dz @ Wz^T; dx = (dx + dboth_cur) + dboth_prev[t + d]
//     dWz += xcat^T dz; db += sum dz; dWrs += h^T dcat; db_res += sum dx
//     with mel: dV_cond[l] = y^T dz; dy += dz @ V_cond[l]^T
//
// What bounds it on this card: arithmetic.  At `full` (L = 40, R = 128,
// S = 256, B = 8, T = 8192) the forward is ~0.6 TFLOP and the backward
// ~1.5 TFLOP of dense products over B*T = 65,536 rows, against ~0.8 GB of
// activations per direction; that is far above the H100's balance point.
//
// What the design does about it, and what it leaves for later:
//   * The TPU walks time tiles of one batch row in sequence on one core and
//     carries each layer's causal context in rings.  Here every 64-row tile
//     is its own block (B*T/64 blocks per layer launch, all SMs busy), and
//     the causal operand x[t - d] is read straight from the layer's input in
//     device memory, so there are no rings and no snapshots.  The price is
//     one launch per layer and the layer inputs kept in device memory: the
//     forward stores each layer's bf16 input, [Lg + 1, B, T, R] per group
//     (the TPU's `xs` stash; ~0.75 GB at `full`), which the backward reads
//     instead of recomputing the group.
//   * The transposed causal shift (dx[t] += dprev[t + d]) reads rows that
//     another block writes, so it is its own elementwise pass.
//   * The mel term is one more block product in each layer kernel: the
//     tile's y rows are staged in the shared buffer that xcat leaves free
//     after z, so shared memory does not grow.  dy is summed over the
//     group's layers in reverse order by a read-modify-write in the layer
//     kernel's epilogue: one block owns a row per launch, so there are no
//     atomics and the order is fixed.
//   * Weight gradients are reductions over all B*T rows.  They run as
//     fixed-order split-K: each block sums its share of rows into a private
//     partial, and a second pass adds the partials in split order.  No
//     float atomics, so two runs give the same bits (exact resume).
//   * Products are blocked in shared memory and summed with f32 FMAs on the
//     CUDA cores (bf16 operand values are exact in f32).  That caps the
//     kernels at the f32 rate; tensor cores (mma.sync / wgmma), TMA and
//     tiling for them are later work.
//
// The plain PyTorch versions (ops/cuda/train_stack.py:
// group_fwd_reference, group_bwd_reference) follow the same recipe.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kThreads = 256;   // 16 x 16 threads: 4 rows x 8 columns each
constexpr int kTM = 64;         // rows per block in the row kernels
constexpr int kKC = 32;         // contraction rows of W staged at a time
constexpr int kNP = 128;        // output columns per pass
constexpr int kWM = 32;         // rows staged at a time in the weight grads

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

__device__ __forceinline__ float sigmoidf(float v) {
  return 1.f / (1.f + expf(-v));
}

// xcat[m][i]: the layer input at row m (i < R) or its causal partner at
// m - d (i >= R), zero before the start of the row's sequence.
__device__ __forceinline__ float xcat_at(const bf16* __restrict__ xs, int m,
                                         int i, int T, int R, int d) {
  if (i < R) return __bfloat162float(xs[(size_t)m * R + i]);
  if (m % T < d) return 0.f;
  return __bfloat162float(xs[(size_t)(m - d) * R + (i - R)]);
}

__device__ __forceinline__ float comp(const float4& v, int s) {
  return s == 0 ? v.x : s == 1 ? v.y : s == 2 ? v.z : v.w;
}

// One pass of a block product: acc[i][j] = sum_k A(r, k) * W(k, n) for the
// thread's rows r = 4 ty + i of the 64-row tile A_s (shared, row stride
// lda) and columns n = n0 + tx + 16 j.  W(k, n) is w[k * ldw + n], or
// w[n * ldw + k] when kTrans; columns n >= N read as zero.  K and lda are
// multiples of 4 (float4 reads of A_s); the last stage of W may be partial.
// Starts with a barrier, so the caller's writes to A_s are seen.
template <bool kTrans>
__device__ __forceinline__ void gemm_pass(const float* A_s, int lda, int K,
                                          const bf16* __restrict__ w, int ldw,
                                          int N, int n0, float* W_s,
                                          float acc[4][8]) {
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;
  for (int k0 = 0; k0 < K; k0 += kKC) {
    const int kc = K - k0 < kKC ? K - k0 : kKC;
    __syncthreads();
    for (int e = tid; e < kKC * kNP; e += kThreads) {
      int kk, nn;
      if (kTrans) {
        kk = e % kKC;
        nn = e / kKC;
      } else {
        kk = e / kNP;
        nn = e % kNP;
      }
      const int n = n0 + nn;
      float v = 0.f;
      if (n < N && kk < kc)
        v = __bfloat162float(kTrans ? w[(size_t)n * ldw + k0 + kk]
                                    : w[(size_t)(k0 + kk) * ldw + n]);
      W_s[kk * kNP + nn] = v;
    }
    __syncthreads();
    for (int kk = 0; kk < kc; kk += 4) {
      float4 a[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(
            &A_s[(ty * 4 + i) * lda + k0 + kk]);
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        float wv[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) wv[j] = W_s[(kk + s) * kNP + tx + 16 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float av = comp(a[i], s);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(av, wv[j], acc[i][j]);
        }
      }
    }
  }
}

// Stage the 64-row tile of xcat (row stride 2R) in shared memory.
__device__ __forceinline__ void load_xcat(float* a_s, const bf16* xs, int m0,
                                          int M, int T, int R, int d) {
  const int R2 = 2 * R;
  for (int e = threadIdx.x; e < kTM * R2; e += kThreads) {
    const int r = e / R2, i = e % R2, m = m0 + r;
    a_s[e] = m < M ? xcat_at(xs, m, i, T, R, d) : 0.f;
  }
}

// z = xcat @ Wz + b into z_s [64][2R].
__device__ __forceinline__ void compute_z(const float* a_s, float* z_s,
                                          float* W_s, const bf16* wz,
                                          const float* b, int R) {
  const int R2 = 2 * R, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  float acc[4][8];
  for (int n0 = 0; n0 < R2; n0 += kNP) {
    gemm_pass<false>(a_s, R2, R2, wz, R2, R2, n0, W_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < R2) z_s[(ty * 4 + i) * R2 + n] = acc[i][j] + b[n];
      }
  }
  __syncthreads();
}

// z += y @ V_cond (after the bias, the reference's order): the tile's y
// rows [64][nm] are staged in a_s, which compute_z leaves free.  nm is a
// multiple of 4 and at most 2R.
__device__ __forceinline__ void add_cond(float* a_s, float* z_s, float* W_s,
                                         const bf16* __restrict__ y,
                                         const bf16* __restrict__ vc, int m0,
                                         int M, int nm, int R) {
  const int R2 = 2 * R, ty = threadIdx.x >> 4, tx = threadIdx.x & 15;
  for (int e = threadIdx.x; e < kTM * nm; e += kThreads) {
    const int r = e / nm, m = m0 + r;
    a_s[e] = m < M ? __bfloat162float(y[(size_t)m * nm + e % nm]) : 0.f;
  }
  float acc[4][8];
  for (int n0 = 0; n0 < R2; n0 += kNP) {
    gemm_pass<false>(a_s, nm, nm, vc, R2, R2, n0, W_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n < R2) z_s[(ty * 4 + i) * R2 + n] += acc[i][j];
      }
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// forward: one layer over all B*T rows
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads)
fwd_layer_kernel(const bf16* __restrict__ xs_in, float* __restrict__ carry,
                 bf16* __restrict__ xs_out, float* __restrict__ x_out,
                 const float* skip_in, float* skip_out,
                 const bf16* __restrict__ wz, const float* __restrict__ b,
                 const bf16* __restrict__ wrs, const float* __restrict__ bres,
                 const float* __restrict__ bskip, const bf16* __restrict__ y,
                 const bf16* __restrict__ vc, int M, int T, int R, int S,
                 int nm, int d) {
  extern __shared__ float smem[];
  const int R2 = 2 * R, NO = R + S;
  float* a_s = smem;                  // xcat [64][2R], y [64][nm], h [64][R]
  float* z_s = a_s + kTM * R2;        // z [64][2R]
  float* W_s = z_s + kTM * R2;        // [kKC][kNP]
  const int m0 = blockIdx.x * kTM;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_xcat(a_s, xs_in, m0, M, T, R, d);
  compute_z(a_s, z_s, W_s, wz, b, R);
  if (nm) add_cond(a_s, z_s, W_s, y, vc, m0, M, nm, R);
  for (int e = tid; e < kTM * R; e += kThreads) {
    const int r = e / R, c = e % R;
    a_s[e] = round_bf16(tanhf(z_s[r * R2 + c]) * sigmoidf(z_s[r * R2 + R + c]));
  }
  float acc[4][8];
  for (int n0 = 0; n0 < NO; n0 += kNP) {
    gemm_pass<false>(a_s, R, R, wrs, NO, NO, n0, W_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= NO) continue;
        if (n < R) {
          const size_t o = (size_t)m * R + n;
          const float x = (carry[o] + acc[i][j]) + bres[n];
          carry[o] = x;
          xs_out[o] = __float2bfloat16_rn(x);
          if (x_out) x_out[o] = round_bf16(x);
        } else {
          const size_t o = (size_t)m * S + (n - R);
          skip_out[o] = (skip_in[o] + acc[i][j]) + bskip[n - R];
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
// backward: one layer over all B*T rows
// ---------------------------------------------------------------------------

// Recompute z and h from the stored layer input, then dh, dz and
// dboth = dz @ Wz^T.  Writes h (bf16) and dz for the weight gradients,
// dx_out = dx_in + dboth_cur, and dprev = dboth_prev for the shift pass.
// With mel (nm > 0) also dy = dz @ V_cond^T, added to dy unless dy_first.
__global__ void __launch_bounds__(kThreads)
bwd_layer_kernel(const bf16* __restrict__ xs_in,
                 const float* __restrict__ dx_in,
                 const float* __restrict__ dskip, float* __restrict__ dx_out,
                 float* __restrict__ dprev, float* __restrict__ dz_g,
                 bf16* __restrict__ h_g, const bf16* __restrict__ wz,
                 const float* __restrict__ b, const bf16* __restrict__ wrs,
                 const bf16* __restrict__ y, const bf16* __restrict__ vc,
                 float* __restrict__ dy, int dy_first, int M, int T, int R,
                 int S, int nm, int d) {
  extern __shared__ float smem[];
  const int R2 = 2 * R, NO = R + S;
  const int la = R2 > NO ? R2 : NO;
  float* a_s = smem;                  // xcat, y, then dcat [64][R+S]
  float* z_s = a_s + kTM * la;        // z, then (tanh, sigmoid), then dz
  float* W_s = z_s + kTM * R2;
  const int m0 = blockIdx.x * kTM;
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;

  load_xcat(a_s, xs_in, m0, M, T, R, d);
  compute_z(a_s, z_s, W_s, wz, b, R);
  if (nm) add_cond(a_s, z_s, W_s, y, vc, m0, M, nm, R);
  for (int e = tid; e < kTM * R; e += kThreads) {
    const int r = e / R, c = e % R, m = m0 + r;
    const float tf = tanhf(z_s[r * R2 + c]);
    const float sg = sigmoidf(z_s[r * R2 + R + c]);
    if (m < M) h_g[(size_t)m * R + c] = __float2bfloat16_rn(tf * sg);
    z_s[r * R2 + c] = tf;
    z_s[r * R2 + R + c] = sg;
  }
  for (int e = tid; e < kTM * NO; e += kThreads) {
    const int r = e / NO, j = e % NO, m = m0 + r;
    float v = 0.f;
    if (m < M)
      v = j < R ? dx_in[(size_t)m * R + j] : dskip[(size_t)m * S + (j - R)];
    a_s[r * NO + j] = v;
  }
  float acc[4][8];
  for (int n0 = 0; n0 < R; n0 += kNP) {
    gemm_pass<true>(a_s, NO, NO, wrs, NO, R, n0, W_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i, m = m0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = n0 + tx + 16 * j;
        if (c >= R) continue;
        const float dh = acc[i][j];
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
  }
  for (int n0 = 0; n0 < R2; n0 += kNP) {
    gemm_pass<true>(z_s, R2, R2, wz, R2, R2, n0, W_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= R2) continue;
        if (n < R) {
          const size_t o = (size_t)m * R + n;
          dx_out[o] = dx_in[o] + acc[i][j];
        } else {
          dprev[(size_t)m * R + (n - R)] = acc[i][j];
        }
      }
    }
  }
  for (int n0 = 0; n0 < nm; n0 += kNP) {
    gemm_pass<true>(z_s, R2, R2, vc, R2, nm, n0, W_s, acc);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int m = m0 + ty * 4 + i;
      if (m >= M) continue;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int n = n0 + tx + 16 * j;
        if (n >= nm) continue;
        const size_t o = (size_t)m * nm + n;
        dy[o] = dy_first ? acc[i][j] : dy[o] + acc[i][j];
      }
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
template <int kMode>
__global__ void __launch_bounds__(kThreads)
wgrad_kernel(const bf16* __restrict__ xs, const float* __restrict__ dz,
             const bf16* __restrict__ h, const float* __restrict__ dx,
             const float* __restrict__ dskip, const bf16* __restrict__ y,
             int M, int T, int R, int S, int nm, int d, int rows_per_split,
             float* __restrict__ part) {
  __shared__ __align__(16) float P_s[kWM * 64];
  __shared__ __align__(16) float Q_s[kWM * kNP];
  const int NP = kMode == 0 ? 2 * R : kMode == 1 ? R : nm;
  const int NQ = kMode == 1 ? R + S : 2 * R;
  const int i0 = blockIdx.x * 64, j0 = blockIdx.y * kNP;
  const int s = blockIdx.z;
  const int mb = s * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  const int tid = threadIdx.x, ty = tid >> 4, tx = tid & 15;
  float acc[4][8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int m0 = mb; m0 < me; m0 += kWM) {
    __syncthreads();
    for (int e = tid; e < kWM * 64; e += kThreads) {
      const int mm = e / 64, ii = e % 64, m = m0 + mm, i = i0 + ii;
      float v = 0.f;
      if (m < me && i < NP)
        v = kMode == 0 ? xcat_at(xs, m, i, T, R, d)
            : kMode == 1 ? __bfloat162float(h[(size_t)m * R + i])
                         : __bfloat162float(y[(size_t)m * nm + i]);
      P_s[e] = v;
    }
    for (int e = tid; e < kWM * kNP; e += kThreads) {
      const int mm = e / kNP, jj = e % kNP, m = m0 + mm, j = j0 + jj;
      float v = 0.f;
      if (m < me && j < NQ) {
        if (kMode != 1)
          v = dz[(size_t)m * NQ + j];
        else
          v = j < R ? dx[(size_t)m * R + j] : dskip[(size_t)m * S + (j - R)];
      }
      Q_s[e] = v;
    }
    __syncthreads();
#pragma unroll 4
    for (int mm = 0; mm < kWM; ++mm) {
      const float4 p = *reinterpret_cast<const float4*>(&P_s[mm * 64 + ty * 4]);
      float q[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) q[j] = Q_s[mm * kNP + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = comp(p, i);
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(pv, q[j], acc[i][j]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int ii = i0 + ty * 4 + i;
    if (ii >= NP) continue;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int jj = j0 + tx + 16 * j;
      if (jj < NQ) part[((size_t)s * NP + ii) * NQ + jj] = acc[i][j];
    }
  }
}

// Column-sum partials: part[s][n] = sum over the rows of split s of src[m][n].
__global__ void colsum_kernel(const float* __restrict__ src, int M, int N,
                              int rows_per_split, float* __restrict__ part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  if (n >= N) return;
  const int mb = s * rows_per_split;
  const int me = min(M, mb + rows_per_split);
  float acc = 0.f;
  for (int m = mb; m < me; ++m) acc += src[(size_t)m * N + n];
  part[(size_t)s * N + n] = acc;
}

// out[e] = sum over s, in order, of part[s][e].
__global__ void reduce_splits_kernel(const float* __restrict__ part,
                                     int nsplit, size_t n,
                                     float* __restrict__ out) {
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= n) return;
  float acc = 0.f;
  for (int s = 0; s < nsplit; ++s) acc += part[(size_t)s * n + e];
  out[e] = acc;
}

inline unsigned blocks_for(size_t n, int per) {
  return (unsigned)((n + per - 1) / per);
}

size_t fwd_smem(int R) {
  return (size_t)(2 * kTM * 2 * R + kKC * kNP) * sizeof(float);
}

size_t bwd_smem(int R, int S) {
  const int la = 2 * R > R + S ? 2 * R : R + S;
  return (size_t)(kTM * la + kTM * 2 * R + kKC * kNP) * sizeof(float);
}

// The error of the last launch, if any; else the launch is counted in *n.
inline int counted(int* n) {
  const int rc = (int)cudaGetLastError();
  if (!rc) ++*n;
  return rc;
}

// Column sums of src [M, N] into out [N], fixed order (two launches).
int colsum(const float* src, int M, int N, int rows_per_split, int nsplit,
           float* part, float* out, cudaStream_t st, int* n) {
  colsum_kernel<<<dim3(blocks_for(N, 128), nsplit), 128, 0, st>>>(
      src, M, N, rows_per_split, part);
  int rc = counted(n);
  if (rc) return rc;
  reduce_splits_kernel<<<blocks_for(N, 256), 256, 0, st>>>(part, nsplit, N,
                                                           out);
  return counted(n);
}

}  // namespace

extern "C" {

// Every entry point adds the device kernels it launched to *launched.

// Forward of one layer group.  dils: host array [Lg].  skip_out may equal
// skip_in (then the skip sum is updated in place).  xs [Lg + 1, M, R] bf16
// receives every layer's input (and the group output last); carry [M, R]
// is f32 scratch.  With mel, y [M, nm] and vc [Lg, nm, 2R] (bf16), nm a
// multiple of 4 and at most 2R; else null and nm = 0.
int wn_ts_group_fwd(const float* x_in, const float* skip_in, float* skip_out,
                    float* x_out, bf16* xs, float* carry, const bf16* wz,
                    const float* b, const bf16* wrs, const float* bres,
                    const float* bskip, const bf16* y, const bf16* vc,
                    const int* dils, int Lg, int M, int T, int R, int S,
                    int nm, int* launched, void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t MR = (size_t)M * R;
  const size_t smem = fwd_smem(R);
  if (nm < 0 || nm % 4 || nm > 2 * R || (nm > 0) != (y != nullptr) ||
      (nm > 0) != (vc != nullptr))
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(
      fwd_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  init_carry_kernel<<<blocks_for(MR, 256), 256, 0, st>>>(x_in, carry, xs, MR);
  if ((rc = counted(launched))) return rc;
  const int R2 = 2 * R;
  for (int l = 0; l < Lg; ++l) {
    fwd_layer_kernel<<<blocks_for(M, kTM), kThreads, smem, st>>>(
        xs + l * MR, carry, xs + (l + 1) * MR, l == Lg - 1 ? x_out : nullptr,
        l == 0 ? skip_in : skip_out, skip_out, wz + (size_t)l * R2 * R2,
        b + (size_t)l * R2, wrs + (size_t)l * R * (R + S), bres + (size_t)l * R,
        bskip + (size_t)l * S, y, vc ? vc + (size_t)l * nm * R2 : nullptr, M,
        T, R, S, nm, dils[l]);
    if ((rc = counted(launched))) return rc;
  }
  return 0;
}

// Backward of one layer group.  xs: the forward's stash; dskip [M, S] and
// dx_ct [M, R]: cotangents of the group's skip and x outputs.  Writes
// dx_in [M, R], dwz [Lg, 2R, 2R], db [Lg, 2R], dwrs [Lg, R, R + S],
// dbres [Lg, R]; with mel (y [M, nm], vc [Lg, nm, 2R] bf16) also
// dvc [Lg, nm, 2R] and dy [M, nm].  Scratch: dxa, dxb, dprev [M, R];
// dz [M, 2R]; h [M, R] bf16; part [nsplit * max(4R^2, R(R+S), 2R nm)];
// bpart [nsplit * 2R].
int wn_ts_group_bwd(const bf16* xs, const float* dskip, const float* dx_ct,
                    const bf16* wz, const float* b, const bf16* wrs,
                    const bf16* y, const bf16* vc, const int* dils, int Lg,
                    int M, int T, int R, int S, int nm, float* dx_in,
                    float* dwz, float* db, float* dwrs, float* dbres,
                    float* dvc, float* dy, float* dxa, float* dxb,
                    float* dprev, float* dz, bf16* h, float* part,
                    float* bpart, int rows_per_split, int* launched,
                    void* stream) {
  cudaStream_t st = (cudaStream_t)stream;
  const size_t MR = (size_t)M * R;
  const int R2 = 2 * R, NO = R + S;
  const int nsplit = (M + rows_per_split - 1) / rows_per_split;
  const size_t smem = bwd_smem(R, S);
  if (nm < 0 || nm % 4 || nm > (R2 > NO ? R2 : NO) ||
      (nm > 0) != (y && vc && dvc && dy))
    return (int)cudaErrorInvalidValue;
  int rc = (int)cudaFuncSetAttribute(
      bwd_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (rc) return rc;
  const float* din = dx_ct;
  for (int k = 0, l = Lg - 1; l >= 0; --l, ++k) {
    const int d = dils[l];
    float* dout = l == 0 ? dx_in : (k % 2 ? dxb : dxa);
    const bf16* vcl = vc ? vc + (size_t)l * nm * R2 : nullptr;
    bwd_layer_kernel<<<blocks_for(M, kTM), kThreads, smem, st>>>(
        xs + l * MR, din, dskip, dout, dprev, dz, h, wz + (size_t)l * R2 * R2,
        b + (size_t)l * R2, wrs + (size_t)l * R * NO, y, vcl, dy, k == 0, M,
        T, R, S, nm, d);
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

    if ((rc = colsum(dz, M, R2, rows_per_split, nsplit, bpart,
                     db + (size_t)l * R2, st, launched)))
      return rc;
    if ((rc = colsum(din, M, R, rows_per_split, nsplit, bpart,
                     dbres + (size_t)l * R, st, launched)))
      return rc;
    din = dout;
  }
  return 0;
}

// Column sums of src [M, N] (the skip-bias gradient), fixed order.
int wn_ts_colsum(const float* src, int M, int N, float* out, float* bpart,
                 int rows_per_split, int* launched, void* stream) {
  const int nsplit = (M + rows_per_split - 1) / rows_per_split;
  return colsum(src, M, N, rows_per_split, nsplit, bpart, out,
                (cudaStream_t)stream, launched);
}

const char* wn_ts_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}

}  // extern "C"
