"""Operation and byte counts of the port's work, and the published peaks.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
limit): 989 TFLOP/s in bf16, the configurations' compute_dtype, and
3.35 TB/s of HBM.  The stack kernels happen to sum on the f64 tensor cores;
the peak follows the dtype the configuration states, not the kernel's
method, so a share reads the same work whatever kernel implements it.

A kernel's least time is the larger of its operations at the peak and its
bytes at the bandwidth, each input byte read once and each output byte
written once.  Operations count multiply and add as two, the algorithm's
own (no recompute, no padding).  Sizes come from sizes.Sizes.

Conditioning (zero for an unconditional model, whose every count is what
it was without it): the mel product y V_cond, [M, 2R] a token and layer,
is the stack's work and the decode kernels'; the upsampler, before the
stack, and the speaker offsets g_embed[s] V_global, [G, 2R] a layer once a
row, are the model's but neither kernel's: a training step counts both,
the decode kernels neither (the server upsamples and the decode computes
the offsets outside them, once a request batch).  Bytes count the
conditioning at the kernels' interfaces: the features y in bf16, V_cond in
bf16 (its gradient f32), the offsets [B, L, 2R] in f32 (and their
gradient).
"""

from __future__ import annotations

from portbench.sizes import Sizes

PEAK_FLOPS = {"bfloat16": 989e12}
PEAK_BYTES_PER_S = 3.35e12
BF16, F32, I32 = 2, 4, 4


def peak_flops(dtype: str) -> float:
    return PEAK_FLOPS[dtype]


def least_seconds(flops: float, nbytes: float, dtype: str) -> float:
    return max(flops / peak_flops(dtype), nbytes / PEAK_BYTES_PER_S)


def layer_flops(z: Sizes) -> int:
    """One gated residual layer, one token: the K taps' [R, 2R] gate
    products, the [R, R] residual and the [R, S] skip product, and a mel
    model's [M, 2R] conditioning product."""
    return 2 * (z.K * z.R * 2 * z.R + z.R * z.R + z.R * z.S
                + z.M * 2 * z.R)


def head_flops(z: Sizes) -> int:
    """ReLU -> [S, S] -> ReLU -> [S, Q], one token."""
    return 2 * (z.S * z.S + z.S * z.Q)


def upsample_flops_per_frame(z: Sizes) -> int:
    """The upsampler over one mel frame: stage i's 2 f_i + 1 taps of
    [M, M] at each of its f_0 .. f_i output samples (0 without mel)."""
    total, n = 0, 1
    for f in z.upsample:
        n *= f
        total += 2 * (2 * f + 1) * z.M * z.M * n
    return total


def upsample_flops_per_token(z: Sizes) -> float:
    """upsample_flops_per_frame over the hop."""
    return upsample_flops_per_frame(z) / z.hop


def speaker_flops_per_row(z: Sizes) -> int:
    """The speaker offsets of one row: [G] x [G, 2R] at each layer."""
    return 2 * z.G * 2 * z.R * z.L


def kernel_flops_per_token(z: Sizes) -> int:
    """The stack and the head, one token: a decode kernel's work."""
    return z.L * layer_flops(z) + head_flops(z)


def forward_flops_per_token(z: Sizes):
    """The model's forward, one token: the stack, the head and the
    upsampler."""
    return kernel_flops_per_token(z) + upsample_flops_per_token(z)


def train_flops_per_step(z: Sizes):
    """Forward and backward as three forwards, over B x W predictions and
    the B rows' speaker offsets."""
    return 3 * (forward_flops_per_token(z) * z.batch * z.window
                + speaker_flops_per_row(z) * z.batch)


def stack_fwd_flops(z: Sizes) -> int:
    """The layer stack's forward over one training batch."""
    return z.L * layer_flops(z) * z.batch * z.window


def stack_bwd_flops(z: Sizes) -> int:
    """The stack's backward: the input and the weight gradients, two
    forwards' worth."""
    return 2 * stack_fwd_flops(z)


def stack_weights(z: Sizes) -> int:
    """The stack's products, V_cond among them."""
    return z.L * (z.K * z.R * 2 * z.R + z.R * (z.R + z.S) + z.M * 2 * z.R)


def stack_biases(z: Sizes) -> int:
    return z.L * (2 * z.R + z.R + z.S)


def offsets(z: Sizes) -> int:
    """The speaker offsets of a batch, [B, L, 2R] (0 without speakers)."""
    return z.batch * z.L * 2 * z.R if z.C else 0


def stack_fwd_bytes(z: Sizes) -> int:
    """In: the embedded input [B, W, R], the features [B, W, M] and the
    weights in bf16, the biases and the offsets in f32.  Out: the skip sum
    [B, W, S] in f32."""
    M = z.batch * z.window
    return (M * (z.R + z.M) * BF16 + stack_weights(z) * BF16
            + (stack_biases(z) + offsets(z)) * F32 + M * z.S * F32)


def stack_bwd_bytes(z: Sizes) -> int:
    """In: the skip cotangent [B, W, S] f32, the input [B, W, R], the
    features [B, W, M] and the weights in bf16, the offsets in f32.  Out:
    the input's and the features' cotangents [B, W, R + M], every weight
    and bias gradient and the offsets' in f32."""
    M = z.batch * z.window
    return (M * z.S * F32 + M * (z.R + z.M) * BF16
            + stack_weights(z) * BF16 + offsets(z) * F32
            + M * (z.R + z.M) * F32
            + (stack_weights(z) + stack_biases(z) + offsets(z)) * F32)


def ring_rows(z: Sizes) -> int:
    return sum(d * (z.K - 1) for d in z.dilations)


def decode_flops(z: Sizes, row_steps: int) -> int:
    """Decode of row_steps (row, step) pairs: the stack and the head of one
    token each (kernel_flops_per_token)."""
    return kernel_flops_per_token(z) * row_steps


def decode_bytes(z: Sizes, launches: int, rows: int, row_steps: int) -> int:
    """Decode launches: each reads the weights (bf16 products, V_cond among
    them, f32 embedding tables and biases) once, reads and writes the rows'
    rings in bf16 and its token carry, and reads each row's speaker offsets
    [L, 2R] in f32; each (row, step) reads its features [M] in bf16 and
    writes one int32 token.  rows: the sum of the launches' batch rows."""
    weights = (stack_weights(z) + z.S * z.S + z.S * z.Q) * BF16 \
        + (2 * z.Q * z.R + stack_biases(z) + z.S + z.Q) * F32
    state = rows * (2 * ring_rows(z) * z.R * BF16 + 2 * I32
                    + (z.L * 2 * z.R * F32 if z.C else 0))
    return launches * weights + state + row_steps * (I32 + z.M * BF16)
