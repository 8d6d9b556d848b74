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
    products, the [R, R] residual and the [R, S] skip product."""
    return 2 * (z.K * z.R * 2 * z.R + z.R * z.R + z.R * z.S)


def head_flops(z: Sizes) -> int:
    """ReLU -> [S, S] -> ReLU -> [S, Q], one token."""
    return 2 * (z.S * z.S + z.S * z.Q)


def forward_flops_per_token(z: Sizes) -> int:
    return z.L * layer_flops(z) + head_flops(z)


def train_flops_per_step(z: Sizes) -> int:
    """Forward and backward as three forwards, over B x W predictions."""
    return 3 * forward_flops_per_token(z) * z.batch * z.window


def stack_fwd_flops(z: Sizes) -> int:
    """The layer stack's forward over one training batch."""
    return z.L * layer_flops(z) * z.batch * z.window


def stack_bwd_flops(z: Sizes) -> int:
    """The stack's backward: the input and the weight gradients, two
    forwards' worth."""
    return 2 * stack_fwd_flops(z)


def stack_weights(z: Sizes) -> int:
    return z.L * (z.K * z.R * 2 * z.R + z.R * (z.R + z.S))


def stack_biases(z: Sizes) -> int:
    return z.L * (2 * z.R + z.R + z.S)


def stack_fwd_bytes(z: Sizes) -> int:
    """In: the embedded input [B, W, R] and the weights in bf16, the biases
    in f32.  Out: the skip sum [B, W, S] in f32."""
    M = z.batch * z.window
    return (M * z.R * BF16 + stack_weights(z) * BF16 + stack_biases(z) * F32
            + M * z.S * F32)


def stack_bwd_bytes(z: Sizes) -> int:
    """In: the skip cotangent [B, W, S] f32, the input [B, W, R] and the
    weights in bf16.  Out: the input's cotangent [B, W, R] and every weight
    and bias gradient in f32."""
    M = z.batch * z.window
    return (M * z.S * F32 + M * z.R * BF16 + stack_weights(z) * BF16
            + M * z.R * F32 + (stack_weights(z) + stack_biases(z)) * F32)


def ring_rows(z: Sizes) -> int:
    return sum(d * (z.K - 1) for d in z.dilations)


def decode_flops(z: Sizes, row_steps: int) -> int:
    """Decode of row_steps (row, step) pairs: one forward token each."""
    return forward_flops_per_token(z) * row_steps


def decode_bytes(z: Sizes, launches: int, rows: int, row_steps: int) -> int:
    """Decode launches: each reads the weights (bf16 products, f32 embedding
    tables and biases) once, reads and writes the rows' rings in bf16 and
    its token carry; each (row, step) writes one int32 token.  rows: the sum
    of the launches' batch rows."""
    weights = (stack_weights(z) + z.S * z.S + z.S * z.Q) * BF16 \
        + (2 * z.Q * z.R + stack_biases(z) + z.S + z.Q) * F32
    state = rows * (2 * ring_rows(z) * z.R * BF16 + 2 * I32)
    return launches * weights + state + row_steps * I32
