"""WaveNet model core in PyTorch: init and fast autoregressive decode.

Plain functions on a params dict with the JAX package's key names and shapes
(wavenet_tpu/models/wavenet.py), so weights carry over unchanged:

  embed_cur, embed_prev: [Q, E]        w_cur, w_prev: [L, R, 2, R]
  b: [L, 2, R]                         w_res: [L, R, R]   b_res: [L, R]
  w_skip: [L, R, S]   b_skip: [L, S]   head_w1 [S, S], head_b1 [S],
                                       head_w2 [S, Q], head_b2 [Q]

Numerics recipe, the reference's (arXiv:1609.03499 eq.2 with bf16 matmul
inputs and f32 accumulation):
  * embed taps are looked up in f32, added in f32, rounded to bf16 once;
  * z = x @ W_cur + old @ W_prev + b in f32; h = bf16(tanh(z_f) * sigmoid(z_g));
  * the skip sum accumulates in f32; the residual is rounded once:
    x' = bf16(f32(x) + h @ W_res + b_res).
torch's bf16 @ bf16 returns bf16, so every product here rounds its operands
to bf16 and multiplies them in a wider type (`_dot`).  That type is f64,
not f32: a bf16 x bf16 product has at most 16 significant bits, so the
f64 sum of a row's products is exact (barring an exponent spread of ~30
binades), and rounding it once to f32 gives the correctly rounded f32 dot
product whatever the summation order.  A reference that accumulates in
f32 instead rounds differently for every order (cuBLAS, MKL, XLA and a
CUDA kernel all differ), and on the 40-layer `full` stack those last-bit
differences flip a bf16 residual now and then and change greedy tokens
at near-ties on ~2-4% of teacher-forced steps.  With exact sums the CUDA
kernel (which also accumulates in f64) and this plain version agree bit
for bit, and a row's result cannot depend on how many rows share a call
(the serving replay contract).

Only the decode half of the reference is here (kernel_size 2, no mel or
speaker conditioning); forward_logits, loss_fn and score_fn come with the
training slice (ROADMAP queue 1 item 2).  The whole-loop CUDA kernel
(ops/cuda/decode_wide.py) computes the same decode_step loop on the card.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.ops import rng

Params = Dict[str, torch.Tensor]

# the matmuls here are f64 (see above); keep any f32 matmul on a GPU in
# full f32 too, never TF32
torch.backends.cuda.matmul.allow_tf32 = False


def check_supported(cfg: WaveNetConfig) -> None:
    """Raise NotImplementedError for features this slice of the port does
    not serve yet, naming the ROADMAP item that brings them."""
    if cfg.mel is not None:
        raise NotImplementedError(
            "mel conditioning is not ported yet (ROADMAP queue 1 item 6)")
    if cfg.global_classes is not None:
        raise NotImplementedError(
            "speaker (global) conditioning is not ported yet "
            "(ROADMAP queue 1 item 6)")
    if cfg.kernel_size != 2:
        raise NotImplementedError(
            "kernel_size > 2 is not ported yet (ROADMAP queue 1 item 7)")
    if cfg.embed_channels != cfg.residual_channels:
        raise NotImplementedError(
            "causal_channels != residual_channels (w_embed_proj) is not "
            "ported yet (ROADMAP queue 1 item 2)")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: WaveNetConfig, generator: torch.Generator,
                device="cpu") -> Params:
    """Random params with the reference's shapes and distributions: embed
    tables N(0, 0.05^2), stacked Glorot-uniform weights (fan-in from the
    input axis, fan-out from the last), zero biases.  Drawn from
    `generator` (a CPU torch.Generator) and moved to `device`; the values
    are not JAX's (the two RNGs differ)."""
    check_supported(cfg)
    L, R = cfg.num_layers, cfg.residual_channels
    S, Q = cfg.skip_channels, cfg.quantization_channels
    f32 = torch.float32

    def glorot(*shape):
        fan_in = shape[1] if len(shape) == 4 else shape[-2]
        fan_out = shape[-1]
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        u = torch.rand(shape, generator=generator, dtype=f32)
        return (u * 2.0 - 1.0) * limit

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=f32) * 0.05

    params = {
        "embed_cur": normal(Q, R),
        "embed_prev": normal(Q, R),
        "w_cur": glorot(L, R, 2, R),
        "w_prev": glorot(L, R, 2, R),
        "b": torch.zeros(L, 2, R),
        "w_res": glorot(L, R, R),
        "b_res": torch.zeros(L, R),
        "w_skip": glorot(L, R, S),
        "b_skip": torch.zeros(L, S),
        "head_w1": glorot(S, S),
        "head_b1": torch.zeros(S),
        "head_w2": glorot(S, Q),
        "head_b2": torch.zeros(Q),
    }
    return {k: v.to(device) for k, v in params.items()}


# ---------------------------------------------------------------------------
# Numerics helpers
# ---------------------------------------------------------------------------

def _bf(x: torch.Tensor) -> torch.Tensor:
    """Round to bf16 and hold the value in f32 (a no-op round for bf16)."""
    return x.to(torch.bfloat16).to(torch.float32)


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[B, K] x [K, N] -> [B, N] f32: the exact product of the bf16-rounded
    operands (summed in f64), rounded once to f32."""
    f64 = torch.float64
    return (a.to(torch.bfloat16).to(f64)
            @ w.to(torch.bfloat16).to(f64)).to(torch.float32)


# ---------------------------------------------------------------------------
# Embedding and head
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: WaveNetConfig, tokens: torch.Tensor,
                 prev_tokens: torch.Tensor) -> torch.Tensor:
    """E_cur[tokens] + E_prev[prev_tokens], summed in f32 and rounded once
    to bf16 -> residual stream [.., R] (f32 holding bf16 values)."""
    x = (params["embed_cur"].float()[tokens.long()]
         + params["embed_prev"].float()[prev_tokens.long()])
    return _bf(x)


def head_logits(params: Params, cfg: WaveNetConfig,
                skip: torch.Tensor) -> torch.Tensor:
    """skip-sum -> ReLU -> 1x1 -> ReLU -> 1x1 (paper §2.4 Fig 4)."""
    h = torch.relu(skip)
    h = torch.relu(_dot(h, params["head_w1"]) + params["head_b1"].float())
    return _dot(h, params["head_w2"]) + params["head_b2"].float()


# ---------------------------------------------------------------------------
# Fast AR decode (cached ring-buffer queues)
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Carried state of the fast decoder (arXiv:1611.09482 Fig 2).

    queues: [sum_d, B, R] bf16 compact rings: layer l owns rows
      [offset_l, offset_l + d_l); its slot at step t is offset_l + t mod d_l,
      holding layer l's input from step t - d_l (read at t, then
      overwritten with the current input).
    prev_token: [B] int32 token at t-1.
    t: global step (Python int).
    """
    queues: torch.Tensor
    prev_token: torch.Tensor
    t: int


def ring_offsets(cfg: WaveNetConfig) -> Tuple[Tuple[int, ...], int]:
    """Static per-layer ring offsets and the total ring length sum_d."""
    offs, acc = [], 0
    for d in cfg.dilations:
        offs.append(acc)
        acc += d
    return tuple(offs), acc


def decode_init(cfg: WaveNetConfig, batch: int, device="cpu") -> DecodeState:
    _, sum_d = ring_offsets(cfg)
    return DecodeState(
        queues=torch.zeros(sum_d, batch, cfg.residual_channels,
                           dtype=torch.bfloat16, device=device),
        prev_token=torch.zeros(batch, dtype=torch.int32, device=device),
        t=0)


def decode_step(params: Params, cfg: WaveNetConfig, state: DecodeState,
                token: torch.Tensor) -> Tuple[DecodeState, torch.Tensor]:
    """Advance one sample: consume `token` ([B] int32), return the updated
    state and the logits [B, Q] f32 for the next sample.

    Updates state.queues IN PLACE (one [B, R] row per layer) instead of
    copying the [sum_d, B, R] rings every step; callers that need the old
    rings clone them first.  Accepts model-layout params or the kernel
    layout of ops/cuda/decode_wide.flatten_params (same keys, gate axis
    folded, matrices in bf16)."""
    L, R = cfg.num_layers, cfg.residual_channels
    B = token.shape[0]
    w_cur = params["w_cur"].reshape(L, R, 2 * R)
    w_prev = params["w_prev"].reshape(L, R, 2 * R)
    b = params["b"].reshape(L, 2 * R).float()
    b_res, b_skip = params["b_res"].float(), params["b_skip"].float()
    offs, _ = ring_offsets(cfg)
    queues = state.queues

    x = embed_tokens(params, cfg, token, state.prev_token)      # [B, R]
    skip = torch.zeros(B, cfg.skip_channels, device=x.device)
    for l, d in enumerate(cfg.dilations):
        slot = offs[l] + state.t % d
        old = queues[slot].float()
        z = (_dot(x, w_cur[l]) + _dot(old, w_prev[l])) + b[l]   # [B, 2R]
        h = _bf(torch.tanh(z[:, :R]) * torch.sigmoid(z[:, R:]))
        skip = (skip + _dot(h, params["w_skip"][l])) + b_skip[l]
        queues[slot] = x.to(torch.bfloat16)     # this layer's INPUT
        x = _bf((x + _dot(h, params["w_res"][l])) + b_res[l])

    logits = head_logits(params, cfg, skip)
    return DecodeState(queues, token.to(torch.int32), state.t + 1), logits


def sample_tokens(logits: torch.Tensor, t: int, seeds: torch.Tensor,
                  temperature: float) -> torch.Tensor:
    """Gumbel-max over counter-RNG noise keyed by (row seed, global step t,
    class); argmax at temperature <= 0.  Ties take the first index, like
    jnp.argmax.  The scores are logits * f32(1/T) + gumbel: a multiply by
    the reciprocal, not a division, exactly as the reference."""
    if temperature <= 0:
        return torch.argmax(logits, dim=-1).to(torch.int32)
    g = rng.counter_gumbel(seeds, t, logits.shape[-1])
    return torch.argmax(logits * (1.0 / temperature) + g,
                        dim=-1).to(torch.int32)


def decode_prime(params: Params, cfg: WaveNetConfig, batch: int,
                 prime_tokens: Optional[torch.Tensor], device="cpu"):
    """Decode state ready to free-run: teacher-force all but the last
    priming token (the last one seeds sampling), or seed with the mid-scale
    silence token Q // 2.  Returns (state, first token [B])."""
    state = decode_init(cfg, batch, device)
    if prime_tokens is None:
        first = torch.full((batch,), cfg.quantization_channels // 2,
                           dtype=torch.int32, device=device)
        return state, first
    prime_tokens = prime_tokens.to(device=device, dtype=torch.int32)
    for i in range(prime_tokens.shape[1] - 1):
        state, _ = decode_step(params, cfg, state, prime_tokens[:, i])
    return state, prime_tokens[:, -1]


def decode_sample_chunk(params: Params, cfg: WaveNetConfig,
                        state: DecodeState, first: torch.Tensor, n: int,
                        seeds: torch.Tensor, temperature: float = 1.0):
    """`n` free-running sampling steps from `state`, consuming `first`.
    Noise is keyed by the state's global step, so chunking cannot change
    the sample path.  Returns (state, next token [B], samples [B, n])."""
    token, out = first, []
    for _ in range(n):
        t = state.t
        state, logits = decode_step(params, cfg, state, token)
        token = sample_tokens(logits, t, seeds, temperature)
        out.append(token)
    return state, token, torch.stack(out, dim=1)


def generate(params: Params, cfg: WaveNetConfig, num_samples: int,
             batch: int = 1, prime_tokens: Optional[torch.Tensor] = None,
             temperature: float = 1.0, seeds=0, device="cpu") -> torch.Tensor:
    """Plain autoregressive sampling of [batch, num_samples] int32 tokens
    (decode_prime + one decode_sample_chunk).  seeds: an int (per-row seeds
    derived from it) or [batch] per-row counter-RNG seeds."""
    check_supported(cfg)
    seeds = rng.as_row_seeds(seeds, batch, device)
    state, first = decode_prime(params, cfg, batch, prime_tokens, device)
    _, _, samples = decode_sample_chunk(params, cfg, state, first,
                                        num_samples, seeds, temperature)
    return samples
