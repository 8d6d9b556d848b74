"""WaveNet model core in PyTorch: init and fast autoregressive decode.

Plain functions on a params dict with the JAX package's key names and shapes
(wavenet_tpu/models/wavenet.py), so weights carry over unchanged:

  embed_cur, embed_prev: [Q, E]        w_cur, w_prev: [L, R, 2, R]
  b: [L, 2, R]                         w_res: [L, R, R]   b_res: [L, R]
  w_skip: [L, R, S]   b_skip: [L, S]   head_w1 [S, S], head_b1 [S],
                                       head_w2 [S, Q], head_b2 [Q]
  with mel: v_cond [L, M, 2, R] and upsampler {w0, b0, w1, b1, ...}
  (models/conditioning.py), a nested dict as in the reference

Numerics recipe, the reference's (arXiv:1609.03499 eq.2 with bf16 matmul
inputs and f32 accumulation):
  * embed taps are looked up in f32, added in f32, rounded to bf16 once;
  * z = x @ W_cur + old @ W_prev + b in f32, then + y @ V_cond with mel;
    h = bf16(tanh(z_f) * sigmoid(z_g));
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

Kernel_size 2 only, no speaker conditioning (ROADMAP queue 1 items 6, 7).
Two halves:
  * training: forward_logits (the scan recipe: the residual rounded to bf16
    after every layer, autograd through it), forward_logits_fused (the
    fused layer-group recipe of ops/cuda/train_stack.py: f32 carry within
    a group, f32 cotangents), loss_fn and score_fn;
  * decode: decode_step and its drivers; the whole-loop CUDA kernel
    (ops/cuda/decode_wide.py) computes the same loop on the card.
With mel, every layer's gate adds y @ V_cond[l] after the bias, y the
upsampled features: in training from the mel frames (`mel`) or given
upsampled (`upsampled_cond`), in decode as per-step contributions cond_t
(conditioning.project_cond).
"""

from __future__ import annotations

import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import conditioning
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.shift import shift_right

Params = Dict[str, torch.Tensor]

# the matmuls here are f64 (see above); keep any f32 matmul on a GPU in
# full f32 too, never TF32
torch.backends.cuda.matmul.allow_tf32 = False


def check_supported(cfg: WaveNetConfig) -> None:
    """Raise NotImplementedError for features this slice of the port does
    not serve yet, naming the ROADMAP item that brings them."""
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
                device="cuda") -> Params:
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
    if cfg.mel is not None:
        params["v_cond"] = glorot(L, cfg.mel.num_mels, 2, R)
        params["upsampler"] = conditioning.init_upsampler_params(
            cfg.mel, generator, device)
    return {k: v if isinstance(v, dict) else v.to(device)
            for k, v in params.items()}


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
    x = (_Gather.apply(params["embed_cur"].float(), tokens.long())
         + _Gather.apply(params["embed_prev"].float(), prev_tokens.long()))
    return _bf(x)


class _Gather(torch.autograd.Function):
    """table[idx] whose backward is a one-hot product, not a scatter-add:
    on the card the scatter-add of torch's indexing backward sums with
    float atomics (its order changes from run to run), while the product
    onehot(idx)^T @ grad has a fixed order, so two training runs give the
    same bits without switching torch to deterministic algorithms."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.num_rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(idx.reshape(-1), ctx.num_rows)
        g = grad.reshape(-1, grad.shape[-1])
        return onehot.to(g.dtype).T @ g, None


def head_logits(params: Params, cfg: WaveNetConfig,
                skip: torch.Tensor) -> torch.Tensor:
    """skip-sum -> ReLU -> 1x1 -> ReLU -> 1x1 (paper §2.4 Fig 4)."""
    h = torch.relu(skip)
    h = torch.relu(_dot(h, params["head_w1"]) + params["head_b1"].float())
    return _dot(h, params["head_w2"]) + params["head_b2"].float()


# ---------------------------------------------------------------------------
# Full-sequence forward and loss (training)
# ---------------------------------------------------------------------------

def _shifted_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """prev_tokens[t] = tokens[t-1], with a leading zero-token."""
    return torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]], dim=1)


def _layer_step(x, skip, left_ctx, d: int, w_cur, w_prev, b, w_res, b_res,
                w_skip, b_skip, y=None, v_cond=None):
    """One gated residual layer over a whole sequence, the scan recipe:
    z = (x @ W_cur + x[t-d] @ W_prev) + b in f32, then + y @ V_cond when y
    (the upsampled mel features [B, T, M]) is given, h = bf16(tanh * sigmoid),
    skip = (skip + h @ W_skip) + b_skip, and the residual rounded once:
    x' = bf16((x + h @ W_res) + b_res).  x: [B, T, R] f32 holding bf16
    values; w_cur, w_prev: [R, 2, R]; b: [2, R]."""
    R = x.shape[-1]
    x_prev = shift_right(x, d, left_ctx)
    z = ((_dot(x, w_cur.reshape(R, 2 * R)) + _dot(x_prev,
                                                   w_prev.reshape(R, 2 * R)))
         + b.reshape(2 * R).float())
    if y is not None:
        z = z + _dot(y, v_cond.reshape(y.shape[-1], 2 * R))
    h = _bf(torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:]))
    skip = (skip + _dot(h, w_skip)) + b_skip.float()
    x = _bf((x + _dot(h, w_res)) + b_res.float())
    return x, skip


def _mel_features(params: Params, cfg: WaveNetConfig, T: int, mel,
                  upsampled_cond=None) -> Optional[torch.Tensor]:
    """The upsampled features [B, T, M] of a mel model (from `mel` frames,
    or given as `upsampled_cond`), None for an unconditional one."""
    if cfg.mel is None:
        return None
    if upsampled_cond is not None:
        if mel is not None:
            raise ValueError("pass either mel= (frames) or upsampled_cond=")
        return upsampled_cond
    if mel is None:
        raise ValueError("cfg.mel set but no mel features passed")
    return conditioning.upsample_mel(params["upsampler"], cfg.mel, mel, T)


def forward_logits(params: Params, cfg: WaveNetConfig, tokens: torch.Tensor,
                   mel: Optional[torch.Tensor] = None,
                   prev_tokens: Optional[torch.Tensor] = None,
                   valid_mask=None, halo_fn=None,
                   upsampled_cond: Optional[torch.Tensor] = None
                   ) -> torch.Tensor:
    """[B, T] int tokens -> [B, T, Q] f32 logits (logits[t] predicts t+1),
    the reference's scan path: layer by layer, the residual rounded to bf16
    after every layer; autograd differentiates it (cotangents through the
    bf16 roundings are rounded as JAX's transposes round them).  With
    cfg.remat each layer is recomputed in the backward
    (torch.utils.checkpoint), as jax.checkpoint does.  mel: [B, F, M]
    frames (F * hop >= T) of a mel model, or upsampled_cond [B, T, M]."""
    if valid_mask is not None or halo_fn is not None:
        raise NotImplementedError(
            "valid_mask and halo inputs of forward_logits are not ported yet "
            "(ROADMAP queue 1 items 3 and 11)")
    check_supported(cfg)
    B, T = tokens.shape
    prev = _shifted_tokens(tokens) if prev_tokens is None else prev_tokens
    x = embed_tokens(params, cfg, tokens, prev)
    y = _mel_features(params, cfg, T, mel, upsampled_cond)
    skip = torch.zeros(B, T, cfg.skip_channels, device=x.device)
    zeros_ctx = x.new_zeros(B, cfg.max_dilation, cfg.residual_channels)
    for l, d in enumerate(cfg.dilations):
        lp = [params[k][l] for k in ("w_cur", "w_prev", "b", "w_res",
                                     "b_res", "w_skip", "b_skip")]
        if y is not None:
            lp += [y, params["v_cond"][l]]
        if cfg.remat and torch.is_grad_enabled():
            x, skip = checkpoint(_layer_step, x, skip, zeros_ctx, d, *lp,
                                 use_reentrant=False)
        else:
            x, skip = _layer_step(x, skip, zeros_ctx, d, *lp)
    return head_logits(params, cfg, skip)


def forward_logits_fused(params: Params, cfg: WaveNetConfig,
                         tokens: torch.Tensor, tile=None,
                         mel: Optional[torch.Tensor] = None) -> torch.Tensor:
    """forward_logits through the fused layer-group stack
    (ops/cuda/train_stack.py: the CUDA kernels for tensors on the card,
    their plain versions on the CPU); callers check
    train_stack.supported(cfg, T).  With mel the upsampler runs here in
    plain PyTorch (its params train through autograd) and y @ V_cond runs
    inside the stack's kernels."""
    from wavenet_tpu_torch.ops.cuda import train_stack
    check_supported(cfg)
    x = embed_tokens(params, cfg, tokens, _shifted_tokens(tokens))
    y = _mel_features(params, cfg, tokens.shape[1], mel)
    skip = train_stack.forward_skip_fused(params, cfg, x, tile=tile, y=y)
    return head_logits(params, cfg, skip)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def loss_fn(params: Params, cfg: WaveNetConfig, tokens: torch.Tensor,
            mel: Optional[torch.Tensor] = None, use_fused: bool = False,
            tile=None):
    """Next-sample softmax cross-entropy over a [B, W+1] token window:
    inputs tokens[:, :-1], targets tokens[:, 1:]; mel: [B, F, M] frames
    covering the W inputs (mel models).  Returns (loss, aux) with
    aux = {loss, bits_per_sample, accuracy} (0-d tensors)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if use_fused:
        logits = forward_logits_fused(params, cfg, inputs, tile=tile,
                                      mel=mel)
    else:
        logits = forward_logits(params, cfg, inputs, mel=mel)
    loss = _nll(logits, targets).mean()
    aux = {
        "loss": loss,
        "bits_per_sample": loss / math.log(2.0),
        "accuracy": (torch.argmax(logits, dim=-1) == targets.long()
                     ).float().mean(),
    }
    return loss, aux


def score_fn(params: Params, cfg: WaveNetConfig, tokens: torch.Tensor,
             mel: Optional[torch.Tensor] = None,
             use_fused: bool = False) -> torch.Tensor:
    """Per-utterance teacher-forced score: the mean next-sample negative
    log-likelihood in bits per sample, [B], of tokens [B, T+1] (mel: the
    frames of a mel model)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if use_fused:
        logits = forward_logits_fused(params, cfg, inputs, mel=mel)
    else:
        logits = forward_logits(params, cfg, inputs, mel=mel)
    return _nll(logits, targets).mean(dim=-1) / math.log(2.0)


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


def decode_init(cfg: WaveNetConfig, batch: int, device) -> DecodeState:
    _, sum_d = ring_offsets(cfg)
    return DecodeState(
        queues=torch.zeros(sum_d, batch, cfg.residual_channels,
                           dtype=torch.bfloat16, device=device),
        prev_token=torch.zeros(batch, dtype=torch.int32, device=device),
        t=0)


def decode_step(params: Params, cfg: WaveNetConfig, state: DecodeState,
                token: torch.Tensor, cond_t: Optional[torch.Tensor] = None
                ) -> Tuple[DecodeState, torch.Tensor]:
    """Advance one sample: consume `token` ([B] int32), return the updated
    state and the logits [B, Q] f32 for the next sample.  cond_t: [B, L, 2R]
    f32 gate contributions of this step (conditioning.project_cond), added
    after the bias: z = ((x @ W_cur + old @ W_prev) + b) + cond_t[:, l].

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
        if cond_t is not None:
            z = z + cond_t[:, l]
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


def _cond_at(cond, t: int, cond_t0: int = 0):
    return None if cond is None else cond[:, t - cond_t0]


def decode_prime(params: Params, cfg: WaveNetConfig, batch: int,
                 prime_tokens: Optional[torch.Tensor], device,
                 cond: Optional[torch.Tensor] = None, num_samples: int = 0):
    """Decode state ready to free-run: teacher-force all but the last
    priming token (the last one seeds sampling), or seed with the mid-scale
    silence token Q // 2.  cond: [B, total, L, 2R] per-step gate
    contributions (conditioning.prepare_decode_cond) covering the whole
    timeline, max(P - 1, 0) + num_samples steps.  Returns (state, first
    token [B])."""
    state = decode_init(cfg, batch, device)
    P = 0 if prime_tokens is None else prime_tokens.shape[1]
    total = max(P - 1, 0) + num_samples
    if cond is not None and cond.shape[1] < total:
        raise ValueError(f"cond covers {cond.shape[1]} steps < required "
                         f"{total} (max(P-1, 0) + num_samples with P={P})")
    if prime_tokens is None:
        first = torch.full((batch,), cfg.quantization_channels // 2,
                           dtype=torch.int32, device=device)
        return state, first
    prime_tokens = prime_tokens.to(device=device, dtype=torch.int32)
    for i in range(P - 1):
        state, _ = decode_step(params, cfg, state, prime_tokens[:, i],
                               cond_t=_cond_at(cond, state.t))
    return state, prime_tokens[:, -1]


def decode_sample_chunk(params: Params, cfg: WaveNetConfig,
                        state: DecodeState, first: torch.Tensor, n: int,
                        seeds: torch.Tensor, temperature: float = 1.0,
                        cond: Optional[torch.Tensor] = None,
                        cond_t0: int = 0):
    """`n` free-running sampling steps from `state`, consuming `first`.
    Noise is keyed by the state's global step, so chunking cannot change
    the sample path.  cond is indexed by the global step minus cond_t0 (a
    chunked caller passes its chunk's slice).  Returns (state, next token
    [B], samples [B, n])."""
    token, out = first, []
    for _ in range(n):
        t = state.t
        state, logits = decode_step(params, cfg, state, token,
                                    cond_t=_cond_at(cond, t, cond_t0))
        token = sample_tokens(logits, t, seeds, temperature)
        out.append(token)
    return state, token, torch.stack(out, dim=1)


def generate(params: Params, cfg: WaveNetConfig, num_samples: int,
             batch: int = 1, prime_tokens: Optional[torch.Tensor] = None,
             temperature: float = 1.0, seeds=0, device="cuda",
             cond: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain autoregressive sampling of [batch, num_samples] int32 tokens
    (decode_prime + one decode_sample_chunk).  seeds: an int (per-row seeds
    derived from it) or [batch] per-row counter-RNG seeds; cond: the
    per-step gate contributions of a mel model (see decode_prime)."""
    check_supported(cfg)
    if (cond is None) != (cfg.mel is None):
        raise ValueError("cond is required with cfg.mel, and only then")
    seeds = rng.as_row_seeds(seeds, batch, device)
    state, first = decode_prime(params, cfg, batch, prime_tokens, device,
                                cond=cond, num_samples=num_samples)
    _, _, samples = decode_sample_chunk(params, cfg, state, first,
                                        num_samples, seeds, temperature,
                                        cond=cond)
    return samples
