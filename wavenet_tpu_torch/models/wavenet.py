"""WaveNet model core in PyTorch: init and fast autoregressive decode.

Plain functions on a params dict with the JAX package's key names and shapes
(wavenet_tpu/models/wavenet.py), so weights carry over unchanged:

  embed_cur, embed_prev: [Q, E]        w_cur, w_prev: [L, R, 2, R]
  b: [L, 2, R]                         w_res: [L, R, R]   b_res: [L, R]
  w_skip: [L, R, S]   b_skip: [L, S]   head_w1 [S, S], head_b1 [S],
                                       head_w2 [S, Q], head_b2 [Q]
  with mel: v_cond [L, M, 2, R] and upsampler {w0, b0, w1, b1, ...}
  (models/conditioning.py), a nested dict as in the reference
  with speakers (global_classes C): g_embed [C, G], v_global [L, G, 2, R]

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

Every config the reference takes, in two halves:
  * training: forward_logits (the scan recipe: the residual rounded to the
    compute dtype after every layer, autograd through it),
    forward_logits_fused (the fused layer-group recipe of
    ops/cuda/train_stack.py: f32 carry within a group, f32 cotangents),
    loss_fn and score_fn;
  * decode: decode_step and its drivers; the whole-loop CUDA kernels
    (ops/cuda/decode.py, ops/cuda/decode_wide.py) compute the same loop on
    the card for the configs the reference's kernels take.
cfg.compute_dtype sets the type of every matmul operand, activation,
residual and ring, as the reference's _dtype(cfg) does: "bfloat16" rounds
them as described above; "float16" rounds them to f16 the same way (an
f16 x f16 product has at most 22 significant bits, so the f64 sums stay
exact); "float32" keeps them in f32 (the products still summed in f64 and
rounded once to f32).  cfg.param_dtype ("float32", "bfloat16" or
"float16") is the dtype of every leaf, as the reference's init_params
draws them: each matmul casts its weight to the compute dtype, each bias
and embedding lookup is read in f32 (the embedding's taps summed in the
table's dtype first, as the reference's gather adds them), and autograd
hands each leaf its gradient in its own dtype.  kernel_size K > 2 adds
the taps w_prevk [L, K-2, R, 2, R] at distances 2d..(K-1)d and embed_prevk
[K-2, Q, E] at t-2..t-(K-1); causal_channels E != R adds w_embed_proj
[E, R] after the embedding.  The CUDA kernels take none of these three
(bf16 compute, K = 2, E = R only, as the reference's Pallas kernels
compute in bf16): such models, f16- and f32-compute ones among them,
train and decode here, on the plain path, on any device.  The kernels
take every param_dtype (their operands are cast to bf16, their biases to
f32).
With mel, every layer's gate adds y @ V_cond[l] after the bias, y the
upsampled features: in training from the mel frames (`mel`) or given
upsampled (`upsampled_cond`), in decode as per-step contributions cond_t
(conditioning.project_cond).  With a speaker, the gate then adds the
time-constant offset g[l] = g_embed[speaker] @ v_global[l]
(global_cond_offsets, paper eq.2), one function for training, scoring
and decode, so all three see the same g.
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


_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
           "float32": torch.float32}


def compute_dtype(cfg: WaveNetConfig) -> torch.dtype:
    """The torch dtype of cfg.compute_dtype (matmul operands, activations,
    the residual stream and the decode rings)."""
    check_supported(cfg)
    return _DTYPES[cfg.compute_dtype]


def param_dtype(cfg: WaveNetConfig) -> torch.dtype:
    """The torch dtype of cfg.param_dtype (every leaf, Adam's moments and
    the EMA)."""
    check_supported(cfg)
    return _DTYPES[cfg.param_dtype]


def check_supported(cfg: WaveNetConfig) -> None:
    """Raise NotImplementedError for a compute or param dtype outside the
    reference's floating types (bfloat16, float16, float32)."""
    for field in ("compute_dtype", "param_dtype"):
        if getattr(cfg, field) not in _DTYPES:
            raise NotImplementedError(
                f"{field}={getattr(cfg, field)!r}: the port takes "
                f"{sorted(_DTYPES)}")


def check_trainable(cfg: WaveNetConfig) -> None:
    """Refuse what the training half (forward, loss, score, trainer) does
    not take: the port trains every model it serves, so this is
    check_supported."""
    check_supported(cfg)


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(cfg: WaveNetConfig, generator: torch.Generator,
                device="cuda") -> Params:
    """Random params with the reference's shapes and distributions: embed
    tables (and g_embed, embed_prevk) N(0, 0.05^2), stacked Glorot-uniform
    weights (fan-in from the input axis, fan-out from the last), zero
    biases.  Drawn in f32 from `generator` (a CPU torch.Generator), cast to
    cfg.param_dtype and moved to `device`; the values are not JAX's (the
    two RNGs differ), the dtypes are.  The leaves of K > 2 and E != R are
    drawn last, so a K = 2, E = R model draws what it drew before they
    existed, and a model of any param_dtype draws the same f32 values."""
    pdt = param_dtype(cfg)
    L, R = cfg.num_layers, cfg.residual_channels
    S, Q = cfg.skip_channels, cfg.quantization_channels
    E, K = cfg.embed_channels, cfg.kernel_size
    f32 = torch.float32

    def glorot(*shape):
        # the leading L (and K-2) axes and the gate axis are batch axes
        fan_in = shape[-3] if len(shape) >= 4 else shape[-2]
        fan_out = shape[-1]
        limit = (6.0 / (fan_in + fan_out)) ** 0.5
        u = torch.rand(shape, generator=generator, dtype=f32)
        return (u * 2.0 - 1.0) * limit

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=f32) * 0.05

    params = {
        "embed_cur": normal(Q, E),
        "embed_prev": normal(Q, E),
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
            cfg.mel, generator, device, pdt)
    if cfg.global_classes is not None:
        G = cfg.global_channels
        params["g_embed"] = normal(cfg.global_classes, G)
        params["v_global"] = glorot(L, G, 2, R)
    if K > 2:
        params["w_prevk"] = glorot(L, K - 2, R, 2, R)
        params["embed_prevk"] = normal(K - 2, Q, E)
    if E != R:
        params["w_embed_proj"] = glorot(E, R)
    return {k: v if isinstance(v, dict) else v.to(device=device, dtype=pdt)
            for k, v in params.items()}


# ---------------------------------------------------------------------------
# Numerics helpers
# ---------------------------------------------------------------------------

def _round(x: torch.Tensor, cdt=torch.bfloat16) -> torch.Tensor:
    """Round to the compute dtype cdt and hold the value in f32 (a no-op
    for f32)."""
    return x.to(cdt).to(torch.float32)


def _dot(a: torch.Tensor, w: torch.Tensor, cdt=torch.bfloat16) -> torch.Tensor:
    """[B, K] x [K, N] -> [B, N] f32: the product of the operands rounded
    to the compute dtype cdt, summed in f64 (exact for bf16 operands) and
    rounded once to f32."""
    f64 = torch.float64
    return (a.to(cdt).to(f64) @ w.to(cdt).to(f64)).to(torch.float32)


def global_cond_offsets(params: Params, cfg: WaveNetConfig,
                        speaker: torch.Tensor, tp=None) -> torch.Tensor:
    """Speaker ids [B] -> per-layer gate offsets [L, B, 2, R] f32 (paper
    eq.2: one time-constant offset per layer and row, computed once per
    request batch): g_embed[speaker] @ v_global[l] with bf16 operands,
    each dot summed exactly and rounded once (_dot; f16 or f32 operands
    at compute_dtype float16 or float32).  Accepts model-layout params or
    the decode kernels' layout (v_global folded to [L, G, 2R]).  The
    lookup is a _Gather, so in training two rows of one speaker add their
    gradients in a fixed order (bit-exact resume).  v_global may be a
    slice of the layers (a pipeline stage's, [L/mp, ..]) or of the gate
    columns (a Megatron rank's, [L, G, 2, R/mp], with tp its split): the
    offsets are then that slice's."""
    G = cfg.global_channels
    cdt = compute_dtype(cfg)
    gvec = _Gather.apply(params["g_embed"].float(), speaker.long())  # [B, G]
    if tp is not None:
        gvec = tp.enter(gvec)
    v = params["v_global"]
    L = v.shape[0]
    v = v.reshape(L, G, -1)
    return torch.stack([_dot(gvec, v[l], cdt) for l in range(L)]).reshape(
        L, -1, 2, v.shape[-1] // 2)


# ---------------------------------------------------------------------------
# Embedding and head
# ---------------------------------------------------------------------------

def embed_tokens(params: Params, cfg: WaveNetConfig, tokens: torch.Tensor,
                 prev_tokens: torch.Tensor,
                 prev_extra: Optional[torch.Tensor] = None) -> torch.Tensor:
    """E_cur[tokens] + E_prev[prev_tokens] (+ embed_prevk[j][prev_extra[j]]
    for the taps at t-2..t-(K-1) of a kernel_size K > 2 model), summed in
    the tables' dtype (f32 at param_dtype float32; each add rounded to a
    bf16 or f16 table's type, as the reference's gathers add) and rounded
    once to the compute dtype; a model with E != R then projects: x =
    round(x @ w_embed_proj).  -> residual stream [.., R] (f32 holding
    compute-dtype values).  prev_extra: [K-2, *tokens.shape]."""
    cdt = compute_dtype(cfg)
    x = (_Gather.apply(params["embed_cur"], tokens.long())
         + _Gather.apply(params["embed_prev"], prev_tokens.long()))
    ek = params.get("embed_prevk")
    if ek is not None:
        if prev_extra is None:
            raise ValueError("kernel_size > 2 model: embed_tokens needs the "
                             "prev_extra taps (tokens at t-2..t-(K-1))")
        for j in range(ek.shape[0]):
            x = x + _Gather.apply(ek[j], prev_extra[j].long())
    x = _round(x.float(), cdt)
    if "w_embed_proj" in params:
        x = _round(_dot(x, params["w_embed_proj"], cdt), cdt)
    return x


class _Gather(torch.autograd.Function):
    """table[idx] whose backward is a one-hot product, not a scatter-add:
    on the card the scatter-add of torch's indexing backward sums with
    float atomics (its order changes from run to run), while the product
    onehot(idx)^T @ grad has a fixed order, so two training runs give the
    same bits without switching torch to deterministic algorithms.  The
    product is taken in f32 and rounded once to the table's dtype."""

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
        return (onehot.float().T @ g.float()).to(grad.dtype), None


def head_logits(params: Params, cfg: WaveNetConfig,
                skip: torch.Tensor, tp=None) -> torch.Tensor:
    """skip-sum -> ReLU -> 1x1 -> ReLU -> 1x1 (paper §2.4 Fig 4).  With a
    Megatron split tp, head_w2 and head_b2 are this rank's class slices
    and the logits are its [.., Q/mp] columns."""
    cdt = compute_dtype(cfg)
    h = torch.relu(skip)
    h = torch.relu(_dot(h, params["head_w1"], cdt)
                   + params["head_b1"].float())
    if tp is not None:
        h = tp.enter(h)
    return _dot(h, params["head_w2"], cdt) + params["head_b2"].float()


# ---------------------------------------------------------------------------
# Full-sequence forward and loss (training)
# ---------------------------------------------------------------------------

def _shifted_tokens(tokens: torch.Tensor) -> torch.Tensor:
    """prev_tokens[t] = tokens[t-1], with a leading zero-token."""
    return torch.cat([torch.zeros_like(tokens[:, :1]), tokens[:, :-1]], dim=1)


def _shifted_tokens_extra(tokens: torch.Tensor, K: int) -> torch.Tensor:
    """[K-2, B, T] with entry j-2 holding tokens[t-j], zero-token filled
    before the sequence start: the extra embed taps of kernel_size K > 2.
    Pad-then-slice keeps the width at T even when T <= j."""
    T = tokens.shape[1]
    return torch.stack([torch.nn.functional.pad(tokens, (j, 0))[:, :T]
                        for j in range(2, K)])


def _layer_step(x, skip, left_ctx, d: int, w_cur, w_prev, b, w_res, b_res,
                w_skip, b_skip, y=None, v_cond=None, gcond=None,
                w_prevk=None, cdt=torch.bfloat16, tp=None):
    """One gated residual layer over a whole sequence, the scan recipe:
    z = (x @ W_cur + x[t-d] @ W_prev) [+ x[t-jd] @ W_prevk[j-2] for the
    taps j = 2..K-1 of a K > 2 model] + b in f32, then + y @ V_cond when y
    (the upsampled mel features [B, T, M]) is given, then + gcond (the
    speaker offsets [B, 2, R], broadcast over time), h = round(tanh *
    sigmoid), skip = (skip + h @ W_skip) + b_skip, and the residual rounded
    once: x' = round((x + h @ W_res) + b_res), every round to the compute
    dtype cdt.  x: [B, T, R] f32 holding cdt values; w_cur, w_prev:
    [R, 2, R]; b: [2, R]; w_prevk: [K-2, R, 2, R]; left_ctx: the
    (K-1) maxd samples before x.
    tp: a Megatron split (parallel/megatron.ModelSplit): the gate weights
    are this rank's column slices [.., 2, R/mp] and w_res, w_skip its row
    slices [R/mp, ..]; x and left_ctx enter the column products through
    tp.enter and the row products' exact partial sums are added over the
    model axis by tp.row_dot, so x and skip stay whole and replicated."""
    R, Rh = x.shape[-1], w_cur.shape[-1]
    row_dot = _dot if tp is None else tp.row_dot
    x_in = x
    if tp is not None:
        x_in, left_ctx = tp.enter(x), tp.enter(left_ctx)
    x_prev = shift_right(x_in, d, left_ctx)
    z = (_dot(x_in, w_cur.reshape(R, 2 * Rh), cdt)
         + _dot(x_prev, w_prev.reshape(R, 2 * Rh), cdt))
    if w_prevk is not None:              # the order of decode_step's taps
        for j in range(w_prevk.shape[0]):
            z = z + _dot(shift_right(x_in, (j + 2) * d, left_ctx),
                         w_prevk[j].reshape(R, 2 * Rh), cdt)
    z = z + b.reshape(2 * Rh).float()
    if y is not None:
        z = z + _dot(y, v_cond.reshape(y.shape[-1], 2 * Rh), cdt)
    if gcond is not None:
        z = z + gcond.reshape(-1, 1, 2 * Rh)
    h = _round(torch.tanh(z[..., :Rh]) * torch.sigmoid(z[..., Rh:]), cdt)
    skip = (skip + row_dot(h, w_skip, cdt)) + b_skip.float()
    x = _round((x + row_dot(h, w_res, cdt)) + b_res.float(), cdt)
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
    return conditioning.upsample_mel_train(params["upsampler"], cfg.mel, mel,
                                           T)


def _speaker_offsets(params: Params, cfg: WaveNetConfig,
                     speaker, tp=None) -> Optional[torch.Tensor]:
    """The speaker offsets [L, B, 2, R] of a speaker model's ids (None for
    another model); ids are required with cfg.global_classes, and only
    then (the reference's check, models/wavenet.py:338-341)."""
    if cfg.global_classes is None:
        if speaker is not None:
            raise ValueError("model has no global conditioning; speaker= "
                             "is not an input")
        return None
    if speaker is None:
        raise ValueError("cfg.global_classes set but no speaker ids passed")
    return global_cond_offsets(params, cfg, torch.as_tensor(
        speaker, device=params["g_embed"].device), tp)


def forward_logits(params: Params, cfg: WaveNetConfig, tokens: torch.Tensor,
                   mel: Optional[torch.Tensor] = None,
                   prev_tokens: Optional[torch.Tensor] = None,
                   valid_mask=None, halo_fn=None,
                   upsampled_cond: Optional[torch.Tensor] = None,
                   speaker=None,
                   prev_tokens_extra: Optional[torch.Tensor] = None,
                   tp=None) -> torch.Tensor:
    """[B, T] int tokens -> [B, T, Q] f32 logits (logits[t] predicts t+1),
    the reference's scan path: layer by layer, the residual rounded to the
    compute dtype after every layer; autograd differentiates it
    (cotangents through the bf16 roundings are rounded as JAX's transposes
    round them).  With cfg.remat each layer is recomputed in the backward
    (torch.utils.checkpoint), as jax.checkpoint does.  mel: [B, F, M]
    frames (F * hop >= T) of a mel model, or upsampled_cond [B, T, M];
    speaker: [B] int ids of a speaker model.
    prev_tokens: [B, T] tokens at t-1 (default: tokens shifted right, a
      zero-token first); prev_tokens_extra: [K-2, B, T] tokens at
      t-2..t-(K-1) of a kernel_size K > 2 model (default: zero-filled
      shifts).  The naive oracle passes its window's true history in both.
    valid_mask: [B, T] 0/1, the positions that exist.  The carry is zeroed
      at masked positions before every layer, so each dilated read of one
      returns the zero padding a shorter sequence would see: logits at
      valid positions equal those of the valid suffix alone (the
      reference's contract, wavenet_tpu/models/wavenet.py:272-281).
    halo_fn: x [B, T, R] -> the [B, (K-1) maxd, R] left context of a
      layer whose input is x, in place of zeros (the sequence start): the
      sequence-parallel scan passes the previous time shard's tail
      (parallel/seqpar.py), which keeps the math that of the unsharded
      forward.  upsampled_cond: [B, T, M] features already upsampled (the
      sequence-parallel path upsamples before it splits time), in place
      of mel.
    tp: a Megatron split of the params over the model axis
      (parallel/megatron.ModelSplit; see _layer_step): the logits are
      then this rank's [B, T, Q/mp] class columns."""
    check_trainable(cfg)
    B, T = tokens.shape
    K, cdt = cfg.kernel_size, compute_dtype(cfg)
    prev = _shifted_tokens(tokens) if prev_tokens is None else prev_tokens
    prev_extra = None
    if K > 2:
        prev_extra = (_shifted_tokens_extra(tokens, K)
                      if prev_tokens_extra is None else prev_tokens_extra)
    x = embed_tokens(params, cfg, tokens, prev, prev_extra)
    y = _mel_features(params, cfg, T, mel, upsampled_cond)
    if y is not None and tp is not None:
        y = tp.enter(y)
    g = _speaker_offsets(params, cfg, speaker, tp)
    vmask = (None if valid_mask is None else
             torch.as_tensor(valid_mask, device=x.device).float()[..., None])
    skip = torch.zeros(B, T, cfg.skip_channels, device=x.device)
    zeros_ctx = x.new_zeros(B, (K - 1) * cfg.max_dilation,
                            cfg.residual_channels)
    for l, d in enumerate(cfg.dilations):
        lp = [params[k][l] for k in ("w_cur", "w_prev", "b", "w_res",
                                     "b_res", "w_skip", "b_skip")]
        kw = {"cdt": cdt, "tp": tp}
        if y is not None:
            kw.update(y=y, v_cond=params["v_cond"][l])
        if g is not None:
            kw["gcond"] = g[l]
        if K > 2:
            kw["w_prevk"] = params["w_prevk"][l]
        if vmask is not None:
            x = x * vmask
        # the halo is exchanged here, outside a remat'd layer, so the
        # backward's recompute does not exchange it again
        ctx = zeros_ctx if halo_fn is None else halo_fn(x)
        if cfg.remat and torch.is_grad_enabled():
            x, skip = checkpoint(_layer_step, x, skip, ctx, d, *lp,
                                 use_reentrant=False, **kw)
        else:
            x, skip = _layer_step(x, skip, ctx, d, *lp, **kw)
    return head_logits(params, cfg, skip, tp)


def forward_logits_fused(params: Params, cfg: WaveNetConfig,
                         tokens: torch.Tensor, tile=None,
                         mel: Optional[torch.Tensor] = None,
                         speaker=None) -> torch.Tensor:
    """forward_logits through the fused layer-group stack
    (ops/cuda/train_stack.py: the CUDA kernels for tensors on the card,
    their plain versions on the CPU); callers check
    train_stack.supported(cfg, T).  With mel the upsampler runs here in
    plain PyTorch (its params train through autograd) and y @ V_cond runs
    inside the stack's kernels; with a speaker the offsets g are computed
    here (g_embed and v_global train through autograd) and added inside
    the kernels.  The stack computes in bf16 at kernel_size 2 with E = R
    only: any other model is refused here (it trains on the scan)."""
    from wavenet_tpu_torch.ops.cuda import train_stack
    check_trainable(cfg)
    if not train_stack.config_taken(cfg):
        raise ValueError(
            "the fused stack takes kernel_size 2, causal_channels == "
            "residual_channels and compute_dtype bfloat16 only; this model "
            "trains on the scan (forward_logits)")
    x = embed_tokens(params, cfg, tokens, _shifted_tokens(tokens))
    y = _mel_features(params, cfg, tokens.shape[1], mel)
    g = _speaker_offsets(params, cfg, speaker)
    skip = train_stack.forward_skip_fused(params, cfg, x, tile=tile, y=y,
                                          g=g)
    return head_logits(params, cfg, skip)


def _nll(logits: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def loss_fn(params: Params, cfg: WaveNetConfig, tokens: torch.Tensor,
            mel: Optional[torch.Tensor] = None, use_fused: bool = False,
            tile=None, speaker=None):
    """Next-sample softmax cross-entropy over a [B, W+1] token window:
    inputs tokens[:, :-1], targets tokens[:, 1:]; mel: [B, F, M] frames
    covering the W inputs (mel models); speaker: [B] int ids (speaker
    models).  Returns (loss, aux) with aux = {loss, bits_per_sample,
    accuracy} (0-d tensors)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if use_fused:
        logits = forward_logits_fused(params, cfg, inputs, tile=tile,
                                      mel=mel, speaker=speaker)
    else:
        logits = forward_logits(params, cfg, inputs, mel=mel,
                                speaker=speaker)
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
             use_fused: bool = False, speaker=None) -> torch.Tensor:
    """Per-utterance teacher-forced score: the mean next-sample negative
    log-likelihood in bits per sample, [B], of tokens [B, T+1] (mel: the
    frames of a mel model; speaker: the [B] ids of a speaker model)."""
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if use_fused:
        logits = forward_logits_fused(params, cfg, inputs, mel=mel,
                                      speaker=speaker)
    else:
        logits = forward_logits(params, cfg, inputs, mel=mel,
                                speaker=speaker)
    return _nll(logits, targets).mean(dim=-1) / math.log(2.0)


# ---------------------------------------------------------------------------
# Fast AR decode (cached ring-buffer queues)
# ---------------------------------------------------------------------------

class DecodeState(NamedTuple):
    """Carried state of the fast decoder (arXiv:1611.09482 Fig 2).

    queues: [sum_d, B, R] compact rings in the compute dtype: layer l owns
      rows [offset_l, offset_l + d_l (K-1)); at step t it writes its input
      to slot offset_l + t mod (d_l (K-1)) after reading tap j (j = 1..K-1)
      at offset_l + (t - j d_l) mod (d_l (K-1)), its input from step
      t - j d_l (zero before the sequence start).  At K = 2 that is the
      length-d FIFO: read slot t mod d, then overwrite it.
    prev_token: [B] int32 token at t-1 (K = 2); [B, K-1] for K > 2, column
      j-1 holding the token at t-j.
    t: global step (Python int).
    """
    queues: torch.Tensor
    prev_token: torch.Tensor
    t: int


def ring_offsets(cfg: WaveNetConfig) -> Tuple[Tuple[int, ...], int]:
    """Static per-layer ring offsets and the total ring length: layer l's
    ring is d_l (K-1) rows, the history of its K-1 taps."""
    offs, acc = [], 0
    for d in cfg.dilations:
        offs.append(acc)
        acc += d * (cfg.kernel_size - 1)
    return tuple(offs), acc


def decode_init(cfg: WaveNetConfig, batch: int, device) -> DecodeState:
    _, sum_d = ring_offsets(cfg)
    K = cfg.kernel_size
    prev = (torch.zeros(batch, dtype=torch.int32, device=device) if K == 2
            else torch.zeros(batch, K - 1, dtype=torch.int32, device=device))
    return DecodeState(
        queues=torch.zeros(sum_d, batch, cfg.residual_channels,
                           dtype=compute_dtype(cfg), device=device),
        prev_token=prev, t=0)


def decode_step(params: Params, cfg: WaveNetConfig, state: DecodeState,
                token: torch.Tensor, cond_t: Optional[torch.Tensor] = None,
                gcond: Optional[torch.Tensor] = None
                ) -> Tuple[DecodeState, torch.Tensor]:
    """Advance one sample: consume `token` ([B] int32), return the updated
    state and the logits [B, Q] f32 for the next sample.  cond_t: [B, L, 2R]
    f32 gate contributions of this step (conditioning.project_cond), added
    after the bias: z = ((x @ W_cur + old @ W_prev) + b) + cond_t[:, l]
    (a K > 2 model adds its taps old_j @ W_prevk[j-2] before the bias);
    gcond: the speaker offsets [L, B, 2R] (or [L, B, 2, R]) f32 of
    global_cond_offsets, added after that: z = z + gcond[l].

    Updates state.queues IN PLACE (one [B, R] row per layer) instead of
    copying the [sum_d, B, R] rings every step; callers that need the old
    rings clone them first.  Accepts model-layout params or the kernel
    layout of ops/cuda/decode_common.flatten_params (same keys, gate axis
    folded)."""
    L, R, K = cfg.num_layers, cfg.residual_channels, cfg.kernel_size
    cdt = compute_dtype(cfg)
    B = token.shape[0]
    w_cur = params["w_cur"].reshape(L, R, 2 * R)
    w_prev = params["w_prev"].reshape(L, R, 2 * R)
    w_prevk = (None if K == 2 else
               params["w_prevk"].reshape(L, K - 2, R, 2 * R))
    b = params["b"].reshape(L, 2 * R).float()
    b_res, b_skip = params["b_res"].float(), params["b_skip"].float()
    offs, _ = ring_offsets(cfg)
    queues = state.queues

    if K == 2:
        x = embed_tokens(params, cfg, token, state.prev_token)  # [B, R]
    else:
        x = embed_tokens(params, cfg, token, state.prev_token[:, 0],
                         state.prev_token[:, 1:].T)
    skip = torch.zeros(B, cfg.skip_channels, device=x.device)
    for l, d in enumerate(cfg.dilations):
        ring = d * (K - 1)
        old = [queues[offs[l] + (state.t - j * d) % ring].float()
               for j in range(1, K)]                   # taps at t - j d
        z = _dot(x, w_cur[l], cdt) + _dot(old[0], w_prev[l], cdt)
        for j in range(K - 2):
            z = z + _dot(old[j + 1], w_prevk[l, j], cdt)
        z = z + b[l]                                     # [B, 2R]
        if cond_t is not None:
            z = z + cond_t[:, l]
        if gcond is not None:
            z = z + gcond[l].reshape(B, 2 * R)
        h = _round(torch.tanh(z[:, :R]) * torch.sigmoid(z[:, R:]), cdt)
        skip = (skip + _dot(h, params["w_skip"][l], cdt)) + b_skip[l]
        queues[offs[l] + state.t % ring] = x.to(cdt)   # this layer's INPUT
        x = _round((x + _dot(h, params["w_res"][l], cdt)) + b_res[l], cdt)

    logits = head_logits(params, cfg, skip)
    token = token.to(torch.int32)
    prev = (token if K == 2 else
            torch.cat([token[:, None], state.prev_token[:, :-1]], dim=1))
    return DecodeState(queues, prev, state.t + 1), logits


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
                 cond: Optional[torch.Tensor] = None, num_samples: int = 0,
                 gcond: Optional[torch.Tensor] = None):
    """Decode state ready to free-run: teacher-force all but the last
    priming token (the last one seeds sampling), or seed with the mid-scale
    silence token Q // 2.  cond: [B, total, L, 2R] per-step gate
    contributions (conditioning.prepare_decode_cond) covering the whole
    timeline, max(P - 1, 0) + num_samples steps; gcond: the speaker
    offsets (decode_step).  Returns (state, first token [B])."""
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
                               cond_t=_cond_at(cond, state.t), gcond=gcond)
    return state, prime_tokens[:, -1]


def decode_sample_chunk(params: Params, cfg: WaveNetConfig,
                        state: DecodeState, first: torch.Tensor, n: int,
                        seeds: torch.Tensor, temperature: float = 1.0,
                        cond: Optional[torch.Tensor] = None,
                        cond_t0: int = 0,
                        gcond: Optional[torch.Tensor] = None):
    """`n` free-running sampling steps from `state`, consuming `first`.
    Noise is keyed by the state's global step, so chunking cannot change
    the sample path.  cond is indexed by the global step minus cond_t0 (a
    chunked caller passes its chunk's slice); gcond as in decode_step.
    Returns (state, next token [B], samples [B, n])."""
    token, out = first, []
    for _ in range(n):
        t = state.t
        state, logits = decode_step(params, cfg, state, token,
                                    cond_t=_cond_at(cond, t, cond_t0),
                                    gcond=gcond)
        token = sample_tokens(logits, t, seeds, temperature)
        out.append(token)
    return state, token, torch.stack(out, dim=1)


def generate(params: Params, cfg: WaveNetConfig, num_samples: int,
             batch: int = 1, prime_tokens: Optional[torch.Tensor] = None,
             temperature: float = 1.0, seeds=0, device="cuda",
             cond: Optional[torch.Tensor] = None,
             speaker: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Plain autoregressive sampling of [batch, num_samples] int32 tokens
    (decode_prime + one decode_sample_chunk).  seeds: an int (per-row seeds
    derived from it) or [batch] per-row counter-RNG seeds; cond: the
    per-step gate contributions of a mel model (see decode_prime);
    speaker: [batch] int ids of a speaker-conditioned model."""
    if (cond is None) != (cfg.mel is None):
        raise ValueError("cond is required with cfg.mel, and only then")
    if (speaker is None) != (cfg.global_classes is None):
        raise ValueError("speaker is required with cfg.global_classes, "
                         "and only then")
    gcond = (None if speaker is None else global_cond_offsets(
        params, cfg, torch.as_tensor(speaker, device=device)))
    seeds = rng.as_row_seeds(seeds, batch, device)
    state, first = decode_prime(params, cfg, batch, prime_tokens, device,
                                cond=cond, num_samples=num_samples,
                                gcond=gcond)
    _, _, samples = decode_sample_chunk(params, cfg, state, first,
                                        num_samples, seeds, temperature,
                                        cond=cond, gcond=gcond)
    return samples
