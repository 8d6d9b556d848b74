"""What the two whole-loop decode kernels share: the kernel-layout weights,
the plain PyTorch version of a launch, the drivers' set-up, and the
operand checks of the wrappers.

The narrow kernel (ops/cuda/decode.py, R < 128) and the wide one
(ops/cuda/decode_wide.py, R a multiple of 128) compute the same loop on the
same layout: rings [sum_d, B, R] bf16, carry [B, 2] int32, weights as
`flatten_params` gives them.  The reference's narrow kernel transposes its
rings to [sum_d, R, B] only to put the batch on TPU lanes
(wavenet_tpu/ops/pallas/decode.py:38-41); the card has no lanes to fill, so
one plain version (`decode_chunk_reference`), one `setup_decode` and one
`cond_timeline` serve both kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import conditioning
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import build


class DecodeWeights(dict):
    """Model params in the kernels' layout (same key names): embed tables
    f32 [Q, E]; w_cur/w_prev [L, R, 2R] (gate axis folded, [in, out]);
    w_res [L, R, R]; w_skip [L, R, S]; head_w1/head_w2; biases f32 with the
    gate axis folded (b [L, 2R]); dils int32 [L]; with mel, v_cond
    [L, M, 2R]; with speakers, g_embed f32 [C, G] and v_global [L, G, 2R]
    (read by speaker_offsets, not the kernels).  Matrices are held in the
    compute dtype (bf16, the kernels' type; f16 or f32 for such a model).
    A model no kernel takes also carries w_prevk [L, K-2, R, 2R] and
    embed_prevk [K-2, Q, E] (K > 2) and w_embed_proj [E, R] (E != R)
    for the plain route, and keeps its embed tables in param_dtype: its
    taps are then summed in the tables' dtype, as the reference's scan
    decoder sums them (the kernels, like the reference's, sum f32 tables
    once; for bf16 or f32 tables at K = 2 the two are the same bits)."""


def embed_dtype(cfg: WaveNetConfig) -> torch.dtype:
    """The dtype of the decode layout's embed tables: f32 for the
    kernels' family (kernel_size 2, E = R, bf16 compute), whose taps the
    kernels sum in f32; cfg.param_dtype for every other model (see
    DecodeWeights)."""
    if (cfg.kernel_size == 2 and cfg.embed_channels == cfg.residual_channels
            and wn.compute_dtype(cfg) == torch.bfloat16):
        return torch.float32
    return wn.param_dtype(cfg)


def flatten_params(params, cfg: WaveNetConfig) -> DecodeWeights:
    """Model params -> DecodeWeights on the params' device (a DecodeWeights
    passes through unchanged, so callers may cache the result)."""
    if isinstance(params, DecodeWeights):
        return params
    L, R, K = cfg.num_layers, cfg.residual_channels, cfg.kernel_size
    cdt, f32 = wn.compute_dtype(cfg), torch.float32
    dev = params["w_cur"].device
    edt = embed_dtype(cfg)
    w = DecodeWeights(
        embed_cur=params["embed_cur"].to(edt),
        embed_prev=params["embed_prev"].to(edt),
        w_cur=params["w_cur"].reshape(L, R, 2 * R).to(cdt),
        w_prev=params["w_prev"].reshape(L, R, 2 * R).to(cdt),
        b=params["b"].reshape(L, 2 * R).to(f32),
        w_res=params["w_res"].to(cdt), b_res=params["b_res"].to(f32),
        w_skip=params["w_skip"].to(cdt), b_skip=params["b_skip"].to(f32),
        head_w1=params["head_w1"].to(cdt), head_b1=params["head_b1"].to(f32),
        head_w2=params["head_w2"].to(cdt), head_b2=params["head_b2"].to(f32),
        dils=torch.tensor(cfg.dilations, dtype=torch.int32, device=dev))
    if cfg.mel is not None:
        w["v_cond"] = params["v_cond"].reshape(
            L, cfg.mel.num_mels, 2 * R).to(cdt)
    if cfg.global_classes is not None:
        w["g_embed"] = params["g_embed"].to(f32)
        w["v_global"] = params["v_global"].reshape(
            L, cfg.global_channels, 2 * R).to(cdt)
    if K > 2:
        w["w_prevk"] = params["w_prevk"].reshape(L, K - 2, R, 2 * R).to(cdt)
        w["embed_prevk"] = params["embed_prevk"].to(edt)
    if cfg.embed_channels != R:
        w["w_embed_proj"] = params["w_embed_proj"].to(cdt)
    return DecodeWeights({k: v.detach().contiguous() for k, v in w.items()})


def check_y(cfg: WaveNetConfig, y, B: int, num_steps: int) -> None:
    """y must come with a mel model, and only then, covering the steps."""
    if cfg.mel is None:
        if y is not None:
            raise ValueError("y passed but cfg.mel is None")
        return
    if y is None:
        raise ValueError("a mel-conditioned model needs y, the upsampled "
                         "features [B, num_steps, M]")
    if tuple(y.shape) != (B, num_steps, cfg.mel.num_mels):
        raise ValueError(f"y has shape {tuple(y.shape)}, expected "
                         f"{(B, num_steps, cfg.mel.num_mels)}")


def check_g(cfg: WaveNetConfig, g, B: int) -> None:
    """g must come with a speaker model, and only then: [L, B, 2R]."""
    if cfg.global_classes is None:
        if g is not None:
            raise ValueError("g passed but cfg.global_classes is None")
        return
    shape = (cfg.num_layers, B, 2 * cfg.residual_channels)
    if g is None:
        raise ValueError("a speaker-conditioned model needs g, the speaker "
                         "offsets [L, B, 2R] (speaker_offsets)")
    if tuple(g.shape) != shape:
        raise ValueError(f"g has shape {tuple(g.shape)}, expected {shape}")


def decode_chunk_reference(w: DecodeWeights, cfg: WaveNetConfig,
                           rings: torch.Tensor, tokens_init: torch.Tensor,
                           t0: int, seeds: torch.Tensor, num_steps: int,
                           temperature: float = 1.0,
                           forced: Optional[torch.Tensor] = None,
                           y: Optional[torch.Tensor] = None,
                           g: Optional[torch.Tensor] = None):
    """Plain PyTorch version of both kernels' `decode_chunk`, built from
    models/wavenet.decode_step, models/conditioning.project_cond and
    ops/rng.py: the same signature, outputs and carry convention, on any
    device.  It is also the whole decode of the plain route (a model no
    kernel takes: K > 2, E != R or compute_dtype float32 or float16),
    whose rings are in the compute dtype and whose carry is [B, K]: the
    next token, then the tokens at t-1..t-(K-1)."""
    B = tokens_init.shape[0]
    check_y(cfg, y, B, num_steps)
    check_g(cfg, g, B)
    cdt = wn.compute_dtype(cfg)
    prev = tokens_init[:, 1] if cfg.kernel_size == 2 else tokens_init[:, 1:]
    state = wn.DecodeState(rings.clone(), prev.to(torch.int32), int(t0))
    token = tokens_init[:, 0].to(torch.int32)
    num_forced = 0 if forced is None else forced.shape[1]
    out = torch.empty(B, num_steps, dtype=torch.int32, device=rings.device)
    for t in range(num_steps):
        step = state.t
        cond_t = (None if y is None
                  else conditioning.project_cond(w, y[:, t], cdt))
        state, logits = wn.decode_step(w, cfg, state, token, cond_t=cond_t,
                                       gcond=g)
        nxt = wn.sample_tokens(logits, step, seeds, temperature)
        out[:, t] = nxt                      # the model's own choice ...
        if step + 1 < num_forced:            # ... then the prime overrides
            nxt = forced[:, step + 1].to(torch.int32)
        token = nxt
    carry = torch.cat([token[:, None], state.prev_token.reshape(B, -1)], 1)
    return out, state.queues, carry


def speaker_offsets(w: DecodeWeights, cfg: WaveNetConfig, speaker,
                    batch: int, device) -> Optional[torch.Tensor]:
    """The speaker offsets g [L, batch, 2R] f32 on `device` of a speaker
    model (None for another model), computed once per request batch.  The
    ids index g_embed: ids outside [0, global_classes) are refused."""
    if cfg.global_classes is None:
        if speaker is not None:
            raise ValueError("model has no global conditioning; speaker= "
                             "is not an input")
        return None
    if speaker is None:
        raise ValueError("cfg.global_classes set but no speaker ids passed")
    if w is None:
        raise ValueError("the speaker offsets need the model's weights (w)")
    ids = torch.as_tensor(speaker, device=device).to(torch.int64).reshape(-1)
    if ids.shape[0] != batch:
        raise ValueError(f"speaker has {ids.shape[0]} ids for a batch of "
                         f"{batch}")
    lo, hi = int(ids.min()), int(ids.max())
    if lo < 0 or hi >= cfg.global_classes:
        raise ValueError(f"speaker ids must lie in [0, {cfg.global_classes})"
                         f"; got [{lo}, {hi}]")
    g = wn.global_cond_offsets(w, cfg, ids)
    return g.reshape(cfg.num_layers, batch,
                     2 * cfg.residual_channels).contiguous()


def setup_decode(cfg: WaveNetConfig, batch: int, num_samples: int,
                 prime_tokens: Optional[torch.Tensor] = None, seeds=0,
                 device="cuda", w: Optional[DecodeWeights] = None,
                 speaker=None):
    """Decode set-up shared by the one-shot and streaming drivers of every
    route: zero rings [sum_d, B, R] in the compute dtype (bf16 for the
    kernels), the carry [B, K] (first token: the prime's first, else
    Q // 2; the history before it 0), per-row seeds, and the speaker
    offsets g of a speaker model (from w and speaker [B] ids; None
    otherwise).  Returns (rings, carry, seeds, g, P, total_steps), the
    reference's order (wavenet_tpu/ops/pallas/decode.py:495)."""
    P = 0 if prime_tokens is None else prime_tokens.shape[1]
    _, sum_d = wn.ring_offsets(cfg)
    rings = torch.zeros(sum_d, batch, cfg.residual_channels,
                        dtype=wn.compute_dtype(cfg), device=device)
    if P:
        # token ids index the embed tables inside the kernel: refuse ids
        # from outside that would read past them
        lo, hi = int(prime_tokens.min()), int(prime_tokens.max())
        if lo < 0 or hi >= cfg.quantization_channels:
            raise ValueError(f"prime token ids must lie in [0, "
                             f"{cfg.quantization_channels}); got "
                             f"[{lo}, {hi}]")
        first = prime_tokens[:, 0].to(device=device, dtype=torch.int32)
    else:
        first = torch.full((batch,), cfg.quantization_channels // 2,
                           dtype=torch.int32, device=device)
    carry = torch.zeros(batch, cfg.kernel_size, dtype=torch.int32,
                        device=device)
    carry[:, 0] = first
    seeds = rng.as_row_seeds(seeds, batch, device)
    g = speaker_offsets(w, cfg, speaker, batch, device)
    return rings, carry, seeds, g, P, max(P - 1, 0) + num_samples


def cond_timeline(y: Optional[torch.Tensor], total: int):
    """y [B, >= total, M] -> its first `total` steps (the conditioning
    timeline spans the priming steps too), or None without mel."""
    if y is None:
        return None
    if y.shape[1] < total:
        raise ValueError(f"y covers {y.shape[1]} < {total} steps (priming "
                         f"included)")
    return y[:, :total]


def generate_one_shot(decode_chunk, params, cfg: WaveNetConfig,
                      num_samples: int, batch: int = 1,
                      prime_tokens: Optional[torch.Tensor] = None,
                      temperature: float = 1.0, seeds=0, device="cuda",
                      y: Optional[torch.Tensor] = None, speaker=None):
    """[batch, num_samples] int32 tokens from one `decode_chunk` launch of
    either kernel's module (priming included: the first max(P - 1, 0)
    outputs are dropped).  y: [batch, >= max(P - 1, 0) + num_samples, M]
    upsampled mel features on `device` (mel models); speaker: [batch] int
    ids (speaker models)."""
    w = flatten_params(params, cfg)
    rings, carry, seeds, g, P, total = setup_decode(
        cfg, batch, num_samples, prime_tokens, seeds, device, w, speaker)
    forced = (None if prime_tokens is None else
              prime_tokens.to(device=device, dtype=torch.int32).contiguous())
    toks, _, _ = decode_chunk(w, cfg, rings, carry, 0, seeds, total,
                              temperature, forced=forced,
                              y=cond_timeline(y, total), g=g)
    return toks[:, max(P - 1, 0):total]


def kernel_operands(w: DecodeWeights, cfg: WaveNetConfig,
                    rings: torch.Tensor, tokens_init: torch.Tensor,
                    seeds: torch.Tensor, forced, y, g, num_steps: int):
    """Check every operand of a kernel launch (device, dtype, shape,
    contiguity) before a pointer is passed.  Returns (y as the kernel takes
    it: bf16 contiguous, or None; the prime's length)."""
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    _, sum_d = wn.ring_offsets(cfg)
    B = tokens_init.shape[0]
    check_y(cfg, y, B, num_steps)
    check_g(cfg, g, B)
    dev = rings.device
    i32, bf, f32 = torch.int32, torch.bfloat16, torch.float32
    build.check_tensor("rings", rings, (sum_d, B, R), bf, dev)
    build.check_tensor("tokens_init", tokens_init, (B, 2), i32, dev)
    build.check_tensor("seeds", seeds, (B,), i32, dev)
    shapes = {"embed_cur": ((Q, R), f32), "embed_prev": ((Q, R), f32),
              "w_cur": ((L, R, 2 * R), bf), "w_prev": ((L, R, 2 * R), bf),
              "b": ((L, 2 * R), f32), "w_res": ((L, R, R), bf),
              "b_res": ((L, R), f32), "w_skip": ((L, R, S), bf),
              "b_skip": ((L, S), f32), "head_w1": ((S, S), bf),
              "head_b1": ((S,), f32), "head_w2": ((S, Q), bf),
              "head_b2": ((Q,), f32), "dils": ((L,), i32)}
    y_k = None
    if cfg.mel is not None:
        shapes["v_cond"] = ((L, cfg.mel.num_mels, 2 * R), bf)
        y_k = y.to(device=dev, dtype=bf).contiguous()
    for k, (shape, dtype) in shapes.items():
        build.check_tensor(k, w[k], shape, dtype, dev)
    if g is not None:
        build.check_tensor("g", g, (L, B, 2 * R), f32, dev)
    num_forced = 0
    if forced is not None:
        num_forced = forced.shape[1]
        build.check_tensor("forced", forced, (B, num_forced), i32, dev)
    return y_k, num_forced


def tile_rows(batch: int, num_sms: int, max_rows: int = 8) -> int:
    """Batch rows per thread block of the narrow kernel (a power of two up
    to max_rows; the wide kernel's plan is decode_wide.plan_clusters): one
    row per block while the blocks fit the card's SMs, so batches spread
    over SMs (a block's step time grows with its rows); larger batches
    share each weight load over more rows per block.  A row's result does
    not depend on the choice."""
    bt = 1
    while bt < max_rows and -(-batch // bt) > num_sms:
        bt *= 2
    return bt


def raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.wn_error_string(rc).decode()})")


def ptr(x) -> Optional[int]:
    """A tensor's device address for ctypes (None for an absent operand)."""
    return None if x is None else x.data_ptr()
