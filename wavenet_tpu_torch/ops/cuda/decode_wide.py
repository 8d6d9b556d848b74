"""Whole-loop decode for wide models: the CUDA kernel (csrc/decode_wide.cu)
and its plain PyTorch version.

Counterpart of wavenet_tpu/ops/pallas/decode_wide.py (its `supported`,
`_flatten_params`, `decode_chunk`, `setup_decode` and `generate_wide`),
unconditional and mel-conditioned (`y`); speaker conditioning is not ported
yet (ROADMAP queue 2).
The TPU's tile planning (plan_tiles, _tile_bytes, TC_MIN_HW and the VMEM
budget) has no counterpart: the CUDA kernel takes any num_steps >= 1 and
any batch, in tiles of up to 8 rows per thread block.

Routing is by the tensors' device and nothing else: `decode_chunk` runs the
plain version (`decode_chunk_reference`) only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import conditioning
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import build

# one count per kernel variant, bumped where the wrapper launches it: the
# unconditional decode, the mel-conditioned decode, the RNG probe
launches = build.LaunchCounter()
mel_launches = build.LaunchCounter()
rng_launches = build.LaunchCounter()

_MAX_THREADS = 512
_MAX_SMEM = 227 * 1024


class DecodeWeights(dict):
    """Model params in the kernel's layout (same key names): embed tables
    f32 [Q, R]; w_cur/w_prev bf16 [L, R, 2R] (gate axis folded, [in, out]);
    w_res bf16 [L, R, R]; w_skip bf16 [L, R, S]; head_w1/head_w2 bf16;
    biases f32 with the gate axis folded (b [L, 2R]); dils int32 [L]; with
    mel, v_cond bf16 [L, M, 2R]."""


def supported(cfg: WaveNetConfig) -> bool:
    """Configs the CUDA kernel serves: the wide, width-2 models, with or
    without mel conditioning (R a multiple of 128, like the TPU kernel it
    replaces).  Narrow models (R < 128) and speaker conditioning belong to
    the still-unported ops/pallas/decode.py counterpart and has_gc variant
    (ROADMAP queue 2)."""
    R, S = cfg.residual_channels, cfg.skip_channels
    return (R >= 128 and R % 128 == 0 and S % 32 == 0 and cfg.kernel_size == 2
            and cfg.embed_channels == R and cfg.global_classes is None)


def flatten_params(params, cfg: WaveNetConfig) -> DecodeWeights:
    """Model params -> DecodeWeights on the params' device (a DecodeWeights
    passes through unchanged, so callers may cache the result)."""
    if isinstance(params, DecodeWeights):
        return params
    wn.check_supported(cfg)
    L, R = cfg.num_layers, cfg.residual_channels
    bf, f32 = torch.bfloat16, torch.float32
    dev = params["w_cur"].device
    w = DecodeWeights(
        embed_cur=params["embed_cur"].to(f32),
        embed_prev=params["embed_prev"].to(f32),
        w_cur=params["w_cur"].reshape(L, R, 2 * R).to(bf),
        w_prev=params["w_prev"].reshape(L, R, 2 * R).to(bf),
        b=params["b"].reshape(L, 2 * R).to(f32),
        w_res=params["w_res"].to(bf), b_res=params["b_res"].to(f32),
        w_skip=params["w_skip"].to(bf), b_skip=params["b_skip"].to(f32),
        head_w1=params["head_w1"].to(bf), head_b1=params["head_b1"].to(f32),
        head_w2=params["head_w2"].to(bf), head_b2=params["head_b2"].to(f32),
        dils=torch.tensor(cfg.dilations, dtype=torch.int32, device=dev))
    if cfg.mel is not None:
        w["v_cond"] = params["v_cond"].reshape(
            L, cfg.mel.num_mels, 2 * R).to(bf)
    return DecodeWeights({k: v.detach().contiguous() for k, v in w.items()})


def _check_y(cfg: WaveNetConfig, y, B: int, num_steps: int) -> None:
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


def decode_chunk_reference(w: DecodeWeights, cfg: WaveNetConfig,
                           rings: torch.Tensor, tokens_init: torch.Tensor,
                           t0: int, seeds: torch.Tensor, num_steps: int,
                           temperature: float = 1.0,
                           forced: Optional[torch.Tensor] = None,
                           y: Optional[torch.Tensor] = None):
    """Plain PyTorch version of `decode_chunk`, built from
    models/wavenet.decode_step, models/conditioning.project_cond and
    ops/rng.py: the same signature, outputs and carry convention, on any
    device."""
    B = tokens_init.shape[0]
    _check_y(cfg, y, B, num_steps)
    state = wn.DecodeState(rings.clone(), tokens_init[:, 1].to(torch.int32),
                           int(t0))
    token = tokens_init[:, 0].to(torch.int32)
    num_forced = 0 if forced is None else forced.shape[1]
    out = torch.empty(B, num_steps, dtype=torch.int32, device=rings.device)
    for t in range(num_steps):
        g = state.t
        cond_t = (None if y is None
                  else conditioning.project_cond(w, y[:, t]))
        state, logits = wn.decode_step(w, cfg, state, token, cond_t=cond_t)
        nxt = wn.sample_tokens(logits, g, seeds, temperature)
        out[:, t] = nxt                      # the model's own choice ...
        if g + 1 < num_forced:               # ... then the prime overrides
            nxt = forced[:, g + 1].to(torch.int32)
        token = nxt
    carry = torch.stack([token, state.prev_token], dim=1)
    return out, state.queues, carry


def tile_rows(batch: int, num_sms: int) -> int:
    """Batch rows per thread block (1, 2, 4 or 8): one row per block while
    the blocks fit the card's SMs, so small batches spread over SMs (one
    block's step time is bound by its SM's f64 FMA and conversion rate, and
    grows with its rows); larger batches share weight loads over more rows
    per block.  A row's result does not depend on the choice."""
    bt = 1
    while bt < 8 and -(-batch // bt) > num_sms:
        bt *= 2
    return bt


def block_threads(cfg: WaveNetConfig) -> int:
    """Threads per block: one per dot product of the widest phase (2 x 2R
    for z, R + S for skip and residual, Q for the logits), a multiple of
    32, at least 256 (one argmax warp per row), at most 512."""
    R, S, Q = (cfg.residual_channels, cfg.skip_channels,
               cfg.quantization_channels)
    n = max(4 * R, R + S, Q, 256)
    return min(-(-n // 32) * 32, _MAX_THREADS)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wn_decode_wide.argtypes = [p] * 23 + [i] * 11 + [f, i, i, p]
    lib.wn_decode_wide.restype = i
    lib.wn_decode_wide_smem.argtypes = [i] * 6
    lib.wn_decode_wide_smem.restype = ctypes.c_size_t
    lib.wn_counter_bits.argtypes = [p, i, i, i, p, p]
    lib.wn_counter_bits.restype = i
    lib.wn_error_string.argtypes = [i]
    lib.wn_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built and bound kernel library (builds on first use)."""
    lib = build.load("decode_wide")
    _bind(lib)
    return lib


def _raise_on(lib: ctypes.CDLL, rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} "
                           f"({lib.wn_error_string(rc).decode()})")


def decode_chunk(w: DecodeWeights, cfg: WaveNetConfig, rings: torch.Tensor,
                 tokens_init: torch.Tensor, t0: int, seeds: torch.Tensor,
                 num_steps: int, temperature: float = 1.0,
                 forced: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate `num_steps` tokens in one launch.

    w: flatten_params(params, cfg), on the rings' device.
    rings: [sum_d, B, R] bf16 ring state (zeros at start; opaque between
      calls).  Not modified: the updated rings come back as a new tensor.
    tokens_init: [B, 2] int32 carry: column 0 the token consumed at the
      first step, column 1 the token before it (ids in [0, Q), as
      setup_decode and earlier launches give them).
    t0: global step of the chunk start (ring phase and RNG key).
    seeds: [B] int32 per-row sampling seeds (ops/rng.py keying).
    temperature: <= 0 means greedy argmax.
    forced: optional [B, P] int32 prime; while the global step g + 1 < P
      the token consumed at step g + 1 is forced[:, g + 1] (the kernel's
      own argmax is still what the token output records).
    y: [B, num_steps, M] upsampled mel features of THIS launch's steps
      (a mel-conditioned model only; a chunked caller passes its chunk's
      slice).  Rounded to bf16 here, as the reference kernel takes it.
    Returns (tokens [B, num_steps] int32, rings', carry [B, 2] int32).
    """
    if rings.device.type == "cpu":
        return decode_chunk_reference(w, cfg, rings, tokens_init, t0, seeds,
                                      num_steps, temperature, forced, y)
    if rings.device.type != "cuda":
        raise ValueError(f"decode_chunk: unsupported device {rings.device}")
    if not supported(cfg):
        raise ValueError("config not served by the wide decode kernel (needs "
                         "R a multiple of 128, S of 32, kernel_size 2, no "
                         "w_embed_proj, no speaker conditioning)")
    if num_steps < 1:
        raise ValueError("num_steps must be >= 1")
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    _, sum_d = wn.ring_offsets(cfg)
    B = tokens_init.shape[0]
    _check_y(cfg, y, B, num_steps)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
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
    if M:
        shapes["v_cond"] = ((L, M, 2 * R), bf)
        y_k = y.to(device=dev, dtype=bf).contiguous()
    for k, (shape, dtype) in shapes.items():
        build.check_tensor(k, w[k], shape, dtype, dev)
    num_forced = 0
    if forced is not None:
        num_forced = forced.shape[1]
        build.check_tensor("forced", forced, (B, num_forced), i32, dev)
    lib = library()
    bt = tile_rows(B, torch.cuda.get_device_properties(dev)
                   .multi_processor_count)
    smem = lib.wn_decode_wide_smem(bt, L, R, S, Q, M)
    if smem > _MAX_SMEM:
        raise ValueError(f"decode kernel needs {smem} bytes of shared "
                         f"memory per block (> {_MAX_SMEM})")
    tokens = torch.empty(B, num_steps, dtype=i32, device=dev)
    rings_out = torch.empty_like(rings)
    carry = torch.empty(B, 2, dtype=i32, device=dev)
    greedy = temperature <= 0
    ptr = lambda x: None if x is None else x.data_ptr()
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wn_decode_wide(
            ptr(seeds), ptr(tokens_init), ptr(forced),
            ptr(w["embed_cur"]), ptr(w["embed_prev"]), ptr(w["w_cur"]),
            ptr(w["w_prev"]), ptr(w["b"]), ptr(w["w_res"]), ptr(w["b_res"]),
            ptr(w["w_skip"]), ptr(w["b_skip"]), ptr(w["head_w1"]),
            ptr(w["head_b1"]), ptr(w["head_w2"]), ptr(w["head_b2"]),
            ptr(w["dils"]), ptr(y_k), ptr(w.get("v_cond")), ptr(rings),
            ptr(rings_out), ptr(tokens), ptr(carry), L, R, S, Q, M, sum_d, B,
            int(num_steps), int(t0),
            num_forced, int(greedy),
            0.0 if greedy else float(1.0 / temperature),
            bt, block_threads(cfg), stream)
        (mel_launches if M else launches).add()
    _raise_on(lib, rc, "wn_decode_wide")
    return tokens, rings_out, carry


def counter_bits(seeds: torch.Tensor, t: int, num_classes: int):
    """[B] int32 seeds on the card -> [B, num_classes] int32 holding the
    device hash's bits (rng.cuh); the CPU version is ops/rng.counter_bits."""
    if seeds.device.type == "cpu":
        return rng.as_int32(rng.counter_bits(seeds, t, num_classes))
    if seeds.device.type != "cuda":
        raise ValueError(f"counter_bits: unsupported device {seeds.device}")
    B = seeds.shape[0]
    build.check_tensor("seeds", seeds, (B,), torch.int32, seeds.device)
    lib = library()
    out = torch.empty(B, num_classes, dtype=torch.int32, device=seeds.device)
    with torch.cuda.device(seeds.device):
        stream = torch.cuda.current_stream(seeds.device).cuda_stream
        rc = lib.wn_counter_bits(seeds.data_ptr(), B, int(t), num_classes,
                                 out.data_ptr(), stream)
        rng_launches.add()
    _raise_on(lib, rc, "wn_counter_bits")
    return out


def setup_decode(cfg: WaveNetConfig, batch: int, num_samples: int,
                 prime_tokens: Optional[torch.Tensor] = None, seeds=0,
                 device="cuda"):
    """Decode set-up: zero rings [sum_d, B, R] bf16, the carry [B, 2]
    (first token: the prime's first, else Q // 2; prev 0), per-row seeds.
    Returns (rings, carry, seeds, P, total_steps)."""
    wn.check_supported(cfg)
    P = 0 if prime_tokens is None else prime_tokens.shape[1]
    _, sum_d = wn.ring_offsets(cfg)
    rings = torch.zeros(sum_d, batch, cfg.residual_channels,
                        dtype=torch.bfloat16, device=device)
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
    carry = torch.stack([first, torch.zeros_like(first)], dim=1)
    seeds = rng.as_row_seeds(seeds, batch, device)
    return rings, carry, seeds, P, max(P - 1, 0) + num_samples


def cond_timeline(y: Optional[torch.Tensor], total: int):
    """y [B, >= total, M] -> its first `total` steps (the conditioning
    timeline spans the priming steps too), or None without mel."""
    if y is None:
        return None
    if y.shape[1] < total:
        raise ValueError(f"y covers {y.shape[1]} < {total} steps (priming "
                         f"included)")
    return y[:, :total]


def generate_wide(params, cfg: WaveNetConfig, num_samples: int,
                  batch: int = 1, prime_tokens: Optional[torch.Tensor] = None,
                  temperature: float = 1.0, seeds=0, device="cuda",
                  y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[batch, num_samples] int32 tokens from one decode_chunk launch
    (priming included: the first max(P - 1, 0) outputs are dropped).
    y: [batch, >= max(P - 1, 0) + num_samples, M] upsampled mel features
    on `device`, for a mel-conditioned model."""
    w = flatten_params(params, cfg)
    rings, carry, seeds, P, total = setup_decode(
        cfg, batch, num_samples, prime_tokens, seeds, device)
    forced = (None if prime_tokens is None else
              prime_tokens.to(device=device, dtype=torch.int32).contiguous())
    toks, _, _ = decode_chunk(w, cfg, rings, carry, 0, seeds, total,
                              temperature, forced=forced,
                              y=cond_timeline(y, total))
    return toks[:, max(P - 1, 0):total]
