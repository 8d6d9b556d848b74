"""Whole-loop decode for wide models: the CUDA kernel (csrc/decode_wide.cu)
and its wrapper.

Counterpart of wavenet_tpu/ops/pallas/decode_wide.py (its `supported`,
`decode_chunk` and `generate_wide`; `_flatten_params` and `setup_decode`
are ops/cuda/decode_common.py's, shared with the narrow kernel), in all
three variants: unconditional, mel-conditioned (`y`) and speaker-conditioned
(`g`, with or without mel).
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
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import build
# the drivers shared by both kernels, also reached through this module
from wavenet_tpu_torch.ops.cuda.decode_common import (  # noqa: F401
    DecodeWeights, decode_chunk_reference, flatten_params, generate_one_shot,
    kernel_operands, ptr, raise_on, setup_decode, tile_rows)

# one count per kernel variant, bumped where the wrapper launches it: the
# unconditional decode, the mel-conditioned decode, the speaker-conditioned
# decode (with or without mel), the RNG probe
launches = build.LaunchCounter()
mel_launches = build.LaunchCounter()
gc_launches = build.LaunchCounter()
rng_launches = build.LaunchCounter()

_MAX_THREADS = 512
_MAX_SMEM = 227 * 1024


def supported(cfg: WaveNetConfig) -> bool:
    """Configs the wide CUDA kernel serves: bf16 width-2 models with R a
    multiple of 128 (like the TPU kernel it replaces) and S of 32, with or
    without mel and speaker conditioning.  Other widths are the narrow
    kernel's (ops/cuda/decode.py)."""
    R, S = cfg.residual_channels, cfg.skip_channels
    return (R >= 128 and R % 128 == 0 and S % 32 == 0 and cfg.kernel_size == 2
            and cfg.compute_dtype == "bfloat16" and cfg.embed_channels == R)


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
    lib.wn_decode_wide.argtypes = [p] * 24 + [i] * 11 + [f, i, i, p]
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


def decode_chunk(w: DecodeWeights, cfg: WaveNetConfig, rings: torch.Tensor,
                 tokens_init: torch.Tensor, t0: int, seeds: torch.Tensor,
                 num_steps: int, temperature: float = 1.0,
                 forced: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None,
                 g: Optional[torch.Tensor] = None
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
    g: [L, B, 2R] f32 speaker offsets of a speaker-conditioned model
      (setup_decode gives them), added to every gate after the mel term.
    Returns (tokens [B, num_steps] int32, rings', carry [B, 2] int32).
    """
    if rings.device.type == "cpu":
        return decode_chunk_reference(w, cfg, rings, tokens_init, t0, seeds,
                                      num_steps, temperature, forced, y, g)
    if rings.device.type != "cuda":
        raise ValueError(f"decode_chunk: unsupported device {rings.device}")
    if not supported(cfg):
        raise ValueError("config not served by the wide decode kernel (needs "
                         "R a multiple of 128, S of 32, kernel_size 2, bf16, "
                         "no w_embed_proj)")
    y_k, num_forced = kernel_operands(w, cfg, rings, tokens_init, seeds,
                                      forced, y, g, num_steps)
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    _, sum_d = wn.ring_offsets(cfg)
    B = tokens_init.shape[0]
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    dev = rings.device
    lib = library()
    bt = tile_rows(B, torch.cuda.get_device_properties(dev)
                   .multi_processor_count)
    smem = lib.wn_decode_wide_smem(bt, L, R, S, Q, M)
    if smem > _MAX_SMEM:
        raise ValueError(f"decode kernel needs {smem} bytes of shared "
                         f"memory per block (> {_MAX_SMEM})")
    tokens = torch.empty(B, num_steps, dtype=torch.int32, device=dev)
    rings_out = torch.empty_like(rings)
    carry = torch.empty(B, 2, dtype=torch.int32, device=dev)
    greedy = temperature <= 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wn_decode_wide(
            ptr(seeds), ptr(tokens_init), ptr(forced),
            ptr(w["embed_cur"]), ptr(w["embed_prev"]), ptr(w["w_cur"]),
            ptr(w["w_prev"]), ptr(w["b"]), ptr(w["w_res"]), ptr(w["b_res"]),
            ptr(w["w_skip"]), ptr(w["b_skip"]), ptr(w["head_w1"]),
            ptr(w["head_b1"]), ptr(w["head_w2"]), ptr(w["head_b2"]),
            ptr(w["dils"]), ptr(y_k), ptr(w.get("v_cond")), ptr(g),
            ptr(rings), ptr(rings_out), ptr(tokens), ptr(carry),
            L, R, S, Q, M, sum_d, B, int(num_steps), int(t0),
            num_forced, int(greedy),
            0.0 if greedy else float(1.0 / temperature),
            bt, block_threads(cfg), stream)
        (gc_launches if g is not None else
         mel_launches if M else launches).add()
    raise_on(lib, rc, "wn_decode_wide")
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
    raise_on(lib, rc, "wn_counter_bits")
    return out


def generate_wide(params, cfg: WaveNetConfig, num_samples: int,
                  batch: int = 1, prime_tokens: Optional[torch.Tensor] = None,
                  temperature: float = 1.0, seeds=0, device="cuda",
                  y: Optional[torch.Tensor] = None,
                  speaker=None) -> torch.Tensor:
    """The one-shot driver (the reference's `generate_wide`):
    decode_common.generate_one_shot through this module's decode_chunk."""
    return generate_one_shot(decode_chunk, params, cfg, num_samples, batch,
                             prime_tokens, temperature, seeds, device, y,
                             speaker)
