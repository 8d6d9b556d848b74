"""Generation: one-shot and streaming decode, and token -> audio.

Counterparts of wavenet_tpu/generate/sampler.py's generate_auto,
generate_stream and tokens_to_waveform.  Both decoders route on the
model's width, as the reference routes on its kernels: R < 128 to the
narrow whole-loop kernel (ops/cuda/decode.py, the reference's
ops/pallas/decode.py), R a multiple of 128 to the wide one
(ops/cuda/decode_wide.py).  Each module's decode_chunk takes its CUDA
kernel for tensors on the card and the plain PyTorch version for tensors
on the CPU; on the card a width neither kernel takes raises.  A
mel-conditioned model takes y, its upsampled features on the decode
device, covering the whole timeline (priming steps included); a
speaker-conditioned model takes speaker, its [B] int ids.
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.ops.cuda import decode as pnarrow
from wavenet_tpu_torch.ops.cuda import decode_common
from wavenet_tpu_torch.ops.cuda import decode_wide as pwide


def kernel_module(cfg: WaveNetConfig, device):
    """The decode module that serves cfg: ops/cuda/decode for R < 128,
    ops/cuda/decode_wide for R a multiple of 128.  On the CPU either runs
    the plain version, so any width decodes there; on the card a width
    neither kernel takes raises ValueError."""
    R = cfg.residual_channels
    mod = pnarrow if R < 128 else pwide
    if torch.device(device).type == "cuda" and not mod.supported(cfg):
        raise ValueError(
            f"no decode kernel takes residual_channels={R}, skip_channels="
            f"{cfg.skip_channels} (the narrow kernel takes R < 128, the wide "
            f"one R a multiple of 128 with S a multiple of 32)")
    return mod


def generate_auto(params, cfg: WaveNetConfig, num_samples: int,
                  batch: int = 1, prime_tokens: Optional[torch.Tensor] = None,
                  temperature: float = 1.0, seeds=0, device="cuda",
                  y: Optional[torch.Tensor] = None,
                  speaker=None) -> torch.Tensor:
    """[batch, num_samples] int32 tokens in one whole-loop decode launch.
    params: model params or flatten_params' DecodeWeights on `device`;
    seeds: an int (per-row seeds derived from it) or [batch] per-row
    counter-RNG seeds, so each row's audio depends only on its own seed;
    y: [batch, >= max(P - 1, 0) + num_samples, M] upsampled mel features
    (mel models); speaker: [batch] int ids (speaker models)."""
    mod = kernel_module(cfg, device)
    return decode_common.generate_one_shot(
        mod.decode_chunk, params, cfg, num_samples, batch, prime_tokens,
        temperature, seeds, device, y, speaker)


def generate_stream(params, cfg: WaveNetConfig, num_samples: int,
                    chunk_samples: int = 16000, batch: int = 1,
                    prime_tokens: Optional[torch.Tensor] = None,
                    temperature: float = 1.0, seeds=0, device="cuda",
                    y: Optional[torch.Tensor] = None, speaker=None
                    ) -> Iterator[torch.Tensor]:
    """Streaming generation: yields [batch, <= chunk_samples] int32 token
    chunks (on `device`).  Rings and the token carry pass from one launch
    to the next and the RNG is keyed by the global step, so the chunks
    concatenate to exactly the one-shot generate_auto output.  The first
    max(P - 1, 0) decode steps teacher-force the prime and emit nothing.
    y: as in generate_auto; each launch takes its chunk's slice.  speaker:
    as in generate_auto; its offsets are computed once, before the first
    launch."""
    if chunk_samples < 1:
        raise ValueError("chunk_samples must be >= 1")
    mod = kernel_module(cfg, device)
    w = decode_common.flatten_params(params, cfg)
    rings, carry, seeds, g, P, total = decode_common.setup_decode(
        cfg, batch, num_samples, prime_tokens, seeds, device, w, speaker)
    y = decode_common.cond_timeline(y, total)
    forced = (None if prime_tokens is None else
              prime_tokens.to(device=device, dtype=torch.int32).contiguous())
    t0, skip = 0, max(P - 1, 0)                  # skip = priming outputs
    while t0 < total:
        n = min(chunk_samples, total - t0)
        toks, rings, carry = mod.decode_chunk(
            w, cfg, rings, carry, t0, seeds, n, temperature,
            forced=forced if t0 < P - 1 else None,
            y=None if y is None else y[:, t0:t0 + n], g=g)
        if skip:
            drop = min(skip, n)
            toks, skip = toks[:, drop:], skip - drop
        if toks.shape[1]:
            yield toks
        t0 += n


def tokens_to_waveform(tokens: torch.Tensor, cfg: WaveNetConfig) -> np.ndarray:
    """int32 mu-law tokens -> float32 waveform in [-1, 1] on the host."""
    return mulaw.decode(tokens, cfg.quantization_channels).cpu().numpy()
