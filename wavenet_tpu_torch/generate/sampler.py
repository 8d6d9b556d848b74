"""Generation: one-shot and streaming decode, and token -> audio.

Counterparts of wavenet_tpu/generate/sampler.py's generate_auto,
generate_stream (its wide-model branch, _stream_wide) and
tokens_to_waveform.  Routing follows the tensors' device: the decode
launches run ops/cuda/decode_wide.decode_chunk, which takes the CUDA kernel
for tensors on the card and the plain PyTorch version for tensors on the
CPU.  Narrow models (R < 128) are served on the CPU only until the
ops/pallas/decode.py counterpart is ported (ROADMAP queue 2).  A
mel-conditioned model takes y, its upsampled features on the decode
device, covering the whole timeline (priming steps included).
"""

from __future__ import annotations

from typing import Iterator, Optional

import numpy as np
import torch

from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.ops.cuda import decode_wide as pwide


def generate_auto(params, cfg: WaveNetConfig, num_samples: int,
                  batch: int = 1, prime_tokens: Optional[torch.Tensor] = None,
                  temperature: float = 1.0, seeds=0, device="cuda",
                  y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[batch, num_samples] int32 tokens in one whole-loop decode launch.
    params: model params or flatten_params' DecodeWeights on `device`;
    seeds: an int (per-row seeds derived from it) or [batch] per-row
    counter-RNG seeds, so each row's audio depends only on its own seed;
    y: [batch, >= max(P - 1, 0) + num_samples, M] upsampled mel features
    (mel models)."""
    return pwide.generate_wide(params, cfg, num_samples, batch=batch,
                               prime_tokens=prime_tokens,
                               temperature=temperature, seeds=seeds,
                               device=device, y=y)


def generate_stream(params, cfg: WaveNetConfig, num_samples: int,
                    chunk_samples: int = 16000, batch: int = 1,
                    prime_tokens: Optional[torch.Tensor] = None,
                    temperature: float = 1.0, seeds=0, device="cuda",
                    y: Optional[torch.Tensor] = None
                    ) -> Iterator[torch.Tensor]:
    """Streaming generation: yields [batch, <= chunk_samples] int32 token
    chunks (on `device`).  Rings and the token carry pass from one launch
    to the next and the RNG is keyed by the global step, so the chunks
    concatenate to exactly the one-shot generate_auto output.  The first
    max(P - 1, 0) decode steps teacher-force the prime and emit nothing.
    y: as in generate_auto; each launch takes its chunk's slice."""
    if chunk_samples < 1:
        raise ValueError("chunk_samples must be >= 1")
    w = pwide.flatten_params(params, cfg)
    rings, carry, seeds, P, total = pwide.setup_decode(
        cfg, batch, num_samples, prime_tokens, seeds, device)
    y = pwide.cond_timeline(y, total)
    forced = (None if prime_tokens is None else
              prime_tokens.to(device=device, dtype=torch.int32).contiguous())
    t0, skip = 0, max(P - 1, 0)                  # skip = priming outputs
    while t0 < total:
        n = min(chunk_samples, total - t0)
        toks, rings, carry = pwide.decode_chunk(
            w, cfg, rings, carry, t0, seeds, n, temperature,
            forced=forced if t0 < P - 1 else None,
            y=None if y is None else y[:, t0:t0 + n])
        if skip:
            drop = min(skip, n)
            toks, skip = toks[:, drop:], skip - drop
        if toks.shape[1]:
            yield toks
        t0 += n


def tokens_to_waveform(tokens: torch.Tensor, cfg: WaveNetConfig) -> np.ndarray:
    """int32 mu-law tokens -> float32 waveform in [-1, 1] on the host."""
    return mulaw.decode(tokens, cfg.quantization_channels).cpu().numpy()
