"""Generation: one-shot and streaming decode, the naive oracle, and
token -> audio.

Counterparts of wavenet_tpu/generate/sampler.py's generate_auto,
generate_stream, generate_naive, tokens_to_waveform, batch_paths and
generate_wav.  Both decoders
take one of three routes, named by kernel_module, as the reference routes
between its kernels and its XLA scan:
  * the narrow whole-loop kernel (ops/cuda/decode.py, the reference's
    ops/pallas/decode.py) for R < 128 and for any other bf16 width-2 model
    the wide kernel does not take, wherever its block fits;
  * the wide one (ops/cuda/decode_wide.py) for R a multiple of 128 with S a
    multiple of 32;
  * the plain route (PLAIN: decode_common.decode_chunk_reference on any
    device) for a model that no port kernel takes, kernel_size > 2,
    causal_channels != residual_channels or compute_dtype float32 or
    float16 (the reference's kernels would compute those two in bf16;
    the port computes them in their own dtype), at any param_dtype, and for
    a bf16 width-2 model whose widths neither port kernel takes: the
    counterpart of the reference's scan (generate_auto's last branch and
    _stream_scan), which the reference also falls back to when neither of
    its kernels fits.
A kernel module's decode_chunk takes its CUDA kernel for tensors on the
card and the plain PyTorch version for tensors on the CPU.
Every route carries the same rings and carry from launch to launch and keys
its RNG by the global step, so chunked decode equals one-shot bit for bit.
A mel-conditioned model takes y, its upsampled features on the decode
device, covering the whole timeline (priming steps included); a
speaker-conditioned model takes speaker, its [B] int ids.
generate_distributed and stream_distributed decode over a (data, model)
mesh of ranks (parallel/distdecode.py), routed as the reference routes
them: the kernel fan-out on a data-only mesh, the collective loop
otherwise.
"""

from __future__ import annotations

import os
import types
from typing import Iterator, List, Optional

import numpy as np
import torch

from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import decode as pnarrow
from wavenet_tpu_torch.ops.cuda import decode_common
from wavenet_tpu_torch.ops.cuda import decode_wide as pwide

# the plain route: the whole decode in plain PyTorch, on any device
PLAIN = types.SimpleNamespace(
    decode_chunk=decode_common.decode_chunk_reference)


def kernel_module(cfg: WaveNetConfig, device):
    """The route that decodes cfg: PLAIN for a model no port kernel takes
    (kernel_size > 2, E != R, compute_dtype float32 or float16, which the
    reference's kernels would compute in bf16); else
    ops/cuda/decode_wide for R a multiple of 128 with S a multiple of 32,
    and ops/cuda/decode for every other width.  On the card a width that
    neither kernel takes (the narrow one's block does not fit) goes to
    PLAIN too, as the reference falls back to its scan
    (wavenet_tpu/generate/sampler.py generate_auto); on the CPU a kernel
    module runs its plain version, so any width decodes there."""
    R = cfg.residual_channels
    if (cfg.kernel_size != 2 or cfg.embed_channels != R
            or wn.compute_dtype(cfg) != torch.bfloat16):
        return PLAIN
    mod = pwide if pwide.supported(cfg) else pnarrow
    if torch.device(device).type == "cuda" and not mod.supported(cfg):
        return PLAIN
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


def kernel_fan_out(cfg: WaveNetConfig, groups, batch: int,
                    temperature: float, device) -> bool:
    """The reference's routing rule (wavenet_tpu/generate/sampler.py
    :211-215): a data-only mesh whose rows split evenly, bf16 compute or
    greedy, and a route that is a kernel take the kernel fan-out;
    everything else takes the collective loop."""
    greedy = temperature <= 0
    return (groups.mp == 1 and batch % groups.dp == 0
            and (wn.compute_dtype(cfg) == torch.bfloat16 or greedy)
            and kernel_module(cfg, device) is not PLAIN)


def generate_distributed(params, cfg: WaveNetConfig, mesh, seeds,
                         num_samples: int, batch: int,
                         prime_tokens: Optional[torch.Tensor] = None,
                         y: Optional[torch.Tensor] = None, speaker=None,
                         temperature: float = 1.0, device="cuda",
                         local_y: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """[batch, num_samples] int32 tokens on every rank of a (data, model)
    mesh (a DeviceMesh of parallel/mesh.make_mesh, or MeshGroups), equal
    to one device's generate_auto at the same seeds on any layout.  Every
    rank passes the same global arguments (those of generate_auto; local_y
    instead of y: this rank's rows of the features).  A data-only mesh
    fans the decode kernel out over its ranks
    (distdecode.generate_kernel_dp); a model-sharded mesh, or a model no
    kernel takes, runs the collective loop (distdecode.generate_sharded).
    params: model params or DecodeWeights on `device`."""
    from wavenet_tpu_torch.parallel import distdecode
    groups = distdecode.as_groups(mesh)
    kw = dict(prime_tokens=prime_tokens, y=y, speaker=speaker,
              temperature=temperature, device=device, local_y=local_y)
    if kernel_fan_out(cfg, groups, batch, temperature, device):
        return distdecode.generate_kernel_dp(params, cfg, groups, seeds,
                                             num_samples, batch, **kw)
    return distdecode.generate_sharded(params, cfg, groups, seeds,
                                       num_samples, batch, **kw)


def stream_distributed(params, cfg: WaveNetConfig, mesh, seeds,
                       num_samples: int, batch: int,
                       chunk_samples: int = 16000,
                       prime_tokens: Optional[torch.Tensor] = None,
                       y: Optional[torch.Tensor] = None, speaker=None,
                       temperature: float = 1.0, device="cuda",
                       local_y: Optional[torch.Tensor] = None
                       ) -> Iterator[torch.Tensor]:
    """Streaming generate_distributed: yields [batch, <= chunk_samples]
    int32 token chunks on every rank, routed by the same rule, which
    concatenate to its one-shot tokens."""
    from wavenet_tpu_torch.parallel import distdecode
    groups = distdecode.as_groups(mesh)
    kw = dict(chunk_samples=chunk_samples, prime_tokens=prime_tokens, y=y,
              speaker=speaker, temperature=temperature, device=device,
              local_y=local_y)
    if kernel_fan_out(cfg, groups, batch, temperature, device):
        yield from distdecode.generate_kernel_dp_stream(
            params, cfg, groups, seeds, num_samples, batch, **kw)
        return
    yield from distdecode.generate_sharded_stream(
        params, cfg, groups, seeds, num_samples, batch, **kw)


@torch.no_grad()
def generate_naive(params, cfg: WaveNetConfig, num_samples: int,
                   batch: int = 1,
                   prime_tokens: Optional[torch.Tensor] = None,
                   speaker=None, y: Optional[torch.Tensor] = None,
                   temperature: float = 1.0, seeds=0,
                   device="cuda") -> torch.Tensor:
    """Naive AR sampling, [batch, num_samples] int32: the full
    receptive-field forward (models/wavenet.forward_logits) per sample, the
    slow oracle the fast decoders are held against (the reference's
    generate_naive, wavenet_tpu/generate/sampler.py:355).  It reproduces
    the fast path's boundary semantics exactly:

    - The window is RF + K - 1 tokens wide: positions [K-1:] feed the model
      and the K - 1 before each one are its true history (prev_tokens and,
      for K > 2, prev_tokens_extra), so the oldest model position never
      sees the default zero-token history once the window has rolled past
      the sequence start.
    - While the history is shorter than the window, a validity mask makes
      the missing positions contribute exactly the zero left-padding the
      fast path's empty rings see (forward_logits valid_mask), instead of
      a window full of silence tokens; they are left-filled with token 0,
      the fast path's initial history.
    - A mel model's y ([batch, >= max(P-1, 0) + num_samples, M] upsampled
      features, the fast decoders' timeline) slides a matching window:
      model position t' sees y at its absolute decode step, zeros before
      the sequence start.
    - Sampling draws the counter RNG keyed by (row seed, absolute decode
      step, class), as the fast decoders do, so at any temperature fast
      and naive give the same tokens (the reference's oracle samples with
      jax.random instead, so it matches its fast path only greedily).

    params: model params on `device`; speaker: [batch] ids of a speaker
    model; seeds: an int or [batch] per-row seeds."""
    K = cfg.kernel_size
    rf, Km1, Q = cfg.receptive_field, K - 1, cfg.quantization_channels
    W = rf + Km1
    P = 0 if prime_tokens is None else prime_tokens.shape[1]
    window = torch.zeros(batch, W, dtype=torch.int32, device=device)
    if P == 0:
        window[:, -1] = Q // 2
        count = 1                              # valid tokens in the window
    else:
        prime = prime_tokens.to(device=device, dtype=torch.int32)
        count = min(P, W)
        window[:, W - count:] = prime[:, P - count:]
    base = max(P - 1, 0)                       # decode step of sample 0
    y_pad = None
    if y is not None:
        if cfg.mel is None:
            raise ValueError("y passed but cfg.mel is None")
        if y.shape[1] < base + num_samples:
            raise ValueError(f"y covers {y.shape[1]} < {base + num_samples} "
                             f"steps (priming included)")
        # rf - 1 zero steps first: a window ending at step s reads
        # y_pad[:, s : s + rf]
        y_pad = torch.nn.functional.pad(y.float(), (0, 0, rf - 1, 0))
    seeds = rng.as_row_seeds(seeds, batch, device)
    pos = torch.arange(rf, device=device)
    out = torch.empty(batch, num_samples, dtype=torch.int32, device=device)
    for i in range(num_samples):
        mask = (pos >= rf - min(count, rf)).float().expand(batch, rf)
        extra = (None if Km1 == 1 else torch.stack(
            [window[:, Km1 - j:W - j] for j in range(2, Km1 + 1)]))
        logits = wn.forward_logits(
            params, cfg, window[:, Km1:], prev_tokens=window[:, Km1 - 1:-1],
            prev_tokens_extra=extra, speaker=speaker,
            upsampled_cond=(None if y_pad is None
                            else y_pad[:, base + i:base + i + rf]),
            valid_mask=mask)[:, -1]
        nxt = wn.sample_tokens(logits, base + i, seeds, temperature)
        out[:, i] = nxt
        window = torch.cat([window[:, 1:], nxt[:, None]], dim=1)
        count = min(count + 1, W)
    return out


def tokens_to_waveform(tokens: torch.Tensor, cfg: WaveNetConfig) -> np.ndarray:
    """int32 mu-law tokens -> float32 waveform in [-1, 1] on the host."""
    return mulaw.decode(tokens, cfg.quantization_channels).cpu().numpy()


def batch_paths(out_path: str, batch: int) -> List[str]:
    """out.wav -> [out_0.wav, ...] for batch > 1 (an extensionless path
    gets .wav); the one naming rule of batched wav output, the
    reference's."""
    if batch == 1:
        return [out_path]
    root, ext = os.path.splitext(out_path)
    ext = ext or ".wav"
    return [f"{root}_{i}{ext}" for i in range(batch)]


def write_wavs(out_path: str, tokens: torch.Tensor,
               cfg: WaveNetConfig) -> np.ndarray:
    """Write each row of [batch, T] tokens as a 16-bit wav (batch_paths
    names them); returns the [batch, T] float32 waveform."""
    # imported here: audio.io pulls in scipy.signal (seconds), which the
    # decode path (serving's first request included) must not wait for
    from wavenet_tpu_torch.audio.io import write_wav
    wave = tokens_to_waveform(tokens, cfg)
    for i, path in enumerate(batch_paths(out_path, wave.shape[0])):
        write_wav(path, wave[i], cfg.sample_rate)
    return wave


@torch.no_grad()
def generate_wav(params, cfg: WaveNetConfig, out_path: str, seconds: float,
                 batch: int = 1, temperature: float = 1.0, seeds=0,
                 device="cuda", **decode_kw) -> np.ndarray:
    """Sample `seconds` of audio through generate_auto (the kernel that
    decodes cfg) and write wav file(s) (batch_paths); returns the
    [batch, T] waveform.  params: model params (nested, or the trainer's
    flat leaves, gradients or not) or DecodeWeights on `device`; seeds:
    an int (per-row seeds derived from it) or [batch] row seeds;
    decode_kw (prime_tokens=, y=, speaker=) pass through to
    generate_auto."""
    toks = generate_auto(params, cfg, int(seconds * cfg.sample_rate),
                         batch=batch, temperature=temperature, seeds=seeds,
                         device=device, **decode_kw)
    return write_wavs(out_path, toks, cfg)
