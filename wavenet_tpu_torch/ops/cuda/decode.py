"""Whole-loop decode for narrow models (R < 128, and any bf16 width-2
width the wide kernel does not take whose block fits): the CUDA kernel
(csrc/decode.cu) and its wrapper.

Counterpart of wavenet_tpu/ops/pallas/decode.py (its `fits_vmem` and
`plan_tiles` as `supported` and `tile_rows`, `decode_chunk`, and
`generate_pallas` as `generate_narrow`; `_flatten_params` and
`setup_decode` are ops/cuda/decode_common.py's, shared with the wide
kernel), in all three variants: unconditional, mel-conditioned (`y`) and
speaker-conditioned (`g`, with or without mel).  This serves the `tiny`,
`small`, `fastgen_bench` and `conditional` presets.

The reference keeps its rings transposed, [sum_d, R, B], to put the batch
on TPU lanes; the port keeps [sum_d, B, R] for both kernels, so the plain
version, the set-up and the streaming driver are one.  The TPU's VMEM plan
(the time chunk, VMEM_BUDGET, batch tiles as separate launches) has no
counterpart: the CUDA kernel takes any num_steps >= 1, any batch and any
prime length, in tiles of up to 16 rows per thread block.

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
from wavenet_tpu_torch.ops.cuda import build
# the drivers shared by both kernels, also reached through this module
from wavenet_tpu_torch.ops.cuda.decode_common import (  # noqa: F401
    DecodeWeights, decode_chunk_reference, flatten_params, generate_one_shot,
    kernel_operands, ptr, raise_on, setup_decode, tile_rows)

# one count per kernel variant, bumped where the wrapper launches it: the
# unconditional decode, the mel-conditioned decode, the speaker-conditioned
# decode (with or without mel)
launches = build.LaunchCounter()
mel_launches = build.LaunchCounter()
gc_launches = build.LaunchCounter()

MAX_ROWS = 16      # rows per block: one argmax warp per row of 512 threads
_MAX_SMEM = 227 * 1024


# the kernel's plan lives here and nowhere else: csrc/decode.cu takes the
# segment counts, the partial-sum units and the shared-memory size from
# wn_decode's arguments
_THREADS = 512     # threads per block (decode.cu kThreads)
_MIN_SEG = 8       # shortest K segment a phase splits into


def _phase_segs(ndots: int, kmin: int) -> int:
    """K segments per dot product of a phase with ndots dot products whose
    shortest K is kmin: doubled while the phase has fewer units than the
    block has threads and every segment keeps at least _MIN_SEG terms."""
    s = 1
    while ndots * s < _THREADS and (kmin + 2 * s - 1) // (2 * s) >= _MIN_SEG:
        s *= 2
    return s


def plan(R: int, S: int, Q: int, M: int) -> Tuple[int, int, int, int, int]:
    """The kernel's plan: (K segments per dot product of the z, skip +
    residual, head 1 and head 2 phases, the partial-sum units of the
    largest phase)."""
    nz = 4 * R + (2 * R if M else 0)
    z, sr = _phase_segs(nz, M if M and M < R else R), _phase_segs(S + R, R)
    h1, h2 = _phase_segs(S, S), _phase_segs(Q, S)
    return z, sr, h1, h2, max(nz * z, (S + R) * sr, S * h1, Q * h2)


def smem_bytes(bt: int, L: int, R: int, S: int, Q: int, M: int) -> int:
    """Shared memory of one block at bt rows per block, in the order
    decode.cu lays it out: f64 [3R + 2S + M + units][bt] (matmul inputs
    and partial sums), f32 [S + Q][bt] (skip sum, scores), int [3 bt + 2L]
    (tokens, prevs, seeds, ring offsets, dilations)."""
    units = plan(R, S, Q, M)[4]
    return (8 * bt * (3 * R + 2 * S + M + units)
            + 4 * (bt * (S + Q) + 3 * bt + 2 * L))


def _cfg_smem(cfg: WaveNetConfig, bt: int) -> int:
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    return smem_bytes(bt, cfg.num_layers, cfg.residual_channels,
                      cfg.skip_channels, cfg.quantization_channels, M)


def supported(cfg: WaveNetConfig) -> bool:
    """Configs the narrow CUDA kernel serves: bf16 width-2 models with
    E == R whose one-row block fits the shared memory, with or without mel
    and speaker conditioning.  Its K-split dot products take any R, S and
    M and its thread plan any width (a strided loop over the units of a
    phase, one argmax warp per row); the presets use R in {32, 64}, the
    tests R = 16, and the sampler sends it any width the wide kernel does
    not take (generate/sampler.py kernel_module)."""
    return (cfg.kernel_size == 2 and cfg.compute_dtype == "bfloat16"
            and cfg.embed_channels == cfg.residual_channels
            and _cfg_smem(cfg, 1) <= _MAX_SMEM)


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wn_decode.argtypes = [p] * 24 + [i] * 11 + [f] + [i] * 7 + [p]
    lib.wn_decode.restype = i
    lib.wn_error_string.argtypes = [i]
    lib.wn_error_string.restype = ctypes.c_char_p


def library() -> ctypes.CDLL:
    """The built and bound kernel library (builds on first use)."""
    lib = build.load("decode")
    _bind(lib)
    return lib


def decode_chunk(w: DecodeWeights, cfg: WaveNetConfig, rings: torch.Tensor,
                 tokens_init: torch.Tensor, t0: int, seeds: torch.Tensor,
                 num_steps: int, temperature: float = 1.0,
                 forced: Optional[torch.Tensor] = None,
                 y: Optional[torch.Tensor] = None,
                 g: Optional[torch.Tensor] = None,
                 rows_per_block: Optional[int] = None
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Generate `num_steps` tokens in one launch; the arguments, outputs
    and carry convention are those of ops/cuda/decode_wide.decode_chunk
    (rings [sum_d, B, R] bf16, carry [B, 2], y [B, num_steps, M] of this
    launch's steps, g [L, B, 2R] f32 speaker offsets).
    rows_per_block: batch rows per thread block (1, 2, 4, 8 or 16); by
      default tile_rows' choice.  A row's result does not depend on it:
      this is the knob that measures the tile policy.
    Returns (tokens [B, num_steps] int32, rings', carry [B, 2] int32).
    """
    if rings.device.type == "cpu":
        return decode_chunk_reference(w, cfg, rings, tokens_init, t0, seeds,
                                      num_steps, temperature, forced, y, g)
    if rings.device.type != "cuda":
        raise ValueError(f"decode_chunk: unsupported device {rings.device}")
    if not supported(cfg):
        raise ValueError("config not served by the narrow decode kernel "
                         "(needs kernel_size 2, bf16, no w_embed_proj and "
                         "a one-row block within the shared memory)")
    y_k, num_forced = kernel_operands(w, cfg, rings, tokens_init, seeds,
                                      forced, y, g, num_steps)
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    _, sum_d = wn.ring_offsets(cfg)
    B = tokens_init.shape[0]
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    dev = rings.device
    lib = library()
    bt = rows_per_block
    if bt is None:              # tile_rows' choice, halved until it fits
        bt = tile_rows(
            B, torch.cuda.get_device_properties(dev).multi_processor_count,
            MAX_ROWS)
        while bt > 1 and _cfg_smem(cfg, bt) > _MAX_SMEM:
            bt //= 2
    if bt not in (1, 2, 4, 8, 16):
        raise ValueError(f"rows_per_block must be 1, 2, 4, 8 or 16; got {bt}")
    smem = smem_bytes(bt, L, R, S, Q, M)
    if smem > _MAX_SMEM:
        raise ValueError(f"decode kernel needs {smem} bytes of shared "
                         f"memory per block (> {_MAX_SMEM})")
    tokens = torch.empty(B, num_steps, dtype=torch.int32, device=dev)
    rings_out = torch.empty_like(rings)
    carry = torch.empty(B, 2, dtype=torch.int32, device=dev)
    greedy = temperature <= 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wn_decode(
            ptr(seeds), ptr(tokens_init), ptr(forced),
            ptr(w["embed_cur"]), ptr(w["embed_prev"]), ptr(w["w_cur"]),
            ptr(w["w_prev"]), ptr(w["b"]), ptr(w["w_res"]), ptr(w["b_res"]),
            ptr(w["w_skip"]), ptr(w["b_skip"]), ptr(w["head_w1"]),
            ptr(w["head_b1"]), ptr(w["head_w2"]), ptr(w["head_b2"]),
            ptr(w["dils"]), ptr(y_k), ptr(w.get("v_cond")), ptr(g),
            ptr(rings), ptr(rings_out), ptr(tokens), ptr(carry),
            L, R, S, Q, M, sum_d, B, int(num_steps), int(t0),
            num_forced, int(greedy),
            0.0 if greedy else float(1.0 / temperature), bt,
            *plan(R, S, Q, M), smem, stream)
        (gc_launches if g is not None else
         mel_launches if M else launches).add()
    raise_on(lib, rc, "wn_decode")
    return tokens, rings_out, carry


def generate_narrow(params, cfg: WaveNetConfig, num_samples: int,
                    batch: int = 1,
                    prime_tokens: Optional[torch.Tensor] = None,
                    temperature: float = 1.0, seeds=0, device="cuda",
                    y: Optional[torch.Tensor] = None,
                    speaker=None) -> torch.Tensor:
    """The one-shot driver, counterpart of the reference's
    `generate_pallas`: decode_common.generate_one_shot through this
    module's decode_chunk."""
    return generate_one_shot(decode_chunk, params, cfg, num_samples, batch,
                             prime_tokens, temperature, seeds, device, y,
                             speaker)
