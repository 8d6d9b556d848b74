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
prime length, in tiles of up to 16 rows per thread block.  Its plan is
`plan` (each layer's weights staged in shared memory or read in place,
the head's resident or not, the shared-memory layout), and `pack_layers`
lays each layer's weights and biases out as one blob in the order the
kernel's lanes read them.

Routing is by the tensors' device and nothing else: `decode_chunk` runs the
plain version (`decode_chunk_reference`) only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  There is no fallback.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Optional, Tuple

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

# the most rows per block the default tile takes: 16 rows spill registers
# and measured slower than 8 rows run in two turns (PERF.md)
TILE_ROWS = 8
_MAX_SMEM = 227 * 1024

# the lanes' mapping, fixed in csrc/decode.cu: lanes splitting one unit's K
# range, units a warp owns at once, K rows of one block (8 a lane), a
# channel's gate sums per row
SEG, UNITS, BLK, SLOTS = 8, 4, 64, 6


class Plan(NamedTuple):
    """One launch's plan, in the order of csrc/decode.cu's `Plan` (the
    kernel takes it as ints and computes none of it): whether the layer
    blobs are staged in shared memory (else read in place) and the head
    blob resident; element offsets of
    phase B's weights and of the f32 biases in a layer blob and its
    length, the same of W2's weights in the head blob; byte offsets of
    the shared-memory arrays (f64 x/old/y, h, relu(skip), s1; f32 gate
    sums, skip sums, scores, speaker offsets; the ints; three mbarriers;
    two stage buffers; the head) and their total."""
    stage: int
    head_res: int
    wb: int
    bias: int
    blk: int
    h2: int
    hbias: int
    hblk: int
    x: int
    h: int
    s: int
    s1: int
    z: int
    skip: int
    score: int
    gs: int
    tok: int
    mbar: int
    stg: int
    head: int
    smem: int


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def _blobs(R: int, S: int, Q: int, M: int) -> Tuple[int, ...]:
    """Element offsets (bf16) in the blobs pack_layers lays out: a layer's
    phase A weights (per group of UNITS channels: W_cur, W_prev, V_cond
    blocks x 2 columns x 32 lanes x 8), phase B's at wb ([W_skip | W_res]
    columns), then its biases as f32 at `bias` (b, b_skip, b_res), blk in all; the
    head's W1 groups, W2's at h2, then b1 and b2 as f32 at hbias, hblk in
    all; lengths padded to 16 bytes.  Returns (wb, bias, blk, h2, hbias,
    hblk)."""
    nbR, nbS, nbM = _cdiv(R, BLK), _cdiv(S, BLK), _cdiv(M, BLK)
    wb = _cdiv(R, UNITS) * (2 * nbR + nbM) * 2 * 256
    bias = wb + _cdiv(S + R, UNITS) * nbR * 256
    blk = _cdiv(bias + 2 * (3 * R + S), 8) * 8
    h2 = _cdiv(S, UNITS) * nbS * 256
    hbias = h2 + _cdiv(Q, UNITS) * nbS * 256
    hblk = _cdiv(hbias + 2 * (S + Q), 8) * 8
    return wb, bias, blk, h2, hbias, hblk


def _layout(bt: int, L: int, R: int, S: int, Q: int, M: int, gc: bool,
            stage: bool, head_res: bool) -> Plan:
    wb, bias, blk, h2, hbias, hblk = _blobs(R, S, Q, M)
    nbR, nbS, nbM = _cdiv(R, BLK), _cdiv(S, BLK), _cdiv(M, BLK)
    off, at = 0, {}
    for name, n in (("x", 8 * bt * BLK * (2 * nbR + nbM)),
                    ("h", 8 * bt * BLK * nbR), ("s", 8 * bt * BLK * nbS),
                    ("s1", 8 * bt * BLK * nbS), ("z", 4 * R * SLOTS * bt),
                    ("skip", 4 * S * bt), ("score", 4 * Q * bt),
                    ("gs", 4 * bt * 2 * R if gc else 0),
                    ("tok", 4 * (3 * bt + 2 * L)), ("mbar", 8 * 3),
                    ("stg", 2 * 2 * blk if stage else 0),
                    ("head", 2 * hblk if head_res else 0)):
        at[name] = off
        off += _cdiv(n, 16) * 16
    return Plan(int(stage), int(head_res), wb, bias, blk, h2, hbias, hblk,
                **at, smem=off)


# the plans in the order they are tried: (staged, head resident)
PLANS = ((1, 1), (1, 0), (0, 1), (0, 0))


def plan(bt: int, L: int, R: int, S: int, Q: int, M: int,
         gc: bool = False) -> Plan:
    """The kernel's plan at bt rows per block: the first of PLANS that
    fits 227 KiB: the layer blobs staged (two buffers) with the head
    resident, else without it, else read in place.  (A plan whose smem
    exceeds 227 KiB does not fit at all: the wrapper refuses it.)"""
    for stage, head_res in PLANS:
        p = _layout(bt, L, R, S, Q, M, gc, stage, head_res)
        if p.smem <= _MAX_SMEM:
            return p
    return p


def smem_bytes(bt: int, L: int, R: int, S: int, Q: int, M: int,
               gc: bool = False) -> int:
    """Shared memory of one block at bt rows per block (plan's `smem`):
    f64 [K][bt] rows of x/old/y, h, relu(skip) and s1, each zero-padded to
    whole blocks of BLK rows; f32 gate sums [R][SLOTS][bt], skip sums
    [S][bt], scores [Q][bt] and, with a speaker, offsets [bt][2R]; ints
    (tokens, prevs, seeds, ring offsets, dilations); three mbarriers; two
    layer blobs and the head blob where they fit."""
    return plan(bt, L, R, S, Q, M, gc).smem


def _cfg_smem(cfg: WaveNetConfig, bt: int) -> int:
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    return smem_bytes(bt, cfg.num_layers, cfg.residual_channels,
                      cfg.skip_channels, cfg.quantization_channels, M,
                      cfg.global_classes is not None)


def supported(cfg: WaveNetConfig) -> bool:
    """Configs the narrow CUDA kernel serves: bf16 width-2 models with
    E == R whose one-row block fits the shared memory (its blobs read in
    place where they do not fit beside it), with or without mel and
    speaker conditioning.  Its lanes take any R, S, Q and M; the presets
    use R in {32, 64}, the tests R = 16, and the sampler sends it any
    width the wide kernel does not take (generate/sampler.py
    kernel_module)."""
    return (cfg.kernel_size == 2 and cfg.compute_dtype == "bfloat16"
            and cfg.embed_channels == cfg.residual_channels
            and _cfg_smem(cfg, 1) <= _MAX_SMEM)


def _lane_pack(W: torch.Tensor, cols: torch.Tensor) -> torch.Tensor:
    """W [L, K, N] -> [L, G, nb, C, 32 * 8]: for group g, K block b and
    column c, lane q * SEG + s's 8 weights W[k][cols[g, q, c]] at its rows
    k = BLK b + 16 j + 2 s + e (value 2 j + e), zero past K and for a
    column index N."""
    L, K, N = W.shape
    nb = _cdiv(K, BLK)
    Wz = W.new_zeros(L, nb * BLK, N + 1)
    Wz[:, :K, :N] = W
    b = torch.arange(nb)[:, None, None]
    s = torch.arange(SEG)[None, :, None]
    v = torch.arange(8)[None, None, :]
    k = (BLK * b + 16 * (v // 2) + 2 * s + v % 2).reshape(-1).to(W.device)
    G, U, C = cols.shape
    out = Wz[:, k][..., cols.reshape(-1).to(W.device)]
    out = out.reshape(L, nb, SEG, 8, G, U, C)
    return out.permute(0, 4, 1, 6, 5, 2, 3).reshape(L, G, nb, C, U * SEG * 8)


def _units(n: int, cols) -> torch.Tensor:
    """[G, UNITS, C] column indices of n units in groups of UNITS: cols(u),
    the C columns of unit u (for u >= n, the zero column)."""
    G = _cdiv(n, UNITS)
    return torch.tensor([[cols(u) for u in range(g * UNITS, (g + 1) * UNITS)]
                         for g in range(G)], dtype=torch.long)


def _f32_as_bf16(*xs) -> torch.Tensor:
    return torch.cat([x.float() for x in xs], -1).contiguous().view(
        torch.bfloat16)


def _pad(x: torch.Tensor, n: int) -> torch.Tensor:
    return torch.cat([x, x.new_zeros(*x.shape[:-1], n - x.shape[-1])], -1)


def pack_layers(w: DecodeWeights, cfg: WaveNetConfig
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(pack [L, blk], head [hblk]) bf16: each layer's weights and biases
    in one contiguous blob in the order the kernel's lanes read them (a
    stage is one copy), and the head's likewise (`_blobs`).  Every value
    is a copy of one in w (f32 bits as bf16 pairs)."""
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    _, _, blk, _, _, hblk = _blobs(R, S, Q, M)
    gate = _units(R, lambda c: [c, R + c] if c < R else [2 * R, 2 * R])
    parts = [_lane_pack(w["w_cur"], gate), _lane_pack(w["w_prev"], gate)]
    if M:
        parts.append(_lane_pack(w["v_cond"], gate))
    a = torch.cat(parts, 2).reshape(L, -1)
    sr = _lane_pack(torch.cat([w["w_skip"], w["w_res"]], -1),
                    _units(S + R, lambda u: [min(u, S + R)])).reshape(L, -1)
    bias = _f32_as_bf16(w["b"], w["b_skip"], w["b_res"])
    pack = _pad(torch.cat([a, sr, bias], -1), blk)
    h1 = _lane_pack(w["head_w1"][None], _units(S, lambda u: [min(u, S)]))
    h2 = _lane_pack(w["head_w2"][None], _units(Q, lambda u: [min(u, Q)]))
    head = _pad(torch.cat([h1.reshape(-1), h2.reshape(-1), _f32_as_bf16(
        w["head_b1"], w["head_b2"])]), hblk)
    return pack.contiguous(), head.contiguous()


# the keys whose values pack_layers copies
_PACKED = ("w_cur", "w_prev", "v_cond", "w_skip", "w_res", "b", "b_res",
           "b_skip", "head_w1", "head_b1", "head_w2", "head_b2")


def packed_layers(w: DecodeWeights, cfg: WaveNetConfig
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """pack_layers(w, cfg), kept on w (a DecodeWeights) and made anew when
    a packed tensor is replaced or updated in place."""
    key = tuple((w[k].data_ptr(), w[k]._version) for k in _PACKED if k in w)
    cache = getattr(w, "__dict__", {})
    hit = cache.get("_narrow_pack")
    if hit is None or hit[0] != key:
        hit = cache["_narrow_pack"] = (key, pack_layers(w, cfg))
    return hit[1]


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wn_decode.argtypes = [p] * 14 + [i] * 11 + [f, i, p, i, p]
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
    gc = g is not None
    if bt is None:              # tile_rows' choice, halved until it fits
        bt = tile_rows(
            B, torch.cuda.get_device_properties(dev).multi_processor_count,
            TILE_ROWS)
        while bt > 1 and smem_bytes(bt, L, R, S, Q, M, gc) > _MAX_SMEM:
            bt //= 2
    if bt not in (1, 2, 4, 8, 16):
        raise ValueError(f"rows_per_block must be 1, 2, 4, 8 or 16; got {bt}")
    pl = plan(bt, L, R, S, Q, M, gc)
    if pl.smem > _MAX_SMEM:
        raise ValueError(f"decode kernel needs {pl.smem} bytes of shared "
                         f"memory per block (> {_MAX_SMEM})")
    pack, head = packed_layers(w, cfg)
    plan_ints = (ctypes.c_int * len(pl))(*pl)
    tokens = torch.empty(B, num_steps, dtype=torch.int32, device=dev)
    rings_out = torch.empty_like(rings)
    carry = torch.empty(B, 2, dtype=torch.int32, device=dev)
    greedy = temperature <= 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wn_decode(
            ptr(seeds), ptr(tokens_init), ptr(forced),
            ptr(w["embed_cur"]), ptr(w["embed_prev"]), ptr(pack), ptr(head),
            ptr(w["dils"]), ptr(y_k), ptr(g), ptr(rings), ptr(rings_out),
            ptr(tokens), ptr(carry), L, R, S, Q, M, sum_d, B,
            int(num_steps), int(t0), num_forced, int(greedy),
            0.0 if greedy else float(1.0 / temperature), bt, plan_ints,
            len(pl), stream)
        (gc_launches if gc else mel_launches if M else launches).add()
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
