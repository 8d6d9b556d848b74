"""Whole-loop decode for wide models: the CUDA kernel (csrc/decode_wide.cu)
and its wrapper.

Counterpart of wavenet_tpu/ops/pallas/decode_wide.py (its `supported`,
`decode_chunk` and `generate_wide`; `_flatten_params` and `setup_decode`
are ops/cuda/decode_common.py's, shared with the narrow kernel), in all
three variants: unconditional, mel-conditioned (`y`) and speaker-conditioned
(`g`, with or without mel).
The TPU's tile planning (plan_tiles, _tile_bytes, TC_MIN_HW and the VMEM
budget) has no counterpart: the CUDA kernel takes any num_steps >= 1 and
any batch.  Its plan is `plan_clusters`: a cluster of C CTAs per tile of
up to 8 rows, each CTA owning a share of every layer, which `pack_shares`
lays out contiguously, and one of two exchanges between the CTAs.

Routing is by the tensors' device and nothing else: `decode_chunk` runs the
plain version (`decode_chunk_reference`) only for CPU tensors; for CUDA
tensors it launches the kernel or raises.  There is no fallback: a cluster
shape the card refuses raises too.
"""

from __future__ import annotations

import ctypes
from typing import Callable, Dict, NamedTuple, Optional, Tuple

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import build
# the drivers shared by both kernels, also reached through this module
from wavenet_tpu_torch.ops.cuda.decode_common import (  # noqa: F401
    DecodeWeights, decode_chunk_reference, flatten_params, generate_one_shot,
    kernel_operands, ptr, raise_on, setup_decode)

# one count per kernel variant, bumped where the wrapper launches it: the
# unconditional decode, the mel-conditioned decode, the speaker-conditioned
# decode (with or without mel), the RNG probe
launches = build.LaunchCounter()
mel_launches = build.LaunchCounter()
gc_launches = build.LaunchCounter()
rng_launches = build.LaunchCounter()

_MAX_SMEM = 227 * 1024
ROWS = (1, 2, 4, 8)              # rows per cluster the kernel is built for
MAX_CLUSTER = 16                 # above 8 a non-portable cluster size
DEFAULT_CLUSTER = 16             # faster than 8 on an H100 (PERF.md)
THREADS = 256                    # threads per CTA


class ClusterPlan(NamedTuple):
    """One launch's shape: `cluster` CTAs per tile of `rows` batch rows,
    `threads` per CTA, whether each layer's weight share is staged in
    shared memory (`stage`) or read from L2 in place, and whether the
    residual partial sums go to the CTA owning each column, which sends
    its slice of x back to all (`scatter`), or to every CTA (the
    all-reduce)."""
    cluster: int
    rows: int
    threads: int
    stage: bool
    scatter: bool


def supported(cfg: WaveNetConfig) -> bool:
    """Configs the wide CUDA kernel serves: bf16 width-2 models with R a
    multiple of 128 (like the TPU kernel it replaces) and S of 32, with or
    without mel and speaker conditioning.  Other widths are the narrow
    kernel's (ops/cuda/decode.py)."""
    R, S = cfg.residual_channels, cfg.skip_channels
    return (R >= 128 and R % 128 == 0 and S % 32 == 0 and cfg.kernel_size == 2
            and cfg.compute_dtype == "bfloat16" and cfg.embed_channels == R)


def _cluster_ok(cfg: WaveNetConfig, C: int) -> bool:
    """C CTAs split R and S into whole shares that the kernel stages in
    whole copies (R / C a multiple of 8, S / C even), and Q into non-empty
    ragged shares."""
    R, S, Q = (cfg.residual_channels, cfg.skip_channels,
               cfg.quantization_channels)
    return (2 <= C <= MAX_CLUSTER and R % C == 0 and S % C == 0
            and (R // C) % 8 == 0 and (S // C) % 2 == 0 and Q >= C)


def _align16(n: int) -> int:
    return -(-n // 16) * 16


def share_elems(cluster: int, cfg: WaveNetConfig) -> int:
    """bf16 elements of one CTA's share of one layer in the pack
    (csrc/decode_wide.cu `share_layout`): W_cur and W_prev [R][2hc] (its
    z_f, then its z_g columns), V_cond [M][2hc], the rows of W_skip [hc][S]
    and W_res [hc][R] its slice of h multiplies, then its biases as f32
    (2hc + R + sc: b's z_f and z_g channels, all of b_res, its b_skip
    columns), padded to 16 bytes; hc = R / C, sc = S / C."""
    R, S = cfg.residual_channels, cfg.skip_channels
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    hc, sc = R // cluster, S // cluster
    n = 2 * R * 2 * hc + M * 2 * hc + hc * S + hc * R + 2 * (2 * hc + R + sc)
    return -(-n // 8) * 8


def pack_shares(w: DecodeWeights, cfg: WaveNetConfig,
                cluster: int) -> torch.Tensor:
    """[L, C, share_elems] bf16: layer l's share of CTA c at [l, c], so a
    CTA stages a layer with one contiguous copy.  Every value is a copy of
    one in w (the biases' f32 bits as bf16 pairs)."""
    L, R, S = cfg.num_layers, cfg.residual_channels, cfg.skip_channels
    C = cluster
    hc, sc = R // C, S // C

    def gate_cols(x, K):      # [L, K, 2R] -> [L, C, K * 2hc]
        return x.reshape(L, K, 2, C, hc).permute(0, 3, 1, 2, 4).reshape(
            L, C, K * 2 * hc)

    parts = [gate_cols(w["w_cur"], R), gate_cols(w["w_prev"], R)]
    if cfg.mel is not None:
        parts.append(gate_cols(w["v_cond"], cfg.mel.num_mels))
    parts += [w["w_skip"].reshape(L, C, hc * S), w["w_res"].reshape(
        L, C, hc * R)]
    bias = torch.cat([w["b"].reshape(L, 2, C, hc).permute(0, 2, 1, 3)
                      .reshape(L, C, 2 * hc),
                      w["b_res"][:, None].expand(L, C, R),
                      w["b_skip"].reshape(L, C, sc)], -1)
    parts.append(bias.contiguous().view(torch.bfloat16))
    n = sum(x.shape[-1] for x in parts)
    parts.append(parts[0].new_zeros(L, C, share_elems(C, cfg) - n))
    return torch.cat(parts, -1).contiguous()


# the keys whose values pack_shares copies
_PACKED = ("w_cur", "w_prev", "v_cond", "w_skip", "w_res", "b", "b_res",
           "b_skip")


def packed_shares(w: DecodeWeights, cfg: WaveNetConfig,
                  cluster: int) -> torch.Tensor:
    """pack_shares(w, cfg, cluster), kept on w (a DecodeWeights) and made
    anew when a packed tensor is replaced or updated in place."""
    key = tuple((w[k].data_ptr(), w[k]._version) for k in _PACKED if k in w)
    cache = getattr(w, "__dict__", {}).setdefault("_wide_packs", {})
    hit = cache.get(cluster)
    if hit is None or hit[0] != key:
        hit = cache[cluster] = (key, pack_shares(w, cfg, cluster))
    return hit[1]


def stage_bytes(rows: int, cluster: int, cfg: WaveNetConfig) -> int:
    """Bytes of one stage buffer (csrc/decode_wide.cu `stage_layout`):
    what a CTA reads of one layer from device memory, copied a layer
    ahead: its share (share_elems, bf16), the ring rows [rows][R] bf16
    and, with a speaker, the rows' offsets [rows][2hc] f32."""
    R = cfg.residual_channels
    return (2 * share_elems(cluster, cfg) + _align16(2 * rows * R)
            + (_align16(4 * rows * 2 * (R // cluster))
               if cfg.global_classes else 0))


def smem_bytes(rows: int, cluster: int, threads: int, stage: bool,
               scatter: bool, cfg: WaveNetConfig) -> int:
    """Shared memory bytes of one CTA (csrc/decode_wide.cu `layout`), f64
    unless said: x, old [R][rows], its h slice [hc][rows], relu(skip) and
    s1 [S][rows], y [M][rows], the widest phase's partial sums, and the
    exchange's partial sums of the residual columns it reduces and of its
    skip columns (all-reduce: two buffers of C x (R + sc) per row; scatter:
    one of C x (hc + sc), with relu(skip) and s1 over the arrays only the
    layers use); two stage buffers when staged; the skip sums and scores
    as f32; the argmax candidates; the exchange's mbarriers; the rows'
    tokens and seeds; the ring offsets."""
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    C, bt = cluster, rows
    hc, sc, qc = R // C, S // C, -(-Q // C)
    units = max(threads, (3 if M else 2) * 2 * hc, sc, qc)
    head = 2 * _align16(8 * S * bt)
    if scatter:
        arrays = max(head, sum(_align16(n) for n in (
            8 * R * bt, 8 * hc * bt, 8 * M * bt, 8 * R * bt,
            8 * C * sc * bt)))
    else:
        arrays = head + sum(_align16(n) for n in (
            8 * R * bt, 8 * hc * bt, 8 * M * bt, 8 * 2 * C * R * bt,
            8 * 2 * C * sc * bt))
    sizes = [8 * R * bt, 8 * units * bt,
             2 * stage_bytes(bt, C, cfg) if stage else 0, 4 * sc * bt,
             4 * qc * bt, 4 * C * bt, 4 * C * bt, 16, 4 * bt, 4 * bt, 4 * bt,
             4 * L, 4 * L]
    return arrays + sum(_align16(n) for n in sizes)


def plan_clusters(batch: int, cfg: WaveNetConfig,
                  held: Callable[[ClusterPlan], int],
                  cluster: Optional[int] = None, rows: Optional[int] = None,
                  scatter: Optional[bool] = None) -> ClusterPlan:
    """The launch shape for `batch` rows.

    held: clusters of a plan's shape the card holds at once (max_clusters
      on the card; 0 where the shape cannot run there).
    cluster: CTAs per cluster; by default the largest of DEFAULT_CLUSTER,
      its halves down to 2, that splits the widths (R / C a multiple of 8,
      S / C even, Q >= C) and that some plan fits.
    rows: batch rows per cluster (1, 2, 4 or 8); by default the fewest at
      which every tile's cluster runs at once (ceil(batch / rows) <= held),
      so a small batch spreads over the card, else the most that fit (the
      clusters then run in turns).
    scatter: the exchange; by default the all-reduce at one row per
      cluster where its buffers (C x R partial sums) fit, the scatter
      otherwise (measured faster at more rows, PERF.md).
    The layer shares are staged when two buffers fit 227 KiB with the
    rest at some rows per cluster, else read in place.  No choice changes
    any row's result (exact sums).  Raises ValueError for a forced shape
    the kernel does not take, or a width no shape fits (R beyond 8,704 at
    S = 32: x, old and the scatter's partial sums alone are 24 bytes a
    channel; the one-block kernel before the cluster design took R up to
    5,760)."""
    if cluster is None:
        sizes = [C for C in (16, 8, 4, 2)
                 if C <= DEFAULT_CLUSTER and _cluster_ok(cfg, C)]
    else:
        if not _cluster_ok(cfg, int(cluster)):
            raise ValueError(f"cluster={cluster} does not split "
                             f"residual_channels={cfg.residual_channels}, "
                             f"skip_channels={cfg.skip_channels} (R / C a "
                             f"multiple of 8, S / C even, Q >= C, 2 <= C <= "
                             f"{MAX_CLUSTER})")
        sizes = [int(cluster)]
    if rows is not None and rows not in ROWS:
        raise ValueError(f"rows per cluster must be one of {ROWS}; got {rows}")
    def fits(bt, C, stage, mode):
        return smem_bytes(bt, C, THREADS, stage, mode, cfg) <= _MAX_SMEM

    for C in sizes:
        for stage in (True, False):
            plans = []
            for bt in (ROWS if rows is None else (rows,)):
                mode = (bt > 1 or not fits(bt, C, stage, False)
                        if scatter is None else bool(scatter))
                if fits(bt, C, stage, mode):
                    plans.append(ClusterPlan(C, bt, THREADS, stage, mode))
            plans = [p for p in plans if held(p) > 0]
            for p in plans:
                if -(-batch // p.rows) <= held(p):
                    return p
            if plans:
                return plans[-1]
    raise ValueError(f"no cluster plan of the wide decode kernel fits "
                     f"{_MAX_SMEM} bytes of shared memory per CTA on this "
                     f"card for residual_channels={cfg.residual_channels}, "
                     f"skip_channels={cfg.skip_channels}, rows={rows}, "
                     f"cluster={cluster}, scatter={scatter}")


def _bind(lib: ctypes.CDLL) -> None:
    p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wn_decode_wide.argtypes = [p] * 17 + [i] * 11 + [f] + [i] * 5 + [p]
    lib.wn_decode_wide.restype = i
    lib.wn_decode_wide_smem.argtypes = [i] * 11
    lib.wn_decode_wide_smem.restype = ctypes.c_size_t
    lib.wn_decode_wide_max_clusters.argtypes = [i] * 11 + [p]
    lib.wn_decode_wide_max_clusters.restype = i
    lib.wn_decode_wide_share.argtypes = [i] * 4
    lib.wn_decode_wide_share.restype = i
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
                 g: Optional[torch.Tensor] = None,
                 cluster: Optional[int] = None,
                 rows_per_cluster: Optional[int] = None,
                 scatter: Optional[bool] = None
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
    cluster, rows_per_cluster, scatter: force plan_clusters' choice (CTAs
      per cluster, batch rows per cluster, the exchange).  A row's result
      does not depend on them: the replay contract.
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
    with torch.cuda.device(dev):
        plan = plan_clusters(B, cfg, lambda p: max_clusters(cfg, p), cluster,
                             rows_per_cluster, scatter)
    pack = packed_shares(w, cfg, plan.cluster)
    tokens = torch.empty(B, num_steps, dtype=torch.int32, device=dev)
    rings_out = torch.empty_like(rings)
    carry = torch.empty(B, 2, dtype=torch.int32, device=dev)
    greedy = temperature <= 0
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.wn_decode_wide(
            ptr(seeds), ptr(tokens_init), ptr(forced),
            ptr(w["embed_cur"]), ptr(w["embed_prev"]), ptr(pack),
            ptr(w["head_w1"]), ptr(w["head_b1"]), ptr(w["head_w2"]),
            ptr(w["head_b2"]), ptr(w["dils"]), ptr(y_k), ptr(g),
            ptr(rings), ptr(rings_out), ptr(tokens), ptr(carry),
            L, R, S, Q, M, sum_d, B, int(num_steps), int(t0),
            num_forced, int(greedy),
            0.0 if greedy else float(1.0 / temperature),
            plan.rows, plan.cluster, plan.threads, int(plan.stage),
            int(plan.scatter), stream)
        (gc_launches if g is not None else
         mel_launches if M else launches).add()
    raise_on(lib, rc, "wn_decode_wide")
    return tokens, rings_out, carry


_held: Dict[tuple, int] = {}


def max_clusters(cfg: WaveNetConfig, plan: ClusterPlan) -> int:
    """Clusters of `plan`'s shape the current card holds at once (0: the
    shape cannot run there; cudaOccupancyMaxActiveClusters, asked once per
    card and shape); raises on a shape the kernel refuses."""
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    shape = (plan.rows, plan.cluster, plan.threads, int(plan.stage),
             int(plan.scatter), int(cfg.global_classes is not None),
             cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
             cfg.quantization_channels, M)
    key = (torch.cuda.current_device(), *shape)
    if key not in _held:
        lib = library()
        n = ctypes.c_int(0)
        rc = lib.wn_decode_wide_max_clusters(*shape, ctypes.addressof(n))
        raise_on(lib, rc, "wn_decode_wide_max_clusters")
        _held[key] = n.value
    return _held[key]


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
