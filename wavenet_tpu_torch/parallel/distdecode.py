"""Autoregressive generation over the (data, model) mesh.

Counterpart of wavenet_tpu/parallel/distdecode.py.  The reference is one
controller driving every device through shard_map; here every rank runs
the same functions on its own slice (one process per rank, started by
torchrun) and issues the collectives itself on its MeshGroups
(parallel/mesh.py).  Every rank passes the same GLOBAL arguments (seed,
prime, speakers, features) and gets the whole batch's tokens back.

Two routes, chosen by generate/sampler.py's generate_distributed:
  * the kernel fan-out (generate_kernel_dp, generate_kernel_dp_stream; the
    reference's generate_pallas_dp :616 and its stream :520): on a
    data-only mesh each rank decodes its batch / dp rows through the
    whole-loop decode kernel that takes the model (the same decode_chunk
    a single device runs), then the tokens are all-gathered over `data`;
  * the collective loop (generate_sharded, generate_sharded_stream; :195,
    :257): the gated layers run Megatron-style on each rank's column and
    row slices (parallel/sharding.py).  With shard_rings_model the rings
    also split their channels over `model`, and each step all-gathers the
    ring rows its layers read.  Sampling is a distributed Gumbel-argmax:
    each rank draws the noise of its own classes from the counter RNG
    keyed by the GLOBAL class index, takes its best, and a max then a min
    over `model` pick the winner.

Exactness.  The port's decode sums each bf16 dot product exactly in f64
and rounds once to f32 (models/wavenet.py _dot), and adds b_skip to the
f32 skip sum at every layer.  So the collective loop does not reduce `res`
and `skip` in f32 at two sites as the reference does (its psums at :94 and
:181): each rank computes the exact f64 partial sums of h @ w_res and
h @ w_skip over its R/mp rows, one all-reduce in float64 of the [B, S + R]
buffer per layer adds them (a sum of exact partials is the exact sum), and
only then are they rounded to f32.  It is still one collective per layer,
and every mesh layout gives the single-device bits: tokens, rings and
carry.  The fan-out runs the single-device kernel on each row, and a row's
result does not depend on the rows beside it.  Per-row seeds come from the
GLOBAL batch (rng.as_row_seeds(seed, batch)) and are then sliced, as are
the speakers, primes and features, so a row's audio is the same on any
layout.
"""

from __future__ import annotations

from typing import Iterator, Optional

import torch
import torch.distributed as dist

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import conditioning
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import decode_common
from wavenet_tpu_torch.parallel import sharding as shd
from wavenet_tpu_torch.parallel.mesh import MeshGroups, mesh_groups


def as_groups(mesh) -> MeshGroups:
    """A DeviceMesh (make_mesh) -> its MeshGroups; a MeshGroups (e.g. a
    serving lane's own, mesh.new_mesh_groups) passes through."""
    return mesh if isinstance(mesh, MeshGroups) else mesh_groups(mesh)


def check_mesh(cfg: WaveNetConfig, groups: MeshGroups, batch: int) -> None:
    """The reference's refusals (:216-224) and the split widths."""
    if cfg.kernel_size != 2:
        raise ValueError("the distributed decoder's ring exchange is "
                         "width-2 only; decode kernel_size > 2 models on "
                         "one device (sampler.generate_auto)")
    if batch % groups.dp:
        raise ValueError(f"batch {batch} not divisible by data={groups.dp}")
    shd.validate(cfg, groups.mp)


def local_rows(groups: MeshGroups, batch: int) -> slice:
    """This rank's rows of the global batch (its data index's block)."""
    n = batch // groups.dp
    return slice(groups.data_index * n, (groups.data_index + 1) * n)


def _rows_of(x, rows: slice, device):
    return None if x is None else torch.as_tensor(x, device=device)[rows]


def _all_gather(t: torch.Tensor, group, size: int, dim: int) -> torch.Tensor:
    """The ranks' tensors concatenated along dim, in rank order."""
    if size == 1:
        return t
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(size)]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts, dim=dim)


def gather_rows(toks: torch.Tensor, groups: MeshGroups) -> torch.Tensor:
    """[batch / dp, n] tokens of each rank -> the whole [batch, n] on
    every rank (the counterpart of the reference's _unreplicate_tokens,
    :330: the model ranks of a data index hold the same tokens)."""
    return _all_gather(toks, groups.data, groups.dp, 0)


# ---------------------------------------------------------------------------
# The collective loop's weights and step
# ---------------------------------------------------------------------------

class LocalWeights(dict):
    """One rank's model-sharded weights in the decode layout: each gate
    leaf cut on the unfolded [.., 2, R] axis (parallel/sharding.py), then
    folded to [.., 2R/mp] (the first R/mp columns the filter's, the next
    the gate's): w_cur, w_prev [L, R, 2R/mp], b [L, 2R/mp], v_cond
    [L, M, 2R/mp], v_global [L, G, 2R/mp]; w_out [L, R/mp, S + R] f64,
    the row slices of w_skip and w_res side by side (the layer's one
    reduced product); head_w2 [S, Q/mp], head_b2 [Q/mp]; the rest whole.
    conditioning.project_cond takes its v_cond as it is: the local
    columns' contributions, aligned with the local z."""


def local_weights(params, cfg: WaveNetConfig,
                  groups: MeshGroups) -> LocalWeights:
    """Model params or DecodeWeights -> this rank's LocalWeights."""
    L, R, S = cfg.num_layers, cfg.residual_channels, cfg.skip_channels
    Rl = R // groups.mp
    cdt, f32, f64 = wn.compute_dtype(cfg), torch.float32, torch.float64
    p = shd.shard_params(params, cfg, groups.mp, groups.model_index)
    edt = decode_common.embed_dtype(cfg)
    w = LocalWeights(
        embed_cur=p["embed_cur"].to(edt), embed_prev=p["embed_prev"].to(edt),
        w_cur=p["w_cur"].reshape(L, R, 2 * Rl).to(cdt),
        w_prev=p["w_prev"].reshape(L, R, 2 * Rl).to(cdt),
        b=p["b"].reshape(L, 2 * Rl).to(f32),
        w_out=torch.cat([p["w_skip"].reshape(L, Rl, S),
                         p["w_res"].reshape(L, Rl, R)], dim=2
                        ).to(cdt).to(f64),
        b_res=p["b_res"].to(f32), b_skip=p["b_skip"].to(f32),
        head_w1=p["head_w1"].to(cdt), head_b1=p["head_b1"].to(f32),
        head_w2=p["head_w2"].to(cdt), head_b2=p["head_b2"].to(f32))
    if cfg.mel is not None:
        w["v_cond"] = p["v_cond"].reshape(L, cfg.mel.num_mels,
                                          2 * Rl).to(cdt)
    if cfg.global_classes is not None:
        w["g_embed"] = p["g_embed"].to(f32)
        w["v_global"] = p["v_global"].reshape(
            L, cfg.global_channels, 2 * Rl).to(cdt)
    if cfg.embed_channels != R:
        w["w_embed_proj"] = p["w_embed_proj"].to(cdt)
    return LocalWeights({k: v.detach().contiguous() for k, v in w.items()})


def speaker_offsets_local(w: LocalWeights, cfg: WaveNetConfig,
                          speaker: torch.Tensor) -> torch.Tensor:
    """The speaker offsets of this rank's gate columns, [L, B, 2R/mp] f32:
    g_embed[speaker] @ v_global[l] on the local column slice, each dot
    summed exactly (models/wavenet.global_cond_offsets' recipe), so they
    are the single-device offsets' columns."""
    cdt = wn.compute_dtype(cfg)
    gvec = w["g_embed"][speaker.long()]
    return torch.stack([wn._dot(gvec, w["v_global"][l], cdt)
                        for l in range(cfg.num_layers)]).contiguous()


def _layer_scan_local(cfg: WaveNetConfig, w: LocalWeights, groups,
                      x: torch.Tensor, old_all: torch.Tensor, gcond=None,
                      cond=None):
    """Every gated layer on this rank's slices.  x [B, R] (f32 holding
    compute-dtype values) and old_all [L, B, R] carry the full channel
    width; z and h have the local columns; the row-split products end in
    one f64 all-reduce over `model` per layer (module docstring).
    Returns (x after the last layer, the f32 skip sum with every b_skip
    added, the layer inputs [L, B, R])."""
    cdt, f32, f64 = wn.compute_dtype(cfg), torch.float32, torch.float64
    S = cfg.skip_channels
    Rl = cfg.residual_channels // groups.mp
    skip = torch.zeros(x.shape[0], S, device=x.device)
    inputs = []
    for l in range(cfg.num_layers):
        z = (wn._dot(x, w["w_cur"][l], cdt)
             + wn._dot(old_all[l], w["w_prev"][l], cdt))
        z = z + w["b"][l]                                  # [B, 2R/mp]
        if cond is not None:
            z = z + cond[:, l]
        if gcond is not None:
            z = z + gcond[l]
        h = wn._round(torch.tanh(z[:, :Rl]) * torch.sigmoid(z[:, Rl:]), cdt)
        part = h.to(cdt).to(f64) @ w["w_out"][l]          # exact partials
        if groups.mp > 1:
            dist.all_reduce(part, group=groups.model)      # exact sum
        part = part.to(f32)
        skip = (skip + part[:, :S]) + w["b_skip"][l]
        inputs.append(x)
        x = wn._round((x + part[:, S:]) + w["b_res"][l], cdt)
    return x, skip, torch.stack(inputs)


def _sample_distributed(logits_local: torch.Tensor, seeds: torch.Tensor,
                        t: int, col0: int, temperature: float,
                        groups: MeshGroups) -> torch.Tensor:
    """Gumbel-argmax over the class dim split over `model`: this rank
    holds classes [col0, col0 + Q/mp) and draws their noise from the
    counter RNG keyed by (row seed, global step t, GLOBAL class); a max of
    the local bests over `model`, then a min of the winning class ids (the
    lowest on a tie, as a single device's first-index argmax).  Greedy at
    temperature <= 0.  The scores are the single device's, column for
    column, so the token is too."""
    if temperature > 0:
        g = rng.counter_gumbel(seeds, t, logits_local.shape[-1], class0=col0)
        scores = logits_local * (1.0 / temperature) + g
    else:
        scores = logits_local
    idx = torch.argmax(scores, dim=-1)
    tok = (idx + col0).to(torch.int32)
    if groups.mp == 1:
        return tok
    best = scores.gather(1, idx[:, None])[:, 0]
    top = best.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=groups.model)
    cand = torch.where(best == top, tok, torch.full_like(tok, 2 ** 30))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=groups.model)
    return cand


def decode_step_sharded(w: LocalWeights, cfg: WaveNetConfig,
                        groups: MeshGroups, state: wn.DecodeState,
                        token: torch.Tensor, *, shard_rings_model: bool,
                        cond_t=None, gcond=None):
    """One sharded decode step (the reference's :139).  state.queues:
    [sum_d, B/dp, Rq], Rq = R/mp with shard_rings_model (the step's ring
    rows are then all-gathered over `model`, the cached-state exchange)
    else R; updated in place.  cond_t: [B, L, 2R/mp] this step's local
    conditioning; gcond: [L, B, 2R/mp] local speaker offsets.  Returns
    (the new state, logits of the local classes [B/dp, Q/mp])."""
    x = wn.embed_tokens(w, cfg, token, state.prev_token)      # [B, R]
    offs, _ = wn.ring_offsets(cfg)
    slots = torch.tensor([o + state.t % d for o, d in
                          zip(offs, cfg.dilations)], device=x.device)
    queues = state.queues
    old_all = queues[slots]                                   # [L, B, Rq]
    if shard_rings_model:
        old_all = _all_gather(old_all, groups.model, groups.mp, 2)
    x, skip, inputs = _layer_scan_local(cfg, w, groups, x, old_all.float(),
                                        gcond=gcond, cond=cond_t)
    queues[slots] = inputs[:, :, shd.ring_channels(
        cfg, groups.mp, groups.model_index, shard_rings_model)].to(
        queues.dtype)
    logits = wn.head_logits(w, cfg, skip)
    return wn.DecodeState(queues, token.to(torch.int32), state.t + 1), logits


def decode_chunk_sharded(w: LocalWeights, cfg: WaveNetConfig,
                         groups: MeshGroups, rings: torch.Tensor,
                         tokens_init: torch.Tensor, t0: int,
                         seeds: torch.Tensor, num_steps: int,
                         temperature: float = 1.0,
                         forced: Optional[torch.Tensor] = None,
                         y: Optional[torch.Tensor] = None,
                         g: Optional[torch.Tensor] = None,
                         shard_rings_model: bool = False):
    """The collective loop's launch, with decode_chunk's signature and
    carry convention on this rank's rows (the reference's priming and
    chunk programs, :350 and :419, in one: steps before the prime's end
    teacher-force it).  rings [sum_d, B/dp, Rq]; tokens_init [B/dp, 2];
    seeds [B/dp]; forced [B/dp, P]; y [B/dp, num_steps, M] this chunk's
    features; g [L, B/dp, 2R/mp] (speaker_offsets_local).  Returns
    (tokens [B/dp, num_steps], rings, carry), equal on every model rank."""
    cdt = wn.compute_dtype(cfg)
    col0 = groups.model_index * (cfg.quantization_channels // groups.mp)
    state = wn.DecodeState(rings.clone(), tokens_init[:, 1].to(torch.int32),
                           int(t0))
    token = tokens_init[:, 0].to(torch.int32)
    num_forced = 0 if forced is None else forced.shape[1]
    out = torch.empty(token.shape[0], num_steps, dtype=torch.int32,
                      device=rings.device)
    for t in range(num_steps):
        step = state.t
        cond_t = (None if y is None
                  else conditioning.project_cond(w, y[:, t], cdt))
        state, logits = decode_step_sharded(
            w, cfg, groups, state, token,
            shard_rings_model=shard_rings_model, cond_t=cond_t, gcond=g)
        nxt = _sample_distributed(logits, seeds, step, col0, temperature,
                                  groups)
        out[:, t] = nxt                      # the model's own choice ...
        if step + 1 < num_forced:            # ... then the prime overrides
            nxt = forced[:, step + 1].to(torch.int32)
        token = nxt
    carry = torch.stack([token, state.prev_token], dim=1)
    return out, state.queues, carry


# ---------------------------------------------------------------------------
# Drivers
# ---------------------------------------------------------------------------

def generate_sharded_stream(params, cfg: WaveNetConfig, mesh, seed,
                            num_samples: int, batch: int,
                            chunk_samples: int = 16000,
                            prime_tokens: Optional[torch.Tensor] = None,
                            speaker=None, y: Optional[torch.Tensor] = None,
                            temperature: float = 1.0,
                            shard_rings_model: bool = False, device="cuda",
                            local_y: Optional[torch.Tensor] = None
                            ) -> Iterator[torch.Tensor]:
    """Streaming collective decode: yields [batch, <= chunk_samples] int32
    token chunks on every rank, the state carried from chunk to chunk and
    the RNG keyed by the global step, so the chunks concatenate to the
    one-shot generate_sharded.  seed: an int or [batch] row seeds;
    prime_tokens [batch, P]; speaker [batch] ids; y [batch, >= max(P - 1,
    0) + num_samples, M] upsampled features, or local_y, this rank's rows
    of them (a caller that upsampled only its own rows).  params: model
    params, DecodeWeights or this rank's LocalWeights, on `device`."""
    if chunk_samples < 1:
        raise ValueError("chunk_samples must be >= 1")
    groups = as_groups(mesh)
    check_mesh(cfg, groups, batch)
    w = local_weights(params, cfg, groups)
    rings, carry, seeds, g, prime, local_y, P, total = setup_sharded(
        w, cfg, groups, batch, num_samples, prime_tokens, seed, speaker, y,
        local_y, device, shard_rings_model)
    t0, skip = 0, max(P - 1, 0)
    while t0 < total:
        n = min(chunk_samples, total - t0)
        toks, rings, carry = decode_chunk_sharded(
            w, cfg, groups, rings, carry, t0, seeds, n, temperature,
            forced=prime if t0 < P - 1 else None,
            y=None if local_y is None else local_y[:, t0:t0 + n], g=g,
            shard_rings_model=shard_rings_model)
        if skip:
            drop = min(skip, n)
            toks, skip = toks[:, drop:], skip - drop
        if toks.shape[1]:
            yield gather_rows(toks, groups)
        t0 += n


def setup_sharded(w: LocalWeights, cfg: WaveNetConfig, groups: MeshGroups,
                  batch: int, num_samples: int, prime_tokens=None, seed=0,
                  speaker=None, y=None, local_y=None, device="cuda",
                  shard_rings_model: bool = False):
    """This rank's decode set-up on the collective loop, from the global
    arguments (the counterpart of decode_common.setup_decode): zero rings
    [sum_d, B/dp, Rq] in the compute dtype, the carry [B/dp, 2] (the
    prime's first token, else Q // 2), the row seeds of the GLOBAL batch
    sliced to this rank's rows, the local speaker offsets, this rank's
    rows of the prime and of the features covering the timeline.
    Returns (rings, carry, seeds, g, prime, local_y, P, total_steps)."""
    rows = local_rows(groups, batch)
    B = rows.stop - rows.start
    P = 0 if prime_tokens is None else prime_tokens.shape[1]
    total = max(P - 1, 0) + num_samples
    seeds = rng.as_row_seeds(seed, batch, device)[rows]
    prime = _rows_of(prime_tokens, rows, device)
    _, sum_d = wn.ring_offsets(cfg)
    ch = shd.ring_channels(cfg, groups.mp, groups.model_index,
                           shard_rings_model)
    rings = torch.zeros(sum_d, B, ch.stop - ch.start,
                        dtype=wn.compute_dtype(cfg), device=device)
    carry = torch.zeros(B, 2, dtype=torch.int32, device=device)
    carry[:, 0] = cfg.quantization_channels // 2
    if P:
        lo, hi = int(prime_tokens.min()), int(prime_tokens.max())
        if lo < 0 or hi >= cfg.quantization_channels:
            raise ValueError(f"prime token ids must lie in [0, "
                             f"{cfg.quantization_channels}); got "
                             f"[{lo}, {hi}]")
        prime = prime.to(torch.int32).contiguous()
        carry[:, 0] = prime[:, 0]
    g = None
    if cfg.global_classes is not None or speaker is not None:
        ids = _check_speaker(cfg, speaker, batch, device)
        g = speaker_offsets_local(w, cfg, ids[rows])
    if local_y is None:
        local_y = _rows_of(y, rows, device)
    local_y = decode_common.cond_timeline(local_y, total)
    decode_common.check_y(cfg, local_y, B, total)
    return rings, carry, seeds, g, prime, local_y, P, total


def _check_speaker(cfg: WaveNetConfig, speaker, batch: int,
                   device) -> torch.Tensor:
    """The global speaker ids [batch] as int64 on `device`, refused as the
    single-device set-up refuses them (decode_common.speaker_offsets)."""
    if cfg.global_classes is None:
        raise ValueError("model has no global conditioning; speaker= is "
                         "not an input")
    if speaker is None:
        raise ValueError("cfg.global_classes set but no speaker ids passed")
    ids = torch.as_tensor(speaker, device=device).to(torch.int64).reshape(-1)
    if ids.shape[0] != batch:
        raise ValueError(f"speaker has {ids.shape[0]} ids for a batch of "
                         f"{batch}")
    lo, hi = int(ids.min()), int(ids.max())
    if lo < 0 or hi >= cfg.global_classes:
        raise ValueError(f"speaker ids must lie in [0, {cfg.global_classes})"
                         f"; got [{lo}, {hi}]")
    return ids


def generate_sharded(params, cfg: WaveNetConfig, mesh, seed,
                     num_samples: int, batch: int,
                     prime_tokens: Optional[torch.Tensor] = None,
                     speaker=None, y: Optional[torch.Tensor] = None,
                     temperature: float = 1.0,
                     shard_rings_model: bool = False, device="cuda",
                     local_y: Optional[torch.Tensor] = None) -> torch.Tensor:
    """[batch, num_samples] int32 tokens on every rank from the collective
    loop in one launch (the arguments of generate_sharded_stream)."""
    P = 0 if prime_tokens is None else prime_tokens.shape[1]
    total = max(P - 1, 0) + num_samples
    return torch.cat(list(generate_sharded_stream(
        params, cfg, mesh, seed, num_samples, batch, chunk_samples=total,
        prime_tokens=prime_tokens, speaker=speaker, y=y,
        temperature=temperature, shard_rings_model=shard_rings_model,
        device=device, local_y=local_y)), dim=1)


def _kernel_dp_args(cfg: WaveNetConfig, mesh, seed, batch: int,
                    prime_tokens, speaker, y, local_y, device):
    """The fan-out's groups, kernel module and this rank's rows of every
    per-row input."""
    from wavenet_tpu_torch.generate import sampler
    groups = as_groups(mesh)
    if groups.mp != 1:
        raise ValueError("the kernel fan-out runs on a data-only mesh; a "
                         "model-sharded one decodes by generate_sharded")
    if batch % groups.dp:
        raise ValueError(f"batch {batch} not divisible by data={groups.dp}")
    mod = sampler.kernel_module(cfg, device)
    if mod is sampler.PLAIN:
        raise ValueError("no decode kernel takes this model; it decodes "
                         "over the mesh by generate_sharded")
    rows = local_rows(groups, batch)
    kw = dict(batch=rows.stop - rows.start,
              seeds=rng.as_row_seeds(seed, batch, device)[rows],
              prime_tokens=_rows_of(prime_tokens, rows, device),
              speaker=_rows_of(speaker, rows, device),
              y=_rows_of(y, rows, device) if local_y is None else local_y,
              device=device)
    return groups, kw


def generate_kernel_dp(params, cfg: WaveNetConfig, mesh, seed,
                       num_samples: int, batch: int,
                       prime_tokens: Optional[torch.Tensor] = None,
                       speaker=None, y: Optional[torch.Tensor] = None,
                       temperature: float = 1.0, device="cuda",
                       local_y: Optional[torch.Tensor] = None
                       ) -> torch.Tensor:
    """Data-parallel fan-out of the whole-loop decode kernel (the
    reference's generate_pallas_dp): each rank decodes its batch / dp rows
    with the whole model through sampler.generate_auto, the tokens are
    all-gathered over `data`; [batch, num_samples] on every rank, equal to
    one device's decode of the whole batch at the same seeds.  params:
    model params or DecodeWeights on `device`; the rest as in
    generate_sharded_stream."""
    from wavenet_tpu_torch.generate import sampler
    groups, kw = _kernel_dp_args(cfg, mesh, seed, batch, prime_tokens,
                                 speaker, y, local_y, device)
    toks = sampler.generate_auto(params, cfg, num_samples,
                                 temperature=temperature, **kw)
    return gather_rows(toks, groups)


def generate_kernel_dp_stream(params, cfg: WaveNetConfig, mesh, seed,
                              num_samples: int, batch: int,
                              chunk_samples: int = 16000,
                              prime_tokens: Optional[torch.Tensor] = None,
                              speaker=None, y: Optional[torch.Tensor] = None,
                              temperature: float = 1.0, device="cuda",
                              local_y: Optional[torch.Tensor] = None
                              ) -> Iterator[torch.Tensor]:
    """Streaming kernel fan-out (the reference's
    generate_pallas_dp_stream): each rank streams its rows through
    sampler.generate_stream and every chunk is all-gathered over `data`;
    the chunks concatenate to generate_kernel_dp's tokens."""
    from wavenet_tpu_torch.generate import sampler
    groups, kw = _kernel_dp_args(cfg, mesh, seed, batch, prime_tokens,
                                 speaker, y, local_y, device)
    for toks in sampler.generate_stream(params, cfg, num_samples,
                                        chunk_samples=chunk_samples,
                                        temperature=temperature, **kw):
        yield gather_rows(toks, groups)
