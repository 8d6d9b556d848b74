"""Sequence (time-axis) parallelism: the halo exchange and overlap-discard.

Counterpart of wavenet_tpu/parallel/seqpar.py.  The reference shards the
time axis with shard_map over ('data', 'seq') and ppermutes each layer's
left context; here every rank is a process holding its [B/dp, T/sp] slice
of the window (sharding.batch_slice) and the whole params (or its Megatron
slice, when the mesh also has a model axis), and issues the exchanges
itself (parallel/collectives.py, each with its transpose as the
backward):

  * loss_fn_sp, the scan: each layer's left context is the previous shard's
    last maxd inputs (_right_halo_fn, one exchange of [B, maxd, R] a
    layer), so the sharded forward is the unsharded one's arithmetic;
  * loss_fn_sp_fused, overlap-discard: the fused stack's kernels
    (ops/cuda/train_stack.forward_skip_fused, unchanged) run on each
    shard's [B, H + T/sp, R] window, H the stack's receptive field
    rounded up to whole tiles, with the H rows before the shard fetched
    from its left neighbor in ONE exchange of the embedded input (and the
    upsampled features); the first H outputs are dropped.  Positions past
    H see their whole receptive field inside the window, so the kept
    outputs are those of the unsharded stack.  Shard 0 puts its data at
    the window's START and the zero rows after it (the reference's roll):
    a zero-filled halo is not the kernel's zero-ring start, because the
    gate and residual biases are added to the phantom rows.

Both return this rank's share of the global mean loss (its nll sum over
the GLOBAL token count, so the gradients summed over the (data, seq)
replicas are the global mean's) and the global metrics, as
dataparallel.loss_fn_dp does.  The mel features are upsampled over the
whole window on every seq rank before the time split (frame-to-sample
alignment does not split cleanly, as in the reference); the speaker
offsets are time-constant and need no halo.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import conditioning
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.parallel import collectives as col
from wavenet_tpu_torch.parallel import megatron
from wavenet_tpu_torch.parallel.mesh import MeshGroups


def _right_halo_fn(maxd: int, seq: col.Axis):
    """Per-layer halo: shard i sends its last maxd samples to shard i+1.
    Shard 0 receives zeros, exactly the causal zero left-padding at the
    sequence start."""
    def halo(x):
        return col.ppermute(x[:, -maxd:, :].contiguous(), seq, 1)
    return halo


def _prev_tokens_sp(tokens: torch.Tensor, seq: col.Axis) -> torch.Tensor:
    """tokens[t-1] with the shard boundary value fetched from the left
    neighbor (shard 0 gets the zero token)."""
    boundary = col.shift(tokens[:, -1:].contiguous(), seq, 1)
    return torch.cat([boundary, tokens[:, :-1]], dim=1)


def check_seq_shardable(cfg: WaveNetConfig, sp: int, T: int) -> int:
    """T / sp, or ValueError: width-2 models only (at any sp: a K > 2
    tap's (K-1) maxd shift through a maxd-wide halo would read the wrong
    samples), T divisible by sp, and a shard at least max_dilation long
    (the halo comes from one neighbor)."""
    if cfg.kernel_size != 2:
        raise ValueError("the sequence-parallel path is width-2 only (the "
                         "halo carries maxd samples and one prev token); "
                         "run kernel_size > 2 models through the plain "
                         "forward / data-parallel paths instead")
    if T % sp:
        raise ValueError(f"sequence length {T} not divisible by seq={sp}")
    local = T // sp
    if sp > 1 and local < cfg.max_dilation:
        raise ValueError(
            f"T/seq = {local} < max_dilation = {cfg.max_dilation}: halo would "
            f"span more than one neighbor; use fewer seq shards")
    return local


def _local_features(params, cfg: WaveNetConfig, mel, seq: col.Axis,
                    T_local: int) -> Optional[torch.Tensor]:
    """This shard's [b, T/sp, M] slice of the features upsampled over the
    whole window (None without mel)."""
    if cfg.mel is None:
        return None
    if mel is None:
        raise ValueError("cfg.mel set but no mel features passed")
    y = conditioning.upsample_mel(params["upsampler"], cfg.mel, mel,
                                  T_local * seq.size)
    return y[:, seq.index * T_local:(seq.index + 1) * T_local]


def _model_split(groups: MeshGroups) -> Optional[megatron.ModelSplit]:
    return megatron.ModelSplit(col.axis_of(groups, "model")) \
        if groups.mp > 1 else None


def _loss_sums(logits, targets, tp=None) -> torch.Tensor:
    """[nll sum, correct count] of this rank's positions."""
    if tp is not None:
        return megatron.local_sums(logits, targets, tp)
    correct = (torch.argmax(logits, dim=-1) == targets.long()).float()
    return torch.stack([wn._nll(logits, targets).sum(), correct.sum()])


def metrics(sums: torch.Tensor, groups: MeshGroups, n_tokens: int
            ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(this rank's loss share, the global metrics) of its [nll, correct]
    sums: the share is the local nll over the global token count; the
    metrics add every replica's sums (one small all-reduce over
    (data, seq))."""
    total = col.all_reduce(sums.detach().clone(), groups.replica)
    n = float(n_tokens)
    loss = total[0] / n
    return sums[0] / n, {"loss": loss,
                         "bits_per_sample": loss / math.log(2.0),
                         "accuracy": total[1] / n}


def forward_logits_sp(params, cfg: WaveNetConfig, groups: MeshGroups,
                      tokens: torch.Tensor,
                      mel: Optional[torch.Tensor] = None,
                      speaker=None) -> torch.Tensor:
    """Sequence-parallel forward: this rank's [B/dp, T/sp] slice of the
    tokens -> its [B/dp, T/sp, Q] logits, those of the unsharded forward
    at these positions (with a model axis, its [.., Q/mp] class columns:
    the params are then its Megatron slices).  mel: its rows' whole
    [B/dp, F, M] frames; speaker: its rows' [B/dp] ids (time-constant, so
    they need no halo)."""
    seq = col.axis_of(groups, "seq")
    Tl = tokens.shape[1]
    check_seq_shardable(cfg, seq.size, Tl * seq.size)
    return wn.forward_logits(
        params, cfg, tokens, prev_tokens=_prev_tokens_sp(tokens, seq),
        halo_fn=_right_halo_fn(cfg.max_dilation, seq),
        upsampled_cond=_local_features(params, cfg, mel, seq, Tl),
        speaker=speaker, tp=_model_split(groups))


def loss_fn_sp(params, cfg: WaveNetConfig, groups: MeshGroups,
               inputs: torch.Tensor, targets: torch.Tensor,
               mel: Optional[torch.Tensor] = None, speaker=None
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence-parallel training loss through the scan.  inputs, targets:
    this rank's [B/dp, W/sp] slices of window[:, :-1] and window[:, 1:]
    (sharding.batch_slice); mel, speaker: as forward_logits_sp's.  With a
    model axis the params are this rank's Megatron slices and the layers
    run split (parallel/megatron.py)."""
    logits = forward_logits_sp(params, cfg, groups, inputs, mel, speaker)
    n = inputs.numel() * groups.dp * groups.sp
    return metrics(_loss_sums(logits, targets, _model_split(groups)),
                   groups, n)


# ---------------------------------------------------------------------------
# overlap-discard through the fused stack
# ---------------------------------------------------------------------------

def _halo_tiles(cfg: WaveNetConfig, TT: int) -> int:
    """Warmup rows each shard prepends, rounded up to whole kernel tiles:
    the stack's receptive field is sum(dilations), so outputs at positions
    >= H are exact even though the stack starts from zero history."""
    rf = sum(cfg.dilations)
    return -(-rf // TT) * TT


def sp_fused_supported(cfg: WaveNetConfig, W: int, sp: int) -> bool:
    """Can the fused stack serve seq-parallel training via overlap-discard?
    Needs tileable local windows and a local window long enough that the
    halo comes from ONE left neighbor."""
    from wavenet_tpu_torch.ops.cuda import train_stack as ts
    if sp <= 1 or W % sp or not ts.config_taken(cfg):
        return False
    Tl = W // sp
    TT = ts.pick_tile(cfg, Tl)
    if not TT or not ts.group_plan(cfg, TT):
        return False
    return Tl >= _halo_tiles(cfg, TT)


def loss_fn_sp_fused(params, cfg: WaveNetConfig, groups: MeshGroups,
                     inputs: torch.Tensor, targets: torch.Tensor,
                     mel: Optional[torch.Tensor] = None, speaker=None
                     ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Sequence-parallel loss through the fused stack (the kernels for
    tensors on the card), by overlap-discard; arguments as loss_fn_sp's
    (no model axis: the fused stack needs every channel of a layer).
    Extra stack work is H / (W/sp) (at `full`, W = 8192, sp = 2:
    H = 4096 = W/sp, so each shard runs a whole 8192-row window)."""
    from wavenet_tpu_torch.ops.cuda import train_stack as ts
    if groups.mp > 1:
        raise ValueError("overlap-discard runs the whole stack on each "
                         "shard; with a model axis use loss_fn_sp")
    seq = col.axis_of(groups, "seq")
    Tl = inputs.shape[1]
    check_seq_shardable(cfg, seq.size, Tl * seq.size)
    TT = ts.pick_tile(cfg, Tl)
    if not TT:
        raise ValueError(f"T/seq = {Tl} is not tileable for this config; "
                         f"gate on sp_fused_supported()")
    H = _halo_tiles(cfg, TT)
    if Tl < H:
        raise ValueError(f"T/seq = {Tl} < warmup {H}; gate on "
                         f"sp_fused_supported()")
    first = seq.index == 0

    def ext(a):                                  # [b, H + Tl, C]
        halo = col.ppermute(a[:, -H:].contiguous(), seq, 1)
        # shard 0's halo is zeros: its data goes first and the zeros
        # after (still on the graph, so its backward takes part in the
        # exchange of the cotangents)
        return torch.cat([a, halo] if first else [halo, a], dim=1)

    x = wn.embed_tokens(params, cfg, inputs, _prev_tokens_sp(inputs, seq))
    y = _local_features(params, cfg, mel, seq, Tl)
    g = wn._speaker_offsets(params, cfg, speaker)
    skip = ts.forward_skip_fused(params, cfg, ext(x), tile=TT,
                                 y=None if y is None else ext(y), g=g)
    skip = skip[:, :Tl] if first else skip[:, H:]
    logits = wn.head_logits(params, cfg, skip)
    n = inputs.numel() * groups.dp * groups.sp
    return metrics(_loss_sums(logits, targets), groups, n)
