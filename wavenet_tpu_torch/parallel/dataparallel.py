"""Data parallelism over the mesh's data axis: each rank computes the loss
of its own rows through the same per-device stack, and the gradients are
summed across ranks.

Counterpart of wavenet_tpu/parallel/dataparallel.py, where a shard_map over
('data',) gives each chip a local batch slice so the Pallas kernel runs
unchanged, and shard_map's transpose inserts the gradient psum.  Here each
rank is a process holding whole params and its rows of the global batch:
  * loss_fn_dp returns this rank's share of the global mean loss, its
    local nll sum over the GLOBAL token count, so the gradients summed by
    one all_reduce equal the gradient of the global mean, the reference's
    psum'd one; the metrics' two sums (nll, correct) travel in one small
    all_reduce and come back global;
  * reduce_gradients sums the gradients as one flat buffer in sorted-key
    order (a fixed order: two runs are bit-identical, and every rank gets
    the same bits);
  * broadcast_params makes every rank start from rank 0's params;
    check_replicas shows that they stayed equal.
In a group of one rank, loss_fn_dp is models/wavenet.loss_fn itself and
a sum over one rank is its input, so a one-rank run equals a run without a
process group bit for bit.  Without a process group the other functions
return their input.
"""

from __future__ import annotations

import math
from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.parallel import collectives as col


def _size(group) -> int:
    return dist.get_world_size(group) if dist.is_initialized() else 1


def _src(group) -> int:
    return dist.get_global_rank(group, 0) if group is not None else 0


def loss_fn_dp(params, cfg: WaveNetConfig, tokens: torch.Tensor,
               use_fused: bool = False,
               mel: Optional[torch.Tensor] = None,
               speaker: Optional[torch.Tensor] = None,
               group=None) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss share, global metrics) of this rank's rows: tokens [b, W+1]
    (mel [b, F, M] and speaker [b] split by rows like them), b the global
    batch over the group's size.  The loss share's gradients, summed over
    the group (reduce_gradients), are the global mean loss's; aux holds
    the global loss, bits_per_sample and accuracy.  The stack runs through
    the fused kernels when use_fused, else through the scan."""
    n_ranks = _size(group)
    if n_ranks == 1:
        return wn.loss_fn(params, cfg, tokens, mel=mel, use_fused=use_fused,
                          speaker=speaker)
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if use_fused:
        logits = wn.forward_logits_fused(params, cfg, inputs, mel=mel,
                                         speaker=speaker)
    else:
        logits = wn.forward_logits(params, cfg, inputs, mel=mel,
                                   speaker=speaker)
    correct = (torch.argmax(logits, dim=-1) == targets.long()).float()
    local = torch.stack([wn._nll(logits, targets).sum(), correct.sum()])
    total = local.detach().clone()
    dist.all_reduce(total, group=group)
    n = float(targets.numel() * n_ranks)
    loss = total[0] / n
    return local[0] / n, {"loss": loss,
                          "bits_per_sample": loss / math.log(2.0),
                          "accuracy": total[1] / n}


def _flat(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """The leaves in sorted-key order as one new 1-D buffer."""
    keys = sorted(tree)
    dtypes = {tree[k].dtype for k in keys}
    if len(dtypes) != 1:
        raise ValueError(f"leaves of several dtypes {dtypes} in one buffer")
    return torch.cat([tree[k].detach().reshape(-1) for k in keys])


def _split(flat: torch.Tensor, like: Dict[str, torch.Tensor]
           ) -> Dict[str, torch.Tensor]:
    out, off = {}, 0
    for k in sorted(like):
        n = like[k].numel()
        out[k] = flat[off:off + n].view(like[k].shape)
        off += n
    return out


def reduce_gradients(grads: Dict[str, torch.Tensor], group=None
                     ) -> Dict[str, torch.Tensor]:
    """The sum of every rank's gradients (views of one flat buffer)."""
    if not dist.is_initialized():
        return grads
    flat = _flat(grads)
    col.all_reduce(flat, group if group is not None else dist.group.WORLD)
    return _split(flat, grads)


def broadcast_params(params: Dict[str, torch.Tensor], group=None
                     ) -> Dict[str, torch.Tensor]:
    """Rank 0's params on every rank (views of one flat buffer)."""
    if not dist.is_initialized():
        return params
    flat = _flat(params)
    dist.broadcast(flat, src=_src(group), group=group)
    return _split(flat, params)


def check_replicas(params: Dict[str, torch.Tensor], group=None) -> None:
    """Raise on every rank unless every rank holds rank 0's params bit for
    bit."""
    if not dist.is_initialized():
        return
    mine = _flat(params)
    ref = mine.clone()
    dist.broadcast(ref, src=_src(group), group=group)
    # compared as bits: -0.0 == 0.0 and NaN != NaN as floats
    bits = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
        mine.element_size()]
    same = torch.equal(mine.view(bits), ref.view(bits))
    differs = torch.tensor([0.0 if same else 1.0], device=mine.device)
    dist.all_reduce(differs, op=dist.ReduceOp.MAX, group=group)
    if differs.item():
        raise RuntimeError("the data-parallel replicas' params differ")
