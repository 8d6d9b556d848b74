"""The scan over the mesh's model axis: the Megatron split, with explicit
collectives.

Counterpart of the reference's GSPMD path under
wavenet_tpu/parallel/sharding.py::param_pspecs, where XLA inserts the
collectives; here each rank holds its slices (sharding.shard_params,
layout "megatron") and the forward issues them through a ModelSplit:

  * the column-split gate weights (w_cur, w_prev, b, v_cond, v_global)
    give each rank its R/mp filter and gate columns, so z and h are local;
    their inputs (the residual stream, its shifted taps, the mel
    features, the speaker vectors) enter through collectives.enter, whose
    backward sums the ranks' partial cotangents;
  * the row-split w_res and w_skip give exact f64 partial sums of
    h @ w_res and h @ w_skip over each rank's R/mp rows; one f64 sum over
    `model` a product (collectives.row_sum) completes them before the one
    rounding to f32, so the residual stream and the skip sum are the
    single-device bits on every rank;
  * head_w2 and head_b2 split the Q classes: each rank holds its logits'
    columns, and the loss needs a max, a sum and an index reduction over
    `model` (local_sums: the log-softmax's max and normalizer, the
    target's logit, the argmax).
Every rank then holds the whole gradient of each replicated leaf and its
own slice's of each split leaf; gradients sum over the (data, seq)
replicas only.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch
import torch.distributed as dist

from wavenet_tpu_torch.parallel import collectives as col


@dataclass(frozen=True)
class ModelSplit:
    """The model axis of a Megatron-split forward (models/wavenet.py's
    tp= argument)."""
    axis: col.Axis

    def enter(self, t: torch.Tensor) -> torch.Tensor:
        return col.enter(t, self.axis)

    def row_dot(self, a: torch.Tensor, w: torch.Tensor,
                cdt=torch.bfloat16) -> torch.Tensor:
        """a @ w over this rank's rows of w, summed over `model`: the exact
        f64 partial sums added in f64, then rounded once to f32 (the
        single-device _dot's bits)."""
        f64 = torch.float64
        part = a.to(cdt).to(f64) @ w.to(cdt).to(f64)
        return col.row_sum(part, self.axis).to(torch.float32)


class _SplitNLL(torch.autograd.Function):
    """-log softmax(logits)[target] over classes split across the axis:
    logits [N, Q/mp] (this rank's columns), targets [N] global ids."""

    @staticmethod
    def forward(ctx, logits, targets, axis):
        Ql = logits.shape[-1]
        lo = axis.index * Ql
        m = logits.max(dim=-1).values
        col.all_reduce(m, axis.group, dist.ReduceOp.MAX)
        e = torch.exp(logits - m[:, None])
        s = e.sum(dim=-1)
        col.all_reduce(s, axis.group)
        mine = (targets >= lo) & (targets < lo + Ql)
        idx = torch.where(mine, targets - lo, 0).long()
        t = torch.where(mine, logits.gather(1, idx[:, None])[:, 0],
                        torch.zeros_like(m))
        col.all_reduce(t, axis.group)
        ctx.save_for_backward(e / s[:, None], mine, idx)
        return (torch.log(s) + m) - t

    @staticmethod
    def backward(ctx, g):
        p, mine, idx = ctx.saved_tensors
        d = p * g[:, None]
        rows = torch.arange(d.shape[0], device=d.device)
        d[rows[mine], idx[mine]] -= g[mine]
        return d, None, None


def local_sums(logits: torch.Tensor, targets: torch.Tensor,
               split: ModelSplit) -> torch.Tensor:
    """[nll sum, correct count] of logits [.., Q/mp] (this rank's class
    columns) against targets [..] (global ids): the same on every rank of
    the model axis.  The argmax takes the lowest class index among ties,
    as jnp.argmax does."""
    axis = split.axis
    Ql = logits.shape[-1]
    flat, tgt = logits.reshape(-1, Ql), targets.reshape(-1).long()
    nll = _SplitNLL.apply(flat, tgt, axis)
    with torch.no_grad():
        v, i = flat.max(dim=-1)
        best = v.clone()
        col.all_reduce(best, axis.group, dist.ReduceOp.MAX)
        big = torch.iinfo(torch.int32).max
        cand = torch.where(v == best, (i + axis.index * Ql).int(),
                           torch.full_like(i, big, dtype=torch.int32))
        col.all_reduce(cand, axis.group, dist.ReduceOp.MIN)
        correct = (cand.long() == tgt).float().sum()
    return torch.stack([nll.sum(), correct])


def loss_fn_tp(params, cfg, groups, tokens: torch.Tensor, mel=None,
               speaker=None):
    """The scan's training loss over the model axis (no seq axis): tokens
    [B/dp, W+1] this rank's rows (mel, speaker: their frames and ids);
    params: this rank's Megatron slices.  Returns (this rank's loss share,
    the global metrics), as seqpar.loss_fn_sp does (which runs the same
    split under a seq axis)."""
    from wavenet_tpu_torch.models import wavenet as wn
    from wavenet_tpu_torch.parallel import seqpar
    tp = ModelSplit(col.axis_of(groups, "model"))
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    logits = wn.forward_logits(params, cfg, inputs, mel=mel,
                               speaker=speaker, tp=tp)
    return seqpar.metrics(local_sums(logits, targets, tp), groups,
                          targets.numel() * groups.dp * groups.sp)
