"""Pipeline parallelism for the fused training stack over the `model` axis.

Counterpart of wavenet_tpu/parallel/pipeline.py.  The fused stack is a
chain of layer-group kernels, and inside a group every layer needs the
whole channel width of the residual stream, so the model axis splits the
LAYER axis: stage s (model index s) owns a contiguous run of whole
dilation blocks (cfg.num_blocks % mp == 0, so every stage has the same
dilation pattern), its params the "layer" slices of
parallel/sharding.py.  Microbatches of the rank's rows flow through the
stages GPipe-style: stage s runs microbatch k through its groups
(ops/cuda/train_stack._GroupApply: the stack kernels on the card) and
sends the residual stream x [Bmu, W, R] and the skip accumulator
[Bmu, W, S] to stage s + 1.  The last stage's finished skip sums are
broadcast to every stage, and the head and the loss run replicated.

The reverse schedule is written out (JAX derives the reference's): each
stage keeps, per microbatch, the autograd record of its groups (the
activations group_fwd saved), and in the backward runs them in reverse
microbatch order, receiving (dx, dskip) from stage s + 1 and sending its
input cotangents to stage s - 1; stage 0's dx is the embedding's
cotangent.  The skip cotangent enters once, at the last stage.  The head
runs on identical inputs on every stage, so each stage holds the head's
whole gradient; the embedding (stage 0's), the upsampler and g_embed
(every stage uses them for its own layers) hold partial gradients that
the trainer sums over `model` (MODEL_PARTIAL).  Bubble fraction
(mp - 1) / (n_mu + mp - 1).

Not ported: the reference's multi-row `nb` layouts (the port's planner is
single-row).
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Dict, Optional, Tuple

import torch

from wavenet_tpu_torch.config import WaveNetConfig
from wavenet_tpu_torch.models import conditioning
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops.cuda import train_stack as ts
from wavenet_tpu_torch.parallel import collectives as col
from wavenet_tpu_torch.parallel.mesh import MeshGroups

# replicated leaves whose gradient each stage holds only a part of (sum
# over `model`): the embedding is stage 0's, the upsampler's and g_embed's
# are each stage's share through its own layers
MODEL_PARTIAL = ("embed_cur", "embed_prev", "g_embed", "upsampler/")


def model_partial(name: str) -> bool:
    return any(name == k or (k.endswith("/") and name.startswith(k))
               for k in MODEL_PARTIAL)


def stage_dilations(cfg: WaveNetConfig, mp: int) -> Tuple[int, ...]:
    """The (identical) dilation pattern of every pipeline stage."""
    if cfg.num_blocks % mp:
        raise ValueError(f"num_blocks={cfg.num_blocks} not divisible by "
                         f"model_parallel={mp}: pipeline stages must own "
                         f"whole dilation blocks")
    return tuple(cfg.dilations[:cfg.num_layers // mp])


def supported(cfg: WaveNetConfig, T: int, mp: int) -> bool:
    """Can the fused stack run as an mp-stage pipeline on windows of T?"""
    if mp < 1 or cfg.num_blocks % mp or not ts.config_taken(cfg):
        return False
    TT = ts.pick_tile(cfg, T)
    return bool(TT) and bool(ts.plan_dils(cfg, stage_dilations(cfg, mp),
                                          TT))


def _stage_chain(dils, groups, x, skip, weights, y, g):
    """All layer groups of one stage (chained _GroupApply).  weights: the
    stage's GROUP_KEYS leaves then v_cond (None without mel); g: None or
    [Bmu, L_stage, 2R] f32 speaker offsets of this stage's layers."""
    for lo, hi in groups:
        gw = [w[lo:hi] for w in weights[:-1]]
        vc = None if weights[-1] is None else weights[-1][lo:hi]
        skip, x = ts._GroupApply.apply(
            tuple(dils[lo:hi]), x, skip, y,
            None if g is None else g[:, lo:hi].contiguous(), *gw, vc)
    return skip, x


@dataclass(frozen=True)
class _Plan:
    model: col.Axis
    dils: Tuple[int, ...]
    groups: Tuple[Tuple[int, int], ...]
    Bmu: int
    n_mu: int
    S: int


class _Pipeline(torch.autograd.Function):
    """(embedded input [B, W, R], y [B, W, M] or None, g [B, Ls, 2R] or
    None, the stage's weights) -> the finished skip sums [B, W, S] on
    every stage, with the reverse schedule as its backward."""

    @staticmethod
    def forward(ctx, plan, x_emb, y, g, *weights):
        model, S = plan.model, plan.S
        s, last = model.index, model.size - 1
        needs = any(ctx.needs_input_grad)
        B, W, R = x_emb.shape
        dev = x_emb.device
        f32 = torch.float32
        leaves = [None if w is None else w.detach().requires_grad_(needs)
                  for w in weights]
        saved, finished = [], []
        for k in range(plan.n_mu):
            rows = slice(k * plan.Bmu, (k + 1) * plan.Bmu)
            shape = (plan.Bmu, W)
            if s == 0:
                x_in = x_emb[rows].detach().float().contiguous()
                skip_in = torch.zeros(*shape, S, device=dev)
            else:
                x_in = col.recv(torch.empty(*shape, R, device=dev), model,
                                s - 1, tag=0)
                skip_in = col.recv(torch.empty(*shape, S, device=dev),
                                   model, s - 1, tag=1)
            ins = [x_in.requires_grad_(needs), skip_in.requires_grad_(needs),
                   None if y is None else
                   y[rows].detach().to(f32).requires_grad_(needs),
                   None if g is None else
                   g[rows].detach().requires_grad_(needs)]
            with torch.enable_grad():
                skip_out, x_out = _stage_chain(plan.dils, plan.groups,
                                               ins[0], ins[1], leaves,
                                               ins[2], ins[3])
            if s < last:
                col.send(x_out, model, s + 1, tag=0)
                col.send(skip_out, model, s + 1, tag=1)
            else:
                finished.append(skip_out.detach())
            if needs:
                saved.append((ins, skip_out, x_out))
        skip = (torch.cat(finished) if s == last else
                torch.empty(B, W, S, device=dev))
        col.broadcast(skip, model, last)
        ctx.plan, ctx.saved, ctx.leaves = plan, saved, leaves
        ctx.x_shape = x_emb.shape
        return skip

    @staticmethod
    def backward(ctx, dskip_full):
        plan, model = ctx.plan, ctx.plan.model
        s, last = model.index, model.size - 1
        dev = dskip_full.device
        leaves = [w for w in ctx.leaves if w is not None]
        dw = [torch.zeros_like(w) for w in leaves]
        dx_emb = torch.zeros(ctx.x_shape, device=dev) if s == 0 else None
        # the cotangents of y and g, row blocks filled per microbatch
        dy, dg = (None if t is None else
                  torch.zeros(ctx.x_shape[0], *t.shape[1:], device=dev)
                  for t in ctx.saved[0][0][2:])
        for k in reversed(range(plan.n_mu)):
            rows = slice(k * plan.Bmu, (k + 1) * plan.Bmu)
            ins, skip_out, x_out = ctx.saved[k]
            if s == last:
                dskip = dskip_full[rows].float().contiguous()
                dx = torch.zeros_like(x_out)
            else:
                dx = col.recv(x_out, model, s + 1, tag=2)
                dskip = col.recv(skip_out, model, s + 1, tag=3)
            wrt = [t for t in ins if t is not None] + leaves
            got = list(torch.autograd.grad([skip_out, x_out], wrt,
                                           [dskip, dx], allow_unused=True))
            got = [torch.zeros_like(t) if d is None else d
                   for t, d in zip(wrt, got)]
            dx_in, dskip_in = got[0], got[1]
            if s > 0:
                col.send(dx_in, model, s - 1, tag=2)
                col.send(dskip_in, model, s - 1, tag=3)
            else:
                dx_emb[rows] = dx_in
            i = 2
            for d_all in (dy, dg):
                if d_all is not None:
                    d_all[rows] = got[i]
                    i += 1
            for j, d in enumerate(got[i:]):
                dw[j] += d
        ctx.saved = None
        it = iter(dw)
        return (None, dx_emb, dy, dg,
                *(None if w is None else next(it) for w in ctx.leaves))


def loss_fn_pp(params, cfg: WaveNetConfig, groups: MeshGroups,
               tokens: torch.Tensor, mel: Optional[torch.Tensor] = None,
               speaker=None, microbatch: int = 1
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Pipelined fused training loss over this rank's rows tokens
    [B/dp, W+1] (mel [B/dp, F, M], speaker [B/dp]); params: this stage's
    "layer" slices (sharding.shard_params) with the replicated leaves
    whole.  Returns (this rank's loss share, the global metrics): the
    share is the rows' nll sum over the global token count, the same on
    every stage (the head runs replicated), so the gradients summed over
    `data` (and, for MODEL_PARTIAL, over `model`) are the global mean's."""
    model = col.axis_of(groups, "model")
    mp = model.size
    B_loc, W = tokens.shape[0], tokens.shape[1] - 1
    if not supported(cfg, W, mp):
        raise ValueError("config not pipeline-shardable; gate on "
                         "supported()")
    TT = ts.pick_tile(cfg, W)
    dils = stage_dilations(cfg, mp)
    Bmu = min(microbatch, B_loc)
    if B_loc % Bmu:
        raise ValueError(f"local batch {B_loc} not divisible by "
                         f"microbatch {Bmu}")
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    x_emb = wn.embed_tokens(params, cfg, inputs, wn._shifted_tokens(inputs))
    y = None
    if cfg.mel is not None:
        if mel is None:
            raise ValueError("cfg.mel set but no mel features passed")
        y = conditioning.upsample_mel(params["upsampler"], cfg.mel, mel, W)
    g = wn._speaker_offsets(params, cfg, speaker)
    if g is not None:                          # [Ls, B, 2, R] -> [B, Ls, 2R]
        g = g.transpose(0, 1).reshape(B_loc, len(dils), -1)
    plan = _Plan(model, dils, tuple(ts.plan_dils(cfg, dils, TT)), Bmu,
                 B_loc // Bmu, cfg.skip_channels)
    weights = [params[k] for k in ts.GROUP_KEYS] + [params.get("v_cond")]
    skip = _Pipeline.apply(plan, x_emb, y, g, *weights)
    logits = wn.head_logits(params, cfg, skip)
    correct = (torch.argmax(logits, dim=-1) == targets.long()).float()
    sums = torch.stack([wn._nll(logits, targets).sum(), correct.sum()])
    # the stages hold equal sums; the data ranks hold their rows'
    total = col.all_reduce(sums.detach().clone(),
                           col.axis_of(groups, "data").group)
    n = float(B_loc * groups.dp * W)
    loss = total[0] / n
    return sums[0] / n, {"loss": loss,
                         "bits_per_sample": loss / math.log(2.0),
                         "accuracy": total[1] / n}
