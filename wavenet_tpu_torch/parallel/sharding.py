"""How params, batches and the decode state split over the mesh.

Counterpart of wavenet_tpu/parallel/sharding.py (validate, param_pspecs,
param_pspecs_layer, batch_pspec, decode_state_pspecs), as plain tables:
the reference hands PartitionSpecs to GSPMD; here each rank takes its
slices itself (shard_params, batch_slice), puts the whole back together
(gather_params), and the parallel modules issue the collectives.

Two layouts of the params over `model`:

Megatron-style tensor parallelism on the gated residual block:
  * COLUMN split (the last, output dim): w_cur, w_prev, w_prevk [.., 2, R]
    and b [L, 2, R], v_cond and v_global [L, *, 2, R], so z [.., 2, R/mp]
    and the gate h = tanh(z[.., 0, :]) * sigmoid(z[.., 1, :]) are local.
    The split is taken on the UNFOLDED gate axis: each rank gets R/mp
    filter columns and the same R/mp gate columns.  Folding the gate axis
    first ([.., 2R], the decode kernels' layout) and splitting that would
    give one rank every tanh column and the other every sigmoid column.
    head_w2 [S, Q] and head_b2 [Q] split over Q (the logits' classes).
  * ROW split (the contracting dim): w_res [L, R, R] and w_skip [L, R, S]
    split over their input R, so h @ w_res and h @ w_skip are partial sums
    that one reduction over `model` per layer completes.
  * Replicated: the embed tables, the biases of the row-split products,
    head_w1, head_b1, g_embed and the upsampler.
"layer" (the fused pipeline, parallel/pipeline.py; param_pspecs_layer):
every stacked [L, ...] leaf splits its leading layer axis, so stage s
holds layers [s L/mp, (s + 1) L/mp); the embed tables, the head, g_embed
and the upsampler are replicated.
A batch splits its rows over `data` and, on the sequence-parallel routes,
its time over `seq` (batch_pspec(seq_sharded=True)).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.distributed as dist

from wavenet_tpu_torch.config import WaveNetConfig

# leaf -> (the dim that splits over `model`, "column" or "row"); any leaf
# not listed is replicated
PARAM_SPLIT: Dict[str, Tuple[int, str]] = {
    "w_cur": (3, "column"),          # [L, R, 2, R]
    "w_prev": (3, "column"),         # [L, R, 2, R]
    "w_prevk": (4, "column"),        # [L, K-2, R, 2, R]
    "b": (2, "column"),              # [L, 2, R]
    "v_cond": (3, "column"),         # [L, M, 2, R]
    "v_global": (3, "column"),       # [L, G, 2, R]
    "head_w2": (1, "column"),        # [S, Q]
    "head_b2": (0, "column"),        # [Q]
    "w_res": (1, "row"),             # [L, R, R]
    "w_skip": (1, "row"),            # [L, R, S]
}


# the stacked [L, ...] leaves the "layer" layout splits on their first dim
LAYER_LEAVES = ("w_cur", "w_prev", "w_prevk", "b", "w_res", "b_res",
                "w_skip", "b_skip", "v_cond", "v_global")

LAYOUTS = ("megatron", "layer")


def validate(cfg: WaveNetConfig, mp: int, layout: str = "megatron") -> None:
    """Every split dim must divide by the model axis' size: for "megatron"
    the classes first (as the reference's distdecode.py:224 refuses them),
    then R and S; for "layer" the blocks (a pipeline stage owns whole
    dilation blocks)."""
    if layout not in LAYOUTS:
        raise ValueError(f"layout {layout!r} is not one of {LAYOUTS}")
    if layout == "layer":
        if cfg.num_blocks % mp:
            raise ValueError(f"num_blocks={cfg.num_blocks} not divisible "
                             f"by model_parallel={mp} (pipeline stages own "
                             f"whole dilation blocks)")
        return
    if cfg.quantization_channels % mp:
        raise ValueError(f"Q={cfg.quantization_channels} not divisible by "
                         f"model={mp}")
    if cfg.residual_channels % mp:
        raise ValueError(f"residual_channels={cfg.residual_channels} "
                         f"not divisible by model_parallel={mp}")
    if cfg.skip_channels % mp:
        raise ValueError(f"skip_channels={cfg.skip_channels} "
                         f"not divisible by model_parallel={mp}")


def _unfolded_shape(name: str, cfg: WaveNetConfig) -> Optional[tuple]:
    """The model layout of a gate-axis leaf (the decode kernels' layout
    folds [.., 2, R] to [.., 2R]); None for any other leaf."""
    L, R, K = cfg.num_layers, cfg.residual_channels, cfg.kernel_size
    return {"w_cur": (L, R, 2, R), "w_prev": (L, R, 2, R),
            "w_prevk": (L, K - 2, R, 2, R), "b": (L, 2, R),
            "v_cond": (L, -1, 2, R), "v_global": (L, -1, 2, R)}.get(name)


def split_dim(name: str, layout: str = "megatron") -> Optional[int]:
    """The dim of leaf `name` (a flat '/'-joined name) that splits over
    `model` in `layout`, None for a replicated leaf."""
    if layout == "layer":
        return 0 if name in LAYER_LEAVES else None
    return PARAM_SPLIT[name][0] if name in PARAM_SPLIT else None


def shard_params(params, cfg: WaveNetConfig, mp: int, index: int,
                 layout: str = "megatron") -> dict:
    """Rank `index`'s slices of params over a model axis of size mp: the
    leaves that split in `layout` cut to 1/mp along their split dim, every
    other leaf (a nested upsampler included) as it is.  params: model
    layout, or (for "megatron") the decode kernels' (gate axis folded;
    unfolded here before the cut).  The slices are contiguous copies."""
    validate(cfg, mp, layout)
    out = {}
    for k, v in params.items():
        dim = None if isinstance(v, dict) else split_dim(k, layout)
        if dim is None:
            out[k] = v
            continue
        if layout == "megatron":
            shape = _unfolded_shape(k, cfg)
            if shape is not None:
                v = v.reshape(shape)
        n = v.shape[dim] // mp
        out[k] = v.narrow(dim, index * n, n).contiguous()
    return out


def gather_params(params: Dict[str, torch.Tensor], cfg: WaveNetConfig,
                  mp: int, group, layout: str = "megatron"
                  ) -> Dict[str, torch.Tensor]:
    """The inverse of shard_params over the model axis' group: each split
    leaf of these flat params all-gathered and joined along its split dim
    (in model order), replicated leaves as they are.  Every rank of the
    group calls it and gets the whole params."""
    if mp == 1:
        return dict(params)
    out = {}
    for k in sorted(params):
        v, dim = params[k], split_dim(k, layout)
        if dim is None:
            out[k] = v
            continue
        parts = [torch.empty_like(v) for _ in range(mp)]
        dist.all_gather(parts, v.contiguous(), group=group)
        out[k] = torch.cat(parts, dim=dim)
    return out


def batch_slice(batch: Dict[str, torch.Tensor], dp: int, sp: int,
                data_index: int, seq_index: int,
                seq_sharded: bool = False) -> Dict[str, torch.Tensor]:
    """This rank's part of a global batch ({"tokens": [B, W+1], "mel":
    [B, F, M], "speaker": [B]}): its B/dp rows of each, and with
    seq_sharded "inputs" and "targets", its [B/dp, W/sp] slices of
    tokens[:, :-1] and tokens[:, 1:] (the window's +1 overlap does not
    split, so both views are cut, as the reference's trainer hands
    loss_fn_sp both); the mel frames stay whole (the features are
    upsampled over the whole window first)."""
    B = batch["tokens"].shape[0]
    if B % dp:
        raise ValueError(f"batch {B} not divisible by data_parallel={dp}")
    b = B // dp
    rows = slice(data_index * b, (data_index + 1) * b)
    out = {k: v[rows] for k, v in batch.items() if v is not None}
    if seq_sharded:
        W = out["tokens"].shape[1] - 1
        if W % sp:
            raise ValueError(f"sequence length {W} not divisible by "
                             f"seq={sp}")
        t = W // sp
        cols = slice(seq_index * t, (seq_index + 1) * t)
        out["inputs"] = out["tokens"][:, :-1][:, cols]
        out["targets"] = out["tokens"][:, 1:][:, cols]
    return out


def ring_channels(cfg: WaveNetConfig, mp: int, index: int,
                  shard_rings_model: bool) -> slice:
    """The channels of the decode rings [sum_d, B, R] that rank `index`
    of the model axis holds: the decode state's layout (the reference's
    decode_state_pspecs and distdecode._state_specs).  The rings split
    their batch over `data` like the carry and the row seeds; with
    shard_rings_model they also split their channels over `model` (each
    step then all-gathers the rows it reads), else every model rank holds
    all R."""
    R = cfg.residual_channels
    if not shard_rings_model:
        return slice(0, R)
    n = R // mp
    return slice(index * n, (index + 1) * n)
