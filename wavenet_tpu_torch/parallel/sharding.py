"""How params and the decode state split over the mesh's model axis.

Counterpart of the decode half of wavenet_tpu/parallel/sharding.py
(validate, param_pspecs, decode_state_pspecs), as plain tables: the
reference hands PartitionSpecs to GSPMD; here each rank takes its slices
itself (shard_params) and parallel/distdecode.py issues the collectives.

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
The layer-sharded (pipeline) and batch specs of the reference belong to
training over the model axis (ROADMAP queue 1 item 11).
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

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


def validate(cfg: WaveNetConfig, mp: int) -> None:
    """Every split dim must divide by the model axis' size (the classes
    first, as the reference's distdecode.py:224 refuses them)."""
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


def shard_params(params, cfg: WaveNetConfig, mp: int, index: int) -> dict:
    """Rank `index`'s slices of params over a model axis of size mp: the
    column- and row-split leaves of PARAM_SPLIT cut to 1/mp along their
    split dim, every other leaf (a nested upsampler included) as it is.
    params: model layout, or the decode kernels' (gate axis folded;
    unfolded here before the cut).  The slices are contiguous copies."""
    validate(cfg, mp)
    out = {}
    for k, v in params.items():
        if k not in PARAM_SPLIT or isinstance(v, dict):
            out[k] = v
            continue
        shape = _unfolded_shape(k, cfg)
        if shape is not None:
            v = v.reshape(shape)
        dim, _ = PARAM_SPLIT[k]
        n = v.shape[dim] // mp
        out[k] = v.narrow(dim, index * n, n).contiguous()
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
