"""Causal time shift (counterpart of wavenet_tpu/ops/shift.py).

A width-2 dilated causal conv needs, at every position t, the pair
(x[t - d], x[t]); the port, like the reference, forms x[t - d] by a shift
and does the conv as two matrix products.
"""

from __future__ import annotations

import torch


def shift_right(x: torch.Tensor, d: int, left_ctx: torch.Tensor) -> torch.Tensor:
    """y[:, t] = x[:, t - d], reading from `left_ctx` for t < d.

    x: [B, T, C]; d: 1 <= d <= maxd; left_ctx: [B, maxd, C], the maxd
    samples preceding x along time (zeros at the start of a sequence).
    Returns [B, T, C]."""
    T = x.shape[1]
    maxd = left_ctx.shape[1]
    padded = torch.cat([left_ctx, x], dim=1)             # [B, maxd + T, C]
    return padded[:, maxd - d:maxd - d + T]
