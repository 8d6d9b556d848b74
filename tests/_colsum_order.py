"""The fixed order of the training backward's bias-gradient column sums
(db, db_res, db_skip and dg of csrc/train_stack.cu's colsum), written out
in plain float32 PyTorch, for the tests to hold the kernel to bit for bit.

Rows are cut into splits of `rows_per_split` that never straddle two batch
rows; each split's column is summed one row at a time into an f32
accumulator that starts at 0, in row order; then each batch row's split
sums are added in split order, again from 0.  Every step is one f32 add of
whole columns, which rounds as the kernel's scalar adds do.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import torch


def split_rows(B: int, T: int,
               rows_per_split: int) -> List[Tuple[int, int, int]]:
    """(batch row, first row, end row) of every split, in the order the
    partials are added: batch row b's ceil(T / rows_per_split) splits of
    rows [b T + j rows_per_split, min(b T + (j + 1) rows_per_split,
    (b + 1) T)), b by b."""
    nsr = -(-T // rows_per_split)
    return [(b, b * T + j * rows_per_split,
             min(b * T + (j + 1) * rows_per_split, (b + 1) * T))
            for b in range(B) for j in range(nsr)]


def column_sums(x: torch.Tensor, T: Optional[int],
                rows_per_split: int) -> torch.Tensor:
    """x [M, N] f32 -> [M // T, N] (T None or M: one sum over all rows),
    on x's device, in the fixed order."""
    M, N = x.shape
    T = M if T is None else T
    splits = split_rows(M // T, T, rows_per_split)
    first = torch.tensor([s[1] for s in splits], device=x.device)
    end = torch.tensor([s[2] for s in splits], device=x.device)
    part = torch.zeros(len(splits), N, dtype=torch.float32, device=x.device)
    for r in range(rows_per_split):
        live = first + r < end                  # splits with an r-th row
        if not bool(live.any()):
            break
        part[live] = part[live] + x[(first + r)[live]]
    nsr = len(splits) // (M // T)
    part = part.view(M // T, nsr, N)
    out = torch.zeros(M // T, N, dtype=torch.float32, device=x.device)
    for j in range(nsr):
        out = out + part[:, j]
    return out
