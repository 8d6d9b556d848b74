"""The fixed order of the training backward's bias-gradient column sums
(tests/_colsum_order.py, which the card's tests hold the kernel to bit for
bit): its splits and its rounding, on the CPU."""

import pytest
import torch

import _colsum_order as order
from wavenet_tpu_torch.ops.cuda import train_stack as ts

# (B, T, N, by batch row): T = 1,100 gives a batch row two splits, the
# second of 76 rows; T = 200 and M below 1,024 one short split a row; N is
# no multiple of 4, 32 or 128.  By batch row is dg's form; else one sum
# over all M rows, db's, db_res's and db_skip's (whose splits may cross
# batch rows).
CASES = [(2, 1100, 37, True), (3, 200, 37, True), (4, 200, 130, True),
         (2, 1100, 37, False), (3, 200, 130, False), (1, 700, 6, False)]


@pytest.mark.parametrize("B,T,N,by_row", CASES)
def test_column_sums_within_f32_rounding_of_float64(B, T, N, by_row):
    g = torch.Generator().manual_seed(B * T + N)
    x = torch.randn(B * T, N, generator=g) * 0.01
    x[::7] *= 1e3                       # terms of very different sizes
    rows = T if by_row else B * T
    got = order.column_sums(x, rows, ts.ROWS_PER_SPLIT)
    assert got.dtype == torch.float32 and got.shape == (B * T // rows, N)
    want = x.double().view(-1, rows, N).sum(dim=1)
    # a chain of n f32 adds is within n u sum |x| of the exact sum: at most
    # a split's rows, then its batch row's splits
    n = min(rows, ts.ROWS_PER_SPLIT) + -(-rows // ts.ROWS_PER_SPLIT)
    bound = n * 2.0 ** -24 * x.double().abs().view(-1, rows, N).sum(dim=1)
    assert bool(((got.double() - want).abs() <= bound).all())
    # and it is not the float64 sum rounded once: the order shows
    assert not torch.equal(got, want.float())


@pytest.mark.parametrize("B,T,N,by_row", CASES)
def test_column_sum_splits_never_straddle_a_batch_row(B, T, N, by_row):
    rows = T if by_row else B * T
    splits = order.split_rows(B * T // rows, rows, ts.ROWS_PER_SPLIT)
    # in order, contiguous, covering every row once
    assert splits[0][1] == 0 and splits[-1][2] == B * T
    assert all(a[2] == b[1] for a, b in zip(splits, splits[1:]))
    for b, first, end in splits:
        assert 0 < end - first <= ts.ROWS_PER_SPLIT
        assert b * rows <= first < end <= (b + 1) * rows
    # a batch row's splits are all full but its last
    per_row = -(-rows // ts.ROWS_PER_SPLIT)
    assert len(splits) == per_row * (B * T // rows)
    for k, (b, first, end) in enumerate(splits):
        last = k % per_row == per_row - 1
        assert end - first == (rows - (per_row - 1) * ts.ROWS_PER_SPLIT
                               if last else ts.ROWS_PER_SPLIT)


@pytest.mark.parametrize("B,T,N,by_row", CASES[:2])
def test_column_sums_plain_version_and_refusals(B, T, N, by_row):
    """column_sums on CPU tensors is its plain version (torch's sum, per
    batch row of T rows, a sum a tensor); a T that does not divide M, and
    more than two tensors, are refused."""
    x = torch.randn(B * T, N, generator=torch.Generator().manual_seed(3))
    rows = T if by_row else B * T
    got = ts.column_sums(x, x[:, :2], T=rows)
    want = x.double().view(-1, rows, N).sum(dim=1).float()
    assert len(got) == 2
    torch.testing.assert_close(got[0], want)
    torch.testing.assert_close(got[1], want[:, :2])
    with pytest.raises(ValueError, match="must divide"):
        ts.column_sums(x, T=B * T + 1)
    with pytest.raises(ValueError, match="one or two"):
        ts.column_sums(x, x, x)
