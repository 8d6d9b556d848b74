"""Counter-based sampling RNG: the plain PyTorch version of the hash that
csrc/rng.cuh runs inside the decode kernel.

Noise for (row, global step t, class q) = f(row_seed, t, q): a murmur3
finalizer over uint32 (not Philox), bit-identical to wavenet_tpu/ops/rng.py.
Nothing else enters the hash, so a request's audio depends only on its own
seed (the serving replay contract) and chunked decode equals one-shot.

torch's uint32 supports few ops, so the arithmetic runs in int64 masked to
32 bits after every multiply and add; right shifts of a non-negative int64
are logical, as the hash needs (an arithmetic shift of a signed 32-bit value
would clear the top bit and squeeze the output into (0, 0.5)).
"""

from __future__ import annotations

import torch

_M32 = 0xFFFFFFFF


def _mulc(h: torch.Tensor, c: int) -> torch.Tensor:
    """(h * c) mod 2**32 for int64 h holding uint32 values, split into
    16-bit halves of c so no int64 product overflows."""
    lo = h * (c & 0xFFFF)
    hi = ((h * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _M32


def _mix(h: torch.Tensor) -> torch.Tensor:
    """murmur3 finalizer on int64 tensors holding uint32 values."""
    h = h ^ (h >> 16)
    h = _mulc(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mulc(h, 0xC2B2AE35)
    return h ^ (h >> 16)


def _u32(x) -> torch.Tensor:
    """int32 (or Python int) -> int64 tensor holding its uint32 bits."""
    return torch.as_tensor(x).to(torch.int64) & _M32


def as_int32(h: torch.Tensor) -> torch.Tensor:
    """int64 holding uint32 bits -> int32 with the same bits."""
    return torch.where(h >= 2 ** 31, h - 2 ** 32, h).to(torch.int32)


def derive_row_seeds(seed, batch: int, device=None) -> torch.Tensor:
    """Scalar seed -> [batch] int32 per-row seeds, hashed from the row
    index (so a slice of the vector draws the same noise as the whole)."""
    rows = torch.arange(batch, dtype=torch.int64, device=device)
    h = (_mulc(_u32(seed).to(device), 0x9E3779B9)
         + _mulc(rows, 0x85EBCA77)) & _M32
    return as_int32(_mix((_mix(h) + rows) & _M32))


def as_row_seeds(seed, batch: int, device=None) -> torch.Tensor:
    """Normalize a seed argument: an int/scalar derives per-row seeds; a
    [batch] vector (per-request seeds from the server) passes through."""
    arr = torch.as_tensor(seed, device=device)
    if arr.dim() == 0:
        return derive_row_seeds(arr, batch, device)
    if tuple(arr.shape) != (batch,):
        raise ValueError(f"row seeds shape {tuple(arr.shape)} != ({batch},)")
    return arr.to(torch.int32)


def counter_bits(seeds: torch.Tensor, t: int, num_classes: int,
                 class0: int = 0) -> torch.Tensor:
    """[B] int32 seeds -> [B, num_classes] int64 holding the uint32 hash
    of (seed, global step t, class class0 + q)."""
    cls = (torch.arange(num_classes, dtype=torch.int64, device=seeds.device)
           + class0) & _M32
    step = (int(t) & _M32) * 0x7F4A7C15 & _M32       # Python int: exact
    h = (_mulc(_u32(seeds), 0x9E3779B9)[:, None] + step
         + cls[None, :]) & _M32
    return _mix((_mix(h) + cls) & _M32)


def counter_uniform(seeds: torch.Tensor, t: int, num_classes: int,
                    class0: int = 0) -> torch.Tensor:
    """Uniform f32 in (0, 1), [B, num_classes], keyed by (row seed, t,
    class).  (bits >> 8) fits in 24 bits, so the f32 cast is exact."""
    bits = counter_bits(seeds, t, num_classes, class0)
    return ((bits >> 8).to(torch.float32) * (1.0 / (1 << 24))
            + 1e-12)


def counter_gumbel(seeds: torch.Tensor, t: int, num_classes: int,
                   class0: int = 0) -> torch.Tensor:
    """Gumbel(0,1) noise for the Gumbel-max categorical trick."""
    return -torch.log(-torch.log(counter_uniform(seeds, t, num_classes,
                                                 class0)))
