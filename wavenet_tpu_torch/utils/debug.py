"""Numerics debugging: NaN trapping in autograd, finiteness checks.

Counterpart of wavenet_tpu/utils/debug.py.  `debug_numerics` turns on
autograd's anomaly mode (torch.autograd.set_detect_anomaly with its NaN
check) for a block: a backward function that returns NaN raises, naming
the forward op that made it.  The reference's disable_jit switch (op-by-op
evaluation under XLA) has no counterpart: PyTorch runs op by op already.
"""

from __future__ import annotations

import contextlib
from typing import Iterator

import torch


@contextlib.contextmanager
def debug_numerics(nans: bool = True) -> Iterator[None]:
    """Scoped numerics-debug mode: autograd anomaly detection with NaN
    checks (a NaN in any backward function raises RuntimeError), and
    checked_loss raises on a non-finite loss instead of returning +inf."""
    with torch.autograd.set_detect_anomaly(nans, check_nan=nans):
        yield


def assert_tree_finite(tree, name: str = "tree") -> None:
    """Host-side finite check over a (nested) dict of tensors: raises
    FloatingPointError naming every floating leaf holding a NaN or Inf."""
    bad = []

    def walk(node, path):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{path}/{k}" if path else str(k))
        elif (isinstance(node, torch.Tensor) and node.is_floating_point()
              and not bool(torch.isfinite(node).all())):
            bad.append(path)

    walk(tree, "")
    if bad:
        raise FloatingPointError(f"non-finite values in {name}: {bad}")


def checked_loss(loss: torch.Tensor) -> torch.Tensor:
    """The loss where it is finite, else +inf, so that divergence shows in
    the metrics instead of training on silently; under debug_numerics a
    non-finite loss raises FloatingPointError (a host check)."""
    finite = torch.isfinite(loss)
    if torch.is_anomaly_enabled() and not bool(finite.all()):
        raise FloatingPointError(f"non-finite loss: {loss}")
    return torch.where(finite, loss, torch.full_like(loss, float("inf")))
