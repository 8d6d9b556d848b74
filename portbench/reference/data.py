"""Mu-law (arXiv 1609.03499 section 2.2) and the draw of training windows.

`encode` is the companding the paper gives, rounded to the nearest of Q
classes; `levels` the classes' waveform values.  `windows` is a frozen copy
of the draw the port's AudioDataset.sample_batch makes: batch k of a run
seeded s comes from numpy's default_rng((s, s, k)), one clip index and
then one start per row.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def encode(x: np.ndarray, Q: int) -> np.ndarray:
    mu = Q - 1
    x = np.clip(x, -1.0, 1.0)
    c = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.round((c + 1.0) / 2.0 * mu).astype(np.int32)


def levels(Q: int) -> np.ndarray:
    """[Q] float64 waveform value of each class."""
    mu = Q - 1
    c = 2.0 * np.arange(Q, dtype=np.float64) / mu - 1.0
    return np.sign(c) * np.expm1(np.abs(c) * np.log1p(mu)) / mu


def windows(tokens: Sequence[np.ndarray], seed: int, step: int, B: int,
            W: int) -> np.ndarray:
    """[B, W+1] int32 windows of batch `step` (clips shorter than W+1 are
    not in `tokens`)."""
    rng = np.random.default_rng((seed, seed, step))
    out = np.empty((B, W + 1), np.int32)
    for i in range(B):
        ci = int(rng.integers(0, len(tokens)))
        s = int(rng.integers(0, len(tokens[ci]) - (W + 1) + 1))
        out[i] = tokens[ci][s:s + W + 1]
    return out


def corpus_tokens(clips: Sequence[np.ndarray], Q: int, W: int
                  ) -> List[np.ndarray]:
    return [encode(c, Q) for c in clips if len(c) >= W + 1]
