"""Mu-law companding codec (WaveNet paper arXiv:1609.03499 §2.2 eq.1).

    f(x) = sign(x) * ln(1 + mu*|x|) / ln(1 + mu),   mu = Q - 1

quantized to Q (default 256) integer classes by round-to-nearest over the
affine map to [0, Q-1].  Bit-identical to wavenet_tpu/audio/mulaw.py: the
NumPy encoder is the same expression, and every decoder (NumPy and torch)
reads the same float32 bin-center table.
"""

from __future__ import annotations

import functools

import numpy as np
import torch


@functools.lru_cache(maxsize=8)
def _decode_table(quantization_channels: int) -> np.ndarray:
    """[Q] float32 bin centers: the compressed value in f32 (matching the
    encoder's affine map), the expansion in f64, rounded once to f32."""
    mu = quantization_channels - 1
    q = np.arange(quantization_channels, dtype=np.int32)
    compressed = 2.0 * q.astype(np.float32) / mu - 1.0
    x = (np.sign(compressed)
         * (np.expm1(np.abs(compressed) * np.log1p(mu)) / mu))
    return x.astype(np.float32)


def decode(q: torch.Tensor, quantization_channels: int = 256) -> torch.Tensor:
    """Int class ids in [0, Q-1] -> float32 waveform in [-1, 1], on q's
    device (a gather from the shared bin-center table)."""
    table = torch.from_numpy(_decode_table(quantization_channels))
    return table.to(q.device)[q.long()]


def encode_np(x: np.ndarray, quantization_channels: int = 256) -> np.ndarray:
    """Float waveform in [-1, 1] -> int32 class ids in [0, Q-1]."""
    mu = quantization_channels - 1
    x = np.clip(x, -1.0, 1.0)
    compressed = np.sign(x) * np.log1p(mu * np.abs(x)) / np.log1p(mu)
    return np.round((compressed + 1.0) / 2.0 * mu).astype(np.int32)


def decode_np(q: np.ndarray, quantization_channels: int = 256) -> np.ndarray:
    return _decode_table(quantization_channels)[q]
