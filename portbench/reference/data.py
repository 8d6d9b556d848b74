"""Mu-law (arXiv 1609.03499 section 2.2), log-mel frames, and the draw of
training windows.

`encode` is the companding the paper gives, rounded to the nearest of Q
classes; `levels` the classes' waveform values.  `draw` is a frozen copy
of the draw the port's AudioDataset.sample_batch makes: batch k of a run
seeded s comes from numpy's default_rng((s, s, k)), one clip index and
then one start per row; a mel model's start is floored to a hop boundary,
so that its frames are s // hop .. s // hop + W // hop.  The clip index
is a kept clip's (one of at least W + 1 samples), which a speaker model
takes, modulo its classes, as the row's speaker.

`log_mel` is the log-mel spectrogram from its definition: frames of n_fft
samples every hop, centred (the clip reflected by n_fft / 2 at each end),
times a symmetric Hann window, the power of their real FFT, triangular
filters on the mel scale 2595 log10(1 + f / 700) (unnormalised, corners
at n_mels + 2 points evenly spaced in mel over [fmin, fmax]), and the
natural log of each energy floored at 1e-5.
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

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


def draw(tokens: Sequence[np.ndarray], seed: int, step: int, B: int,
         W: int, hop: int = 1) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """([B, W+1] int32 windows, [B] clip indices, [B] starts) of batch
    `step` (clips shorter than W+1 are not in `tokens`); hop > 1 floors
    each start to a multiple of hop."""
    rng = np.random.default_rng((seed, seed, step))
    out = np.empty((B, W + 1), np.int32)
    ids = np.empty(B, np.int64)
    starts = np.empty(B, np.int64)
    for i in range(B):
        ci = int(rng.integers(0, len(tokens)))
        s = int(rng.integers(0, len(tokens[ci]) - (W + 1) + 1))
        s = s // hop * hop
        out[i] = tokens[ci][s:s + W + 1]
        ids[i], starts[i] = ci, s
    return out, ids, starts


def window_frames(mels: Sequence[np.ndarray], ids: np.ndarray,
                  starts: np.ndarray, W: int, hop: int) -> np.ndarray:
    """[B, W // hop, M] float32 frames of drawn windows: clip ids[i]'s
    frames from starts[i] // hop."""
    return np.stack([mels[c][s // hop:s // hop + W // hop]
                     for c, s in zip(ids, starts)]).astype(np.float32)


def kept_clips(clips: Sequence[np.ndarray], W: int) -> List[np.ndarray]:
    """The clips a window of W + 1 samples fits in, in order."""
    return [c for c in clips if len(c) >= W + 1]


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filters(sr: int, n_fft: int, n_mels: int, fmin: float,
                fmax: float) -> np.ndarray:
    """[n_mels, n_fft // 2 + 1] float64 triangular filters."""
    fmax = fmax or sr / 2
    hz = _mel_to_hz(np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax),
                                n_mels + 2))
    bins = np.arange(n_fft // 2 + 1) * (sr / n_fft)
    lo, c, hi = hz[:-2, None], hz[1:-1, None], hz[2:, None]
    up = (bins - lo) / np.maximum(c - lo, 1e-10)
    down = (hi - bins) / np.maximum(hi - c, 1e-10)
    return np.maximum(0.0, np.minimum(up, down))


def log_mel(x: np.ndarray, sr: int, n_fft: int, hop: int, n_mels: int,
            fmin: float, fmax: float) -> np.ndarray:
    """[T] waveform -> [1 + (T - 1) // hop, n_mels] float32 log-mel
    frames; frame f is centred on sample f * hop."""
    x = np.asarray(x, np.float64)
    pad = n_fft // 2
    xp = np.pad(x, (pad, pad), mode="reflect")
    n = 1 + (len(x) - 1) // hop
    idx = np.arange(n)[:, None] * hop + np.arange(n_fft)[None, :]
    hann = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n_fft) / (n_fft - 1))
    power = np.abs(np.fft.rfft(xp[idx] * hann, axis=-1)) ** 2
    mels = power @ mel_filters(sr, n_fft, n_mels, fmin, fmax).T
    return np.log(np.maximum(mels, 1e-5)).astype(np.float32)


def clip_mels(clips: Sequence[np.ndarray], z) -> List[np.ndarray]:
    """log_mel of each clip at the mel sizes of z (a sizes.Sizes)."""
    return [log_mel(c, z.sample_rate, z.n_fft, z.hop, z.M, z.fmin, z.fmax)
            for c in clips]
