"""Log-mel spectrogram extraction (host-side NumPy) for local conditioning.

A copy of wavenet_tpu/audio/mel.py (numpy only, so the port keeps its own):
frame -> Hann window -> rFFT -> mel filterbank -> log, bit-identical to the
JAX package's features for the same waveform (tests/test_torch_vocoder.py).
"""

from __future__ import annotations

import numpy as np

from wavenet_tpu_torch.config import MelConfig


def _hz_to_mel(f):
    return 2595.0 * np.log10(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_to_hz(m):
    return 700.0 * (10.0 ** (np.asarray(m, np.float64) / 2595.0) - 1.0)


def mel_filterbank(sr: int, n_fft: int, n_mels: int,
                   fmin: float, fmax: float) -> np.ndarray:
    """[n_mels, n_fft//2+1] triangular (Slaney-style, unnormalized) filters."""
    fmax = fmax or sr / 2
    mel_pts = np.linspace(_hz_to_mel(fmin), _hz_to_mel(fmax), n_mels + 2)
    hz_pts = _mel_to_hz(mel_pts)
    bins = np.fft.rfftfreq(n_fft, 1.0 / sr)
    fb = np.zeros((n_mels, len(bins)), np.float32)
    for i in range(n_mels):
        lo, c, hi = hz_pts[i], hz_pts[i + 1], hz_pts[i + 2]
        up = (bins - lo) / max(c - lo, 1e-10)
        down = (hi - bins) / max(hi - c, 1e-10)
        fb[i] = np.maximum(0.0, np.minimum(up, down)).astype(np.float32)
    return fb


def log_mel(x: np.ndarray, sr: int, cfg: MelConfig) -> np.ndarray:
    """Float waveform [T] -> log-mel frames [F, num_mels], F = ceil(T/hop).

    Center-padded so frame f is aligned with sample f*hop — the alignment the
    upsampler (models/conditioning.py) assumes.
    """
    n_fft = cfg.win_length
    hop = cfg.hop_length
    pad = n_fft // 2
    xp = np.pad(x.astype(np.float32), (pad, pad), mode="reflect")
    n_frames = 1 + (len(x) - 1) // hop
    win = np.hanning(n_fft).astype(np.float32)
    frames = np.stack([xp[i * hop: i * hop + n_fft] for i in range(n_frames)])
    spec = np.abs(np.fft.rfft(frames * win, axis=-1)) ** 2
    fb = mel_filterbank(sr, n_fft, cfg.num_mels, cfg.fmin, cfg.fmax)
    mels = spec @ fb.T                                  # [F, n_mels]
    return np.log(np.maximum(mels, 1e-5)).astype(np.float32)


def frames_for_samples(num_samples: int, hop: int) -> int:
    return 1 + (num_samples - 1) // hop
