"""Host-side audio I/O: wav read/write, resample, mono-ize (numpy + scipy).

A copy of wavenet_tpu/audio/io.py (which imports no JAX, but the port
imports nothing of the JAX package).
"""

from __future__ import annotations

import os
from typing import List, Optional, Tuple

import numpy as np
from scipy.io import wavfile
from scipy.signal import resample_poly


def read_wav(path: str,
             target_rate: Optional[int] = None) -> Tuple[np.ndarray, int]:
    """Read a wav file -> (float32 mono waveform in [-1, 1], sample_rate)."""
    rate, data = wavfile.read(path)
    if data.dtype == np.int16:
        x = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        x = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        x = (data.astype(np.float32) - 128.0) / 128.0
    else:  # float32/float64
        x = data.astype(np.float32)
    if x.ndim == 2:                       # mono-ize
        x = x.mean(axis=1)
    if target_rate is not None and rate != target_rate:
        g = np.gcd(rate, target_rate)
        x = resample_poly(x, target_rate // g, rate // g).astype(np.float32)
        rate = target_rate
    return np.clip(x, -1.0, 1.0), rate


def write_wav(path: str, x: np.ndarray, rate: int) -> None:
    """Write float waveform in [-1, 1] as 16-bit PCM."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    pcm = np.clip(np.asarray(x, np.float32), -1.0, 1.0)
    wavfile.write(path, rate, (pcm * 32767.0).astype(np.int16))


def list_wavs(root: str) -> List[str]:
    out = []
    for dirpath, _, files in os.walk(root):
        for f in sorted(files):
            if f.lower().endswith(".wav"):
                out.append(os.path.join(dirpath, f))
    return sorted(out)
