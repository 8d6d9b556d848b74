"""Training data: wav clips -> mu-law tokens -> deterministic random-crop
batches (numpy only).

A copy of wavenet_tpu/audio/dataset.py for unconditional and
mel-conditioned models: a batch is a pure function of (cfg.seed,
state.seed, state.step) through np.random.default_rng, so the port's
batches ({"tokens"}, plus "mel" for a mel model) are bit-identical to the
reference's and resume after a checkpoint is exact.  With mel, each clip's
log-mel frames are computed once at load (audio/mel.py) and a crop starts
on a hop boundary, so frame f lines up with sample f * hop.  Windows are
gathered by the numpy loop, the reference's own reference implementation;
its native C++ gatherer (bit-identical) is not ported yet (ROADMAP queue 1
item 8), nor are speaker ids (item 6).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Sequence, Tuple

import numpy as np

from wavenet_tpu_torch.audio import mel as mel_lib
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.audio.io import list_wavs, read_wav
from wavenet_tpu_torch.config import WaveNetConfig


@dataclasses.dataclass(frozen=True)
class IteratorState:
    """Complete, serializable state of the data iterator."""
    seed: int
    step: int

    def next(self) -> "IteratorState":
        return IteratorState(self.seed, self.step + 1)


class AudioDataset:
    """In-memory dataset of mu-law-encoded clips; clips shorter than the
    training window (+1 for the target offset) are dropped at load."""

    def __init__(self, clips: Sequence[np.ndarray], cfg: WaveNetConfig):
        if cfg.global_classes is not None:
            raise NotImplementedError(
                "speaker conditioned datasets are not ported yet "
                "(ROADMAP queue 1 item 6)")
        self.cfg = cfg
        window = cfg.train_window + 1
        kept = [c for c in clips if len(c) >= window]
        if not kept:
            raise ValueError(
                f"no clip is >= train_window+1 = {window} samples")
        self.tokens = [mulaw.encode_np(c, cfg.quantization_channels)
                       for c in kept]
        self.mels = None
        if cfg.mel is not None:
            self.mels = [mel_lib.log_mel(c, cfg.sample_rate, cfg.mel)
                         for c in kept]

    @classmethod
    def from_dir(cls, root: str, cfg: WaveNetConfig) -> "AudioDataset":
        """Load every .wav under `root` (resampled to cfg.sample_rate)."""
        paths = list_wavs(root)
        if not paths:
            raise FileNotFoundError(f"no .wav under {root}")
        return cls([read_wav(p, cfg.sample_rate)[0] for p in paths], cfg)

    @classmethod
    def synthetic(cls, cfg: WaveNetConfig, num_clips: int = 4,
                  clip_seconds: float = 2.0, seed: int = 0) -> "AudioDataset":
        """Deterministic sine-mixture clips for tests and benchmarks."""
        rng = np.random.default_rng(seed)
        sr = cfg.sample_rate
        T = int(clip_seconds * sr)
        t = np.arange(T) / sr
        clips = []
        for _ in range(num_clips):
            freqs = rng.uniform(80, 2000, size=3)
            amps = rng.uniform(0.1, 0.3, size=3)
            phases = rng.uniform(0, 2 * np.pi, size=3)
            x = sum(a * np.sin(2 * np.pi * f * t + ph)
                    for f, a, ph in zip(freqs, amps, phases))
            clips.append(np.asarray(x, np.float32))
        return cls(clips, cfg)

    def sample_batch(self, state: IteratorState
                     ) -> Tuple[Dict[str, np.ndarray], IteratorState]:
        """Pure function of `state`: {"tokens": [B, W+1] int32} random crops
        (plus "mel": [B, W // hop, M] float32 frames for a mel model) and
        the advanced iterator state."""
        cfg = self.cfg
        B = cfg.batch_size
        W = cfg.train_window
        rng = np.random.default_rng((cfg.seed, state.seed, state.step))
        hop = cfg.mel.hop_length if cfg.mel is not None else 1
        toks = np.empty((B, W + 1), np.int32)
        mels = None
        if self.mels is not None:
            mels = np.empty((B, W // hop, cfg.mel.num_mels), np.float32)
        for i in range(B):
            ci = int(rng.integers(0, len(self.tokens)))
            max_start = len(self.tokens[ci]) - (W + 1)
            s = int(rng.integers(0, max_start + 1))
            if mels is not None:
                # a hop-aligned start: frame s // hop is sample s exactly
                s = (s // hop) * hop
                mels[i] = self.mels[ci][s // hop:s // hop + W // hop]
            toks[i] = self.tokens[ci][s:s + W + 1]
        batch = {"tokens": toks}
        if mels is not None:
            batch["mel"] = mels
        return batch, state.next()
