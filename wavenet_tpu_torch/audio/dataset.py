"""Training data: wav clips -> mu-law tokens -> deterministic random-crop
batches (numpy, and the native window gatherer).

A copy of wavenet_tpu/audio/dataset.py: a batch is a pure function of
(cfg.seed, state.seed, state.step) through np.random.default_rng, so the
port's batches ({"tokens"}, plus "mel" for a mel model and "speaker" for a
speaker model) are bit-identical to the reference's and resume after a
checkpoint is exact.  With mel, each clip's log-mel frames are computed
once at load (audio/mel.py) and a crop starts on a hop boundary, so frame
f lines up with sample f * hop.  A speaker model's clips carry class ids:
by top-level subdirectory of the corpus (speakers_from_dir), or the clip
index mod global_classes for synthetic data.  Windows are gathered by the
native gatherer (cpp/loader.py, bit-identical), as the reference gathers
them; native=False runs the NumPy loop instead, the reference's own
reference implementation.  Unlike the reference, a failed build of the
native library raises instead of falling back to the loop.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from wavenet_tpu_torch.audio import mel as mel_lib
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.audio.io import list_wavs, read_wav
from wavenet_tpu_torch.config import WaveNetConfig


def speakers_from_dir(root: str, paths: Sequence[str],
                      cfg: WaveNetConfig) -> Optional[List[int]]:
    """Per-clip class ids from the corpus layout root/<speaker>/<clip>.wav:
    each clip's id is the index of its top-level subdirectory under `root`
    in sorted order; clips directly under root take class 0 (the name ""
    sorts first).  None when cfg.global_classes is unset; more
    subdirectories than classes raise."""
    if cfg.global_classes is None:
        return None
    rootp = os.path.abspath(root)

    def subdir(p):
        rel = os.path.relpath(os.path.abspath(p), rootp)
        return rel.split(os.sep)[0] if os.sep in rel else ""

    names = sorted({subdir(p) for p in paths})
    if len(names) > cfg.global_classes:
        raise ValueError(
            f"{len(names)} speaker subdirectories under {root} but "
            f"global_classes={cfg.global_classes}")
    idx = {n: i for i, n in enumerate(names)}
    return [idx[subdir(p)] for p in paths]


@dataclasses.dataclass(frozen=True)
class IteratorState:
    """Complete, serializable state of the data iterator."""
    seed: int
    step: int

    def next(self) -> "IteratorState":
        return IteratorState(self.seed, self.step + 1)


class AudioDataset:
    """In-memory dataset of mu-law-encoded clips; clips shorter than the
    training window (+1 for the target offset) are dropped at load.  A
    speaker model's clips take the given per-clip ids (speakers, aligned
    with clips) or, without them, the kept clip's index mod
    global_classes.  native: gather windows through the native library
    (built at construction if needed; a failed build raises), else through
    the NumPy loop."""

    def __init__(self, clips: Sequence[np.ndarray], cfg: WaveNetConfig,
                 speakers: Optional[Sequence[int]] = None,
                 native: bool = True):
        self.cfg = cfg
        window = cfg.train_window + 1
        if speakers is not None and len(speakers) != len(clips):
            raise ValueError("speakers must align 1:1 with clips")
        keep = [len(c) >= window for c in clips]
        kept = [c for c, k in zip(clips, keep) if k]
        if not kept:
            raise ValueError(
                f"no clip is >= train_window+1 = {window} samples")
        self.speakers: Optional[np.ndarray] = None
        if cfg.global_classes is not None:
            if speakers is not None:
                sp = np.asarray([s for s, k in zip(speakers, keep) if k],
                                np.int32)
            else:
                sp = np.arange(len(kept), dtype=np.int32) % cfg.global_classes
            if sp.min() < 0 or sp.max() >= cfg.global_classes:
                raise ValueError("speaker id out of range for global_classes")
            self.speakers = sp
        self.tokens = [mulaw.encode_np(c, cfg.quantization_channels)
                       for c in kept]
        self.mels = None
        if cfg.mel is not None:
            self.mels = [mel_lib.log_mel(c, cfg.sample_rate, cfg.mel)
                         for c in kept]
        self._gatherer = None
        if native:
            from wavenet_tpu_torch.cpp import loader
            self._gatherer = loader.WindowGatherer(self.tokens)

    @classmethod
    def from_dir(cls, root: str, cfg: WaveNetConfig,
                 native: bool = True) -> "AudioDataset":
        """Load every .wav under `root` (resampled to cfg.sample_rate); a
        speaker model's ids come from the layout (speakers_from_dir)."""
        paths = list_wavs(root)
        if not paths:
            raise FileNotFoundError(f"no .wav under {root}")
        return cls([read_wav(p, cfg.sample_rate)[0] for p in paths], cfg,
                   speakers=speakers_from_dir(root, paths, cfg),
                   native=native)

    @classmethod
    def synthetic(cls, cfg: WaveNetConfig, num_clips: int = 4,
                  clip_seconds: float = 2.0, seed: int = 0,
                  native: bool = True) -> "AudioDataset":
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
        return cls(clips, cfg, native=native)

    def sample_batch(self, state: IteratorState,
                     batch_size: Optional[int] = None,
                     ) -> Tuple[Dict[str, np.ndarray], IteratorState]:
        """Pure function of `state`: {"tokens": [B, W+1] int32} random crops
        (plus "mel": [B, W // hop, M] float32 frames for a mel model and
        "speaker": [B] int32 clip ids for a speaker model) and the advanced
        iterator state; B is batch_size, by default cfg.batch_size."""
        cfg = self.cfg
        B = batch_size or cfg.batch_size
        W = cfg.train_window
        rng = np.random.default_rng((cfg.seed, state.seed, state.step))
        hop = cfg.mel.hop_length if cfg.mel is not None else 1
        mels = None
        if self.mels is not None:
            mels = np.empty((B, W // hop, cfg.mel.num_mels), np.float32)
        clip_idx = np.empty(B, np.int32)
        starts = np.empty(B, np.int64)
        for i in range(B):
            ci = int(rng.integers(0, len(self.tokens)))
            max_start = len(self.tokens[ci]) - (W + 1)
            s = int(rng.integers(0, max_start + 1))
            if mels is not None:
                # a hop-aligned start: frame s // hop is sample s exactly
                s = (s // hop) * hop
                mels[i] = self.mels[ci][s // hop:s // hop + W // hop]
            clip_idx[i], starts[i] = ci, s
        if self._gatherer is not None:
            toks = self._gatherer.gather(clip_idx, starts, W + 1)
        else:
            toks = np.empty((B, W + 1), np.int32)
            for i in range(B):
                toks[i] = self.tokens[clip_idx[i]][starts[i]:
                                                   starts[i] + W + 1]
        batch = {"tokens": toks}
        if mels is not None:
            batch["mel"] = mels
        if self.speakers is not None:
            batch["speaker"] = self.speakers[clip_idx]
        return batch, state.next()
