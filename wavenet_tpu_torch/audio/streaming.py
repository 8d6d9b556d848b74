"""Streaming training data: bounded memory, background prefetch, the same
batches as AudioDataset.

Counterpart of wavenet_tpu/audio/streaming.py.  The in-memory AudioDataset
decodes the whole corpus at load; this dataset keeps the same contract (a
batch is a pure function of (cfg.seed, state.seed, state.step), so resume
is exact and its batches equal AudioDataset's on the same corpus bit for
bit) while holding only a bounded working set:

  * the corpus scan reads wav headers only (stdlib `wave` for PCM; one
    full decode otherwise) to learn each clip's resampled length; decoded
    clips (mu-law tokens and, for a mel model, log-mel frames) live in an
    LRU cache of `cache_clips` entries;
  * a background thread assembles the batches of state, state + 1, ...
    into a small queue, hiding the decode behind the device step; a
    request for another state (after a restore) resynchronises it;
  * rows= assembles only a slice of the global batch: under data
    parallelism each rank reads only the clips its rows
    (parallel/distributed.local_batch_slice) touch, while every rank draws
    the same global (clip, start) sequence.
"""

from __future__ import annotations

import collections
import queue
import threading
import wave as wave_mod
from typing import Dict, List, Optional, Tuple

import numpy as np

from wavenet_tpu_torch.audio import mel as mel_lib
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.audio.dataset import IteratorState, speakers_from_dir
from wavenet_tpu_torch.audio.io import list_wavs, read_wav
from wavenet_tpu_torch.config import WaveNetConfig


def _scan_length(path: str, target_rate: int) -> int:
    """Resampled sample count of a wav, reading only the header when PCM."""
    try:
        with wave_mod.open(path, "rb") as w:
            n, rate = w.getnframes(), w.getframerate()
    except (wave_mod.Error, EOFError):
        x, rate = read_wav(path, None)
        n = len(x)
    if rate == target_rate:
        return n
    # io.read_wav's resample_poly output length
    g = np.gcd(rate, target_rate)
    up, down = target_rate // g, rate // g
    return int(np.ceil(n * up / down))


class StreamingAudioDataset:
    """Disk-backed dataset with AudioDataset's batching contract.  Clips
    shorter than train_window + 1 are dropped at the scan; a speaker
    model's clips take the given ids (aligned with paths) or the kept
    clip's index mod global_classes."""

    def __init__(self, paths: List[str], cfg: WaveNetConfig,
                 cache_clips: int = 64, prefetch: int = 2,
                 speakers: Optional[List[int]] = None):
        if not paths:
            raise FileNotFoundError("empty wav list")
        if speakers is not None and len(speakers) != len(paths):
            raise ValueError("speakers must align 1:1 with paths")
        self.cfg = cfg
        window = cfg.train_window + 1
        lengths = [_scan_length(p, cfg.sample_rate) for p in paths]
        keep = [i for i, n in enumerate(lengths) if n >= window]
        if not keep:
            raise ValueError(
                f"no clip is >= train_window+1 = {window} samples")
        self.paths = [paths[i] for i in keep]
        self.lengths = np.asarray([lengths[i] for i in keep], np.int64)
        self.speakers: Optional[np.ndarray] = None
        if cfg.global_classes is not None:
            if speakers is not None:
                sp = np.asarray([speakers[i] for i in keep], np.int32)
            else:
                sp = (np.arange(len(self.paths), dtype=np.int32)
                      % cfg.global_classes)
            if sp.min() < 0 or sp.max() >= cfg.global_classes:
                raise ValueError("speaker id out of range for global_classes")
            self.speakers = sp
        self._cache: "collections.OrderedDict[int, tuple]" = \
            collections.OrderedDict()
        self._cache_max = max(cache_clips, 1)
        self._lock = threading.Lock()
        self._prefetch_depth = prefetch
        self._pf_thread: Optional[threading.Thread] = None
        self._pf_queue: Optional[queue.Queue] = None
        self._pf_stop: Optional[threading.Event] = None
        self._pf_rows: Optional[slice] = None

    @classmethod
    def from_dir(cls, root: str, cfg: WaveNetConfig,
                 **kw) -> "StreamingAudioDataset":
        """Every .wav under `root`; a speaker model's ids come from the
        layout (speakers_from_dir)."""
        paths = list_wavs(root)
        if not paths:
            raise FileNotFoundError(f"no .wav under {root}")
        return cls(paths, cfg, speakers=speakers_from_dir(root, paths, cfg),
                   **kw)

    # ---- clip cache ----

    def _clip(self, ci: int):
        """(tokens, mel or None) of clip ci, through the LRU cache."""
        with self._lock:
            if ci in self._cache:
                self._cache.move_to_end(ci)
                return self._cache[ci]
        cfg = self.cfg
        x, _ = read_wav(self.paths[ci], cfg.sample_rate)
        entry = (mulaw.encode_np(x, cfg.quantization_channels),
                 mel_lib.log_mel(x, cfg.sample_rate, cfg.mel)
                 if cfg.mel is not None else None)
        with self._lock:
            self._cache[ci] = entry
            self._cache.move_to_end(ci)
            while len(self._cache) > self._cache_max:
                self._cache.popitem(last=False)
        return entry

    # ---- deterministic batching (AudioDataset's contract) ----

    def _draws(self, state: IteratorState, B: int):
        """AudioDataset.sample_batch's (clip, start) draws for `state`:
        every rank draws the same, whichever rows it assembles."""
        cfg = self.cfg
        W = cfg.train_window
        rng = np.random.default_rng((cfg.seed, state.seed, state.step))
        hop = cfg.mel.hop_length if cfg.mel is not None else 1
        clip_idx = np.empty(B, np.int32)
        starts = np.empty(B, np.int64)
        for i in range(B):
            ci = int(rng.integers(0, len(self.paths)))
            max_start = int(self.lengths[ci]) - (W + 1)
            s = int(rng.integers(0, max_start + 1))
            if cfg.mel is not None:
                s = (s // hop) * hop
            clip_idx[i], starts[i] = ci, s
        return clip_idx, starts

    def sample_batch(self, state: IteratorState,
                     batch_size: Optional[int] = None,
                     rows: Optional[slice] = None,
                     ) -> Tuple[Dict[str, np.ndarray], IteratorState]:
        """The batch of `state` and the advanced state.  rows= assembles
        only that slice of the global batch; the arrays then hold just
        those rows.  A prefetched batch is taken when the prefetch runs
        for these rows at cfg.batch_size."""
        nxt = state.next()
        if (self._pf_queue is not None and rows == self._pf_rows
                and batch_size in (None, self.cfg.batch_size)):
            got = self._try_prefetched(state)
            if got is not None:
                return got, nxt
        return self._assemble(state, batch_size, rows), nxt

    def _assemble(self, state: IteratorState,
                  batch_size: Optional[int] = None,
                  rows: Optional[slice] = None) -> Dict[str, np.ndarray]:
        cfg = self.cfg
        B = batch_size or cfg.batch_size
        W = cfg.train_window
        hop = cfg.mel.hop_length if cfg.mel is not None else 1
        clip_idx, starts = self._draws(state, B)
        sel = list(range(B) if rows is None else range(*rows.indices(B)))
        toks = np.empty((len(sel), W + 1), np.int32)
        mels = (np.empty((len(sel), W // hop, cfg.mel.num_mels), np.float32)
                if cfg.mel is not None else None)
        for j, i in enumerate(sel):
            ct, cm = self._clip(int(clip_idx[i]))
            s = int(starts[i])
            toks[j] = ct[s:s + W + 1]
            if mels is not None:
                mels[j] = cm[s // hop:s // hop + W // hop]
        batch = {"tokens": toks}
        if mels is not None:
            batch["mel"] = mels
        if self.speakers is not None:
            batch["speaker"] = self.speakers[clip_idx[sel]]
        return batch

    # ---- background prefetch ----

    def start_prefetch(self, state: IteratorState,
                       rows: Optional[slice] = None) -> None:
        """Assemble the batches of state, state + 1, ... (of `rows`) in a
        daemon thread; sample_batch pops them in order."""
        self.stop_prefetch()
        q: queue.Queue = queue.Queue(maxsize=self._prefetch_depth)
        stop = threading.Event()
        self._pf_queue, self._pf_rows, self._pf_stop = q, rows, stop

        def worker(st: IteratorState):
            # q and stop are this worker's own: one that outlives
            # stop_prefetch's join must not feed a successor's queue
            while not stop.is_set():
                batch = self._assemble(st, None, rows)
                while not stop.is_set():
                    try:
                        q.put((st, batch), timeout=0.2)
                        break
                    except queue.Full:
                        continue
                st = st.next()

        self._pf_thread = threading.Thread(target=worker, args=(state,),
                                           daemon=True)
        self._pf_thread.start()

    def _try_prefetched(self, state: IteratorState):
        try:
            st, batch = self._pf_queue.get(timeout=30.0)
        except queue.Empty:
            return None
        if st != state:
            # the caller assembles `state` itself, so the restarted worker
            # begins at the state after it
            self.start_prefetch(state.next(), self._pf_rows)
            return None
        return batch

    def stop_prefetch(self) -> None:
        if self._pf_thread is not None:
            self._pf_stop.set()
            self._pf_thread.join(timeout=5.0)
            self._pf_thread = None
            self._pf_queue = None
