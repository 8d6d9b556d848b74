"""In-process synthesis server: request microbatching over streaming decode.

Counterpart of wavenet_tpu/serving/server.py on one GPU (or the CPU).
Concurrent requests are grouped into microbatches (length/temperature
buckets, rows padded to a power-of-two batch size), the whole batch decodes
in one streaming loop of whole-loop kernel launches, and each request
receives its own waveform chunks as they are produced.

  * Each request's audio depends ONLY on its own seed: rows sample from the
    counter RNG (ops/rng.py) keyed by the request seed, and the decode
    kernel's per-row arithmetic does not depend on the co-batched rows, so
    re-submitting a request reproduces its audio bit-exactly whatever
    traffic it was batched with (WaveNet.stream(batch=1, seeds=[seed])
    replays it).  Padding rows use seed 0 and their output is dropped.
  * Mel (vocoder) and primed requests run on their own decode lane (a
    second worker thread), so neither head-of-line-blocks the batchable
    lane.  Mel requests of one (length bucket, temperature) batch there:
    each row's mel is upsampled alone at that row's own timeline length,
    max(P - 1, 0) + num_samples, then zero-padded to the group's; padded
    steps lie after the row's emitted prefix and decode is causal, so a
    batched mel request equals its singleton replay bit for bit.  The
    features stay on the model's device; only the mel frames cross from
    the host.  Primed requests stay singletons.
  * Chunks flow through per-request unbounded queues: a lagging consumer
    costs memory for its own utterance and never stalls the decode loop.

Speaker-conditioned models and mesh (multi-GPU) serving are not ported yet
(ROADMAP queue 1 items 6 and 11); the port's WaveNet refuses such models.
"""

from __future__ import annotations

import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch


def _bucket(n: int, quantum: int) -> int:
    """Round n up to a multiple of quantum (bounded set of scan lengths)."""
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


def _batch_bucket(n: int, max_batch: int) -> int:
    """Next power of two >= n, capped at max_batch."""
    b = 1
    while b < n and b < max_batch:
        b *= 2
    return min(b, max_batch)


@dataclass
class _Request:
    num_samples: int
    seed: int
    temperature: float
    mel: Optional[np.ndarray] = None           # [frames, M]
    prime: Optional[np.ndarray] = None
    chunks: "queue.Queue" = field(default_factory=queue.Queue)
    error: Optional[BaseException] = None


_DONE = object()


class ResponseStream:
    """Handle returned by submit(): iterate waveform chunks, or collect all.

    Iterating yields float32 [n] arrays in [-1, 1]; waveform() concatenates
    whatever has not been consumed yet.  One-shot: once exhausted, further
    iteration yields nothing.  Raises the server-side exception (if any) at
    the point of consumption.
    """

    def __init__(self, req: _Request, rate: int):
        self._req = req
        self._exhausted = False
        self.sample_rate = rate
        self.num_samples = req.num_samples

    def __iter__(self) -> Iterator[np.ndarray]:
        while not self._exhausted:
            item = self._req.chunks.get()
            if item is _DONE:
                self._exhausted = True
                if self._req.error is not None:
                    raise self._req.error
                return
            yield item

    def waveform(self) -> np.ndarray:
        parts = list(self)
        return (np.concatenate(parts) if parts
                else np.zeros((0,), np.float32))


class WaveNetServer:
    """Microbatching synthesis engine around a port WaveNet facade.

    server = WaveNetServer(model, max_batch=8)
    h = server.submit(seconds=1.0, seed=17)
    audio = h.waveform()          # or: for chunk in h: play(chunk)
    server.close()

    max_wait_ms bounds the batching latency: the worker collects requests
    for up to that long (or until max_batch are waiting), then launches.
    The model decodes on its own device (model.to("cuda") for the kernel).
    """

    def __init__(self, model, max_batch: int = 8, max_wait_ms: float = 10.0,
                 chunk_seconds: float = 0.5,
                 length_quantum_seconds: float = 0.5):
        self.model = model
        self.cfg = model.cfg
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.chunk_samples = max(1, int(chunk_seconds * self.cfg.sample_rate))
        self.length_quantum = max(
            1, int(length_quantum_seconds * self.cfg.sample_rate))
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                      "samples_out": 0, "decode_seconds": 0.0}
        self._stats_lock = threading.Lock()
        # two decode lanes: unconditioned batchable traffic, and mel
        # (batched) and primed (singleton) requests — so neither
        # head-of-line-blocks the other
        self._inbox: "queue.Queue" = queue.Queue()
        self._inbox_single: "queue.Queue" = queue.Queue()
        # guards the closed-check + enqueue pair in submit() against a
        # concurrent close(): nothing may enter the inboxes after _DONE
        self._submit_lock = threading.Lock()
        self._closed = False
        self._workers = [
            threading.Thread(target=self._run, args=(self._inbox,),
                             daemon=True),
            threading.Thread(target=self._run,
                             args=(self._inbox_single,), daemon=True),
        ]
        for w in self._workers:
            w.start()

    def _bump(self, key: str, n=1) -> None:
        with self._stats_lock:
            self.stats[key] += n

    # ---- client surface ----

    def submit(self, seconds: Optional[float] = None,
               num_samples: Optional[int] = None, seed: int = 0,
               temperature: float = 1.0, speaker: Optional[int] = None,
               mel: Optional[np.ndarray] = None,
               prime: Optional[np.ndarray] = None) -> ResponseStream:
        """Enqueue one utterance; returns immediately with a ResponseStream.

        prime: optional [P] float waveform in [-1, 1] to continue from
        (mu-law encoded here; the emitted audio excludes the prime); primed
        requests decode as singleton batches.  mel: [frames, M] (or
        [1, frames, M]) log-mel frames of a mel model, covering the
        request's timeline (priming steps included); checked here, so a
        bad request cannot fail the rows batched with it.  speaker= is
        rejected: the port serves no speaker-conditioned model yet.
        """
        if num_samples is None:
            if seconds is None:
                raise ValueError("pass seconds= or num_samples=")
            num_samples = int(seconds * self.cfg.sample_rate)
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        if speaker is not None:
            raise ValueError("model has no global conditioning; "
                             "speaker= is not an input")
        if prime is not None:
            prime = np.asarray(prime, np.float32).reshape(-1)
            if prime.size == 0:
                prime = None
        if mel is not None:
            mel = self._check_mel(mel, num_samples, prime)
        elif self.cfg.mel is not None:
            raise ValueError("a mel-conditioned model needs mel= frames")
        req = _Request(int(num_samples), int(seed), float(temperature),
                       mel, prime)
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._bump("requests")
            if req.mel is not None or req.prime is not None:
                self._inbox_single.put(req)      # conditioned lane
            else:
                self._inbox.put(req)
        return ResponseStream(req, self.cfg.sample_rate)

    def _check_mel(self, mel, num_samples: int, prime) -> np.ndarray:
        """Validate a request's mel frames -> [frames, M] float32."""
        if self.cfg.mel is None:
            raise ValueError("model is unconditional; mel= is not an input")
        m = np.asarray(mel, np.float32)
        if m.ndim == 3 and m.shape[0] == 1:
            m = m[0]
        M = self.cfg.mel.num_mels
        if m.ndim != 2 or m.shape[1] != M or m.shape[0] == 0:
            raise ValueError(f"mel must be [frames, {M}] (or "
                             f"[1, frames, {M}]); got shape "
                             f"{np.asarray(mel).shape}")
        if not np.isfinite(m).all():
            raise ValueError("mel holds non-finite values")
        cap = m.shape[0] * self.cfg.mel.hop_length
        span = max(prime.size - 1, 0) if prime is not None else 0
        if span + num_samples > cap:
            raise ValueError(
                f"num_samples={num_samples}"
                + (f" (+{span} priming steps)" if span else "")
                + f" exceeds the {cap} samples covered by {m.shape[0]} mel "
                f"frames")
        return m

    def synthesize(self, **kw) -> np.ndarray:
        """Blocking convenience: submit() + waveform()."""
        return self.submit(**kw).waveform()

    def warmup(self, seconds: float = 1.0, verbose: bool = False) -> None:
        """Push `seconds` of synthesis through every batch bucket (1, 2,
        4, ..., max_batch) on the calling thread, so the kernel library is
        built and loaded before the first real request arrives.  On a mel
        model the rows carry zero mel, as vocoder traffic does."""
        n = max(1, int(seconds * self.cfg.sample_rate))
        mel = None
        if self.cfg.mel is not None:
            frames = -(-_bucket(n, self.length_quantum)
                       // self.cfg.mel.hop_length)
            mel = np.zeros((frames, self.cfg.mel.num_mels), np.float32)
        b = 1
        while True:
            group = [_Request(n, i, 1.0, mel) for i in range(b)]
            t0 = time.monotonic()
            self._decode_group(group)
            if verbose:
                print(f"warmup: batch bucket {b} ran "
                      f"in {time.monotonic() - t0:.1f}s", flush=True)
            if b >= self.max_batch:
                return
            b = min(b * 2, self.max_batch)

    def close(self, wait: bool = True) -> None:
        """Stop accepting requests; optionally drain in-flight work."""
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._inbox.put(_DONE)
            self._inbox_single.put(_DONE)
        if wait:
            for w in self._workers:
                w.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    # ---- worker ----

    def _collect(self, inbox):
        """Gather one microbatch group: the first request fixes the group
        signature (length bucket, temperature, mel or not); compatible
        requests arriving within max_wait_s join.  Primed requests stay
        singletons (the prime fixes a request-specific timeline)."""
        first = inbox.get()
        if first is _DONE:
            return None
        if first.prime is not None:
            return [first]

        def sig(r):
            return (None if r.prime is not None else
                    (_bucket(r.num_samples, self.length_quantum),
                     r.temperature, r.mel is not None))

        s0 = sig(first)
        group = [first]
        deadline = time.monotonic() + self.max_wait_s
        leftovers, saw_done = [], False
        while len(group) < self.max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                nxt = inbox.get(timeout=remaining)
            except queue.Empty:
                break
            if nxt is _DONE:
                saw_done = True
                break
            if sig(nxt) == s0:
                group.append(nxt)
            else:
                leftovers.append(nxt)
        for r in leftovers:  # keep deferred requests ahead of shutdown
            inbox.put(r)
        if saw_done:
            inbox.put(_DONE)  # re-arm shutdown after the drain
        return group

    def _run(self, inbox):
        while True:
            group = self._collect(inbox)
            if group is None:
                return
            t0 = time.monotonic()
            try:
                self._decode_group(group)
            except Exception as e:  # surface to every waiting client
                for r in group:
                    r.error = e
            finally:
                self._bump("decode_seconds", time.monotonic() - t0)
                for r in group:
                    r.chunks.put(_DONE)

    @property
    def realtime_factor(self) -> float:
        """Generated-audio seconds per wall second of decode (aggregate
        over all requests; > 1 keeps up with demand)."""
        with self._stats_lock:
            dt = self.stats["decode_seconds"]
            return (self.stats["samples_out"] / self.cfg.sample_rate / dt
                    if dt > 0 else 0.0)

    def _decode_group(self, group):
        n_real = len(group)
        scan_len = _bucket(max(r.num_samples for r in group),
                           self.length_quantum)
        B = _batch_bucket(n_real, self.max_batch)
        self._bump("batches")
        self._bump("padded_rows", B - n_real)

        # per-REQUEST sampling seeds: row i draws noise keyed by ITS seed
        # only (ops/rng.py), so co-batched traffic and pad rows can never
        # change a response (replay contract; pad rows use seed 0)
        seeds = np.asarray([r.seed for r in group] + [0] * (B - n_real),
                           np.int32)

        # the prime first: it fixes the scan length (singleton, exact) and
        # the conditioning span the mel rows must cover
        prime_tokens = None
        P = 0
        if group[0].prime is not None:
            from wavenet_tpu_torch.audio import mulaw
            prime_tokens = mulaw.encode_np(
                group[0].prime, self.cfg.quantization_channels)[None]
            P = prime_tokens.shape[1]
            scan_len = group[0].num_samples  # singleton: exact length

        y = None
        if group[0].mel is not None:
            y = self._features(group, B, max(P - 1, 0), scan_len)

        emitted = [0] * n_real
        for chunk in self.model.stream(
                num_samples=scan_len, chunk_samples=self.chunk_samples,
                batch=B, seeds=seeds, prime_tokens=prime_tokens,
                temperature=group[0].temperature, y=y):
            chunk = np.asarray(chunk, np.float32)
            for i, r in enumerate(group):
                take = min(chunk.shape[1], r.num_samples - emitted[i])
                if take > 0:
                    r.chunks.put(chunk[i, :take])
                    emitted[i] += take
                    self._bump("samples_out", take)
            if all(emitted[i] >= group[i].num_samples
                   for i in range(n_real)):
                break  # bucket tail serves nobody; stop the scan early

    def _features(self, group, B: int, span: int, scan_len: int):
        """[B, span + scan_len, M] upsampled features on the model's
        device: each row upsampled alone at its own timeline length (one
        conv per row, so its bits cannot depend on the rows batched with
        it), zero-padded to the group's; pad rows are zeros."""
        from wavenet_tpu_torch.models import conditioning
        dev, M = self.model.device, self.cfg.mel.num_mels
        total = span + scan_len
        y = torch.zeros(B, total, M, device=dev)
        ups = self.model.params["upsampler"]
        with torch.no_grad():
            for i, r in enumerate(group):
                n = span + r.num_samples
                mel = torch.as_tensor(r.mel[None], device=dev)
                y[i, :n] = conditioning.upsample_mel(ups, self.cfg.mel, mel,
                                                     n)[0]
        return y
