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
    the host.  Primed requests stay singletons.  A mel model's request
    without mel takes the batchable lane and decodes with no conditioning
    term, as the reference's does (its y=None): through the same kernel's
    unconditional variant, on the model's weights without v_cond
    (_unconditioned).
  * A speaker-conditioned model takes each request's speaker id (checked
    at submit); speakers are not part of the batching signature, so rows
    of different speakers share a batch (each row's gate offsets are its
    own, computed once per batch).  Requests that name no speaker, pad
    rows and warmup rows use speaker 0, as the reference does.
  * Chunks flow through per-request unbounded queues: a lagging consumer
    costs memory for its own utterance and never stalls the decode loop.
  * While a torch.profiler runs, each lane records its loop as spans
    (utils/profiling.span), which tile it: "serve.collect" (waiting on an
    empty inbox, then gathering a group) and "serve.group" (its decode and
    the hand-off of its end; id the group's serial, numbers lane, rows,
    real).  Each request records "serve.queue_wait", from submit to the
    start of the group that takes it (id the request's serial, parent the
    group's).  A mel group's per-row upsampling records "serve.upsample"
    inside its "serve.group" (parent the group's serial; numbers lane,
    rows upsampled, frames in), as stats "upsampled_rows" and
    "upsampled_frames" count it.

  * Over a (data, model) mesh of ranks (mesh=, one process per rank under
    torchrun) every microbatch decodes through the distributed decoder
    (generate/sampler.stream_distributed: the kernel fan-out on a
    data-only mesh, the collective loop otherwise), streaming chunk for
    chunk as on one device, with batch buckets rounded up to a multiple
    of the data axis.  Rank 0 takes the requests; the other ranks are
    followers (follow()).  For each microbatch rank 0 broadcasts a header
    (the batch, scan length, temperature, seeds, speakers, the prime's
    tokens and each mel row's frames) on the lane's control group, and
    every rank then runs the same decode; a rank upsamples only its own
    rows' mel (the upsampled features are ~hop x M floats a sample, the
    frames 1/hop of that), and followers drop the tokens.  Each lane has
    its own data, model and control groups (made in the same order on
    every rank), so the two lanes' collectives never interleave on one
    group, and one follower thread per lane runs them: the lanes decode
    concurrently on the mesh as they do on one device.  Closing the
    server sends each lane's followers a close header.
"""

from __future__ import annotations

import itertools
import queue
import threading
import time
from dataclasses import dataclass, field
from typing import Iterator, Optional

import numpy as np
import torch
import torch.distributed as dist

from wavenet_tpu_torch.utils import profiling


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
    speaker: Optional[int] = None
    chunks: "queue.Queue" = field(default_factory=queue.Queue)
    error: Optional[BaseException] = None
    serial: int = 0
    queued_ns: Optional[int] = None     # profiling.stamp() at submit


_DONE = object()


class _Lane:
    """One decode lane's collectives over the mesh: its own data and model
    groups (parallel/mesh.new_mesh_groups) for the decode, a gloo group of
    every rank for the headers rank 0 broadcasts, and the lock that keeps
    one microbatch at a time on the lane (rank 0's worker and warmup)."""

    def __init__(self, mesh):
        from wavenet_tpu_torch.parallel.mesh import new_mesh_groups
        self.groups = new_mesh_groups(mesh)
        self.control = dist.new_group(backend="gloo")
        self.lock = threading.Lock()

    def send(self, header) -> None:
        dist.broadcast_object_list([header], src=0, group=self.control)

    def recv(self):
        box = [None]
        dist.broadcast_object_list(box, src=0, group=self.control)
        return box[0]


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


def unconditioned(model):
    """A mel model's weights without the conditioning term: the same
    tensors (not copies) under the config without mel, less v_cond and the
    upsampler.  It decodes the mel model with no conditioning term,
    as the reference decodes a request that brings no mel."""
    from wavenet_tpu_torch.models.api import WaveNet
    params = {k: v for k, v in model.params.items()
              if k not in ("v_cond", "upsampler")}
    return WaveNet(model.cfg.replace(mel=None), params)


class WaveNetServer:
    """Microbatching synthesis engine around a port WaveNet facade.

    server = WaveNetServer(model, max_batch=8)
    h = server.submit(seconds=1.0, seed=17)
    audio = h.waveform()          # or: for chunk in h: play(chunk)
    server.close()

    max_wait_ms bounds the batching latency: the worker collects requests
    for up to that long (or until max_batch are waiting), then launches.
    The model decodes on its own device (model.to("cuda") for the kernel).

    mesh: a (data, model) DeviceMesh (parallel/mesh.make_mesh) over the
    running process group: every rank builds the server with the same
    arguments; rank 0 takes requests and the others call follow(), which
    returns when rank 0's server closes (see the module docstring).
    """

    def __init__(self, model, max_batch: int = 8, max_wait_ms: float = 10.0,
                 chunk_seconds: float = 0.5,
                 length_quantum_seconds: float = 0.5, mesh=None):
        self.model = model
        self._unconditioned = None
        self.cfg = model.cfg
        # the mesh's lanes, made in the same order on every rank
        self._lanes = (None if mesh is None
                       else [_Lane(mesh), _Lane(mesh)])
        self._dp = 1 if mesh is None else self._lanes[0].groups.dp
        self.follower = mesh is not None and dist.get_rank() != 0
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.chunk_samples = max(1, int(chunk_seconds * self.cfg.sample_rate))
        self.length_quantum = max(
            1, int(length_quantum_seconds * self.cfg.sample_rate))
        self.stats = {"requests": 0, "batches": 0, "padded_rows": 0,
                      "samples_out": 0, "decode_seconds": 0.0,
                      "upsampled_rows": 0, "upsampled_frames": 0}
        self._stats_lock = threading.Lock()
        self._group_serials = itertools.count(1)
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
            threading.Thread(target=self._run, args=(self._inbox, 0),
                             daemon=True),
            threading.Thread(target=self._run,
                             args=(self._inbox_single, 1), daemon=True),
        ]
        if not self.follower:
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
        bad request cannot fail the rows batched with it.  speaker: the
        class id of a speaker-conditioned model, in [0, global_classes)
        (speaker 0 when omitted); refused for other models.
        """
        if num_samples is None:
            if seconds is None:
                raise ValueError("pass seconds= or num_samples=")
            num_samples = int(seconds * self.cfg.sample_rate)
        if num_samples <= 0:
            raise ValueError("num_samples must be positive")
        if speaker is not None:
            if self.cfg.global_classes is None:
                raise ValueError("model has no global conditioning; "
                                 "speaker= is not an input")
            if not 0 <= int(speaker) < self.cfg.global_classes:
                # the id indexes g_embed: refuse it here instead of
                # failing the rows batched with it
                raise ValueError(f"speaker={speaker} out of range "
                                 f"[0, {self.cfg.global_classes})")
        if prime is not None:
            prime = np.asarray(prime, np.float32).reshape(-1)
            if prime.size == 0:
                prime = None
        if self.follower:
            raise RuntimeError("a follower rank takes no requests (rank 0 "
                               "does)")
        if mel is not None:
            mel = self._check_mel(mel, num_samples, prime)
        req = _Request(int(num_samples), int(seed), float(temperature),
                       mel, prime, None if speaker is None else int(speaker))
        with self._submit_lock:
            if self._closed:
                raise RuntimeError("server is closed")
            self._bump("requests")
            req.serial = self.stats["requests"]
            req.queued_ns = profiling.stamp()
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
        model the rows carry zero mel, as vocoder traffic does; on a
        speaker model they name no speaker, so they decode as speaker 0.
        On a mesh it runs on rank 0, and the followers run their share of
        each bucket in follow()."""
        if self.follower:
            return
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
        """Stop accepting requests; optionally drain in-flight work.  On a
        mesh each lane's worker then tells the followers to stop."""
        if self.follower:
            return
        with self._submit_lock:
            if self._closed:
                return
            self._closed = True
            self._inbox.put(_DONE)
            self._inbox_single.put(_DONE)
        if wait:
            for w in self._workers:
                w.join()

    def follow(self, timeout: Optional[float] = None) -> None:
        """A follower rank's serving loop: one thread per lane receives
        rank 0's headers and runs the same decodes (the tokens dropped)
        until rank 0 closes the lane.  Returns when both lanes closed;
        raises a lane's error, or TimeoutError after `timeout` seconds."""
        if not self.follower:
            raise RuntimeError("follow() runs on the ranks other than 0")
        errors = []

        def lane_loop(lane):
            try:
                while True:
                    header = lane.recv()
                    if header is None:
                        return
                    for _ in self._decode_mesh(header, lane):
                        pass
            except Exception as e:  # surfaced by follow()
                errors.append(e)

        threads = [threading.Thread(target=lane_loop, args=(lane,),
                                    daemon=True) for lane in self._lanes]
        for t in threads:
            t.start()
        deadline = None if timeout is None else time.monotonic() + timeout
        for t in threads:
            t.join(None if deadline is None
                   else max(deadline - time.monotonic(), 0.0))
            if errors:
                raise errors[0]
            if t.is_alive():
                raise TimeoutError(f"a follower lane ran past {timeout} s")

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

    def _run(self, inbox, lane: int):
        while True:
            with profiling.span("serve.collect", lane=lane):
                group = self._collect(inbox)
            if group is None:
                if self._lanes is not None:      # release the followers
                    with self._lanes[lane].lock:
                        self._lanes[lane].send(None)
                return
            serial = next(self._group_serials)
            with profiling.span("serve.group", id=serial, lane=lane,
                                rows=self._rows(len(group)),
                                real=len(group)):
                start = profiling.stamp()
                if start is not None:
                    for r in group:
                        if r.queued_ns is not None:
                            profiling.interval("serve.queue_wait",
                                               r.queued_ns, start,
                                               id=r.serial, parent=serial)
                t0 = time.monotonic()
                try:
                    self._decode_group(group, serial)
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

    def _rows(self, n_real: int) -> int:
        """The batch of a group of n_real requests: its power-of-two
        bucket, on a mesh a multiple of the data axis (its rows split over
        that axis)."""
        B = _batch_bucket(n_real, self.max_batch)
        if self._lanes is not None:
            B = -(-max(B, self._dp) // self._dp) * self._dp
        return B

    def _decode_group(self, group, serial=None):
        """Decode one microbatch group and hand each request its chunks;
        serial: the group's "serve.group" id, the parent of its
        "serve.upsample"."""
        n_real = len(group)
        scan_len = _bucket(max(r.num_samples for r in group),
                           self.length_quantum)
        B = self._rows(n_real)
        self._bump("batches")
        self._bump("padded_rows", B - n_real)

        # per-REQUEST sampling seeds: row i draws noise keyed by ITS seed
        # only (ops/rng.py), so co-batched traffic and pad rows can never
        # change a response (replay contract; pad rows use seed 0)
        seeds = np.asarray([r.seed for r in group] + [0] * (B - n_real),
                           np.int32)

        # per-row speakers (not part of the group signature): requests
        # without one and pad rows use speaker 0, as the reference does
        speaker = None
        if self.cfg.global_classes is not None:
            ids = [0 if r.speaker is None else r.speaker for r in group]
            speaker = np.asarray(ids + [0] * (B - n_real), np.int32)

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

        if self._lanes is not None:
            self._serve_mesh(group, B, scan_len, seeds, speaker,
                             prime_tokens)
            return

        y = None
        if group[0].mel is not None:
            y = self._features([r.mel for r in group],
                               [r.num_samples for r in group], range(B),
                               max(P - 1, 0), scan_len, serial)

        emitted = [0] * n_real
        for chunk in self._model_for(y is not None).stream(
                num_samples=scan_len, chunk_samples=self.chunk_samples,
                batch=B, seeds=seeds, prime_tokens=prime_tokens,
                temperature=group[0].temperature, y=y, speaker=speaker):
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

    def _model_for(self, with_mel: bool):
        """The model a group decodes on: self.model, or for a mel model's
        group without mel its unconditioned view."""
        if with_mel or self.cfg.mel is None:
            return self.model
        if self._unconditioned is None:
            self._unconditioned = unconditioned(self.model)
        return self._unconditioned

    def _features(self, mels, nums, rows, span: int, scan_len: int,
                  parent=None):
        """[len(rows), span + scan_len, M] upsampled features on the
        model's device for the batch rows `rows`: row i from mels[i]
        ([frames, M]) upsampled alone at its own timeline length,
        span + nums[i] (one conv per row, so its bits cannot depend on the
        rows batched with it), zero-padded to the group's; rows past the
        requests (pad rows) are zeros.  The upsampling is the span
        "serve.upsample" (parent: the group's serial) and the stats'
        upsampled rows and frames."""
        from wavenet_tpu_torch.models import conditioning
        dev, M = self.model.device, self.cfg.mel.num_mels
        y = torch.zeros(len(rows), span + scan_len, M, device=dev)
        ups = self.model.params["upsampler"]
        real = [(j, i) for j, i in enumerate(rows) if i < len(mels)]
        frames = sum(len(mels[i]) for _, i in real)
        # mel groups always decode on lane 1
        with profiling.span("serve.upsample", parent=parent, lane=1,
                            rows=len(real), frames=frames), \
                torch.no_grad():
            for j, i in real:
                n = span + nums[i]
                mel = torch.as_tensor(mels[i][None], device=dev)
                y[j, :n] = conditioning.upsample_mel(ups, self.cfg.mel, mel,
                                                     n)[0]
        self._bump("upsampled_rows", len(real))
        self._bump("upsampled_frames", frames)
        return y

    # ---- mesh ----

    def _serve_mesh(self, group, B: int, scan_len: int, seeds, speaker,
                    prime_tokens) -> None:
        """Rank 0's side of a mesh microbatch: broadcast its header on the
        lane, run the distributed decode with every rank, and hand each
        request its chunks."""
        lane = self._lanes[int(group[0].mel is not None
                               or group[0].prime is not None)]
        header = {
            "B": B, "scan_len": scan_len, "chunk": self.chunk_samples,
            "stop": max(r.num_samples for r in group),
            "temperature": group[0].temperature, "seeds": seeds,
            "speaker": speaker,
            "prime": (None if prime_tokens is None
                      else np.tile(prime_tokens, (B, 1))),
            "mels": (None if group[0].mel is None
                     else [r.mel for r in group]),
            "nums": [r.num_samples for r in group]}
        n_real = len(group)
        emitted = [0] * n_real
        with lane.lock:
            lane.send(header)
            for chunk in self._decode_mesh(header, lane):
                for i, r in enumerate(group):
                    take = min(chunk.shape[1], r.num_samples - emitted[i])
                    if take > 0:
                        r.chunks.put(chunk[i, :take])
                        emitted[i] += take
                        self._bump("samples_out", take)

    def _decode_mesh(self, h: dict, lane):
        """Every rank's side of a mesh microbatch: the distributed streaming
        decode of header h on the lane's groups, yielding [B, n] float32
        chunks until the longest request is covered (every rank stops
        after the same chunk)."""
        from wavenet_tpu_torch.parallel.distdecode import local_rows
        prime = h["prime"]
        span = 0 if prime is None else max(prime.shape[1] - 1, 0)
        local_y = None
        if h["mels"] is not None:
            rows = local_rows(lane.groups, h["B"])
            local_y = self._features(h["mels"], h["nums"],
                                     range(rows.start, rows.stop), span,
                                     h["scan_len"])
        done = 0
        for chunk in self._model_for(local_y is not None).stream(
                num_samples=h["scan_len"], chunk_samples=h["chunk"],
                batch=h["B"], seeds=h["seeds"], prime_tokens=prime,
                temperature=h["temperature"], speaker=h["speaker"],
                mesh=lane.groups, local_y=local_y):
            yield np.asarray(chunk, np.float32)
            done += chunk.shape[1]
            if done >= h["stop"]:
                return  # bucket tail serves nobody; stop the scan early
