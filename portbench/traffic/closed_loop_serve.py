"""Serving traffic: a closed loop of clients through the port's
WaveNetServer.

Each client submits one request, reads its ResponseStream to the end,
then submits the next at once, until the window closes; the requests
take, in submission order, the mix's lengths (corpus.request_lengths: the
same set for every seed, in an order drawn from it) and seeds drawn from
the run's seed (corpus.request_seeds).  After the window no request is
submitted; those in flight are read to their end, for at most `grace_s`.

A request is unconditional unless the mix says "conditioning": "mel": it
then brings the log-mel frames (reference.data.log_mel) of a span of one
of the mix's synthetic clips (corpus.clips), ceil(n / hop) frames from a
clip and a first frame drawn from the seed (corpus.request_spans), and
takes the server's mel lane.  A speaker model's requests each name a
speaker drawn from the seed (corpus.request_speakers).

  served_audio_s_per_s  audio-seconds delivered to clients over the
                        window's wall seconds: each decode launch's samples
                        for real rows, by the share of the launch's span
                        inside the window (a launch that straddles the close
                        counts pro rata, so that no 0.5 s chunk of a whole
                        group falls on one side of the close or the other);
  first_audio_ms_p95    over every request submitted in the window, submit
                        to the client's receipt of its first chunk; one
                        that failed or gave no first chunk within the grace
                        counts at the grace's end and fails the run.

Set-up warms every batch bucket the server can launch (1, 2, .., max_batch)
through WaveNet.stream with `warm_samples` samples in two chunks (with
features and speaker ids where the requests bring them; and the upsampler
at each number of frames a request brings, whose products' kernels load
at their first use), not WaveNetServer.warmup, which decodes a whole chunk
per bucket.

Mix parameters: clients, max_batch, max_wait_ms, chunk_s,
length_quantum_s, min_s, max_s, temperature, max_requests, grace_s,
warm_samples; with "conditioning": "mel" also clips, clip_min_s,
clip_max_s, noise (every clip at least max_s long).  Workload
parameters: check_requests, ref_rows, limits.
"""

from __future__ import annotations

import threading
import time
from typing import List, Optional

import numpy as np


class _Request:
    __slots__ = ("index", "n", "seed", "mel", "speaker", "submit", "first",
                 "done", "chunks", "audio", "error")

    def __init__(self, index: int, n: int, seed: int, mel=None,
                 speaker: Optional[int] = None):
        self.index, self.n, self.seed = index, n, seed
        self.mel, self.speaker = mel, speaker        # [F, M] frames, id
        self.submit = self.first = self.done = None
        self.chunks: List[tuple] = []          # (receipt time, samples)
        self.audio: List[np.ndarray] = []
        self.error: Optional[str] = None


class ClosedLoop:
    """`clients` threads, each reading one request at a time and
    submitting the next as soon as it ended, until `end` (a
    time.monotonic() value).

    The k-th request submitted takes lengths[k] and seeds[k] (and mels[k],
    speakers[k] where given), and is put into the server's inbox in that
    order (the count and the submit under one lock).  The first `clients`
    requests are submitted together before any client starts."""

    def __init__(self, server, clients: int, lengths, seeds,
                 temperature: float, mels=None, speakers=None):
        self.server, self.temperature = server, temperature
        self.lengths, self.seeds = lengths, seeds
        self.mels, self.speakers = mels, speakers
        self.requests: List[_Request] = []
        self._lock = threading.Lock()
        self.clients = clients
        self._threads: List[threading.Thread] = []
        self.end = None

    def start(self, end: float) -> None:
        self.end = end
        first = [self._submit() for _ in range(self.clients)]
        self._threads = [threading.Thread(target=self._client, args=(h,),
                                          daemon=True) for h in first]
        for t in self._threads:
            t.start()

    def _submit(self):
        """(request, its ResponseStream), or None once the window is over."""
        with self._lock:
            k = len(self.requests)
            if time.monotonic() >= self.end or k >= len(self.lengths):
                return None
            r = _Request(k, int(self.lengths[k]), int(self.seeds[k]),
                         None if self.mels is None else self.mels[k],
                         None if self.speakers is None
                         else int(self.speakers[k]))
            self.requests.append(r)
            r.submit = time.monotonic()
            try:
                return r, self.server.submit(num_samples=r.n, seed=r.seed,
                                             temperature=self.temperature,
                                             mel=r.mel, speaker=r.speaker)
            except Exception as e:          # counted against the run
                r.error = repr(e)
                return r, None

    def _client(self, job) -> None:
        while job is not None:
            r, h = job
            try:
                for chunk in h or ():
                    now = time.monotonic()
                    if r.first is None:
                        r.first = now
                    r.chunks.append((now, len(chunk)))
                    r.audio.append(chunk)
                if h is not None:
                    r.done = time.monotonic()
            except Exception as e:          # counted against the run
                r.error = repr(e)
            job = self._submit()

    def join(self, deadline: float) -> bool:
        """Wait for every client until `deadline`; True if all ended."""
        for t in self._threads:
            t.join(max(0.0, deadline - time.monotonic()))
        return not any(t.is_alive() for t in self._threads)


def _warm(model, mix, mel_frames=(), seeds_base: int = 1) -> None:
    """Every batch bucket through model.stream; with mel_frames (the
    numbers of frames the requests bring), the mel variant with zero
    features, and the upsampler at each number of frames, as the server
    upsamples a request alone."""
    import torch
    n = int(mix["warm_samples"])
    cfg, dev = model.cfg, model.device
    if mel_frames:
        from wavenet_tpu_torch.models import conditioning
        with torch.no_grad():
            for f in sorted(set(mel_frames)):
                conditioning.upsample_mel(
                    model.params["upsampler"], cfg.mel,
                    torch.zeros(1, f, cfg.mel.num_mels, device=dev),
                    f * cfg.mel.hop_length)
    b = 1
    while True:
        kw = {}
        if mel_frames:
            kw["y"] = torch.zeros(b, 2 * n, cfg.mel.num_mels, device=dev)
        if cfg.global_classes is not None:
            kw["speaker"] = np.zeros(b, np.int32)
        for _ in model.stream(num_samples=2 * n, chunk_samples=n, batch=b,
                              seeds=np.arange(seeds_base, seeds_base + b,
                                              dtype=np.int32),
                              temperature=mix["temperature"], **kw):
            pass
        if b >= mix["max_batch"]:
            return
        b = min(2 * b, mix["max_batch"])


def _counted(stream, groups: list, launches: list):
    """model.stream logging each call's (start, rows) into groups and, for
    each launch, (start, end, rows, steps, row seeds): the generator's time
    between resuming and yielding a chunk."""
    def wrapped(*a, **kw):
        B = kw["batch"]
        seeds = tuple(int(x) for x in kw["seeds"])
        groups.append((time.monotonic(), B))
        gen = stream(*a, **kw)
        while True:
            t = time.monotonic()
            try:
                chunk = next(gen)
            except StopIteration:
                return
            launches.append((t, time.monotonic(), B, chunk.shape[1], seeds))
            yield chunk
    return wrapped


def request_mels(run, lengths):
    """Each request's [ceil(n / hop), M] log-mel frames (views into its
    clip's), or None for a mix without "conditioning"."""
    from portbench import corpus
    from portbench.reference import data
    mix, z = run.cell.mix, run.sizes
    kind = mix.get("conditioning")
    if kind is None:
        return None
    if kind != "mel" or not z.M:
        raise ValueError(f"conditioning {kind!r} needs \"mel\" and a mel "
                         f"model")
    mels = data.clip_mels(corpus.clips(
        run.seed, mix["clips"], mix["clip_min_s"], mix["clip_max_s"],
        z.sample_rate, mix["noise"]), z)
    frames = -(-np.asarray(lengths, np.int64) // z.hop)
    clip, start = corpus.request_spans(run.seed, frames,
                                       [len(m) for m in mels])
    return [mels[c][s:s + f] for c, s, f in zip(clip, start, frames)]


def serve(run) -> ClosedLoop:
    """Build the server on the run's weights and run the closed loop over
    the window and the grace; the window's bounds, the padded rows and the
    log of groups and launches go to run.counters."""
    from portbench import corpus
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.serving.server import WaveNetServer
    mix, z = run.cell.mix, run.sizes
    model = WaveNet(run.program_config(), run.program_weights())
    server = WaveNetServer(model, max_batch=mix["max_batch"],
                           max_wait_ms=mix["max_wait_ms"],
                           chunk_seconds=mix["chunk_s"],
                           length_quantum_seconds=mix["length_quantum_s"])
    count = int(mix["max_requests"])
    lengths = corpus.request_lengths(run.seed, count, int(mix["clients"]),
                                     mix["min_s"], mix["max_s"],
                                     z.sample_rate)
    mels = request_mels(run, lengths)
    _warm(model, mix, () if mels is None else [len(m) for m in mels])
    loop = ClosedLoop(server, int(mix["clients"]), lengths,
                      corpus.request_seeds(run.seed, count),
                      float(mix["temperature"]), mels,
                      corpus.request_speakers(run.seed, count, z.C)
                      if z.C else None)
    groups: list = []
    launches: list = []
    model.stream = _counted(model.stream, groups, launches)
    stats0 = dict(server.stats)
    with run.tracing():
        with run.window() as t0:
            loop.start(t0 + run.seconds)
            time.sleep(max(0.0, t0 + run.seconds - time.monotonic()))
            stats1 = dict(server.stats)
        all_ended = loop.join(time.monotonic() + float(mix["grace_s"]))
        gave_up = time.monotonic()
    run.after_window()
    server.close(wait=all_ended)
    run.counters.update(
        window=(t0, t0 + run.window_s), gave_up=gave_up,
        padded_rows=stats1["padded_rows"] - stats0["padded_rows"],
        groups=groups, launches=launches)
    return loop


def launch_samples(reqs, launches) -> list:
    """(start, end, samples) of each launch: the samples it delivered to
    real rows.  A request takes, from each launch that holds its seed in
    turn, the launch's steps or what it still lacks, as the engine hands
    them out; pad rows (seed 0) take nothing."""
    lacking = {r.seed: r.n for r in reqs}
    out = []
    for a, b, _, n, seeds in launches:
        got = 0
        for s in seeds:
            if s in lacking:
                take = min(n, lacking[s])
                lacking[s] -= take
                got += take
        out.append((a, b, got))
    return out


def window_metrics(reqs, launches, t0: float, t1: float, window_s: float,
                   gave_up: float, sample_rate: int) -> dict:
    """The end-to-end numbers of the window [t0, t1]: the samples that the
    launches delivered to clients, each launch by the share of its span
    inside the window, over window_s, and the 95th percentile over every
    request of submit to first chunk (a request without one counts at
    gave_up)."""
    from portbench import stats
    delivered = 0.0
    for a, b, n in launch_samples(reqs, launches):
        inside = max(0.0, min(b, t1) - max(a, t0))
        delivered += n * (inside / (b - a) if b > a else float(t0 <= a <= t1))
    lat = stats.request_latencies([r.submit for r in reqs],
                                  [r.first for r in reqs], gave_up)
    return {"samples_in_window": delivered,
            "served_audio_s_per_s": delivered / sample_rate / window_s,
            "first_audio_ms_p95": 1e3 * stats.nearest_rank(lat, 95)}


def run(run) -> None:
    mix, wl = run.cell.mix, run.cell.workload
    loop = serve(run)
    reqs = loop.requests
    t0, t1 = run.counters["window"]
    launches = run.counters["launches"]
    m = window_metrics(reqs, launches, t0, t1, run.window_s,
                       run.counters["gave_up"], run.sizes.sample_rate)
    run.counters["samples_in_window"] = m.pop("samples_in_window")
    run.e2e.update(m)
    logged = sum(n for _, _, n in launch_samples(reqs, launches))
    received = sum(n for r in reqs for _, n in r.chunks)
    if logged != received:
        run.fault(f"the launches delivered {logged} samples by their log, "
                  f"the clients received {received}")
    missing = [r for r in reqs if r.error is not None or r.done is None]
    run.attempted = len(reqs)
    run.failed = len(missing)
    for r in missing[:3]:
        run.fault(f"request {r.index} ({r.n} samples) "
                  f"{r.error or 'did not finish within the grace'}")
    del loop
    run.free()
    _judge(run, [r for r in reqs if r not in missing],
           float(mix["temperature"]), wl)


def pick(done: list, count: int, seed: int) -> list:
    """`count` finished requests drawn from the seed, the longest among
    them."""
    from portbench import corpus
    if not done:
        return []
    longest = max(done, key=lambda r: (r.n, -r.index))
    rest = [r for r in done if r is not longest]
    rng = corpus.seed32(seed, 4)
    k = min(count - 1, len(rest))
    chosen = [rest[i] for i in sorted(rng.choice(len(rest), size=k,
                                                 replace=False))]
    return [longest] + chosen


def sample_tokens(run, done: list, wl: dict):
    """The judged requests' tokens and seeds, and their conditioning as
    reference.serve.gaps takes it ({"mels": [..]} and {"speakers": [..]}
    where the requests bring them); a request whose audio is not its
    length or not mu-law levels is a fault."""
    from portbench.reference import serve as ref_serve
    chosen = pick(done, int(wl["check_requests"]), run.seed)
    if len(chosen) < int(wl["check_requests"]):
        run.fault(f"only {len(chosen)} requests finished; "
                  f"{wl['check_requests']} are judged")
    toks, seeds, kept = [], [], []
    for r in chosen:
        audio = (np.concatenate(r.audio) if r.audio
                 else np.zeros(0, np.float32))
        if audio.shape[0] != r.n:
            run.fault(f"request {r.index} received {audio.shape[0]} of "
                      f"{r.n} samples")
            continue
        try:
            toks.append(ref_serve.tokens_of(audio, run.sizes.Q))
        except ValueError as e:
            run.fault(f"request {r.index}: {e}")
            continue
        seeds.append(r.seed)
        kept.append(r)
    cond = {}
    if kept and kept[0].mel is not None:
        cond["mels"] = [r.mel for r in kept]
    if kept and kept[0].speaker is not None:
        cond["speakers"] = [r.speaker for r in kept]
    return toks, seeds, cond


def _judge(run, done: list, temperature: float, wl: dict) -> None:
    from portbench.reference import model, serve as ref_serve
    toks, seeds, cond = sample_tokens(run, done, wl)
    if not toks:
        run.fault("no request to judge")
        return
    model.no_tf32()
    w = run.weights()
    gap = max(ref_serve.gaps(w, run.sizes.dilations, toks, seeds,
                             temperature, int(wl["ref_rows"]), **cond))
    run.check("token_gap", gap, wl["limits"]["token_gap"])
