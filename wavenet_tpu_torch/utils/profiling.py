"""Where a training step's device time goes (torch.profiler).

    python -m wavenet_tpu_torch.utils.profiling --preset full_vocoder \
        --steps 3 --device cuda

Builds the port's Trainer on synthetic data for the preset, runs two
warm-up steps, then records `--steps` steps with torch.profiler and
prints one JSON line: the wall time per step, the device's busy time per
step (the union of its kernel and copy intervals), the idle share
(1 - busy / wall), and the busy time per step split by kernel family:
  * train_stack: the fused stack's kernels (csrc/train_stack.cu);
  * gemm_f64: double-precision GEMMs (the head and its backward, whose
    dot products the port sums exactly in f64);
  * gemm_f32: single-precision GEMMs (the upsampler's shifted products,
    the embedding's one-hot backward);
  * copies: memcpy / memset;
  * other: elementwise, reductions, softmax, the optimizer.
With no device events (the CPU) the device numbers are null.  The line
also holds `host_costs`: a step's wall ms with no metric fetch and no
save, with the metrics fetched every step (log_every=1), and with a
checkpoint save every step (checkpoint_every=1), blocking and
asynchronous, and the ms an asynchronous save takes to return.

The reference's tracing helpers (wavenet_tpu/utils/profiling.py) on
torch.profiler: `trace` (a Chrome trace of a block), `profiled_steps` (of a
trainer's steps [start, stop), the train CLI's --profile-dir) and `timeit`
(median seconds per call).

The port's own spans: `span` (a block on one thread), `interval` (begun on
one thread, ended on another) and `records()`.  They are kept only while
a torch.profiler runs, from every thread: the profiler traces only the
thread that started it, so the serving lanes' host work is missing from
its trace but not from `records()`.  Each record is
(name, start_ns, end_ns, id, parent, numbers), stamped with
time.time_ns(), the clock of the profiler's host and device events.  With
no profiler running, `span` returns one shared object that does nothing.
`device_mark` / `device_interval` record the same way and, on a CUDA
device, also time the device work between their two ends with CUDA events
recorded on the current stream: the record's numbers gain "device_ms"
(the events' elapsed time) when `records()` is next read, so no step waits
on them.  With no profiler running they create no event.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch
import torch.autograd.profiler as _autograd_profiler

_WARMUP = 2
_STACK = ("fwd_layer_kernel", "bwd_layer_kernel", "wgrad_kernel",
          "shift_add_kernel", "reduce_splits_kernel", "colsum_kernel",
          "init_carry_kernel")


CAPACITY = 1 << 20          # records kept; the oldest go first
_RECORDS: "collections.deque" = collections.deque(maxlen=CAPACITY)
# (numbers of a record, its start and end CUDA events) not yet resolved
_PENDING: "collections.deque" = collections.deque()


class _Off:
    """The span of a block while no profiler runs."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        return None


_OFF = _Off()


class _Span:
    __slots__ = ("name", "id", "parent", "numbers", "start", "_range")

    def __init__(self, name: str, id, parent, numbers: dict):
        self.name, self.id, self.parent = name, id, parent
        self.numbers = numbers

    def __enter__(self):
        self._range = None
        if torch.autograd._profiler_enabled():
            # the profiling thread: the span is in the trace's host events
            # too.  A function-scope range: a user-scope record_function's
            # is copied onto the device timeline as an annotation over the
            # kernels it encloses, which would read as device work
            self._range = torch._C._profiler._RecordFunctionFast(self.name)
            self._range.__enter__()
        self.start = time.time_ns()
        return self

    def __exit__(self, *exc) -> None:
        end = time.time_ns()
        if self._range is not None:
            self._range.__exit__(*exc)
        _RECORDS.append((self.name, self.start, end, self.id, self.parent,
                         self.numbers))


def span(name: str, id=None, parent=None, **numbers):
    """A context manager recording the block as (name, start_ns, end_ns,
    id, parent, numbers) while a profiler runs; otherwise a shared object
    that does nothing."""
    if not _autograd_profiler._is_profiler_enabled:
        return _OFF
    return _Span(name, id, parent, numbers)


def enabled() -> bool:
    """Whether a profiler runs (in this process, on any thread)."""
    return bool(_autograd_profiler._is_profiler_enabled)


def stamp() -> Optional[int]:
    """time.time_ns() while a profiler runs, else None: the start of an
    interval that another thread ends."""
    return time.time_ns() if _autograd_profiler._is_profiler_enabled \
        else None


def interval(name: str, start_ns: int, end_ns: int, id=None, parent=None,
             **numbers) -> None:
    """Record a span begun on one thread (at start_ns, from stamp()) and
    ended on another, while a profiler runs."""
    if _autograd_profiler._is_profiler_enabled:
        _RECORDS.append((name, start_ns, end_ns, id, parent, numbers))


def _event(device: torch.device):
    """A timing CUDA event recorded now on device's current stream, or
    None off a CUDA device."""
    if device.type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(device))
    return ev


def device_mark(device) -> Optional[tuple]:
    """One end of a device_interval, on any thread: (time.time_ns(), a
    CUDA event recorded on device's current stream or None) while a
    profiler runs, else None."""
    if not enabled():
        return None
    return time.time_ns(), _event(torch.device(device))


def device_interval(name: str, start: Optional[tuple], end: Optional[tuple],
                    id=None, parent=None, **numbers) -> None:
    """Record the span between two device_marks, with "device_ms" between
    their events (see the module doc); nothing if either mark is None."""
    if start is not None and end is not None:
        _RECORDS.append((name, start[0], end[0], id, parent, numbers))
        if start[1] is not None and end[1] is not None:
            _PENDING.append((numbers, start[1], end[1]))


def records() -> List[tuple]:
    """The records kept (at most CAPACITY, the newest), oldest first; the
    device spans' "device_ms" resolved first (waiting for their events)."""
    while True:
        try:
            numbers, a, b = _PENDING.popleft()
        except IndexError:
            break
        b.synchronize()
        numbers["device_ms"] = a.elapsed_time(b)
    return list(_RECORDS)


def family(name: str) -> str:
    """The kernel family of a device event's name (see the module doc)."""
    low = name.lower()
    if any(k in name for k in _STACK):
        return "train_stack"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm_f64" if ("dgemm" in low or "f64" in low
                              or "double" in low) else "gemm_f32"
    return "other"


def _busy_ms(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (us) in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def kernel_name(name: str) -> str:
    """A device event's kernel name without its namespace and argument
    list, template arguments kept: "void (anonymous
    namespace)::wgrad_kernel<1>(...)" -> "wgrad_kernel<1>"."""
    head = name[len("void "):] if name.startswith("void ") else name
    return head.replace("(anonymous namespace)::", "").split("(", 1)[0]


def kernel_split(fn, calls: int = 1) -> Dict[str, float]:
    """Device ms per call of fn() by kernel name (kernel_name), largest
    first, recorded by torch.profiler over `calls` calls after one
    unrecorded call.  fn runs on the card (it synchronises the device)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out: Dict[str, float] = {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        k = kernel_name(e.name)
        out[k] = out.get(k, 0.0) + (
            e.time_range.end - e.time_range.start) / 1e3 / calls
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def _sync() -> None:
    if torch.cuda.is_available() and torch.cuda.is_initialized():
        torch.cuda.synchronize()


def _activities():
    from torch.profiler import ProfilerActivity
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    return acts


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[None]:
    """Trace the block with torch.profiler (the card's kernels too, where
    there is one) into log_dir/trace.json, a Chrome trace (Perfetto,
    chrome://tracing); the device is synchronised before the trace stops."""
    from torch.profiler import profile
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=_activities()) as prof:
        try:
            yield
        finally:
            _sync()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def profiled_steps(trainer, log_dir: str, start: int = 10, stop: int = 15):
    """Trace the trainer's steps [start, stop), counted over every
    trainer.step call inside the block (Trainer.run's chunks included),
    into log_dir/trace_steps<start>-<stop>.json; each traced step is the
    span "train_step_<i>".  The device is synchronised before the trace
    stops, so the last steps' kernels are in it."""
    from torch.profiler import profile, record_function
    os.makedirs(log_dir, exist_ok=True)
    path = os.path.join(log_dir, f"trace_steps{start}-{stop}.json")
    orig = trainer.step
    state = {"i": 0, "prof": None}

    def finish():
        _sync()
        state["prof"].stop()
        state["prof"].export_chrome_trace(path)
        state["prof"] = None

    def wrapped(*a, **kw):
        i = state["i"]
        if i == start:
            state["prof"] = profile(activities=_activities())
            state["prof"].start()
        if state["prof"] is None:
            out = orig(*a, **kw)
        else:
            with record_function(f"train_step_{i}"):
                out = orig(*a, **kw)
        state["i"] = i + 1
        if state["i"] == stop and state["prof"] is not None:
            finish()
        return out

    trainer.step = wrapped
    try:
        yield
    finally:
        trainer.step = orig
        if state["prof"] is not None:
            finish()


def timeit(fn: Callable, *args, warmup: int = 2, iters: int = 10,
           **kwargs) -> float:
    """Median wall-clock seconds per fn(*args, **kwargs), the device
    synchronised around each call and the warm-up calls excluded."""
    for _ in range(warmup):
        fn(*args, **kwargs)
    _sync()
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn(*args, **kwargs)
        _sync()
        times.append(time.perf_counter() - t0)
    return sorted(times)[len(times) // 2]


def step_breakdown(trainer, steps: int = 3) -> Dict:
    """Profile `steps` train steps after _WARMUP unprofiled ones."""
    from torch.profiler import ProfilerActivity, profile
    trainer.run(_WARMUP, log_every=0)
    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        trainer._sync()
        t = time.perf_counter()
        trainer.run(steps, log_every=0)
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    spans, fams = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        f = family(e.name)
        fams[f] = fams.get(f, 0.0) + (b - a) / 1e3 / steps
    busy = _busy_ms(spans) / steps if spans else None
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall_ms,
            "device_ms_per_step_by_family": fams or None}


def host_costs(trainer, steps: int = 3) -> Dict[str, float]:
    """Wall ms per step of trainer.run(steps), the run's end and the wait
    for its saves included: with no per-step fetch and no save
    ("no_fetch_no_save"), with the metrics fetched every step
    (log_every=1, "fetch_every_step"), and with a save every step,
    blocking ("save_every_step_sync") and asynchronous
    ("save_every_step_async"; a write longer than a step backs the
    writer up, and the run's end waits for it); and the median ms an
    asynchronous save takes to return, the host copy of the state
    ("async_save_returns_ms", over `steps` saves, each waited out before
    the next).  The trainer needs a checkpoint directory."""
    def ms(**kw) -> float:
        trainer._sync()
        t = time.perf_counter()
        trainer.run(steps, **kw)
        return (time.perf_counter() - t) * 1e3 / steps

    def save_returns_ms() -> float:
        times = []
        for _ in range(steps):
            trainer._sync()
            t = time.perf_counter()
            trainer.save(wait=False)
            times.append((time.perf_counter() - t) * 1e3)
            trainer.ckpt.wait()
        return sorted(times)[len(times) // 2]

    trainer.run(_WARMUP, log_every=0)
    return {"no_fetch_no_save": ms(log_every=0),
            "fetch_every_step": ms(log_every=1, log_fn=lambda _: None),
            "save_every_step_sync": ms(log_every=0, checkpoint_every=1,
                                       wait_saves=True),
            "save_every_step_async": ms(log_every=0, checkpoint_every=1),
            "async_save_returns_ms": save_returns_ms()}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--preset", default="full_vocoder")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.config import get_config
    from wavenet_tpu_torch.training.trainer import Trainer
    cfg = get_config(args.preset)
    ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=4.0)
    with tempfile.TemporaryDirectory() as ckpt:
        tr = Trainer(cfg, ds, checkpoint_dir=ckpt, device=args.device)
        out = {"preset": args.preset, "batch_size": cfg.batch_size,
               "train_window": cfg.train_window, "fused": tr.use_fused,
               **step_breakdown(tr, args.steps),
               "host_costs": host_costs(tr, args.steps)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
