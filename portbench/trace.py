"""The device trace of a traced run, reduced to what the metrics read.

The profiler records the host's operations and the card's kernels, copies
and sets in one time base; the window is the host span "portbench.window",
and every device interval is clipped to it.  `kernel_name`, the union of
intervals and the device seconds by kernel name are copies of the sound
arithmetic of the port's utils/profiling.py (kernel_name, _busy_ms,
kernel_split), kept here so that the yardstick does not change with the
program.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

WINDOW = "portbench.window"
MAX_HOST_S = 5.0     # longer host spans are markers, not work


def kernel_name(name: str) -> str:
    """"void (anonymous namespace)::wgrad_kernel<1>(...)" ->
    "wgrad_kernel<1>"."""
    head = name[len("void "):] if name.startswith("void ") else name
    return head.replace("(anonymous namespace)::", "").split("(", 1)[0]


def base_name(name: str) -> str:
    """kernel_name without template arguments: "wgrad_kernel"."""
    return kernel_name(name).split("<", 1)[0].strip()


def union_seconds(spans: Sequence[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals, in their unit."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total


class Trace:
    """Device intervals (name, start s, end s) clipped to the window, and
    the host's operations (name, start s, end s)."""

    def __init__(self, window: Tuple[float, float],
                 device: List[Tuple[str, float, float]],
                 host: List[Tuple[str, float, float]]):
        self.window = window
        a, b = window
        self.device = [(n, max(s, a), min(e, b)) for n, s, e in device
                       if e > a and s < b]
        self.host = host

    @property
    def window_s(self) -> float:
        return self.window[1] - self.window[0]

    @property
    def busy_s(self) -> float:
        return union_seconds([(s, e) for _, s, e in self.device])

    def seconds(self, keep: Callable[[str], bool]) -> float:
        """Summed device seconds of the events whose base name `keep`
        takes."""
        return sum(e - s for n, s, e in self.device if keep(base_name(n)))

    def copy_seconds(self, direction: str) -> float:
        """Device seconds of memcpy events of a direction ("HtoD")."""
        return sum(e - s for n, s, e in self.device
                   if "memcpy" in n.lower() and direction.lower()
                   in n.lower())

    def breakdown(self, top: int = 10, attributed: int = 2000) -> dict:
        """The device operations that took most time, and the idle gaps in
        the window by the innermost host operation running at each gap's
        middle (the `attributed` longest gaps; the rest summed as
        "shorter gaps")."""
        ops: Dict[str, float] = {}
        for n, s, e in self.device:
            k = kernel_name(n)
            ops[k] = ops.get(k, 0.0) + (e - s)
        gaps = self._gaps()
        gaps.sort(key=lambda g: g[1] - g[0], reverse=True)
        by: Dict[str, float] = {}
        names, mids = self._innermost([(a + b) / 2 for a, b in
                                       gaps[:attributed]])
        for (a, b), i in zip(gaps[:attributed], mids):
            k = "no host op" if i < 0 else names[i]
            by[k] = by.get(k, 0.0) + (b - a)
        rest = sum(b - a for a, b in gaps[attributed:])
        if rest > 0:
            by["shorter gaps"] = by.get("shorter gaps", 0.0) + rest

        def first(d):
            return [[k, v] for k, v in sorted(d.items(),
                                              key=lambda kv: -kv[1])[:top]]
        return {"device_ops": first(ops), "idle_gaps": first(by)}

    def _gaps(self) -> List[Tuple[float, float]]:
        out, end = [], self.window[0]
        for s, e in sorted((s, e) for _, s, e in self.device):
            if s > end:
                out.append((end, s))
            end = max(end, e)
        if self.window[1] > end:
            out.append((end, self.window[1]))
        return out

    def _innermost(self, times: Sequence[float]):
        """For each time, the index into the host ops' names of the
        shortest host op (of at most MAX_HOST_S) running then, or -1."""
        import numpy as np
        host = sorted((h for h in self.host if h[2] - h[1] <= MAX_HOST_S),
                      key=lambda h: h[1])
        names = [h[0] for h in host]
        starts = np.array([h[1] for h in host], np.float64)
        ends = np.array([h[2] for h in host], np.float64)
        out = []
        for t in times:
            lo = int(np.searchsorted(starts, t - MAX_HOST_S, "left"))
            hi = int(np.searchsorted(starts, t, "right"))
            if hi <= lo:
                out.append(-1)
                continue
            ln = np.where(ends[lo:hi] >= t, ends[lo:hi] - starts[lo:hi],
                          np.inf)
            k = int(np.argmin(ln))
            out.append(lo + k if np.isfinite(ln[k]) else -1)
        return names, out


def from_profiler(prof) -> Trace:
    """A Trace of a finished torch.profiler.profile (CPU and CUDA
    activities) whose host span WINDOW marks the window; the raw events
    are read without building the profiler's event tree."""
    import torch
    cuda = torch.autograd.DeviceType.CUDA
    device, host, window = [], [], None
    for e in _raw_events(prof):
        name = e.name()
        start = _start_s(e)
        end = start + _duration_s(e)
        if name == WINDOW:
            # the marker's host span; its copy on the device timeline (a
            # user annotation over the kernels it encloses) is no work
            if e.device_type() != cuda:
                window = (start, end)
        elif e.device_type() == cuda:
            device.append((name, start, end))
        else:
            host.append((name, start, end))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW} span")
    return Trace(window, device, host)


def _raw_events(prof):
    res = getattr(prof.profiler, "kineto_results", None)
    if res is None:
        raise RuntimeError("the profiler kept no kineto results")
    return res.events()


def _start_s(e) -> float:
    if hasattr(e, "start_ns"):
        return e.start_ns() / 1e9
    return e.start_us() / 1e6


def _duration_s(e) -> float:
    if hasattr(e, "duration_ns"):
        return e.duration_ns() / 1e9
    return e.duration_us() / 1e6
