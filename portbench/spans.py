"""The port's own spans (wavenet_tpu_torch.utils.profiling.records), read
beside the device trace of a traced run.

The program stamps its records with time.time_ns(), the clock of the
profiler's host and device events, so they clip to the trace's window as
they are.  A program that keeps no records (one older than its recorder)
reads None; so does a run whose recorder was full and whose oldest kept
record starts after the window's start, since records of the window were
dropped.
"""

from __future__ import annotations

from typing import Callable, List, Optional, Sequence, Tuple

from portbench import layers

Span = Tuple[float, float]


def window_records(run) -> Optional[list]:
    """(name, start s, end s, id, parent, numbers) of every record that
    overlaps the traced window (unclipped), or None."""
    tr = run.trace
    if tr is None:
        return None
    try:
        from wavenet_tpu_torch.utils.profiling import CAPACITY, records
    except ImportError:
        return None
    recs = records()
    a, b = tr.window
    if not recs or (len(recs) >= CAPACITY and recs[0][1] / 1e9 > a):
        return None
    out = []
    for name, s, e, i, p, nums in recs:
        s, e = s / 1e9, e / 1e9
        if e > a and s < b:
            out.append((name, s, e, i, p, nums))
    return out


def merged(spans: Sequence[Span]) -> List[Span]:
    """The union of [start, end) spans as sorted disjoint spans."""
    out: List[Span] = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            if b > out[-1][1]:
                out[-1] = (out[-1][0], b)
        elif b > a:
            out.append((a, b))
    return out


def overlap_s(xs: Sequence[Span], ys: Sequence[Span]) -> float:
    """Length of the intersection of two unions of spans."""
    xs, ys = merged(xs), merged(ys)
    total, i, j = 0.0, 0, 0
    while i < len(xs) and j < len(ys):
        lo = max(xs[i][0], ys[j][0])
        hi = min(xs[i][1], ys[j][1])
        if hi > lo:
            total += hi - lo
        if xs[i][1] < ys[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_pct_inside(run, keep: Callable[[str, dict], bool]):
    """100 x the window's time with no device interval while a record that
    keep(name, numbers) takes runs, over the window; None on the CPU, with
    no device interval or no such record."""
    if layers.idle_pct(run) is None:
        return None
    recs = window_records(run)
    if recs is None:
        return None
    a, b = run.trace.window
    inside = [(max(s, a), min(e, b)) for name, s, e, _, _, nums in recs
              if keep(name, nums)]
    if not inside:
        return None
    return 100.0 * overlap_s(run.trace._gaps(), inside) / run.trace.window_s


def serving_lane(run):
    """The server lane whose "serve.group" records in the traced window
    served the most real rows (lane 0 takes unconditioned requests, lane 1
    mel and primed ones), or None with no such record."""
    recs = window_records(run)
    rows: dict = {}
    for name, _, _, _, _, nums in recs or ():
        if name == "serve.group":
            lane = nums.get("lane")
            rows[lane] = rows.get(lane, 0) + nums.get("real", 0)
    return max(rows, key=rows.get) if rows else None
