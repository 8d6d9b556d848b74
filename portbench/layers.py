"""Arithmetic that several per-layer readers share."""

from __future__ import annotations

from portbench import roofline


def idle_pct(run):
    """100 (1 - busy / window) of the traced window; None untraced or
    with no device operation in it."""
    tr = run.trace
    if tr is None or run.device == "cpu" or not tr.device:
        return None
    return 100.0 * (1.0 - tr.busy_s / tr.window_s)


def decode_roofline_pct(run, kernel: str):
    """The decode launches' least time in the window over the device
    seconds of `kernel`.  A launch (start, end, rows, steps) straddling
    the window counts by the share of its span inside it, as its kernel's
    interval is clipped to the window."""
    t0, t1 = run.counters.get("window", (None, None))
    log = run.counters.get("launches")
    if run.trace is None or not log or t0 is None:
        return None
    secs = run.trace.seconds(lambda n: n == kernel)
    if secs <= 0:
        return None
    launches = rows = row_steps = 0.0
    for a, b, B, n, *_ in log:
        span = b - a
        share = (max(0.0, min(b, t1) - max(a, t0)) / span if span > 0
                 else float(t0 <= a <= t1))
        launches += share
        rows += share * B
        row_steps += share * B * n
    z, dt = run.sizes, run.cell.config["model"]["compute_dtype"]
    least = roofline.least_seconds(
        roofline.decode_flops(z, row_steps),
        roofline.decode_bytes(z, launches, rows, row_steps), dt)
    return 100.0 * least / secs
