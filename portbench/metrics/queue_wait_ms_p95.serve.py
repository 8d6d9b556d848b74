"""queue_wait_ms_p95.serve: the nearest-rank 95th percentile, over every
request submitted in the traced window, of the program's "serve.queue_wait"
interval: submit to the start of the group that takes it (the engine's
inbox and its grouping by length bucket)."""

from portbench import spans, stats


def read(run):
    recs = spans.window_records(run)
    if recs is None:
        return None
    a, b = run.trace.window
    waits = [e - s for name, s, e, *_ in recs
             if name == "serve.queue_wait" and a <= s <= b]
    if not waits:
        return None
    return 1e3 * stats.nearest_rank(waits, 95)
