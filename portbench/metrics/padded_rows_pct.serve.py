"""padded_rows_pct.serve: the engine's padded rows (WaveNetServer.stats
"padded_rows") over every row of the microbatches that started in the
window (the batch of each WaveNet.stream call the engine made)."""


def read(run):
    t0, t1 = run.counters.get("window", (None, None))
    groups = run.counters.get("groups")
    if not groups or t0 is None:
        return None
    rows = sum(B for t, B in groups if t0 <= t <= t1)
    if rows == 0:
        return None
    return 100.0 * run.counters["padded_rows"] / rows
