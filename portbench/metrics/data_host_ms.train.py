"""data_host_ms.train: host ms a step inside the program's "train.sample"
(AudioDataset.sample_batch) and "train.h2d" (the batch's copy to the
device) spans, clipped to the traced window, over the window's steps."""

from portbench import spans


def read(run):
    steps = run.counters.get("steps")
    recs = spans.window_records(run)
    if not steps or recs is None:
        return None
    a, b = run.trace.window
    host = [min(e, b) - max(s, a) for name, s, e, *_ in recs
            if name in ("train.sample", "train.h2d")]
    if not host:
        return None
    return 1e3 * sum(host) / steps
