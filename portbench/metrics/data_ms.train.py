"""data_ms.train: host ms a step in the data pipeline, AudioDataset.
sample_batch (the native gatherer inside it), plus the device ms of the
host-to-device copies, over the traced window's steps."""


def read(run):
    steps = run.counters.get("steps")
    host = run.counters.get("data_host_s")
    if not steps or host is None or run.trace is None:
        return None
    return 1e3 * (host + run.trace.copy_seconds("HtoD")) / steps
