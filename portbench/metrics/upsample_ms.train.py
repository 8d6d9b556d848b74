"""upsample_ms.train: device ms a step of a mel model's upsampler, its
forward and its backward: the sum of "device_ms" of the program's
"train.upsample" records in the traced window (the time between CUDA
events the program records on the training stream around the upsampler's
launches) over the window's steps.  None on the CPU (no device_ms) and for
a program without that span."""

from portbench import spans


def read(run):
    steps = run.counters.get("steps")
    recs = spans.window_records(run)
    if not steps or recs is None:
        return None
    ms = [nums["device_ms"] for name, _, _, _, _, nums in recs
          if name == "train.upsample" and "device_ms" in nums]
    if not ms:
        return None
    return sum(ms) / steps
