"""mfu.train: the training steps' useful operations (forward and backward
as three forwards, roofline.train_flops_per_step) over the traced window's
seconds, as a share of the configuration dtype's published peak."""

from portbench import roofline


def read(run):
    steps = run.counters.get("steps")
    if not steps or run.trace is None or run.device == "cpu":
        return None
    flops = roofline.train_flops_per_step(run.sizes) * steps
    peak = roofline.peak_flops(run.cell.config["model"]["compute_dtype"])
    return 100.0 * flops / run.trace.window_s / peak
