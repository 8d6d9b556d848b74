"""roofline_pct.stack_bwd: the least time of the layer stack's backward
(roofline.stack_bwd_*) over the device seconds of its kernels
(bwd_layer_kernel<*>, shift_add_kernel, wgrad_kernel<*>,
reduce_splits_kernel, colsum_kernel), in the traced window's steps."""

from portbench import roofline

KERNELS = ("bwd_layer_kernel", "shift_add_kernel", "wgrad_kernel",
           "reduce_splits_kernel", "colsum_kernel")


def read(run):
    steps = run.counters.get("steps")
    if not steps or run.trace is None:
        return None
    secs = run.trace.seconds(lambda n: n in KERNELS)
    if secs <= 0:
        return None
    z, dt = run.sizes, run.cell.config["model"]["compute_dtype"]
    least = roofline.least_seconds(roofline.stack_bwd_flops(z),
                                   roofline.stack_bwd_bytes(z), dt)
    return 100.0 * least * steps / secs
