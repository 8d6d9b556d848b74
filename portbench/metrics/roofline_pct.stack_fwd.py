"""roofline_pct.stack_fwd: the least time of the layer stack's forward
(roofline.stack_fwd_*) over the device seconds of its kernels
(init_carry_kernel, fwd_layer_kernel<*>), in the traced window's steps."""

from portbench import roofline

KERNELS = ("fwd_layer_kernel", "init_carry_kernel")


def read(run):
    steps = run.counters.get("steps")
    if not steps or run.trace is None:
        return None
    secs = run.trace.seconds(lambda n: n in KERNELS)
    if secs <= 0:
        return None
    z, dt = run.sizes, run.cell.config["model"]["compute_dtype"]
    least = roofline.least_seconds(roofline.stack_fwd_flops(z),
                                   roofline.stack_fwd_bytes(z), dt)
    return 100.0 * least * steps / secs
