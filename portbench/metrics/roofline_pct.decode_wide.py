"""roofline_pct.decode_wide: the least time of the decode launches in the
window (roofline.decode_*, every launched row) over the device seconds of
the wide decode kernel (decode_wide_kernel<*>)."""

from portbench import layers


def read(run):
    return layers.decode_roofline_pct(run, "decode_wide_kernel")
