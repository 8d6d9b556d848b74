"""roofline_pct.decode_narrow: the least time of the decode launches in
the window (roofline.decode_*, every launched row) over the device seconds
of the narrow decode kernel (decode_kernel<*>)."""

from portbench import layers


def read(run):
    return layers.decode_roofline_pct(run, "decode_kernel")
