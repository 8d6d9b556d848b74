"""mfu.serve: the forward operations of the samples delivered to clients in
the window (real rows only, a launch straddling the close pro rata, as
served_audio_s_per_s counts them; roofline.forward_flops_per_token each)
over the window's seconds, as a share of the configuration dtype's
published peak."""

from portbench import roofline


def read(run):
    n = run.counters.get("samples_in_window")
    if not n or run.trace is None or run.device == "cpu":
        return None
    peak = roofline.peak_flops(run.cell.config["model"]["compute_dtype"])
    flops = roofline.forward_flops_per_token(run.sizes) * n
    return 100.0 * flops / run.trace.window_s / peak
