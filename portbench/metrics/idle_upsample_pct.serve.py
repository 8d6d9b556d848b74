"""idle_upsample_pct.serve: the share of the traced window in which no
operation ran on the device while the lane that served the window's
requests (spans.serving_lane) was inside the program's "serve.upsample"
span: a mel group's per-row upsampling of its requests' frames, before its
decode.  What batching the upsampler across a group's rows would recover.
A program without that span reads None."""

from portbench import spans


def read(run):
    lane = spans.serving_lane(run)
    return spans.idle_pct_inside(
        run, lambda name, nums: name == "serve.upsample"
        and nums.get("lane") == lane)
