"""idle_collect_pct.serve: the share of the traced window in which no
operation ran on the device while the lane that served the window's
requests (spans.serving_lane: lane 0 for unconditioned requests, lane 1 for
mel ones) was inside the program's "serve.collect" span: waiting on an
empty inbox, then gathering a group for max_wait_ms."""

from portbench import spans


def read(run):
    lane = spans.serving_lane(run)
    return spans.idle_pct_inside(
        run, lambda name, nums: name == "serve.collect"
        and nums.get("lane") == lane)
