"""idle_chunk_pct.serve: the share of the traced window in which no
operation ran on the device while the lane that served the window's
requests (spans.serving_lane) was inside the program's "serve.group"
span: a group's set-up, its launches, the fetch and hand-out of each chunk,
and the hand-off of its end."""

from portbench import spans


def read(run):
    lane = spans.serving_lane(run)
    return spans.idle_pct_inside(
        run, lambda name, nums: name == "serve.group"
        and nums.get("lane") == lane)
