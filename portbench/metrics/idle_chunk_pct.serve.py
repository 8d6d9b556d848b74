"""idle_chunk_pct.serve: the share of the traced window in which no
operation ran on the device while the batchable lane (lane 0) was inside
the program's "serve.group" span: a group's set-up, its launches, the
fetch and hand-out of each chunk, and the hand-off of its end."""

from portbench import spans


def read(run):
    return spans.idle_pct_inside(
        run, lambda name, nums: name == "serve.group"
        and nums.get("lane") == 0)
