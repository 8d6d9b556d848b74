"""idle_launch_pct.train: the share of the traced window in which no
operation ran on the device while the trainer was inside the program's
"train.forward", "train.backward" or "train.optimizer" span: the host's
launch gaps inside a step."""

from portbench import spans

PHASES = ("train.forward", "train.backward", "train.optimizer")


def read(run):
    return spans.idle_pct_inside(run, lambda name, nums: name in PHASES)
