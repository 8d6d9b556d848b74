"""idle_pct.train: the share of the traced training window in which no
operation ran on the device (1 - union of device intervals / window)."""

from portbench import layers


def read(run):
    return layers.idle_pct(run)
