"""idle_pct.serve: the share of the traced serving window in which no
operation ran on the device (1 - union of device intervals / window)."""

from portbench import layers


def read(run):
    return layers.idle_pct(run)
