"""The benchmark of wavenet_tpu_torch, the PyTorch and CUDA port, on one H100.

    python -m portbench --workload full.train --seed 7 --seconds 30 --trace 0

Everything a cell needs is found by name: the cell in BENCHMARK.json and
workloads/<cell>.json, its configuration in configs/<config>.json, its
traffic mix in traffic/<mix>.json with the driver that mix names in
traffic/<driver>.py, and each per-layer metric's reader in
metrics/<metric>.py.  The yardstick (weights, corpus, traffic, the
reduction of the device trace, the operation and byte counts, the peaks and
the plain reference that decides `correct`) lives here; from the port the
harness takes only the system under test and its counters and kernel names.
"""
