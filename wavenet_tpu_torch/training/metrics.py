"""Metrics: a JSONL metrics writer and a throughput meter (pure Python;
Trainer.run reports the meter's rates).

A copy of wavenet_tpu/training/metrics.py, with one change: values are
written unrounded (a Python float's JSON form reads back to the same
float), so two runs, e.g. an uninterrupted one and a resumed one, can be
compared bit for bit from their metrics files.
"""

from __future__ import annotations

import json
import os
import time
from typing import Dict, Optional


class MetricsLogger:
    """Append-only JSONL metrics writer with wall-clock stamps."""

    def __init__(self, path: Optional[str] = None, also_print: bool = True):
        self.path = path
        self.also_print = also_print
        self._f = None
        if path:
            os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
            self._f = open(path, "a", buffering=1)
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, float]) -> None:
        rec = {"step": step, "time": round(time.time() - self._t0, 3)}
        rec.update({k: (float(v) if isinstance(v, (int, float)) else v)
                    for k, v in metrics.items()})
        if self._f:
            self._f.write(json.dumps(rec) + "\n")
        if self.also_print:
            print(" ".join(f"{k}={v}" for k, v in rec.items()), flush=True)

    def close(self):
        if self._f:
            self._f.close()
            self._f = None

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


class ThroughputMeter:
    """Rolling audio-seconds/s and samples/s, first (warm-up) step excluded.
    Callers synchronise the device before tick()."""

    def __init__(self, audio_seconds_per_batch: float, samples_per_batch: int):
        self.aspb = audio_seconds_per_batch
        self.spb = samples_per_batch
        self.t0 = None
        self.n = 0

    def tick(self):
        if self.t0 is None:
            self.t0 = time.perf_counter()
        else:
            self.n += 1

    def rates(self) -> Dict[str, float]:
        if not self.n:
            return {}
        dt = time.perf_counter() - self.t0
        return {"steps_per_sec": self.n / dt,
                "audio_seconds_per_sec": self.n * self.aspb / dt,
                "samples_per_sec": self.n * self.spb / dt}
