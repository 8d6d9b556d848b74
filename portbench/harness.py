"""One run of one cell: the files found by name, the window, the trace, the
check and the result line.

A driver (traffic/<driver>.py) gets a `Run`.  It builds the system under
test from the run's seed, marks the measured window with `run.window()`
inside `run.tracing()`, reads the program's outputs, frees the program's
state after `run.after_window()`, and hands them to the reference through
`run.check`.  The harness turns what the driver recorded into the metrics
that BENCHMARK.json lists for the cell.
"""

from __future__ import annotations

import contextlib
import dataclasses
import gc
import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

from portbench import sizes as sizes_lib
from portbench import trace as trace_lib

HERE = Path(__file__).resolve().parent
CHECKOUT = HERE.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "wavenet_tpu")


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _module(path: Path, name: str) -> ModuleType:
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    workload: dict            # workloads/<cell>.json
    config: dict              # configs/<config>.json
    sizes: sizes_lib.Sizes
    mix: dict                 # traffic/<mix>.json
    driver: ModuleType        # traffic/<mix["driver"]>.py
    end_to_end: List[dict]    # BENCHMARK.json metrics this cell reports
    per_layer: List[dict]


def _reported(metrics: List[dict], cell: str) -> List[dict]:
    return [m for m in metrics if cell in m.get("workloads", [cell])]


def load_cell(name: str, checkout: Path = CHECKOUT,
              overrides: Optional[dict] = None) -> Cell:
    """The cell `name` of checkout/BENCHMARK.json and its files.  overrides
    replaces parts of the loaded files ({"config": {...model fields},
    "mix": {...}, "workload": {...}}), for tests at small sizes."""
    bench = _json(checkout / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    wl = _json(HERE / "workloads" / f"{name}.json")
    for k in ("config", "traffic", "chips"):
        if wl.get(k) != entry[k]:
            raise ValueError(f"workloads/{name}.json: {k} {wl.get(k)!r} "
                             f"differs from BENCHMARK.json's {entry[k]!r}")
    cfg = sizes_lib.load_config(HERE / "configs" / f"{entry['config']}.json")
    mix = _json(HERE / "traffic" / f"{entry['traffic']}.json")
    ov = overrides or {}
    if "config" in ov:
        cfg = dict(cfg, model=dict(cfg["model"], **ov["config"]))
    mix = dict(mix, **ov.get("mix", {}))
    wl = dict(wl, **ov.get("workload", {}))
    driver = _module(HERE / "traffic" / f"{mix['driver']}.py",
                     f"portbench.traffic.{mix['driver']}")
    return Cell(name=name, chips=int(entry["chips"]), workload=wl,
                config=cfg, sizes=sizes_lib.Sizes.from_model(cfg["model"]),
                mix=mix, driver=driver,
                end_to_end=_reported(bench["end_to_end"], name),
                per_layer=_reported(bench["per_layer"], name))


class Run:
    """One run of a cell: its inputs, and what the driver records."""

    def __init__(self, cell: Cell, seed: int, seconds: float, trace: bool,
                 device: str, t_start: float):
        self.cell, self.seed, self.seconds = cell, int(seed), float(seconds)
        self.traced, self.device, self.t_start = trace, device, t_start
        self.setup_s: Optional[float] = None
        self.window_s: Optional[float] = None
        self.trace: Optional[trace_lib.Trace] = None
        self.memory_peak_bytes = 0
        self.e2e: Dict[str, float] = {}
        self.counters: Dict[str, object] = {}
        self.checks: Dict[str, dict] = {}
        self.faults: List[str] = []
        self.attempted = 0
        self.failed = 0

    @property
    def sizes(self) -> sizes_lib.Sizes:
        return self.cell.sizes

    def program_config(self):
        """The port's WaveNetConfig of the configuration file, seeded by
        the run's seed (the corpus's draw and the iterator's)."""
        from wavenet_tpu_torch.config import WaveNetConfig
        model = dict(self.cell.config["model"],
                     seed=self.seed % (1 << 62))
        return WaveNetConfig.from_json(json.dumps(model))

    def weights(self):
        """The run's flat weights (weights.make), as the reference takes
        them."""
        from portbench import weights
        return weights.make(self.sizes, self.seed % (1 << 62), self.device,
                            self.cell.config["model"]["param_dtype"])

    def program_weights(self) -> dict:
        """The run's weights in the layout the port's WaveNet facade and
        Trainer take (weights.nested)."""
        from portbench import weights
        return weights.nested(self.weights())

    @contextlib.contextmanager
    def tracing(self):
        """torch.profiler (host and device) around the block when the run
        is traced; the window inside it is reduced into self.trace."""
        if not self.traced:
            yield
            return
        from torch.profiler import ProfilerActivity, profile
        acts = [ProfilerActivity.CPU]
        if self.device != "cpu":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            yield
            self._sync()
        self.trace = trace_lib.from_profiler(prof)
        del prof
        gc.collect()

    @contextlib.contextmanager
    def window(self):
        """The measured window: set-up ends where it starts; its wall time
        is self.window_s.  The block ends its own work (the drivers
        synchronise the device before they leave it)."""
        import torch
        t0 = time.monotonic()
        self.setup_s = t0 - self.t_start
        ctx = (torch.profiler.record_function(trace_lib.WINDOW)
               if self.traced else contextlib.nullcontext())
        with ctx:
            yield t0
            self.window_s = time.monotonic() - t0

    def after_window(self) -> None:
        """Read the device's memory peak: after the window and before the
        reference, whose own peak must not count."""
        self._sync()
        if self.device != "cpu":
            import torch
            self.memory_peak_bytes = int(torch.cuda.max_memory_allocated())

    def free(self) -> None:
        gc.collect()
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    def _sync(self) -> None:
        if self.device != "cpu":
            import torch
            torch.cuda.synchronize()

    def check(self, name: str, value: float, limit: float) -> None:
        """Record a compared number beside its limit (value <= limit)."""
        self.checks[name] = {"value": float(value), "limit": float(limit)}

    def fault(self, what: str) -> None:
        """Record a fault that makes the run not correct by itself."""
        self.faults.append(what)

    @property
    def correct(self) -> bool:
        return (not self.faults and self.failed == 0 and bool(self.checks)
                and all(c["value"] <= c["limit"]
                        for c in self.checks.values()))


def _reader(metric: str) -> ModuleType:
    return _module(HERE / "metrics" / f"{metric}.py",
                   "portbench.metrics." + metric.replace(".", "_"))


def forbidden_modules() -> List[str]:
    """Top-level names in sys.modules that the port's process may not
    hold (whole names: wavenet_tpu_torch is not wavenet_tpu)."""
    top = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(top.intersection(FORBIDDEN))


def power_limit_w() -> Optional[float]:
    """The card's power limit from nvidia-smi, or None."""
    try:
        r = subprocess.run(["nvidia-smi", "--query-gpu=power.limit",
                            "--format=csv,noheader,nounits"],
                           capture_output=True, text=True, timeout=20)
        return float(r.stdout.split()[0])
    except (OSError, subprocess.TimeoutExpired, ValueError, IndexError):
        return None


def execute(cell: Cell, seed: int, seconds: float, trace: bool,
            device: str, t_start: float) -> Run:
    run = Run(cell, seed, seconds, trace, device, t_start)
    cell.driver.run(run)
    return run


def result(run: Run) -> dict:
    """The result line's object; "checks", the numbers compared and their
    limits, comes last."""
    from portbench import roofline
    cell = run.cell
    metrics = {}
    if not run.traced:
        values = dict(run.e2e, setup_s=run.setup_s)
        for m in cell.end_to_end:
            metrics[m["name"]] = {"value": float(values[m["name"]]),
                                  "unit": m["unit"]}
    else:
        for m in cell.per_layer:
            v = _reader(m["name"]).read(run)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    out = {"correct": run.correct, "attempted": int(run.attempted),
           "failed": int(run.failed), "metrics": metrics,
           "device": device_info(run)}
    if run.traced and run.trace is not None:
        out["breakdown"] = run.trace.breakdown()
    out["peaks"] = {"flops_per_s": roofline.peak_flops(
        cell.config["model"]["compute_dtype"]),
        "bytes_per_s": roofline.PEAK_BYTES_PER_S}
    if run.faults:
        out["faults"] = run.faults
    out["checks"] = run.checks
    return out


def device_info(run: Run) -> dict:
    if run.device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": 0}
    else:
        import torch
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": run.cell.chips,
                "memory_peak_bytes": run.memory_peak_bytes,
                "power_limit_w": power_limit_w()}
    if run.traced and run.trace is not None:
        info["busy_s"] = run.trace.busy_s
        info["window_s"] = run.trace.window_s
    return info


def check_lines(res: dict) -> List[str]:
    return [f"check {k} {v['value']!r} limit {v['limit']!r} "
            f"{'ok' if v['value'] <= v['limit'] else 'FAIL'}"
            for k, v in res["checks"].items()]
