"""Where a step of the wide decode kernel goes: the kernel timed with one
part of its work taken out at a time.

    python -m wavenet_tpu_torch.utils.decode_phases [--steps 256]

On the card, builds csrc/decode_wide.cu as it is and in variants, each
built with one part of a layer's work taken out by a -D flag that the
kernel reads (WN_PHASE_NO_...; the variants' tokens are wrong by design;
each keeps the exchange's protocol, so none can wait forever), and times
them at the `full` preset's widths, B = 4, with 16 CTAs per cluster: one
row per cluster by either exchange (all-reduce, scatter), then all four
rows in one by the scatter, in turns (two rounds).  Prints one JSON line per variant and plan, then the
card: a variant's time below the kernel's is what that part costs the
step.

Variants: `no_exchange` (no partial sums or x slices sent, no wait for
them), `no_z` (the z phase's products), `no_skip_res` (the skip and
residual products), `no_copies` (the staging of later layers),
`skeleton` (all of them: what remains is barriers, epilogues, the head
and the loop).
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys

import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops.cuda import build
from wavenet_tpu_torch.ops.cuda import decode_wide as pw

# the macro that takes each part out (csrc/decode_wide.cu)
PARTS = {"no_exchange": "WN_PHASE_NO_EXCHANGE", "no_z": "WN_PHASE_NO_Z",
         "no_skip_res": "WN_PHASE_NO_SKIP_RES",
         "no_copies": "WN_PHASE_NO_COPIES"}
# (CTAs, rows) per cluster, scatter exchange
PLANS = ((16, 1, False), (16, 1, True), (16, 4, True))


def variants() -> dict:
    """{name: the -D flags of its build}: the kernel, each part taken out
    alone, and all of them (the skeleton)."""
    out = {"kernel": []}
    for name, macro in PARTS.items():
        out[name] = ["-D" + macro]
    out["skeleton"] = ["-D" + m for m in PARTS.values()]
    return out


def build_all(flags: dict) -> dict:
    """One library per variant under the build directory (one nvcc each,
    all started together)."""
    libs, procs = {}, {}
    src = build.CSRC / "decode_wide.cu"
    for name, extra in flags.items():
        d = build.BUILD_DIR / "decode_phases"
        d.mkdir(parents=True, exist_ok=True)
        out = d / f"{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *extra, "-o", str(out),
               str(src)]
        procs[name] = (out, subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                             text=True))
    for name, (out, proc) in procs.items():
        err = proc.communicate(timeout=600)[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(out))
        pw._bind(libs[name])
    return libs


def time_step(lib, w, cfg, rings, carry, seeds, steps: int,
              plan) -> float:
    """ms per decode step of one launch of `steps` steps (CUDA events)."""
    pw.library = lambda: lib
    kw = {"cluster": plan[0], "rows_per_cluster": plan[1],
          "scatter": plan[2]}

    def run():
        pw.decode_chunk(w, cfg, rings, carry, 0, seeds, steps, 1.0, **kw)
    run()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    run()
    e1.record()
    torch.cuda.synchronize()
    return e0.elapsed_time(e1) / steps


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--steps", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_phases: needs a CUDA device", file=sys.stderr)
        return 1
    flags = variants()
    libs = build_all(flags)
    dev = torch.device("cuda")
    cfg = tconfig.full()
    w = pw.flatten_params(wn.init_params(cfg, torch.Generator()
                                         .manual_seed(0), dev), cfg)
    rings, carry, seeds, _, _, _ = pw.setup_decode(
        cfg, 4, args.steps, seeds=[1, 8, 15, 22], device=dev)
    card = torch.cuda.get_device_name(0)
    library = pw.library
    times = {(n, p): [] for n in flags for p in PLANS}
    try:
        for _ in range(2):
            for name in flags:
                for plan in PLANS:
                    times[(name, plan)].append(time_step(
                        libs[name], w, cfg, rings, carry, seeds, args.steps,
                        plan))
    finally:
        pw.library = library
    for (name, plan), ms in times.items():
        print(json.dumps({"variant": name, "cluster": plan[0],
                          "rows_per_cluster": plan[1], "scatter": plan[2],
                          "batch": 4,
                          "ms_per_step": ms, "card": card}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
