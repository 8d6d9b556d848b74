"""Where a step of a decode kernel goes: the kernel timed with one part of
its work taken out at a time.

    python -m wavenet_tpu_torch.utils.decode_phases [--kernel wide|narrow]
        [--steps 256]

On the card, builds the kernel's source as it is and in variants, each
built with one part of a layer's work taken out by a -D flag that the
kernel reads (WN_PHASE_NO_...; the variants' tokens are wrong by design;
each keeps the kernel's protocol, so none can wait forever), and times
them in turns (two rounds).  Prints one JSON line per variant and plan,
then the card: a variant's time below the kernel's is what that part
costs the step.

`--kernel wide` (csrc/decode_wide.cu) at the `full` preset's widths,
B = 4, with 16 CTAs per cluster: one row per cluster by either exchange
(all-reduce, scatter), then all four rows in one by the scatter.
Variants: `no_exchange` (no partial sums or x slices sent, no wait for
them), `no_z` (the z phase's products), `no_skip_res` (the skip and
residual products), `no_copies` (the staging of later layers),
`skeleton` (all of them: what remains is barriers, epilogues, the head
and the loop).

`--kernel narrow` (csrc/decode.cu) at the `fastgen_bench` preset's
widths, B = 64, at the default rows per block.  Variants: `no_ring` (the
ring read of `old` and the write of x), `no_z`, `no_skip_res`,
`no_epilogue_loads` (the biases and speaker offsets the epilogues add),
`skeleton` (all of them); and `no_copies` (no staging of the next
layer), timed beside them.
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
from wavenet_tpu_torch.ops.cuda import decode as pn
from wavenet_tpu_torch.ops.cuda import decode_wide as pw
from wavenet_tpu_torch.utils import compcache

# the macro that takes each part out, by kernel
PARTS = {"no_exchange": "WN_PHASE_NO_EXCHANGE", "no_z": "WN_PHASE_NO_Z",
         "no_skip_res": "WN_PHASE_NO_SKIP_RES",
         "no_copies": "WN_PHASE_NO_COPIES"}
NARROW_PARTS = {"no_ring": "WN_PHASE_NO_RING", "no_z": "WN_PHASE_NO_Z",
                "no_skip_res": "WN_PHASE_NO_SKIP_RES",
                "no_epilogue_loads": "WN_PHASE_NO_EPILOGUE_LOADS"}
# the narrow kernel's other build, timed beside the parts: the staging
# copies left out
NARROW_ALTERNATIVES = {"no_copies": ["-DWN_PHASE_NO_COPIES"]}
# wide: (CTAs, rows) per cluster, scatter exchange; narrow: rows per
# block (None: the default, tile_rows' choice)
PLANS = ((16, 1, False), (16, 1, True), (16, 4, True))
NARROW_PLANS = (None,)
# (source, module, preset, batch) by kernel
KERNELS = {"wide": ("decode_wide.cu", pw, tconfig.full, 4),
           "narrow": ("decode.cu", pn, tconfig.fastgen_bench, 64)}


def parts(kernel: str = "wide") -> dict:
    return PARTS if kernel == "wide" else NARROW_PARTS


def variants(kernel: str = "wide") -> dict:
    """{name: the -D flags of its build}: the kernel, each part taken out
    alone, and all of them (the skeleton); for the narrow kernel also its
    alternatives."""
    out = {"kernel": []}
    for name, macro in parts(kernel).items():
        out[name] = ["-D" + macro]
    out["skeleton"] = ["-D" + m for m in parts(kernel).values()]
    if kernel == "narrow":
        out.update(NARROW_ALTERNATIVES)
    return out


def build_all(flags: dict, kernel: str = "wide") -> dict:
    """One library per variant under the build directory (one nvcc each,
    all started together)."""
    source, mod, _, _ = KERNELS[kernel]
    libs, procs = {}, {}
    d = compcache.build_dir() / "decode_phases" / kernel
    d.mkdir(parents=True, exist_ok=True)
    for name, extra in flags.items():
        out = d / f"{name}.so"
        cmd = [build.nvcc_path(), *build.NVCC_FLAGS, *extra, "-o", str(out),
               str(build.CSRC / source)]
        procs[name] = (out, subprocess.Popen(cmd, stderr=subprocess.PIPE,
                                             text=True))
    for name, (out, proc) in procs.items():
        err = proc.communicate(timeout=600)[1]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed building {name}:\n{err}")
        libs[name] = ctypes.CDLL(str(out))
        mod._bind(libs[name])
    return libs


def plan_kwargs(kernel: str, plan) -> dict:
    if kernel == "wide":
        return {"cluster": plan[0], "rows_per_cluster": plan[1],
                "scatter": plan[2]}
    return {"rows_per_block": plan}


def time_step(mod, lib, w, cfg, rings, carry, seeds, steps: int,
              kw: dict) -> float:
    """ms per decode step of one launch of `steps` steps (CUDA events)."""
    mod.library = lambda: lib

    def run():
        mod.decode_chunk(w, cfg, rings, carry, 0, seeds, steps, 1.0, **kw)
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
    ap.add_argument("--kernel", choices=sorted(KERNELS), default="wide")
    ap.add_argument("--steps", type=int, default=256)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_phases: needs a CUDA device", file=sys.stderr)
        return 1
    kernel = args.kernel
    _, mod, preset, batch = KERNELS[kernel]
    plans = PLANS if kernel == "wide" else NARROW_PLANS
    flags = variants(kernel)
    libs = build_all(flags, kernel)
    dev = torch.device("cuda")
    cfg = preset()
    w = mod.flatten_params(wn.init_params(cfg, torch.Generator()
                                          .manual_seed(0), dev), cfg)
    rings, carry, seeds, _, _, _ = mod.setup_decode(
        cfg, batch, args.steps, seeds=list(range(1, 1 + batch)), device=dev)
    card = torch.cuda.get_device_name(0)
    library = mod.library
    times = {(n, p): [] for n in flags for p in plans}
    try:
        for _ in range(2):
            for name in flags:
                for plan in plans:
                    times[(name, plan)].append(time_step(
                        mod, libs[name], w, cfg, rings, carry, seeds,
                        args.steps, plan_kwargs(kernel, plan)))
    finally:
        mod.library = library
    for (name, plan), ms in times.items():
        print(json.dumps({"kernel": kernel, "variant": name,
                          **plan_kwargs(kernel, plan), "batch": batch,
                          "ms_per_step": ms, "card": card}))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
