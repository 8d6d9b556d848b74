"""Readings that the correctness limits are set from (not run by the
benchmark's own runs).

    python -m portbench.calibrate --workload full.train --seeds 12 \
        --control 3 [--seconds 10] [--first-seed N]

For every seed, the program's reading of each compared number (the cell's
own set-up and checked steps for a training cell; a closed-loop window of
--seconds and the judged sample for a serving cell).  On the first
--control seeds also the control's reading: the reference in fp8 put in the
program's place (a training cell's steps; a serving cell's tokens that fp8
puts first at each served position) and, for a training cell, the fault of
half the batch left out, planted in the reference.  A state left unchanged
reads 1 by the measure and needs no run.  Prints one JSON line per seed and
one summary line: the program's largest reading and the control's and the
fault's smallest, per number.

    python -m portbench.calibrate --workload full.train --seeds 3 --look

The look at which leaf sets grad_err, and why (a training cell): per seed
and leaf, the first gradient's grad_err of the program against the float32
reference, of two witnesses against it (the reference in float64, which
shows the float32 reference's own rounding, and the reference in the
configuration's bfloat16 compute, which shows what that rounding does to
each leaf), and of the program against the bfloat16 witness.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def _train_seed(run, control: bool) -> dict:
    from portbench.reference import train as ref_train
    drv = run.cell.driver
    checked = int(run.cell.workload["checked_steps"])
    tr, ds, prog = drv.program_readings(run, checked)
    del tr, ds
    run.free()
    ref = drv.reference_readings(run, checked)
    out = {"program": ref_train.gaps(prog, ref),
           "leaves": ref_train.leaf_gaps(prog, ref),
           "ref_grad_norms": ref["grad_norms"]}
    if control:
        out["control"] = ref_train.gaps(
            drv.reference_readings(run, checked, precision="fp8"), ref)
        out["half_batch"] = ref_train.gaps(
            drv.reference_readings(run, checked, half=True), ref)
    return out


def _look_seed(run) -> dict:
    from portbench.reference import train as ref_train
    drv = run.cell.driver
    tr, ds, prog = drv.program_readings(run, 1)
    del tr, ds
    run.free()
    ref = drv.reference_readings(run, 1)
    f64 = drv.reference_readings(run, 1, precision="float64")
    bf16 = drv.reference_readings(run, 1, precision="bfloat16")
    out = {"program": ref_train.leaf_errs(prog, ref),
           "float64_witness": ref_train.leaf_errs(ref, f64),
           "bfloat16_witness": ref_train.leaf_errs(bf16, ref),
           "program_vs_bfloat16": ref_train.leaf_errs(prog, bf16)}
    out["worst"] = {k: max(v, key=v.get) for k, v in out.items()}
    out["ref_grad_norms"] = ref["grad_norms"]
    return out


def _serve_seed(run, control: bool) -> dict:
    from portbench.reference import model, serve as ref_serve
    drv, wl = run.cell.driver, run.cell.workload
    loop = drv.serve(run)
    done = [r for r in loop.requests if r.error is None and r.done]
    toks, seeds, cond = drv.sample_tokens(run, done, wl)
    del loop
    run.free()
    model.no_tf32()
    w = run.weights()
    T = float(run.cell.mix["temperature"])
    rows = int(wl["ref_rows"])
    out = {"program": {"token_gap": max(ref_serve.gaps(
        w, run.sizes.dilations, toks, seeds, T, rows, **cond))},
        "finished": len(done), "faults": list(run.faults)}
    if control:
        out["control"] = {"token_gap": max(ref_serve.gaps(
            w, run.sizes.dilations, toks, seeds, T, rows, control=True,
            **cond))}
    return out


def main(argv=None) -> int:
    from portbench.__main__ import CHECKOUT, pin_caches
    p = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, default=12)
    p.add_argument("--control", type=int, default=3)
    p.add_argument("--first-seed", type=int, default=1_000_003)
    p.add_argument("--seconds", type=float, default=10.0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--look", action="store_true")
    args = p.parse_args(argv)
    kernels = pin_caches(CHECKOUT)
    from portbench import harness
    from wavenet_tpu_torch.utils import compcache
    compcache.enable(str(kernels))
    cell = harness.load_cell(args.workload)
    serving = "check_requests" in cell.workload
    rows = []
    for i in range(args.seeds):
        seed = args.first_seed + 7919 * i
        run = harness.Run(cell, seed, args.seconds, False, args.device,
                          time.monotonic())
        control = i < args.control
        t = time.monotonic()
        if args.look:
            rec = _look_seed(run)
        else:
            rec = (_serve_seed if serving else _train_seed)(run, control)
        rec["seed"] = seed
        rec["wall_s"] = time.monotonic() - t
        rows.append(rec)
        print(json.dumps(rec), flush=True)
    if args.look:
        return 0
    summary = {"workload": args.workload, "seeds": len(rows)}
    for name in rows[0]["program"]:
        summary[name] = {
            "program_max": max(r["program"][name] for r in rows)}
        for kind in ("control", "half_batch"):
            vals = [r[kind][name] for r in rows if kind in r]
            if vals:
                summary[name][f"{kind}_min"] = min(vals)
    print(json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
