"""Milliseconds per decode step of a decode kernel at a few shapes, on the
card; each the median of five launches of 256 sampled steps (CUDA
events), from seeded random weights.  The wide kernel (`--kernel wide`,
the default): the `full` preset at B = 4 (the default plan, and all four
rows in one cluster of 16), B = 1 and B = 16, `full_vocoder` and `full`
with 109 speakers at B = 4.  The narrow kernel (`--kernel narrow`):
`fastgen_bench` at B = 64, `conditional` at B = 4, `fastgen_bench` with
109 speakers at B = 8, `small` at B = 1, and `fastgen_bench` at the
offline batches that fill a 132-SM card's tiles of 2, 4 and 8 rows
(B = 264, 528, 1,056) and twice the last (2,112: two turns of 8-row
blocks), and `conditional` at B = 1,056 and 2,112.

    python -m wavenet_tpu_torch.utils.decode_times [--kernel wide|narrow]
        [--label NAME]

Prints one JSON line.  To compare two checkouts on one card, copy this
file into the other's wavenet_tpu_torch/utils/ and run both in one call,
alternating (a, b, b, a, a, b): cards and calls differ by a few percent.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops.cuda import decode as pn
from wavenet_tpu_torch.ops.cuda import decode_wide as pw

STEPS, RUNS = 256, 5
# (name, config, batch, forced plan)
CASES = (("full_B4", tconfig.full, 4, {}),
         ("full_B4_16x4", tconfig.full, 4,
          {"cluster": 16, "rows_per_cluster": 4}),
         ("full_B1", tconfig.full, 1, {}),
         ("full_B16", tconfig.full, 16, {}),
         ("vocoder_B4", tconfig.full_vocoder, 4, {}),
         ("speaker_B4", lambda: tconfig.full().replace(global_classes=109),
          4, {}))
NARROW_CASES = (
    ("fastgen_B64", tconfig.fastgen_bench, 64, {}),
    ("conditional_B4", tconfig.conditional, 4, {}),
    ("speaker_B8",
     lambda: tconfig.fastgen_bench().replace(global_classes=109), 8, {}),
    ("small_B1", tconfig.small, 1, {}),
    ("fastgen_B264", tconfig.fastgen_bench, 264, {}),
    ("fastgen_B528", tconfig.fastgen_bench, 528, {}),
    ("fastgen_B1056", tconfig.fastgen_bench, 1056, {}),
    ("fastgen_B2112", tconfig.fastgen_bench, 2112, {}),
    ("conditional_B1056", tconfig.conditional, 1056, {}),
    ("conditional_B2112", tconfig.conditional, 2112, {}))


def step_ms(fn) -> float:
    """Median ms per step of RUNS launches of fn (one launch of STEPS)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(RUNS):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1) / STEPS)
    return sorted(times)[RUNS // 2]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--kernel", choices=("wide", "narrow"), default="wide")
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_times: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    mod, cases = ((pw, CASES) if args.kernel == "wide"
                  else (pn, NARROW_CASES))
    out, weights = {"label": args.label, "kernel": args.kernel}, {}
    for name, make, batch, plan in cases:
        cfg = make()
        key = (cfg.residual_channels, cfg.skip_channels, cfg.num_layers,
               cfg.mel is not None, cfg.global_classes)
        if key not in weights:
            weights[key] = mod.flatten_params(wn.init_params(
                cfg, torch.Generator().manual_seed(0), dev), cfg)
        w = weights[key]
        rings, carry, seeds, g, _, _ = mod.setup_decode(
            cfg, batch, STEPS, seeds=list(range(1, batch + 1)), device=dev,
            w=w, speaker=list(range(batch)) if cfg.global_classes else None)
        y = (torch.randn(batch, STEPS, cfg.mel.num_mels,
                         generator=torch.Generator().manual_seed(1)).to(dev)
             if cfg.mel else None)
        out[name] = step_ms(lambda: mod.decode_chunk(
            w, cfg, rings, carry, 0, seeds, STEPS, 1.0, y=y, g=g, **plan))
    out["card"] = torch.cuda.get_device_name(0)
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
