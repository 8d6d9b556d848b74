"""Milliseconds per decode step of the wide decode kernel at a few shapes,
on the card: the `full` preset at B = 4 (the default plan, and all four
rows in one cluster of 16), B = 1 and B = 16, `full_vocoder` and `full`
with 109 speakers at B = 4; each the median of five launches of 256
sampled steps (CUDA events), from seeded random weights.

    python -m wavenet_tpu_torch.utils.decode_times [--label NAME]

Prints one JSON line.  To compare two checkouts on one card, copy this
file into the other's wavenet_tpu_torch/utils/ and run both in one call,
alternating (a, b, b, a, a, b): cards and calls differ by a few percent.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as wn
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
    ap.add_argument("--label", default="")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("decode_times: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    out, weights = {"label": args.label}, {}
    for name, make, batch, plan in CASES:
        cfg = make()
        key = (cfg.mel is not None, cfg.global_classes)
        if key not in weights:
            weights[key] = pw.flatten_params(wn.init_params(
                cfg, torch.Generator().manual_seed(0), dev), cfg)
        w = weights[key]
        rings, carry, seeds, g, _, _ = pw.setup_decode(
            cfg, batch, STEPS, seeds=list(range(1, batch + 1)), device=dev,
            w=w, speaker=list(range(batch)) if cfg.global_classes else None)
        y = (torch.randn(batch, STEPS, cfg.mel.num_mels,
                         generator=torch.Generator().manual_seed(1)).to(dev)
             if cfg.mel else None)
        out[name] = step_ms(lambda: pw.decode_chunk(
            w, cfg, rings, carry, 0, seeds, STEPS, 1.0, y=y, g=g, **plan))
    out["card"] = torch.cuda.get_device_name(0)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
