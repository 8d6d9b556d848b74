"""How far correct summation orders of the stack forward drift apart.

The forward's products have bf16 operands, summed in f32 by the reference.
Two f32 summation orders differ in the last bit of z and of each layer's
output, and the stack's bf16 roundings of h and of each layer's input carry
those differences on through its layers.  This runs the whole stack's
forward (`train_stack.stack_forward`, the plain version) with its products
summed exactly (float64, `train_stack._mm`, as the kernels sum them) and in
f32 in two orders, and the kernels where the device is a card, and prints
max|a - b| / max|b| of the skip sums and the count of differing layer
inputs between each order and the exact one, as one JSON line:

    python -m wavenet_tpu_torch.utils.stack_drift --preset full --device cuda

Weights from `init_params` (seed 0), tokens from numpy (seed 4).
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops.cuda import train_stack as ts

ORDERS = {
    "exact": ts._mm,
    "f32": lambda a, w: a @ w.float(),
    "f32 reversed": lambda a, w: a.flip(-1) @ w.float().flip(0),
}


def drift(cfg, batch: int, window: int, device) -> dict:
    """{order: (skip_rel, differing layer inputs)} against the exact sums."""
    params = wn.init_params(cfg, torch.Generator().manual_seed(0), device)
    groups = ts.group_plan(cfg, ts.pick_tile(cfg, window))
    rs = np.random.RandomState(4)
    toks = torch.from_numpy(rs.randint(0, cfg.quantization_channels,
                                       (batch, window)).astype(np.int32))
    toks = toks.to(device)
    x = wn.embed_tokens(params, cfg, toks,
                        wn._shifted_tokens(toks)).contiguous()
    runs = {}
    exact = ts._mm
    with torch.no_grad():
        try:
            for name, mm in ORDERS.items():
                ts._mm = mm
                skip, saved = ts.stack_forward(params, cfg, groups, x,
                                               ts.group_fwd_reference)
                runs[name] = (skip, [s[2] for s in saved])
        finally:
            ts._mm = exact
        if torch.device(device).type == "cuda":
            skip, saved = ts.stack_forward(params, cfg, groups, x,
                                           ts.group_fwd)
            runs["kernel"] = (skip, [s[2] for s in saved])
    ref_skip, ref_xs = runs["exact"]
    return {name: (float((skip - ref_skip).abs().max())
                   / float(ref_skip.abs().max()),
                   sum(int((a != b).sum()) for a, b in zip(xs, ref_xs)))
            for name, (skip, xs) in runs.items() if name != "exact"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--preset", default="full",
                    help="a preset without mel or speakers")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--window", type=int, default=8192)
    ap.add_argument("--layers", type=int, default=0,
                    help="keep the first N layers, N at most one block of "
                         "dilations or whole blocks (0: all)")
    ap.add_argument("--device", default="cuda")
    a = ap.parse_args(argv)
    cfg = getattr(tconfig, a.preset)()
    if cfg.mel is not None or cfg.global_classes is not None:
        ap.error(f"{a.preset} is conditioned; take a preset without mel "
                 f"or speakers")
    per = len(cfg.dilations) // cfg.num_blocks
    if a.layers and a.layers > per and a.layers % per:
        ap.error(f"--layers {a.layers}: at most {per} or a multiple of it")
    if a.layers:
        cfg = cfg.replace(num_blocks=-(-a.layers // per),
                          max_dilation=cfg.dilations[min(a.layers, per) - 1])
    out = drift(cfg, a.batch, a.window, a.device)
    card = (torch.cuda.get_device_name(0) if torch.device(a.device).type
            == "cuda" else "cpu")
    print(json.dumps({"preset": a.preset, "layers": cfg.num_layers,
                      "batch": a.batch, "window": a.window, "device": card,
                      "vs_exact": {k: {"skip_rel": r, "xs_differ": n}
                                   for k, (r, n) in out.items()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
