"""Where a training step's device time goes (torch.profiler).

    python -m wavenet_tpu_torch.utils.profiling --preset full_vocoder \
        --steps 3 --device cuda

Builds the port's Trainer on synthetic data for the preset, runs two
warm-up steps, then records `--steps` steps with torch.profiler and
prints one JSON line: the wall time per step, the device's busy time per
step (the union of its kernel and copy intervals), the idle share
(1 - busy / wall), and the busy time per step split by kernel family:
  * train_stack: the fused stack's kernels (csrc/train_stack.cu);
  * gemm_f64: double-precision GEMMs (the head and its backward, whose
    dot products the port sums exactly in f64);
  * gemm_f32: single-precision GEMMs (the upsampler's shifted products,
    the embedding's one-hot backward);
  * copies: memcpy / memset;
  * other: elementwise, reductions, softmax, the optimizer.
With no device events (the CPU) the device numbers are null.
"""

from __future__ import annotations

import argparse
import json
import time
from typing import Dict, List, Tuple

import torch

_WARMUP = 2
_STACK = ("fwd_layer_kernel", "bwd_layer_kernel", "wgrad_kernel",
          "shift_add_kernel", "reduce_splits_kernel", "colsum_kernel",
          "init_carry_kernel")


def family(name: str) -> str:
    """The kernel family of a device event's name (see the module doc)."""
    low = name.lower()
    if any(k in name for k in _STACK):
        return "train_stack"
    if "memcpy" in low or "memset" in low:
        return "copies"
    if "gemm" in low or "cutlass" in low or "xmma" in low:
        return "gemm_f64" if ("dgemm" in low or "f64" in low
                              or "double" in low) else "gemm_f32"
    return "other"


def _busy_ms(spans: List[Tuple[float, float]]) -> float:
    """Length of the union of [start, end) intervals (us) in ms."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b <= end:
            continue
        total += b - max(a, end)
        end = b
    return total / 1e3


def step_breakdown(trainer, steps: int = 3) -> Dict:
    """Profile `steps` train steps after _WARMUP unprofiled ones."""
    from torch.profiler import ProfilerActivity, profile
    trainer.run(_WARMUP, log_every=0)
    acts = [ProfilerActivity.CPU]
    if trainer.device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        trainer._sync()
        t = time.perf_counter()
        trainer.run(steps, log_every=0)
        wall_ms = (time.perf_counter() - t) * 1e3 / steps
    spans, fams = [], {}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        a, b = e.time_range.start, e.time_range.end
        spans.append((a, b))
        f = family(e.name)
        fams[f] = fams.get(f, 0.0) + (b - a) / 1e3 / steps
    busy = _busy_ms(spans) / steps if spans else None
    return {"wall_ms_per_step": wall_ms,
            "device_busy_ms_per_step": busy,
            "device_idle_share": None if busy is None else 1 - busy / wall_ms,
            "device_ms_per_step_by_family": fams or None}


def main(argv=None) -> Dict:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--preset", default="full_vocoder")
    p.add_argument("--steps", type=int, default=3)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    from wavenet_tpu_torch.audio.dataset import AudioDataset
    from wavenet_tpu_torch.config import get_config
    from wavenet_tpu_torch.training.trainer import Trainer
    cfg = get_config(args.preset)
    ds = AudioDataset.synthetic(cfg, num_clips=8, clip_seconds=4.0)
    tr = Trainer(cfg, ds, device=args.device)
    out = {"preset": args.preset, "batch_size": cfg.batch_size,
           "train_window": cfg.train_window, "fused": tr.use_fused,
           **step_breakdown(tr, args.steps)}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
