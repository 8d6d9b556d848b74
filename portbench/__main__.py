"""python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell on the card and prints one JSON line, last on standard
output; the numbers that decided `correct` come last on standard error.
Exits non-zero, printing no result, when there is no CUDA device or fewer
than the cell asks for, when the port is not in this checkout, or when the
process holds JAX or the JAX package once the window has closed.
"""

import time

T_START = time.monotonic()       # set-up counts from here, before torch

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

CHECKOUT = Path(__file__).resolve().parent.parent


def pin_caches(checkout: Path) -> Path:
    """Every build and kernel cache at a fixed directory of the checkout;
    returns the port's kernel build cache."""
    base = checkout / "build" / "portbench"
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "nv_compute_cache")):
        os.environ[var] = str(base / sub)
    return checkout / "build" / "wavenet_tpu_torch"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m portbench",
                                description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    kernels = pin_caches(CHECKOUT)

    import torch
    from portbench import harness
    cell = harness.load_cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    import wavenet_tpu_torch
    from wavenet_tpu_torch.utils import compcache
    if CHECKOUT not in Path(wavenet_tpu_torch.__file__).resolve().parents:
        print(f"portbench: wavenet_tpu_torch is not this checkout's "
              f"({wavenet_tpu_torch.__file__})", file=sys.stderr)
        return 2
    compcache.enable(str(kernels))

    run = harness.execute(cell, args.seed, args.seconds, bool(args.trace),
                          "cuda", T_START)
    res = harness.result(run)
    found = harness.forbidden_modules()
    if found:
        print(f"portbench: the process holds {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in harness.check_lines(res):
        print(line, file=sys.stderr)
    print(json.dumps(res))
    return 0


if __name__ == "__main__":
    sys.exit(main())
