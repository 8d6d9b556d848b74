"""Compare the machine code (SASS) of kernels in two builds of CUDA
sources: whether a change left a kernel's code as it was.

    python -m wavenet_tpu_torch.utils.sass_compare OLD.cu NEW.cu \
        OLD_NAME=NEW_NAME [...]

Builds each source to a cubin with the port's nvcc flags (ops/cuda/build)
and lists its SASS with cuobjdump.  Each pair names a kernel of each build
by a part of its mangled name (`fwd_layer_kernel=fwd_layer_kernelILi64E`:
the parent's kernel against the 64-row instance of its template).  The
instructions are compared after their addresses, encodings and branch
labels are dropped.  Prints one JSON line: per pair, the instructions of
each and how many differ (0: the same code).  Needs nvcc and cuobjdump,
so it runs where the kernels build.
"""

from __future__ import annotations

import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path
from typing import Dict, List

from wavenet_tpu_torch.ops.cuda import build


def functions(sass: str) -> Dict[str, List[str]]:
    """cuobjdump -sass output -> {mangled name: its instructions}, each
    without its address, encoding or label numbers."""
    out: Dict[str, List[str]] = {}
    name = None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m.group(1)
            out[name] = []
            continue
        if name is None or "/*" not in line:
            continue
        ins = re.sub(r"/\*[0-9a-f]{4,}\*/", "", line)
        ins = re.sub(r"/\* 0x[0-9a-f]+ \*/", "", ins)
        ins = re.sub(r"\.L_x_\d+", ".L", ins).strip()
        if ins:
            out[name].append(ins)
    return out


def compare(a: List[str], b: List[str]) -> dict:
    """Instruction counts of two functions and how many positions differ
    (a longer one's extra instructions count as differing)."""
    differ = sum(x != y for x, y in zip(a, b)) + abs(len(a) - len(b))
    return {"instructions": [len(a), len(b)], "differing": differ}


def _sass(src: str, out: Path) -> str:
    tools = Path(build.nvcc_path()).parent
    flags = [f for f in build.NVCC_FLAGS
             if f not in ("-shared", "-Xcompiler", "-fPIC")]
    subprocess.run([str(tools / "nvcc"), *flags, "-cubin", "-o", str(out),
                    src], check=True)
    return subprocess.run([str(tools / "cuobjdump"), "-sass", str(out)],
                          check=True, capture_output=True, text=True).stdout


def _one(funcs: Dict[str, List[str]], part: str) -> List[str]:
    found = [k for k in funcs if part in k]
    if len(found) != 1:
        raise SystemExit(f"{part!r} names {len(found)} kernels: {found}")
    return funcs[found[0]]


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 3 or any("=" not in p for p in args[2:]):
        print(__doc__, file=sys.stderr)
        return 2
    with tempfile.TemporaryDirectory() as tmp:
        a = functions(_sass(args[0], Path(tmp) / "a.cubin"))
        b = functions(_sass(args[1], Path(tmp) / "b.cubin"))
    print(json.dumps({p: compare(_one(a, p.split("=")[0]),
                                 _one(b, p.split("=")[1]))
                      for p in args[2:]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
