"""Checks of BENCHMARK.json that the harness depends on: the characters of
names and units, that every per-layer metric moves an end-to-end metric
that each of its cells reports, and that every file a cell or metric is
found by exists.  The rest of the contract (counts, bounds, the budget of a
check) is the checking side's to hold, not repeated here.

    python -m portbench.manifest        # prints each fault; exit 1 if any
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path
from typing import List

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def validate(doc: dict, root: Path) -> List[str]:
    """Every fault of `doc` (BENCHMARK.json) found at checkout `root`."""
    errs: List[str] = []

    def name(what, n):
        if not (isinstance(n, str) and NAME.match(n)):
            errs.append(f"{what}: name {n!r} is not [A-Za-z0-9_.-]")

    for c in doc["configs"]:
        name(f"config {c['name']!r}", c["name"])
        for k in c["reduced"]:
            name(f"config {c['name']!r} reduced", k)
        if not (root / c["file"]).is_file():
            errs.append(f"config {c['name']!r}: file {c['file']!r} does "
                        f"not exist")
    cells = {}
    for w in doc["workloads"]:
        for key in ("name", "config", "traffic"):
            name(f"workload {w['name']!r} {key}", w[key])
        cells[w["name"]] = w
    e2e = {}
    for m in doc["end_to_end"] + doc["per_layer"]:
        name(f"metric {m['name']!r}", m["name"])
        if not (isinstance(m["unit"], str) and UNIT.match(m["unit"])):
            errs.append(f"metric {m['name']!r}: unit {m['unit']!r}")
    for m in doc["end_to_end"]:
        e2e[m["name"]] = set(m.get("workloads", cells))
    for m in doc["per_layer"]:
        if m["moves"] not in e2e:
            errs.append(f"metric {m['name']!r}: moves {m['moves']!r} is no "
                        f"end-to-end metric")
            continue
        lacking = set(m.get("workloads", cells)) - e2e[m["moves"]]
        if lacking:
            errs.append(f"metric {m['name']!r}: cells {sorted(lacking)} do "
                        f"not report {m['moves']}")
    return errs + _files(root, cells, [m["name"] for m in doc["per_layer"]])


def _files(root: Path, cells, per) -> List[str]:
    """The files the harness finds each cell and metric by."""
    pb = root / "portbench"
    errs = []
    for n, w in cells.items():
        f = pb / "workloads" / f"{n}.json"
        if not f.is_file():
            errs.append(f"no {f.relative_to(root)}")
            continue
        wl = json.loads(f.read_text())
        if any(wl.get(k) != w[k] for k in ("config", "traffic", "chips")):
            errs.append(f"{f.relative_to(root)} disagrees with BENCHMARK.json")
        mix = pb / "traffic" / f"{w['traffic']}.json"
        if not mix.is_file():
            errs.append(f"no {mix.relative_to(root)}")
            continue
        drv = json.loads(mix.read_text()).get("driver", "")
        if not (pb / "traffic" / f"{drv}.py").is_file():
            errs.append(f"no driver {drv!r} for {mix.relative_to(root)}")
    for n in per:
        if not (pb / "metrics" / f"{n}.py").is_file():
            errs.append(f"no reader portbench/metrics/{n}.py")
    return errs


def main() -> int:
    root = Path(__file__).resolve().parent.parent
    errs = validate(json.loads((root / "BENCHMARK.json").read_text()), root)
    for e in errs:
        print(e)
    return 1 if errs else 0


if __name__ == "__main__":
    sys.exit(main())
