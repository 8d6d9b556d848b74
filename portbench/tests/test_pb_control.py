"""The control: the reference computed in fp8, the precision below the
configurations' bf16, put in the program's place, must come out not
correct under each cell's limits, while the program comes out correct.

On the CPU at sizes a test run holds: a training cell at the tiny
preset's widths; a serving cell's control gap at the cell's own widths and
depth over two requests of 4,000 tokens.  On the card (marked gpu) at each
cell's own size, one seed; the readings over a dozen seeds that the limits
were set from come from `python -m portbench.calibrate`."""

from __future__ import annotations

import time

import numpy as np
import pytest

from conftest import tiny_overrides
from portbench import calibrate, harness, weights
from portbench.reference import serve

TRAIN = ["full.train", "fastgen_bench.train"]
SERVE = ["fastgen_bench.serve", "full.serve"]


def _readings(cell: str, device: str, overrides=None, seed: int = 17,
              seconds: float = 8.0) -> tuple:
    c = harness.load_cell(cell, overrides=overrides)
    run = harness.Run(c, seed, seconds, False, device, time.monotonic())
    seed_fn = (calibrate._serve_seed if "check_requests" in c.workload
               else calibrate._train_seed)
    return c.workload["limits"], seed_fn(run, control=True)


def _judge(limits, rec):
    assert all(rec["program"][k] <= v for k, v in limits.items()), rec
    assert any(rec["control"][k] > v for k, v in limits.items()), rec


@pytest.mark.parametrize("cell", TRAIN)
def test_train_control_is_not_correct_at_a_test_size(cell):
    limits, rec = _readings(cell, "cpu", tiny_overrides(cell), seconds=1.5)
    _judge(limits, rec)


@pytest.mark.parametrize("cell", SERVE)
def test_serve_control_is_not_correct_at_the_cells_widths(cell):
    c = harness.load_cell(cell)
    w = weights.make(c.sizes, 17, "cpu")
    rng = np.random.default_rng(0)
    toks = [rng.integers(0, c.sizes.Q, 4000) for _ in range(2)]
    gap = max(serve.gaps(w, c.sizes.dilations, toks, [5, 6],
                         float(c.mix["temperature"]), 2, control=True))
    assert gap > c.workload["limits"]["token_gap"]


@pytest.mark.gpu
@pytest.mark.parametrize("cell", TRAIN + SERVE)
def test_control_is_not_correct_at_the_cells_size(cuda, cell):
    from portbench.__main__ import CHECKOUT, pin_caches
    from wavenet_tpu_torch.utils import compcache
    compcache.enable(str(pin_caches(CHECKOUT)))
    limits, rec = _readings(cell, cuda)
    _judge(limits, rec)
