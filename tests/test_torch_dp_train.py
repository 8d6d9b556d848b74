"""The port's train CLI under data parallelism on the CPU: two gloo ranks
(tests/_torch_dp_worker.train_ranks, spawned) run wavenet_tpu_torch.train's
main() on `tiny` (synthetic data, B = 4 global, window 128, EMA) for 4
steps with a checkpoint at step 2, then resume from that checkpoint.

  * Against one process on the same batches: each step's loss within rtol
    1e-5 (measured: under 1e-6; each row's forward is the same arithmetic,
    the sums over rows are ordered differently and some bf16 weight
    cotangents are rounded per half-batch, tests/test_torch_dataparallel.py),
    and every param within 2 * 4 * lr of the single run's: Adam's first
    steps move each weight by about lr whatever its gradient's size, so a
    near-zero gradient element whose sign the other order flips moves the
    other way (measured: most params equal to ~1e-7).
  * Both ranks' params and EMA bit-identical.
  * The resumed run's losses at steps 3-4 and its final params and EMA
    equal the uninterrupted run's bit for bit.
  * Only rank 0 created, wrote, renamed or removed anything in the run's
    directory (the checkpoints, params.json, the metrics file).
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from wavenet_tpu_torch import train

import _torch_dp_worker as worker

torch.set_num_threads(1)

STEPS, RESUME_AT, LR = 4, 2, 2e-4
ARGS = ["--preset", "tiny", "--synthetic", "--device", "cpu",
        "--batch-size", "4", "--log-every", "1", "--lr", str(LR),
        "--override", "train_window=128", "--override", "ema_decay=0.99"]


def _losses(path):
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def _run_ranks(tmp, name, extra):
    watch, out = tmp / name, tmp / f"{name}_out"
    watch.mkdir(exist_ok=True)
    out.mkdir()
    argv = ARGS + ["--override", "data_parallel=2", "--ckpt",
                   str(watch / "ckpt"), "--metrics-file",
                   str(watch / "metrics.jsonl")] + extra
    worker.run_ranks(worker.train_ranks, argv, str(watch), str(out),
                     store_dir=str(tmp))
    ranks = [dict(np.load(out / f"rank{r}.npz")) for r in range(2)]
    logs = [json.load(open(out / f"rank{r}.json")) for r in range(2)]
    return watch, ranks, logs


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("dp_train")
    a, ranks, logs = _run_ranks(tmp, "a", ["--steps", str(STEPS),
                                           "--ckpt-every", str(RESUME_AT)])
    b = tmp / "b"
    (b / "ckpt").mkdir(parents=True)
    for f in ("params.json", f"ckpt_{RESUME_AT:08d}.pt"):
        shutil.copy(a / "ckpt" / f, b / "ckpt" / f)
    _, rranks, rlogs = _run_ranks(tmp, "b", ["--steps",
                                             str(STEPS - RESUME_AT),
                                             "--resume"])
    single = tmp / "single"
    train.main(ARGS + ["--steps", str(STEPS), "--ckpt", str(single),
                       "--ckpt-every", str(RESUME_AT), "--metrics-file",
                       str(tmp / "single.jsonl")])
    sp = torch.load(single / f"ckpt_{STEPS:08d}.pt", weights_only=True)
    return dict(a=a, b=b, ranks=ranks, logs=logs, rranks=rranks,
                rlogs=rlogs, single=sp,
                single_losses=_losses(tmp / "single.jsonl"))


def test_dp_matches_single_process(runs):
    la = _losses(runs["a"] / "metrics.jsonl")
    ls = runs["single_losses"]
    assert sorted(la) == sorted(ls) == list(range(1, STEPS + 1))
    for s in la:
        np.testing.assert_allclose(la[s], ls[s], rtol=1e-5, err_msg=s)
    r0 = runs["ranks"][0]
    for k, v in runs["single"]["params"].items():
        d = np.abs(r0[f"param/{k}"] - v.numpy())
        assert d.max() <= 2 * STEPS * LR, (k, d.max())
        assert np.median(d) <= 1e-6, (k, np.median(d))
    assert runs["logs"][0]["metrics"]["loss"] == la[STEPS]


def test_ranks_hold_identical_params_and_ema(runs):
    r0, r1 = runs["ranks"]
    assert sorted(r0) == sorted(r1)
    assert any(k.startswith("ema/") for k in r0)
    for k in r0:
        np.testing.assert_array_equal(r0[k], r1[k], err_msg=k)


def test_dp_resume_bit_exact(runs):
    la = _losses(runs["a"] / "metrics.jsonl")
    lb = _losses(runs["b"] / "metrics.jsonl")
    assert sorted(lb) == list(range(RESUME_AT + 1, STEPS + 1))
    assert all(lb[s] == la[s] for s in lb), (la, lb)
    for r in range(2):
        for k, v in runs["ranks"][r].items():
            np.testing.assert_array_equal(runs["rranks"][r][k], v,
                                          err_msg=(r, k))
    last = f"ckpt_{STEPS:08d}.pt"
    pa = torch.load(runs["a"] / "ckpt" / last, weights_only=True)
    pb = torch.load(runs["b"] / "ckpt" / last, weights_only=True)
    for part in ("params", "ema"):
        for k in pa[part]:
            assert torch.equal(pa[part][k], pb[part][k]), (part, k)


def test_only_rank_zero_writes(runs):
    for logs in (runs["logs"], runs["rlogs"]):
        assert logs[1]["writes"] == []
        for k in ("loss", "accuracy", "grad_norm"):     # global on each
            assert logs[1]["metrics"][k] == logs[0]["metrics"][k], k
        written = {os.path.basename(p) for _, p in logs[0]["writes"]}
        assert "metrics.jsonl" in written
        assert any(n.startswith(f"ckpt_{STEPS:08d}.pt") for n in written)
    assert sorted(os.listdir(runs["a"] / "ckpt")) == [
        f"ckpt_{RESUME_AT:08d}.pt", f"ckpt_{STEPS:08d}.pt", "params.json"]
    assert any(os.path.basename(p).startswith("params.json")
               for _, p in runs["logs"][0]["writes"])
