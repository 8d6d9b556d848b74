"""Each traffic driver through the port's plain routes at tiny sizes on
the CPU: a sound run is correct and reports its cell's metrics, and a run
with the timed path broken underneath comes out not correct, once for each
fault the cell can have (a step that returns its state unchanged; half of
the batch left out; a token altered where it is produced).  The exchange
between chips does not exist in these one-chip cells."""

from __future__ import annotations

import numpy as np
import pytest

from portbench import harness


@pytest.mark.parametrize("cell", ["full.train", "fastgen_bench.train"])
def test_train_loop_sound(tiny_run, cell):
    run = tiny_run(cell)
    res = harness.result(run)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {"train_audio_s_per_s", "setup_s"}
    assert res["attempted"] >= 1 and res["failed"] == 0
    assert list(res)[-1] == "checks"
    assert set(res["checks"]) == set(run.cell.workload["limits"]) == \
        {"grad_gap", "change_gap", "grad_err"}


@pytest.mark.parametrize("cell", ["fastgen_bench.serve", "full.serve"])
def test_closed_loop_serve_sound(tiny_run, cell):
    run = tiny_run(cell)
    res = harness.result(run)
    assert res["correct"], (res["checks"], run.faults)
    want = {"served_audio_s_per_s", "setup_s"}
    if cell == "fastgen_bench.serve":
        want.add("first_audio_ms_p95")
    assert set(res["metrics"]) == want
    assert res["attempted"] >= 6 and res["failed"] == 0
    assert all(m["value"] > 0 for m in res["metrics"].values())


def test_traced_runs_read_the_program_counters(tiny_run):
    res = harness.result(tiny_run("fastgen_bench.serve", trace=True))
    assert res["correct"]
    assert "padded_rows_pct.serve" in res["metrics"]
    assert "breakdown" in res and "window_s" in res["device"]
    res = harness.result(tiny_run("full.train", trace=True))
    assert res["correct"]
    assert res["metrics"]["data_ms.train"]["value"] > 0


def test_train_state_unchanged_is_not_correct(tiny_run, monkeypatch):
    from wavenet_tpu_torch.training import trainer
    step = trainer.Trainer.step

    def frozen(self, *a, **kw):
        keep = self.state
        out = step(self, *a, **kw)
        self.state = keep
        return out
    monkeypatch.setattr(trainer.Trainer, "step", frozen)
    run = tiny_run("full.train")
    assert not run.correct
    assert run.checks["change_gap"]["value"] == pytest.approx(1.0)


def test_train_half_batch_is_not_correct(tiny_run, monkeypatch):
    from wavenet_tpu_torch.parallel import dataparallel
    loss = dataparallel.loss_fn_dp

    def half(params, cfg, tokens, *a, **kw):
        return loss(params, cfg, tokens[:tokens.shape[0] // 2], *a, **kw)
    monkeypatch.setattr(dataparallel, "loss_fn_dp", half)
    run = tiny_run("full.train")
    assert not run.correct, run.checks


def _broken_stream(monkeypatch, edit):
    """WaveNet.stream with each chunk passed through edit(chunk, index)."""
    from wavenet_tpu_torch.models.api import WaveNet
    stream = WaveNet.stream

    def wrapped(self, *a, **kw):
        for i, chunk in enumerate(stream(self, *a, **kw)):
            yield edit(np.array(chunk), i)
    monkeypatch.setattr(WaveNet, "stream", wrapped)


def test_serve_altered_token_is_not_correct(tiny_run, monkeypatch):
    def alter(chunk, i):
        if i == 0 and chunk.shape[1] > 5:
            chunk[:, 5] = -chunk[:, 5]          # another mu-law level
        return chunk
    _broken_stream(monkeypatch, alter)
    run = tiny_run("fastgen_bench.serve")
    assert not run.correct
    assert run.checks["token_gap"]["value"] > \
        run.checks["token_gap"]["limit"]


def test_serve_half_batch_left_out_is_not_correct(tiny_run, monkeypatch):
    def leave_out(chunk, i):
        chunk[chunk.shape[0] // 2:] = 0.0      # rows never computed
        return chunk
    _broken_stream(monkeypatch, leave_out)
    run = tiny_run("fastgen_bench.serve")
    assert not run.correct


def test_serve_state_unchanged_is_not_correct(tiny_run, monkeypatch):
    first = {}

    def restart(chunk, i):
        # every launch decodes from the state it started from: the first
        # chunk again
        if i == 0:
            first["c"] = chunk.copy()
            return chunk
        return first["c"][:, :chunk.shape[1]].copy()
    _broken_stream(monkeypatch, restart)
    run = tiny_run("full.serve")
    assert not run.correct
