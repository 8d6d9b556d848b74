"""The port's spans (utils/profiling.span, interval, records) and the
benchmark's readers of them, on the CPU; one test on a card.

The recorder keeps records only while a torch.profiler runs, from every
thread (the profiler itself traces only the thread that started it), on
the clock of the profiler's events.  The serving lane's spans tile its
loop and agree with the engine's own counts; the trainer's mark a step's
phases.  The readers of portbench/metrics/ are checked on hand-built
traces and records, and on traced tiny runs of the cells.

The card's test runs on a machine without JAX with:

    python -m pytest tests/test_torch_tracing.py --noconftest -q -m gpu
"""

import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import harness, trace as trace_lib
from portbench.tests.conftest import tiny_overrides
from portbench.traffic import closed_loop_serve
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.serving import WaveNetServer
from wavenet_tpu_torch.training import trainer as ttrainer
from wavenet_tpu_torch.utils import profiling

torch.set_num_threads(1)

MICRO = dict(num_blocks=1, max_dilation=8, residual_channels=16,
             skip_channels=16, batch_size=2, train_window=64)
Q = 32                                  # samples a chunk and length bucket


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _records_since(t_ns, name=None):
    return [r for r in profiling.records()
            if r[1] >= t_ns and (name is None or r[0] == name)]


def _server(max_batch=4, max_wait_ms=200.0):
    cfg = tconfig.WaveNetConfig(**MICRO)
    model = WaveNet(cfg, wn.init_params(cfg, torch.Generator().manual_seed(3),
                                         "cpu"))
    return WaveNetServer(model, max_batch=max_batch, max_wait_ms=max_wait_ms,
                         chunk_seconds=Q / cfg.sample_rate,
                         length_quantum_seconds=Q / cfg.sample_rate)


def _serve(server, lengths):
    """Submit every request from its own thread at once; the waveforms."""
    out = [None] * len(lengths)

    def client(i):
        out[i] = server.submit(num_samples=lengths[i], seed=i + 1).waveform()
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(lengths))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(60)
    assert not any(t.is_alive() for t in threads)
    return out


def test_no_profiler_no_records_and_no_record_function(monkeypatch):
    """With no profiler running, serving and 3 train steps keep no record
    and enter no record-function range; span is one shared object."""
    entered = []

    def counting(name, *a, **kw):
        entered.append(name)
        raise AssertionError(f"record_function({name!r}) while off")
    monkeypatch.setattr(torch.autograd.profiler, "record_function", counting)
    monkeypatch.setattr(torch.profiler, "record_function", counting)
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", counting)
    before = profiling.records()
    with _server() as s:
        audio = _serve(s, [40, 70, 100])
    assert [a.shape[0] for a in audio] == [40, 70, 100]
    cfg = tconfig.WaveNetConfig(**MICRO)
    ds = tds.AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.05)
    tr = ttrainer.Trainer(cfg, ds, device="cpu")
    tr.run(3, log_every=0)
    assert tr.state.step == 3
    assert profiling.records() == before
    assert entered == []
    assert profiling.span("a", id=1) is profiling.span("b", rows=2)
    assert profiling.stamp() is None


def test_span_on_a_thread_started_before_the_profiler():
    go, seen = threading.Event(), {}

    def worker():
        go.wait(30)
        seen["thread_profiled"] = torch.autograd._profiler_enabled()
        with profiling.span("t.worker", id=7, rows=3):
            torch.ones(8) + 1
    t = threading.Thread(target=worker)
    t.start()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        go.set()
        t.join(30)
    t1 = time.time_ns()
    assert not t.is_alive()
    # the profiler does not trace this thread; the recorder does
    assert seen["thread_profiled"] is False
    (rec,) = _records_since(t0, "t.worker")
    name, start, end, id_, parent, numbers = rec
    assert t0 <= start <= end <= t1
    assert (id_, parent, numbers) == (7, None, {"rows": 3})


def test_span_stamps_agree_with_its_profiler_event():
    """On the profiling thread the span is also a host event of the
    trace, a function-scope range (a user annotation would be copied onto
    the device timeline), within 1 ms of the span's stamps at both ends."""
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("t.main", id=1):
            torch.ones(64, 64) @ torch.ones(64, 64)
            time.sleep(0.005)
    (rec,) = _records_since(t0, "t.main")
    (ev,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "t.main"]
    assert not ev.is_user_annotation()
    assert abs(ev.start_ns() - rec[1]) < 1_000_000
    assert abs(ev.start_ns() + ev.duration_ns() - rec[2]) < 1_000_000
    assert rec[2] - rec[1] >= 5_000_000


def test_traced_server_spans_match_the_engine():
    """One serve.queue_wait per request, each inside the group that took
    it; the groups' rows are the batches the engine launched (its stream
    calls) and their padding its padded_rows; collect and group spans
    alternate on the lane, one after the other."""
    lengths = [40, 100, 70, 30, 90, 60, 120, 50, 64]
    groups, launches = [], []
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        server = _server()          # its lanes' first collect is recorded
        server.model.stream = closed_loop_serve._counted(
            server.model.stream, groups, launches)
        audio = _serve(server, lengths)
        server.close()
    assert [a.shape[0] for a in audio] == lengths
    recs = _records_since(t0)
    waits = [r for r in recs if r[0] == "serve.queue_wait"]
    grp = sorted((r for r in recs if r[0] == "serve.group"),
                 key=lambda r: r[1])
    assert sorted(r[3] for r in waits) == list(range(1, len(lengths) + 1))
    by_id = {r[3]: r for r in grp}
    for w in waits:
        g = by_id[w[4]]
        assert w[1] <= w[2] == pytest.approx(g[1], abs=5e6)
        assert g[1] <= w[2] <= g[2]
    assert [r[5]["rows"] for r in grp] == [B for _, B in groups]
    assert sum(r[5]["rows"] - r[5]["real"] for r in grp) == \
        server.stats["padded_rows"]
    assert sum(r[5]["real"] for r in grp) == len(lengths)
    lane = sorted((r for r in recs if r[0] in ("serve.collect", "serve.group")
                   and r[5]["lane"] == 0), key=lambda r: r[1])
    assert [r[0] for r in lane] == \
        ["serve.collect", "serve.group"] * len(grp) + ["serve.collect"]
    for a, b in zip(lane, lane[1:]):
        assert 0 <= b[1] - a[2] < 50_000_000        # ns


@pytest.mark.parametrize("cell, metric", [
    ("fastgen_bench.serve", "queue_wait_ms_p95.serve"),
    ("full.train", "data_host_ms.train"),
])
def test_traced_tiny_cells_print_the_span_metrics(cell, metric):
    c = harness.load_cell(cell, overrides=tiny_overrides(cell))
    run = harness.execute(c, 2 ** 31 + 11, 1.5, True, "cpu",
                          time.monotonic())
    res = harness.result(run)
    assert res["correct"], res["checks"]
    assert res["metrics"][metric]["value"] > 0
    assert res["metrics"][metric]["unit"] == \
        {"queue_wait_ms_p95.serve": "ms",
         "data_host_ms.train": "ms/step"}[metric]
    # the idle readers need the card's intervals: none on the CPU
    for idle in ("idle_collect_pct.serve", "idle_chunk_pct.serve",
                 "idle_launch_pct.train"):
        assert idle not in res["metrics"]


def _rec(name, a, b, id_=None, parent=None, **numbers):
    return (name, int(a * 1e9), int(b * 1e9), id_, parent, numbers)


# device busy 11-12 and 14-16 of the window 10-20: idle 10-11, 12-14, 16-20
RECORDS = [
    _rec("serve.collect", 13.0, 15.0, lane=0),   # half of the gap 12-14
    _rec("serve.group", 15.0, 21.0, 1, lane=0, rows=4, real=3),  # 16-20
    _rec("serve.collect", 9.0, 21.0, lane=1),    # the other lane
    _rec("train.forward", 9.5, 11.5, 1),         # 10-11
    _rec("train.backward", 12.0, 13.0, 1),       # 12-13
    _rec("train.optimizer", 17.0, 18.0, 1),      # 17-18
    _rec("train.sample", 18.5, 19.0, 2),         # 0.5 s of data
    _rec("train.h2d", 19.5, 21.0, 2),            # 0.5 s inside
    _rec("serve.queue_wait", 5.0, 15.0, 99, 1),  # submitted before
] + [_rec("serve.queue_wait", 10.5, 10.5 + k / 1000, k, 1)
     for k in range(1, 21)]


def _hand_run(device="cuda"):
    tr = trace_lib.Trace((10.0, 20.0),
                         [("fwd_layer_kernel<64>", 11.0, 12.0),
                          ("decode_kernel<1, true>", 14.0, 16.0)], [])
    return types.SimpleNamespace(trace=tr, device=device,
                                 counters={"steps": 2})


@pytest.mark.parametrize("metric, want", [
    ("idle_collect_pct.serve", 10.0),
    ("idle_chunk_pct.serve", 40.0),
    ("idle_launch_pct.train", 30.0),
    ("data_host_ms.train", 500.0),
    ("queue_wait_ms_p95.serve", 19.0),
])
def test_span_readers_on_a_hand_built_trace(monkeypatch, metric, want):
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    read = harness._reader(metric).read
    assert read(_hand_run()) == pytest.approx(want)
    # the recorder full, its oldest record after the window's start: the
    # window's records may be lost
    monkeypatch.setattr(profiling, "CAPACITY", len(RECORDS))
    monkeypatch.setattr(profiling, "records",
                        lambda: [_rec("serve.collect", 10.5, 11.0, lane=0)]
                        + RECORDS[1:])
    assert read(_hand_run()) is None
    # a program without the recorder
    monkeypatch.delattr(profiling, "records")
    assert read(_hand_run()) is None


@pytest.mark.parametrize("metric", ["idle_collect_pct.serve",
                                    "idle_chunk_pct.serve",
                                    "idle_launch_pct.train"])
def test_idle_readers_read_nothing_on_the_cpu(monkeypatch, metric):
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    read = harness._reader(metric).read
    assert read(_hand_run("cpu")) is None
    run = _hand_run()
    run.trace = None
    assert read(run) is None


@pytest.mark.gpu
def test_span_contains_its_kernel_on_the_card(cuda):
    """The span's stamps and the device's kernel intervals share a clock:
    a span around a launch and a synchronize holds the kernel's interval,
    and the span adds no interval to the device's timeline."""
    x = torch.randn(1024, 1024, device=cuda)
    x @ x
    torch.cuda.synchronize()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with profiling.span("t.launch"):
            y = x @ x
            torch.cuda.synchronize()
    (rec,) = _records_since(t0, "t.launch")
    dev = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == torch.autograd.DeviceType.CUDA]
    assert dev and "t.launch" not in {e.name() for e in dev}
    for e in dev:
        assert rec[1] <= e.start_ns()
        assert e.start_ns() + e.duration_ns() <= rec[2]
    assert np.isfinite(y.sum().item())
