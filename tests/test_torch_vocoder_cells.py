"""The mel vocoder's benchmark cells and what the port records for them,
on the CPU; one test on a card.

`full_vocoder.serve` and `full_vocoder.train` run at tiny sizes through
harness.load_cell's overrides (the mel front end of portbench/tests/
conftest.py: 16 bins, hop 32) and are judged against portbench/reference/.
The serving lane's per-row upsampling records "serve.upsample" inside its
"serve.group", as the engine's stats count it; a training step's upsampler
records "train.upsample", forward and backward, with the device time
between CUDA events on a card.  The readers idle_upsample_pct.serve and
upsample_ms.train are checked on hand-built traces and records.

The card's test runs on a machine without JAX with:

    python -m pytest tests/test_torch_vocoder_cells.py --noconftest -q -m gpu
"""

import threading
import time
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from portbench import corpus, harness, trace as trace_lib
from portbench.tests.conftest import tiny_overrides
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.models import conditioning as tcond
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.serving import WaveNetServer
from wavenet_tpu_torch.training import trainer as ttrainer
from wavenet_tpu_torch.utils import profiling

torch.set_num_threads(1)

SEED = 2 ** 31 + 11
# the tiny model's own token_gap limit (portbench/tests/
# test_pb_conditioned_drivers.py: sound runs 0-0.0135, a frame late 0.135
# on seed 5)
TINY_SERVE = {"limits": {"token_gap": 0.05}}
MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
MICRO = dict(num_blocks=1, max_dilation=8, residual_channels=16,
             skip_channels=16, batch_size=2, train_window=64)
Q = 32                                  # samples a chunk and length bucket


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return "cuda"


def _tiny_cell(cell, seed=SEED, seconds=1.5, trace=False, **workload):
    ov = tiny_overrides(cell, mel=True, **workload)
    c = harness.load_cell(cell, overrides=ov)
    return harness.execute(c, seed, seconds, trace, "cpu", time.monotonic())


def _records_since(t_ns, name=None):
    return [r for r in profiling.records()
            if r[1] >= t_ns and (name is None or r[0] == name)]


@pytest.mark.parametrize("cell, seconds", [("full_vocoder.serve", 2.5),
                                           ("full_vocoder.train", 1.5)])
@pytest.mark.parametrize("trace", [False, True])
def test_tiny_vocoder_cells_are_correct(cell, seconds, trace):
    serving = cell.endswith(".serve")
    run = _tiny_cell(cell, seconds=seconds, trace=trace,
                     **(TINY_SERVE if serving else {}))
    res = harness.result(run)
    assert res["correct"], (res["checks"], run.faults)
    assert run.sizes.M == 16 and run.sizes.hop == 32
    assert res["failed"] == 0 and res["attempted"] > 0
    metrics = res["metrics"]
    if not trace:
        assert set(metrics) == {
            "setup_s", "served_audio_s_per_s" if serving
            else "train_audio_s_per_s"}
        return
    # the new readers need the card's intervals or events: none here
    assert "idle_upsample_pct.serve" not in metrics
    assert "upsample_ms.train" not in metrics
    recs = profiling.records()
    name = "serve.upsample" if serving else "train.upsample"
    a, b = run.trace.window
    assert any(r[0] == name and r[1] / 1e9 < b and r[2] / 1e9 > a
               for r in recs)


def test_tiny_vocoder_cells_report_their_metrics():
    """Each new cell reports setup_s and its end-to-end rate; its
    per-layer metrics are the twins' and the conditioning layer's."""
    serve = harness.load_cell("full_vocoder.serve")
    train = harness.load_cell("full_vocoder.train")
    assert {m["name"] for m in serve.end_to_end} == {
        "served_audio_s_per_s", "setup_s"}
    assert {m["name"] for m in train.end_to_end} == {
        "train_audio_s_per_s", "setup_s"}
    twin_s = {m["name"] for m in harness.load_cell("full.serve").per_layer}
    twin_t = {m["name"] for m in harness.load_cell("full.train").per_layer}
    assert {m["name"] for m in serve.per_layer} == twin_s | {
        "idle_upsample_pct.serve"}
    assert {m["name"] for m in train.per_layer} == twin_t | {
        "upsample_ms.train"}
    assert serve.mix["conditioning"] == "mel" and serve.sizes.M == 80
    assert train.sizes.hop == 256 and train.sizes.upsample == (4, 8, 8)


def test_frame_late_mel_fails_the_tiny_serving_cell(monkeypatch):
    """The longest request's frames start one frame late (the judged
    sample always holds the longest request): token_gap passes the
    limit."""
    mix = tiny_overrides("full_vocoder.serve", mel=True)["mix"]
    longest = int(np.round(corpus.log_uniform_quantiles(
        mix["clients"], mix["min_s"], mix["max_s"]) * 4000).max())
    submit = WaveNetServer.submit
    shifted = []

    def shift(self, **kw):
        if kw["num_samples"] == longest:
            kw["mel"] = np.concatenate([kw["mel"][1:], kw["mel"][-1:]])
            shifted.append(kw["num_samples"])
        return submit(self, **kw)
    monkeypatch.setattr(WaveNetServer, "submit", shift)
    run = _tiny_cell("full_vocoder.serve", seed=5, seconds=2.5, **TINY_SERVE)
    assert shifted and not run.faults
    assert run.checks["token_gap"]["value"] > \
        run.checks["token_gap"]["limit"]


def _mel_server(max_batch=4, max_wait_ms=200.0):
    cfg = tconfig.WaveNetConfig(mel=tconfig.MelConfig(**MEL), **MICRO)
    model = WaveNet(cfg, wn.init_params(cfg, torch.Generator().manual_seed(3),
                                         "cpu"))
    return WaveNetServer(model, max_batch=max_batch, max_wait_ms=max_wait_ms,
                         chunk_seconds=Q / cfg.sample_rate,
                         length_quantum_seconds=Q / cfg.sample_rate)


def test_serve_upsample_records_match_the_engine():
    """One serve.upsample inside each mel group, on lane 1, parented by
    the group; its rows and frames add up to the engine's stats; the
    unconditioned lane records none."""
    rs = np.random.RandomState(4)
    jobs = [dict(num_samples=n, seed=i + 1,
                 mel=rs.randn(-(-n // 16), 8).astype(np.float32))
            for i, n in enumerate([40, 100, 70, 30, 90, 60])]
    jobs += [dict(num_samples=50, seed=20), dict(num_samples=80, seed=21)]
    out = [None] * len(jobs)
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        server = _mel_server()

        def client(i):
            out[i] = server.submit(**jobs[i]).waveform()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(len(jobs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(60)
        server.close()
    assert not any(t.is_alive() for t in threads)
    assert [o.shape[0] for o in out] == [j["num_samples"] for j in jobs]
    recs = _records_since(t0)
    ups = [r for r in recs if r[0] == "serve.upsample"]
    groups = {r[3]: r for r in recs if r[0] == "serve.group"}
    mel_groups = [g for g in groups.values() if g[5]["lane"] == 1]
    assert ups and len(ups) == len(mel_groups)
    for u in ups:
        g = groups[u[4]]
        assert g[5]["lane"] == u[5]["lane"] == 1
        assert g[1] <= u[1] <= u[2] <= g[2]
        assert u[5]["rows"] == g[5]["real"]
    assert sum(u[5]["rows"] for u in ups) == server.stats[
        "upsampled_rows"] == 6
    assert sum(u[5]["frames"] for u in ups) == server.stats[
        "upsampled_frames"] == sum(len(j["mel"]) for j in jobs[:6])


def test_train_upsample_records_in_a_profiled_step():
    """Each step records the upsampler's forward (dir 0) inside
    train.forward and its backward (dir 1) inside train.backward; with no
    device, no device_ms; a step without gradients records nothing."""
    cfg = tconfig.WaveNetConfig(mel=tconfig.MelConfig(**MEL), **MICRO)
    ds = tds.AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.05)
    tr = ttrainer.Trainer(cfg, ds, device="cpu")
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU]):
        tr.run(2, log_every=0)
        tr.evaluate(num_batches=1)
    recs = _records_since(t0)
    ups = sorted((r for r in recs if r[0] == "train.upsample"),
                 key=lambda r: r[1])
    assert [r[5] for r in ups] == [{"dir": 0}, {"dir": 1}] * 2
    for phase, d in (("train.forward", 0), ("train.backward", 1)):
        spans = sorted((r for r in recs if r[0] == phase),
                       key=lambda r: r[1])
        inside = [u for u in ups if u[5]["dir"] == d]
        assert len(spans) == len(inside) == 2
        for s, u in zip(spans, inside):
            assert s[1] <= u[1] <= u[2] <= s[2]


def _rec(name, a, b, id_=None, parent=None, **numbers):
    return (name, int(a * 1e9), int(b * 1e9), id_, parent, numbers)


# device busy 11-12 and 14-16 of the window 10-20: idle 10-11, 12-14, 16-20
RECORDS = [
    _rec("serve.group", 10.0, 13.0, 1, lane=1, rows=4, real=3),
    _rec("serve.upsample", 10.5, 11.5, None, 1, lane=1, rows=3, frames=9),
    _rec("serve.group", 13.0, 19.0, 2, lane=1, rows=4, real=4),
    _rec("serve.upsample", 13.0, 15.0, None, 2, lane=1, rows=4, frames=12),
    _rec("serve.upsample", 16.0, 17.0, None, 9, lane=0, rows=1, frames=3),
    _rec("train.upsample", 10.2, 10.4, dir=0, device_ms=3.0),
    _rec("train.upsample", 11.0, 11.5, dir=1, device_ms=5.0),
    _rec("train.upsample", 15.0, 15.1, dir=0, device_ms=3.5),
    _rec("train.upsample", 16.0, 16.5, dir=1, device_ms=4.5),
    _rec("train.upsample", 8.0, 8.5, dir=0, device_ms=100.0),  # before
]


def _hand_run(device="cuda"):
    tr = trace_lib.Trace((10.0, 20.0),
                         [("fwd_layer_kernel<64>", 11.0, 12.0),
                          ("decode_wide_kernel<1, true, false>", 14.0,
                           16.0)], [])
    return types.SimpleNamespace(trace=tr, device=device,
                                 counters={"steps": 2})


@pytest.mark.parametrize("metric, want", [
    # lane 1 (the most real rows): 0.5 s of 10-11 and 1 s of 12-14
    ("idle_upsample_pct.serve", 15.0),
    # (3 + 5 + 3.5 + 4.5) ms over 2 steps
    ("upsample_ms.train", 8.0),
])
def test_upsample_readers_on_a_hand_built_trace(monkeypatch, metric, want):
    monkeypatch.setattr(profiling, "records", lambda: list(RECORDS))
    read = harness._reader(metric).read
    assert read(_hand_run()) == pytest.approx(want)
    # a program that records neither span (the parent's): None
    others = [r for r in RECORDS if r[0] == "serve.group"]
    monkeypatch.setattr(profiling, "records", lambda: list(others))
    assert read(_hand_run()) is None
    # records without device time (a run on the CPU): None
    no_device = [r[:5] + ({k: v for k, v in r[5].items()
                           if k != "device_ms"},) for r in RECORDS]
    monkeypatch.setattr(profiling, "records", lambda: list(no_device))
    assert read(_hand_run("cpu")) is None
    run = _hand_run()
    run.trace = None
    assert read(run) is None
    # a program without the recorder
    monkeypatch.delattr(profiling, "records")
    assert read(_hand_run()) is None


@pytest.mark.gpu
def test_upsample_device_ms_agrees_with_the_profiler_on_the_card(cuda):
    """train.upsample's device_ms, forward and backward, within 10% of the
    profiler's kernel time for the upsampler's launches.  The device
    sleeps first, so that every launch queues behind it and the kernels
    run back to back, as in a step whose host runs ahead."""
    mel_cfg = tconfig.MelConfig()
    params = {k: v.requires_grad_() for k, v in tcond.init_upsampler_params(
        mel_cfg, torch.Generator().manual_seed(0), cuda).items()}
    T = 8192
    mel = torch.randn(32, T // mel_cfg.hop_length + 1, mel_cfg.num_mels,
                      device=cuda)
    g = torch.randn(32, T, mel_cfg.num_mels, device=cuda)

    def step():
        y = tcond.upsample_mel_train(params, mel_cfg, mel, T)
        return torch.autograd.grad(y, list(params.values()), g)
    want = step()
    torch.cuda.synchronize()
    t0 = time.time_ns()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        torch.cuda._sleep(100_000_000)
        got = step()
        torch.cuda.synchronize()
    for a, b in zip(want, got):
        assert torch.equal(a, b)
    ups = _records_since(t0, "train.upsample")
    assert sorted(r[5]["dir"] for r in ups) == [0, 1]
    device_ms = sum(r[5]["device_ms"] for r in ups)
    device = sorted((e for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA),
                    key=lambda e: e.start_ns())
    kernels = device[1:]                # after the sleep's own kernel
    kernel_ms = sum(e.duration_ns() for e in kernels) / 1e6
    assert kernels and device_ms == pytest.approx(kernel_ms, rel=0.1), (
        device_ms, kernel_ms)
