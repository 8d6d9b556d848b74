"""The port's tracing and numerics utilities (utils/profiling.py trace,
profiled_steps, timeit, host_costs; utils/debug.py) and the facade's
replace_config against the JAX package's, on the CPU at micro widths.

The traced steps are read back from the Chrome trace by their span names;
timeit runs on a fake clock, so its median is exact.
"""

import json
import re

import jax
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import api as japi
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.models import api as tapi
from wavenet_tpu_torch.training import trainer as ttrainer
from wavenet_tpu_torch.utils import debug, profiling
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

MICRO = dict(num_blocks=2, max_dilation=8, residual_channels=16,
             skip_channels=16, batch_size=2, train_window=64,
             learning_rate=3e-3)


def _trainer(ckpt=None):
    cfg = tconfig.WaveNetConfig(**MICRO)
    ds = tds.AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.05)
    return ttrainer.Trainer(cfg, ds, checkpoint_dir=ckpt, device="cpu")


def _traced_steps(path):
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return sorted({int(m.group(1)) for e in events
                   for m in [re.fullmatch(r"train_step_(\d+)",
                                          e.get("name", ""))] if m})


@pytest.mark.parametrize("start,stop,chunks", [(0, 2, (3,)),
                                               (2, 5, (3, 3)),
                                               (3, 8, (2, 3))])
def test_profiled_steps_traces_exactly_start_to_stop(tmp_path, start, stop,
                                                     chunks):
    """Steps [start, stop) counted over every run() inside the block; a
    block that ends before `stop` writes what it traced."""
    tr = _trainer()
    orig = tr.step
    with profiling.profiled_steps(tr, str(tmp_path), start, stop):
        for n in chunks:
            tr.run(n, log_every=0)
    assert tr.step == orig                       # the hook is removed
    want = list(range(start, min(stop, sum(chunks))))
    path = tmp_path / f"trace_steps{start}-{stop}.json"
    assert _traced_steps(path) == want


def test_trace_writes_a_chrome_trace(tmp_path):
    with profiling.trace(str(tmp_path / "t")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    with open(tmp_path / "t" / "trace.json") as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert "aten::matmul" in names


def test_timeit_returns_the_median(monkeypatch):
    """Each call advances a fake clock by its own duration; the two
    warm-up calls (100 s each) are left out."""
    clock = [0.0]
    durations = iter([100.0, 100.0, 5.0, 1.0, 4.0, 2.0, 3.0])
    monkeypatch.setattr(profiling.time, "perf_counter", lambda: clock[0])

    def fn(scale):
        clock[0] += next(durations) * scale

    assert profiling.timeit(fn, 2.0, warmup=2, iters=5) == 6.0


def test_host_costs_on_the_cpu(tmp_path):
    out = profiling.host_costs(_trainer(str(tmp_path / "ck")), steps=1)
    assert sorted(out) == ["async_save_returns_ms", "fetch_every_step",
                           "no_fetch_no_save", "save_every_step_async",
                           "save_every_step_sync"]
    assert all(v > 0 and np.isfinite(v) for v in out.values())


def test_debug_numerics_raises_on_a_nan_in_backward():
    x = torch.tensor([-1.0, 4.0], requires_grad=True)
    torch.sqrt(x).sum().backward()               # NaN grads, no error
    assert torch.isnan(x.grad[0])
    with debug.debug_numerics():
        with pytest.raises(RuntimeError, match="nan"):
            torch.sqrt(x).sum().backward()
    assert not torch.is_anomaly_enabled()


def test_checked_loss_and_finite_checks():
    nan = torch.tensor(float("nan"))
    assert debug.checked_loss(nan) == float("inf")
    assert debug.checked_loss(torch.tensor(2.5)) == 2.5
    with debug.debug_numerics():
        assert debug.checked_loss(torch.tensor(2.5)) == 2.5
        with pytest.raises(FloatingPointError, match="non-finite loss"):
            debug.checked_loss(nan)
    tree = {"a": torch.ones(2), "up": {"w0": torch.tensor([1.0, np.inf])},
            "ids": torch.tensor([1, 2])}
    with pytest.raises(FloatingPointError, match=r"\['up/w0'\]"):
        debug.assert_tree_finite(tree, "params")
    debug.assert_tree_finite({"a": torch.ones(2)})


@pytest.fixture(scope="module")
def models():
    jc = jconfig.WaveNetConfig(**MICRO)
    tc = tconfig.WaveNetConfig(**MICRO)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return japi.WaveNet(jc, jp), tapi.WaveNet(tc, tp)


@pytest.mark.parametrize("field,value", [("residual_channels", 32),
                                         ("sample_rate", 8000),
                                         ("global_classes", 4)])
def test_replace_config_refuses_architecture_fields(models, field, value):
    jm, tm = models
    with pytest.raises(ValueError) as je:
        jm.replace_config(**{field: value})
    with pytest.raises(ValueError) as te:
        tm.replace_config(**{field: value})
    assert str(te.value) == str(je.value)


def test_replace_config_keeps_the_params(models):
    jm, tm = models
    j2 = jm.replace_config(batch_size=3, fused_stack=False)
    t2 = tm.replace_config(batch_size=3, fused_stack=False)
    assert (t2.cfg.batch_size, t2.cfg.fused_stack) == (
        j2.cfg.batch_size, j2.cfg.fused_stack) == (3, False)
    assert tm.cfg.batch_size == MICRO["batch_size"]
    for k, v in tm.params.items():
        assert torch.equal(t2.params[k], v)
        assert t2.params[k].data_ptr() == v.data_ptr()   # shared


def test_decode_layouts_follow_shared_params(models):
    """A model made by replace_config shares its params: a change made
    through either model reaches both decode layouts, so neither decodes
    stale weights."""
    _, tm = models
    tm = tapi.WaveNet(tm.cfg, {k: v.clone() for k, v in tm.params.items()})
    t2 = tm.replace_config(batch_size=3)
    before = tm.generate(num_samples=24, seed=3)
    assert torch.equal(t2.generate(num_samples=24, seed=3), before)
    with torch.no_grad():
        t2.w_cur.mul_(-3.0)
    want = tapi.WaveNet(tm.cfg, {k: v.clone() for k, v in
                                 tm.params.items()}).generate(
        num_samples=24, seed=3)
    assert not torch.equal(want, before)
    assert torch.equal(tm.generate(num_samples=24, seed=3), want)
    assert torch.equal(t2.generate(num_samples=24, seed=3), want)
