"""The port's asynchronous checkpoint saves (training/checkpoint.py) on the
CPU: the reference's durability tests (tests/test_train.py
test_async_save_is_durable_for_fresh_manager and
test_async_save_survives_manager_gc), exact resume with asynchronous
in-loop saves, a failing writer, and pruning.

A gate on torch.save holds the writer thread, so each test reads while its
save is still in flight; a timer opens the gate, and a read that returns
the save's step has waited for it.  Params are compared bit for bit.
"""

import gc
import os
import threading
import weakref

import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.training import checkpoint
from wavenet_tpu_torch.training import trainer as ttrainer

torch.set_num_threads(1)

MICRO = dict(num_blocks=2, max_dilation=8, residual_channels=16,
             skip_channels=16, batch_size=2, train_window=64,
             learning_rate=3e-3)


def _trainer(ckpt, **kw):
    cfg = tconfig.WaveNetConfig(**dict(MICRO, **kw))
    ds = tds.AudioDataset.synthetic(cfg, num_clips=2, clip_seconds=0.05)
    return ttrainer.Trainer(cfg, ds, checkpoint_dir=ckpt, device="cpu")


@pytest.fixture
def gate(monkeypatch):
    """An event the writer waits on before each torch.save."""
    ev = threading.Event()
    real = torch.save

    def gated(*a, **kw):
        if not ev.wait(60):
            raise TimeoutError("the test never opened the gate")
        return real(*a, **kw)

    monkeypatch.setattr(torch, "save", gated)
    yield ev
    ev.set()


def _open_later(ev, seconds=0.3):
    threading.Timer(seconds, ev.set).start()


def _files(d):
    return sorted(n for n in os.listdir(d) if n.startswith("ckpt_"))


def test_async_save_is_seen_by_a_fresh_manager(tmp_path, gate):
    d = str(tmp_path / "ck")
    tr = _trainer(d)
    tr.run(3, log_every=0)
    tr.save(wait=False)                  # returns with the write held
    assert _files(d) == []
    _open_later(gate)
    tr2 = _trainer(d)
    assert tr2.ckpt.latest_step() == 3   # waited for tr's save
    tr2.restore()
    assert tr2.state.step == 3 and tr2.iter_state.step == 3
    for k, v in tr.state.params.items():
        assert torch.equal(v, tr2.state.params[k]), k


def test_async_save_lands_after_its_manager_is_collected(tmp_path, gate):
    d = str(tmp_path / "ck")

    def run_and_drop():
        tr = _trainer(d)
        tr.run(2, log_every=0)
        tr.save(wait=False)
        return ({k: v.detach().clone() for k, v in tr.state.params.items()},
                weakref.ref(tr.ckpt))

    params, manager = run_and_drop()
    gc.collect()
    assert manager() is None and _files(d) == []
    _open_later(gate)
    tr2 = _trainer(d)
    tr2.restore()                        # sees the collected manager's save
    assert tr2.state.step == 2
    for k, v in params.items():
        assert torch.equal(v, tr2.state.params[k]), k


def test_async_in_loop_saves_resume_like_blocking_ones(tmp_path):
    """checkpoint_every saves (asynchronous) write what blocking saves
    write, and a resume from one repeats the run bit for bit."""
    kw = dict(ema_decay=0.5, grad_accum=2)
    a = _trainer(str(tmp_path / "a"), **kw)
    b = _trainer(str(tmp_path / "b"), **kw)
    a.run(6, log_every=0, checkpoint_every=2)
    b.run(6, log_every=0, checkpoint_every=2, wait_saves=True)
    assert a.ckpt.all_steps() == b.ckpt.all_steps() == [2, 4, 6]
    for step in (2, 4, 6):
        sa, _ = a.ckpt.restore(step, "cpu")
        sb, _ = b.ckpt.restore(step, "cpu")
        for tree in ("params", "ema"):
            for k in sa[tree]:
                assert torch.equal(sa[tree][k], sb[tree][k]), (step, k)
    c = _trainer(str(tmp_path / "a"), **kw)
    c.restore(step=2)
    c.run(4, log_every=0)
    for k in a.state.params:
        assert torch.equal(a.state.params[k], c.state.params[k]), k
        assert torch.equal(a.state.ema[k], c.state.ema[k]), k


def test_a_failed_write_raises(tmp_path):
    """A write that fails (an object torch.save cannot pickle) raises from
    wait(), from a read that waited for it and from the manager's next
    save(); no temp file stays behind, and later saves work."""
    from wavenet_tpu_torch.audio.dataset import IteratorState
    cfg = tconfig.WaveNetConfig(**MICRO)
    m = checkpoint.CheckpointManager(str(tmp_path), cfg)
    good = {"params": {"w": torch.ones(3)}}
    bad = {"params": {"w": lambda: 0}}
    it = IteratorState(seed=0, step=0)
    m.save(1, bad, it)
    with pytest.raises(RuntimeError, match="save to"):
        checkpoint.CheckpointManager(str(tmp_path), cfg).all_steps()
    with pytest.raises(RuntimeError, match="save to"):
        m.wait()
    m.save(2, bad, it)
    m2 = checkpoint.CheckpointManager(str(tmp_path), cfg)
    with pytest.raises(RuntimeError):
        m2.latest_step()                 # waits for save 2, which failed
    with pytest.raises(RuntimeError, match="save to"):
        m.save(3, good, it)              # save 2's error surfaces here
    m.save(3, good, it, wait=True)
    assert m.all_steps() == [3]
    assert sorted(os.listdir(tmp_path)) == ["ckpt_00000003.pt",
                                            "params.json"]


def test_pruning_removes_only_landed_files(tmp_path, gate):
    """max_to_keep prunes after each file lands: while the writer is held
    nothing is removed, a temp file that never landed is not touched, and
    two saves of one step in flight take temp names of their own."""
    from wavenet_tpu_torch.audio.dataset import IteratorState
    cfg = tconfig.WaveNetConfig(**MICRO)
    d = str(tmp_path)
    stray = os.path.join(d, "ckpt_00000001.pt.123.0.tmp")
    open(stray, "w").close()
    m = checkpoint.CheckpointManager(d, cfg, max_to_keep=2)
    it = IteratorState(seed=0, step=0)
    for step in (1, 2, 3, 4, 4):
        m.save(step, {"params": {"w": torch.full((2,), float(step))}}, it)
    assert _files(d) == ["ckpt_00000001.pt.123.0.tmp"]
    _open_later(gate, 0.1)
    m.wait()
    assert m.all_steps() == [3, 4]
    assert os.path.exists(stray)
    assert _files(d) == ["ckpt_00000001.pt.123.0.tmp", "ckpt_00000003.pt",
                         "ckpt_00000004.pt"]
    state, _ = m.restore(4, "cpu")
    assert torch.equal(state["params"]["w"], torch.full((2,), 4.0))


def test_save_snapshots_the_state_before_returning(tmp_path, gate):
    """The saved values are those at save() time, even when the caller
    updates its tensors in place while the write is held."""
    from wavenet_tpu_torch.audio.dataset import IteratorState
    cfg = tconfig.WaveNetConfig(**MICRO)
    m = checkpoint.CheckpointManager(str(tmp_path), cfg)
    w = torch.zeros(4)
    m.save(1, {"params": {"w": w}}, IteratorState(seed=0, step=1))
    w.add_(1.0)
    gate.set()
    state, it = m.restore(1, "cpu")
    assert torch.equal(state["params"]["w"], torch.zeros(4))
    assert it.step == 1
