"""The port's streaming dataset (wavenet_tpu_torch/audio/streaming.py):
the counterparts of tests/test_streaming.py's eight tests (equal to the
in-memory AudioDataset, with mel, the cache bound, exact resume, prefetch
parity and resync after a restore, rows= slicing, the trainer on it), then
port against JAX: on the same corpus the port's StreamingAudioDataset
gives the JAX StreamingAudioDataset's batches bit for bit (tokens, mel
frames, speaker ids by subdirectory, every rank's rows)."""

import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.audio import dataset as jds
from wavenet_tpu.audio.streaming import StreamingAudioDataset as JStreaming
from wavenet_tpu_torch.audio.dataset import AudioDataset, IteratorState
from wavenet_tpu_torch.audio.io import write_wav
from wavenet_tpu_torch.audio.streaming import StreamingAudioDataset
from wavenet_tpu_torch.config import MelConfig, WaveNetConfig

torch.set_num_threads(1)

MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))


def cfg_(**kw):
    base = dict(num_blocks=1, max_dilation=8, residual_channels=8,
                skip_channels=8, batch_size=4, train_window=256,
                sample_rate=8000)
    base.update(kw)
    return WaveNetConfig(**base)


def _write_corpus(root, speakers: bool):
    rng = np.random.default_rng(0)
    for i in range(6):
        n = int(rng.integers(2000, 6000))
        t = np.arange(n) / 8000
        f = float(rng.uniform(100, 800))
        x = (0.4 * np.sin(2 * np.pi * f * t)).astype(np.float32)
        # two files at another rate: the header scan's resampled length
        rate = 16000 if i % 3 == 0 else 8000
        if rate != 8000:
            x = np.repeat(x, 2)
        sub = root / f"spk{i % 3}" if speakers else root
        write_wav(str(sub / f"c{i}.wav"), x, rate)
    # a clip shorter than every window: dropped at the scan
    write_wav(str(root / "short.wav"), np.zeros(100, np.float32), 8000)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("wavs")
    _write_corpus(root, speakers=False)
    return str(root)


@pytest.fixture(scope="module")
def speaker_corpus(tmp_path_factory):
    root = tmp_path_factory.mktemp("speakers")
    _write_corpus(root, speakers=True)
    return str(root)


def batches(ds, n, **kw):
    st = IteratorState(seed=0, step=0)
    out = []
    for _ in range(n):
        b, st = ds.sample_batch(st, **kw)
        out.append(b)
    return out


def test_matches_in_memory_dataset(corpus):
    cfg = cfg_()
    mem = AudioDataset.from_dir(corpus, cfg)
    stream = StreamingAudioDataset.from_dir(corpus, cfg, cache_clips=2)
    assert len(stream.paths) == 6
    for bm, bs in zip(batches(mem, 5), batches(stream, 5)):
        np.testing.assert_array_equal(bs["tokens"], bm["tokens"])


def test_matches_with_mel(corpus):
    cfg = cfg_(mel=MelConfig(**MEL))
    mem = AudioDataset.from_dir(corpus, cfg)
    stream = StreamingAudioDataset.from_dir(corpus, cfg, cache_clips=3)
    for bm, bs in zip(batches(mem, 3), batches(stream, 3)):
        np.testing.assert_array_equal(bs["tokens"], bm["tokens"])
        np.testing.assert_array_equal(bs["mel"], bm["mel"])


def test_cache_bounded(corpus):
    stream = StreamingAudioDataset.from_dir(corpus, cfg_(), cache_clips=2)
    batches(stream, 6)
    assert len(stream._cache) <= 2


def test_exact_resume(corpus):
    """A fresh dataset from a saved IteratorState repeats the stream."""
    cfg = cfg_()
    stream = StreamingAudioDataset.from_dir(corpus, cfg)
    st = IteratorState(seed=0, step=0)
    for _ in range(3):
        _, st = stream.sample_batch(st)
    want, _ = stream.sample_batch(st)
    got, _ = StreamingAudioDataset.from_dir(corpus, cfg).sample_batch(st)
    np.testing.assert_array_equal(got["tokens"], want["tokens"])


def test_prefetch_parity(corpus):
    cfg = cfg_()
    plain = StreamingAudioDataset.from_dir(corpus, cfg)
    pf = StreamingAudioDataset.from_dir(corpus, cfg, prefetch=3)
    pf.start_prefetch(IteratorState(seed=0, step=0))
    try:
        for bp, bq in zip(batches(plain, 6), batches(pf, 6)):
            np.testing.assert_array_equal(bq["tokens"], bp["tokens"])
    finally:
        pf.stop_prefetch()
    assert pf._pf_thread is None


def test_prefetch_resync_after_restore(corpus):
    """A jump of the state (a restore) resynchronises the prefetch: the
    jumped batch and the ones after it are right, and after the jump they
    come from the queue again."""
    cfg = cfg_()
    pf = StreamingAudioDataset.from_dir(corpus, cfg, prefetch=2)
    plain = StreamingAudioDataset.from_dir(corpus, cfg)
    pf.start_prefetch(IteratorState(seed=0, step=0))
    try:
        st = IteratorState(seed=0, step=7)
        for _ in range(3):
            got, nxt = pf.sample_batch(st)
            want, _ = plain.sample_batch(st)
            np.testing.assert_array_equal(got["tokens"], want["tokens"])
            st = nxt
        queued = pf._pf_queue.get(timeout=30)
        assert queued[0] in (st, st.next(), st.next().next())
    finally:
        pf.stop_prefetch()


def test_row_slicing_matches_global(corpus):
    """rows= assembles exactly that slice of the global batch, and a
    prefetch for one rank's rows gives them."""
    cfg = cfg_(global_classes=3)
    full_ds = StreamingAudioDataset.from_dir(corpus, cfg)
    part_ds = StreamingAudioDataset.from_dir(corpus, cfg)
    st = IteratorState(seed=0, step=4)
    full, _ = full_ds.sample_batch(st)
    lo, _ = part_ds.sample_batch(st, rows=slice(0, 2))
    hi, _ = part_ds.sample_batch(st, rows=slice(2, 4))
    for k in ("tokens", "speaker"):
        np.testing.assert_array_equal(np.concatenate([lo[k], hi[k]]),
                                      full[k], err_msg=k)
    part_ds.start_prefetch(st, rows=slice(2, 4))
    try:
        got, _ = part_ds.sample_batch(st, rows=slice(2, 4))
    finally:
        part_ds.stop_prefetch()
    np.testing.assert_array_equal(got["tokens"], hi["tokens"])


def test_trainer_runs_on_streaming(corpus):
    """The trainer takes a StreamingAudioDataset; its run equals the same
    run on the in-memory dataset bit for bit."""
    from wavenet_tpu_torch.training.trainer import Trainer
    cfg = cfg_(train_window=512, compute_dtype="float32")
    ds = StreamingAudioDataset.from_dir(corpus, cfg)
    tr = Trainer(cfg, ds, device="cpu")
    m = tr.run(num_steps=3, log_every=0)
    assert np.isfinite(m["loss"])
    ref = Trainer(cfg, AudioDataset.from_dir(corpus, cfg), device="cpu")
    m_ref = ref.run(num_steps=3, log_every=0)
    assert m["loss"] == m_ref["loss"]
    for k, v in tr.state.params.items():
        assert torch.equal(v, ref.state.params[k]), k


def _jcfg(cfg):
    kw = {f: getattr(cfg, f) for f in ("num_blocks", "max_dilation",
                                       "residual_channels", "skip_channels",
                                       "batch_size", "train_window",
                                       "sample_rate", "global_classes")}
    if cfg.mel is not None:
        kw["mel"] = jconfig.MelConfig(**MEL)
    return jconfig.WaveNetConfig(**kw)


@pytest.mark.parametrize("case", ["mel", "speakers"])
def test_port_equals_jax_streaming(corpus, speaker_corpus, case):
    """Port and JAX streaming datasets on one corpus: equal batches, key by
    key and bit for bit, for the global batch and each of two ranks' rows
    (mel: log-mel frames of clips at two rates; speakers: ids by
    subdirectory, and the in-memory datasets of both packages agree too)."""
    if case == "mel":
        root, cfg = corpus, cfg_(mel=MelConfig(**MEL))
    else:
        root, cfg = speaker_corpus, cfg_(global_classes=4)
    jc = _jcfg(cfg)
    port = StreamingAudioDataset.from_dir(root, cfg, cache_clips=3)
    ref = JStreaming.from_dir(root, jc, cache_clips=3)
    assert [p.split("/")[-1] for p in port.paths] == \
        [p.split("/")[-1] for p in ref.paths]
    if case == "speakers":
        np.testing.assert_array_equal(port.speakers, ref.speakers)
        # class 0 is the root's own clips ("" sorts first): the short one,
        # dropped at the scan
        assert sorted(set(port.speakers.tolist())) == [1, 2, 3]
        mem, jmem = AudioDataset.from_dir(root, cfg), \
            jds.AudioDataset.from_dir(root, jc)
    st = IteratorState(seed=2, step=5)
    for rows in (None, slice(0, 2), slice(2, 4)):
        for _ in range(2):
            a, st_next = port.sample_batch(st, rows=rows)
            b, _ = ref.sample_batch(jds.IteratorState(st.seed, st.step),
                                    rows=rows)
            assert sorted(a) == sorted(b)
            for k in a:
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            if case == "speakers" and rows is None:
                m, _ = mem.sample_batch(st)
                jm, _ = jmem.sample_batch(jds.IteratorState(st.seed, st.step))
                for k in a:
                    np.testing.assert_array_equal(a[k], m[k], err_msg=k)
                    np.testing.assert_array_equal(m[k], jm[k], err_msg=k)
            st = st_next
