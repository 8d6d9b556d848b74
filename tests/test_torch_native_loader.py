"""The port's native data loader (wavenet_tpu_torch/cpp/loader.py, which
builds the root cpp/fastloader.cpp) against the NumPy mirrors and against
the JAX package's loader: mu-law encode and decode and the window gather
bit for bit, under every FP rounding mode, at 1 and 4 threads, with bounds
checked; the port's AudioDataset with the native gatherer equal to its
NumPy loop and to the JAX AudioDataset bit for bit (tokens, mel frames,
speaker ids); a failed build raises (no quiet fallback)."""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest

from wavenet_tpu import config as jconfig
from wavenet_tpu.audio import dataset as jds
from wavenet_tpu.audio import mulaw as jmulaw
from wavenet_tpu.cpp import loader as jloader
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.cpp import loader
from wavenet_tpu_torch.utils import compcache

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_library_builds_beside_the_port_kernels():
    assert loader.available()
    assert loader.library_path() == loader._ROOT / "build" / \
        "wavenet_tpu_torch" / "fastloader.so"
    assert str(loader.library_path()) != str(jloader._SO)
    assert loader.SRC.samefile(jloader._SRC)


def test_mulaw_encode_bit_identical():
    x = np.random.RandomState(0).uniform(-1.2, 1.2, 100000).astype(np.float32)
    edges = np.array([-1.0, -0.5, 0.0, 1e-8, -1e-8, 0.5, 1.0], np.float32)
    for v in (x, edges, x.reshape(100, 1000)):
        got = loader.mulaw_encode(v)
        assert got.shape == v.shape and got.dtype == np.int32
        np.testing.assert_array_equal(got, mulaw.encode_np(v))
        np.testing.assert_array_equal(got, jmulaw.encode_np(v))
        np.testing.assert_array_equal(got, jloader.mulaw_encode(v))


def test_mulaw_decode_bit_identical():
    q = np.arange(256, dtype=np.int32)
    for qc in (256, 64):
        got = loader.mulaw_decode(q[:qc], qc)
        np.testing.assert_array_equal(got, mulaw.decode_np(q[:qc], qc))
        np.testing.assert_array_equal(got, jloader.mulaw_decode(q[:qc], qc))


def test_mulaw_encode_independent_of_fp_rounding_mode():
    """The encode rounds half-even explicitly: the process's FP rounding
    mode changes no bit."""
    x = np.concatenate([
        np.random.RandomState(2).uniform(-1, 1, 50000).astype(np.float32),
        mulaw.decode_np(np.arange(256, dtype=np.int32)),   # bin centers
    ])
    ref = mulaw.encode_np(x)
    libm = ctypes.CDLL("libm.so.6")
    FE_TONEAREST, FE_DOWNWARD, FE_UPWARD = 0x0, 0x400, 0x800
    try:
        for mode in (FE_DOWNWARD, FE_UPWARD, FE_TONEAREST):
            libm.fesetround(mode)
            np.testing.assert_array_equal(loader.mulaw_encode(x), ref)
    finally:
        libm.fesetround(FE_TONEAREST)


def test_round_trip():
    x = np.random.RandomState(1).uniform(-1, 1, 4096).astype(np.float32)
    y = loader.mulaw_decode(loader.mulaw_encode(x))
    assert np.max(np.abs(x - y)) < 0.025


@pytest.mark.parametrize("threads", [1, 4])
def test_gather_windows(threads):
    """Past 1 MiB of output the gather runs on `threads` threads; both
    sizes equal the slices and the JAX package's gatherer."""
    rng = np.random.RandomState(2)
    clips = [rng.randint(0, 256, rng.randint(5000, 9000)).astype(np.int32)
             for _ in range(5)]
    g, jg = loader.WindowGatherer(clips), jloader.WindowGatherer(clips)
    for B, W in ((16, 300), (64, 4200)):
        idx = rng.randint(0, 5, B).astype(np.int32)
        starts = np.array([rng.randint(0, len(clips[i]) - W) for i in idx],
                          np.int64)
        out = g.gather(idx, starts, W, num_threads=threads)
        for b in range(B):
            np.testing.assert_array_equal(
                out[b], clips[idx[b]][starts[b]:starts[b] + W])
        np.testing.assert_array_equal(out, jg.gather(idx, starts, W,
                                                     num_threads=threads))


def test_gather_bounds_checked():
    """The library checks no bounds; the wrapper refuses an index out of
    range and a window past its clip, and takes the windows that end on a
    clip's last sample."""
    clips = [np.arange(100, dtype=np.int32), np.arange(50, dtype=np.int32)]
    g = loader.WindowGatherer(clips)
    for ci, s in ((2, 0), (-1, 0), (1, 40), (0, -1)):
        with pytest.raises(IndexError):
            g.gather(np.array([ci], np.int32), np.array([s], np.int64), 16)
    with pytest.raises(ValueError, match="1-D"):
        g.gather(np.array([0, 1], np.int32), np.array([0], np.int64), 16)
    out = g.gather(np.array([1, 0], np.int32), np.array([34, 84], np.int64),
                   16)
    np.testing.assert_array_equal(out[0], clips[1][34:50])
    np.testing.assert_array_equal(out[1], clips[0][84:100])


MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))


def _cfgs(case):
    kw = dict(num_blocks=1, max_dilation=8, residual_channels=8,
              skip_channels=8, batch_size=5, train_window=256, seed=3)
    if case == "speaker":
        kw.update(global_classes=3)
    if case == "mel":
        return (jconfig.WaveNetConfig(mel=jconfig.MelConfig(**MEL), **kw),
                tconfig.WaveNetConfig(mel=tconfig.MelConfig(**MEL), **kw))
    return jconfig.WaveNetConfig(**kw), tconfig.WaveNetConfig(**kw)


@pytest.mark.parametrize("case", ["plain", "mel", "speaker"])
def test_dataset_native_equals_numpy_and_jax(case):
    """AudioDataset(native=True) == native=False == the JAX AudioDataset
    (which gathers natively too) on the same clips and IteratorStates,
    bit for bit, for every key of the batch."""
    jc, tc = _cfgs(case)
    rng = np.random.default_rng(5)
    clips = [rng.uniform(-0.5, 0.5, n).astype(np.float32)
             for n in (300, 900, 257, 2000, 100)]         # one is too short
    speakers = [2, 0, 1, 1, 0] if case == "speaker" else None
    native = tds.AudioDataset(clips, tc, speakers=speakers)
    plain = tds.AudioDataset(clips, tc, speakers=speakers, native=False)
    ref = jds.AudioDataset(clips, jc, speakers=speakers)
    assert native._gatherer is not None and plain._gatherer is None
    assert ref._gatherer is not None
    for st in (tds.IteratorState(0, 0), tds.IteratorState(1, 7),
               tds.IteratorState(4, 123)):
        a, na = native.sample_batch(st)
        b, nb = plain.sample_batch(st)
        c, _ = ref.sample_batch(jds.IteratorState(st.seed, st.step))
        assert na == nb == st.next()
        assert sorted(a) == sorted(b) == sorted(c)
        for k in a:
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
            np.testing.assert_array_equal(a[k], np.asarray(c[k]), err_msg=k)
        half, _ = native.sample_batch(st, batch_size=2)
        assert half["tokens"].shape == (2, tc.train_window + 1)


def test_failed_build_raises(tmp_path, monkeypatch):
    """A source that does not compile raises with g++'s message, from the
    library and from AudioDataset(native=True); native=False needs no
    library."""
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(loader, "SRC", bad)
    monkeypatch.setattr(loader, "library_path",
                        lambda: tmp_path / "fastloader.so")
    monkeypatch.setattr(compcache, "_loaded", None)
    monkeypatch.setattr(loader, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        loader.library()
    assert not loader.available()
    cfg = _cfgs("plain")[1]
    clips = [np.zeros(400, np.float32)]
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tds.AudioDataset(clips, cfg)
    assert tds.AudioDataset(clips, cfg, native=False)._gatherer is None
    assert not list(tmp_path.glob("*.tmp"))


def test_library_that_does_not_load_is_rebuilt(tmp_path, monkeypatch):
    """A library file newer than its source that does not load (built for
    another platform, or corrupt) is rebuilt once, then works."""
    so = tmp_path / "fastloader.so"
    so.write_bytes(b"not an ELF file")
    monkeypatch.setattr(loader, "library_path", lambda: so)
    monkeypatch.setattr(compcache, "_loaded", None)
    monkeypatch.setattr(loader, "_lib", None)
    x = np.linspace(-1, 1, 33, dtype=np.float32)
    np.testing.assert_array_equal(loader.mulaw_encode(x), mulaw.encode_np(x))
    assert so.read_bytes()[:4] == b"\x7fELF"


def test_concurrent_first_builds(tmp_path):
    """Three processes building the library at once into one path all load
    a whole one (each compiles to its own temp name, then renames)."""
    so = tmp_path / "fastloader.so"
    code = ("import sys; from pathlib import Path; "
            "from wavenet_tpu_torch.cpp import loader; "
            "from wavenet_tpu_torch.utils import compcache; "
            "compcache.enable(str(Path(sys.argv[1]).parent)); "
            "import numpy as np; "
            "q = loader.mulaw_encode(np.linspace(-1, 1, 9, dtype=np.float32));"
            "print(q.tolist())")
    procs = [subprocess.Popen([sys.executable, "-c", code, str(so)], cwd=ROOT,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True) for _ in range(3)]
    outs = [p.communicate(timeout=60) for p in procs]
    assert all(p.returncode == 0 for p in procs), outs
    want = str(mulaw.encode_np(np.linspace(-1, 1, 9,
                                           dtype=np.float32)).tolist())
    assert all(o.strip() == want for o, _ in outs)
    assert so.exists() and not list(tmp_path.glob("*.tmp"))
