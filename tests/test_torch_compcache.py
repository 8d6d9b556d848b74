"""The port's kernel build cache (wavenet_tpu_torch/utils/compcache.py),
mirroring tests/test_compcache.py's cache tests (its JAX-only
decode_unroll cases have no counterpart: the port's decode is one kernel
launch, not an unrolled scan).

The port's cache is the directory its native libraries build into and load
from: the nvcc-built kernel libraries (ops/cuda/build.py) and the g++-built
fastloader.so (cpp/loader.py).  Checked here without nvcc: g++ builds the
loader into an enabled directory, the CUDA libraries' paths resolve there,
a second directory is refused once a library was loaded, and the three
CLIs take --compile-cache [DIR].  Each test starts from a process state
with nothing enabled or loaded, restored afterwards.
"""

import argparse
import os

import numpy as np
import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch import serve, train
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.cpp import loader
from wavenet_tpu_torch.generate import __main__ as tgenerate
from wavenet_tpu_torch.models import api as tapi
from wavenet_tpu_torch.ops.cuda import build
from wavenet_tpu_torch.utils import compcache

torch.set_num_threads(1)


@pytest.fixture
def fresh(monkeypatch):
    """Nothing enabled, no library loaded, no cache variable set."""
    monkeypatch.delenv("WAVENET_TPU_COMPILE_CACHE", raising=False)
    monkeypatch.setattr(compcache, "_enabled", None)
    monkeypatch.setattr(compcache, "_loaded", None)
    monkeypatch.setattr(loader, "_lib", None)
    monkeypatch.setattr(build, "_libs", {})
    return monkeypatch


def test_default_dir_is_todays_build_dir(fresh):
    want = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "build", "wavenet_tpu_torch")
    assert compcache.default_dir() == want
    assert str(compcache.build_dir()) == want
    assert compcache.enabled_dir() is None
    assert loader.library_path() == compcache.build_dir() / "fastloader.so"


def test_cache_variable_names_the_default(fresh, tmp_path):
    fresh.setenv("WAVENET_TPU_COMPILE_CACHE", str(tmp_path / "env"))
    assert compcache.default_dir() == str(tmp_path / "env")
    assert compcache.build_dir() == tmp_path / "env"
    assert compcache.enable() == str(tmp_path / "env")
    assert (tmp_path / "env").is_dir()


def test_compilation_cache_persists_to_disk(fresh, tmp_path):
    """enable(DIR) makes the native loader build fastloader.so into DIR
    with g++, and a second process state reuses it without a build."""
    d = str(tmp_path / "cache")
    assert compcache.enable(d) == os.path.abspath(d)
    assert compcache.enabled_dir() == os.path.abspath(d)
    x = np.linspace(-1, 1, 33, dtype=np.float32)
    np.testing.assert_array_equal(loader.mulaw_encode(x), mulaw.encode_np(x))
    so = tmp_path / "cache" / "fastloader.so"
    assert so.read_bytes()[:4] == b"\x7fELF"
    assert os.listdir(d) == ["fastloader.so"]
    built = so.stat().st_mtime_ns
    fresh.setattr(loader, "_lib", None)
    np.testing.assert_array_equal(loader.mulaw_decode(np.arange(9)),
                                  mulaw.decode_np(np.arange(9)))
    assert so.stat().st_mtime_ns == built            # reused, not rebuilt


def test_cuda_library_paths_resolve_under_the_cache(fresh, tmp_path):
    """Checked without nvcc: each kernel library's path is in the enabled
    directory, tagged with the sources' hash."""
    compcache.enable(str(tmp_path))
    for name in ("decode", "decode_wide", "train_stack", "probes"):
        so = build._library_path(name)
        assert so == tmp_path / f"lib{name}-{build.sources_hash()}.so"
    assert len(build.sources_hash()) == 16


def test_enable_after_a_load_raises(fresh, tmp_path):
    a, b = str(tmp_path / "a"), str(tmp_path / "b")
    compcache.enable(a)
    compcache.enable(b)                  # nothing loaded yet: allowed
    loader.library()
    assert compcache.build_dir() == tmp_path / "b"
    assert compcache.enable(b) == b      # the same directory again is fine
    with pytest.raises(RuntimeError, match="already loaded from"):
        compcache.enable(a)
    with pytest.raises(RuntimeError, match="after others"):
        compcache.mark_loaded(tmp_path / "a")
    assert compcache.build_dir() == tmp_path / "b"
    assert compcache.enabled_dir() == b


def test_compile_cache_cli_flag(fresh, tmp_path):
    p = argparse.ArgumentParser()
    compcache.add_cli_flag(p)
    # absent -> not enabled
    assert compcache.enable_from_args(p.parse_args([])) is None
    assert compcache.enabled_dir() is None
    # with a value -> that directory
    d = str(tmp_path / "cli_cache")
    got = compcache.enable_from_args(p.parse_args(["--compile-cache", d]))
    assert got == os.path.abspath(d) and os.path.isdir(d)
    # bare flag -> the default directory
    fresh.setenv("WAVENET_TPU_COMPILE_CACHE", str(tmp_path / "dflt"))
    assert compcache.enable_from_args(
        p.parse_args(["--compile-cache"])) == str(tmp_path / "dflt")


@pytest.mark.parametrize("cli", ["generate", "serve", "train"])
def test_compile_cache_parses_on_every_cli(cli, tmp_path):
    head = {"generate": (tgenerate.parse_args, ["--ckpt", "x"]),
            "serve": (serve.parse_args, ["--npz", "m.npz"]),
            "train": (train.parse_args, [])}
    parse, argv = head[cli]
    argv = argv + ["--device", "cpu"]
    assert parse(argv).compile_cache is None
    assert parse(argv + ["--compile-cache"]).compile_cache == ""
    d = str(tmp_path / "c")
    assert parse(argv + ["--compile-cache", d]).compile_cache == d


def test_generate_cli_enables_and_prints_the_cache(fresh, tmp_path,
                                                    capsys):
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=4,
                                residual_channels=8, skip_channels=8)
    ck = str(tmp_path / "ck")
    tapi.WaveNet(cfg).init(device="cpu").save(ck)
    d = str(tmp_path / "cache")
    toks = tgenerate.main(["--ckpt", ck, "--seconds", "0.001", "--out",
                           str(tmp_path / "o.wav"), "--device", "cpu",
                           "--compile-cache", d])
    assert toks.shape == (1, 16)
    assert f"kernel build cache: {d}" in capsys.readouterr().out
    assert compcache.enabled_dir() == d and compcache.build_dir() == \
        tmp_path / "cache"
