"""The port's WaveNetServer over a (data, model) mesh on the CPU: one
two-process gloo run (tests/_torch_mesh_worker.serve_ranks) in which rank
0 serves and rank 1 follows (WaveNetServer.follow), the counterparts of
the reference's tests/test_serving.py:590 (mesh mode) and :626
(the conditioned lane does not block the batchable one).

  * Three requests share one microbatch padded to a bucket that is a
    multiple of the data axis (padded_rows as in the reference), on the
    kernel fan-out (2, 1) and on the collective loop (1, 2).
  * Every response equals its single-device singleton replay
    (WaveNet.generate(batch=1, seeds=[seed])) bit for bit: batchable,
    primed, mel (each rank upsamples only its own rows' frames) and
    speaker requests.
  * A long primed request on the conditioned lane streams while short
    batchable requests, submitted after it, finish first, on the kernel
    fan-out (2, 1) and on the collective loop (1, 2): the lanes issue
    their collectives on their own groups, concurrently and without a
    deadlock (with one group for both lanes, the loop's per-layer
    all-reduces of two batch sizes mix, and the run fails).  Every wait
    in the ranks has a timeout.
"""

import json
import os

import numpy as np
import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.utils.pytree_io import flatten_tree, params_to_numpy

import _torch_dp_worker as dpw
import _torch_mesh_worker as worker

torch.set_num_threads(1)

RATE = 8000
Q32 = 32 / RATE                        # 32-sample chunks and length buckets
BASE = dict(num_blocks=1, max_dilation=8, residual_channels=16,
            skip_channels=16, sample_rate=RATE)
MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
MODELS = {
    "plain": dict(BASE),
    "mel": dict(BASE, mel=MEL),
    "speaker": dict(BASE, global_classes=5, global_channels=8),
}
ENGINE = dict(max_batch=4, max_wait_ms=2000.0, chunk_seconds=Q32,
              length_quantum_seconds=Q32)
PAD_REQS = [dict(num_samples=32, seed=4), dict(num_samples=24, seed=9),
            dict(num_samples=32, seed=2)]
_rs = np.random.RandomState(8)
MEL_FRAMES = [_rs.randn(3, 8).astype(np.float32).tolist(),
              _rs.randn(2, 8).astype(np.float32).tolist()]
PRIME = (_rs.rand(9).astype(np.float32) * 2 - 1).tolist()
LONG = 640                             # the conditioned lane's request
CASES = {
    "pad_dp": dict(model="plain", layout=[2, 1], server=ENGINE,
                   requests=PAD_REQS),
    "pad_mp": dict(model="plain", layout=[1, 2], server=ENGINE,
                   requests=PAD_REQS),
    "mel_dp": dict(model="mel", layout=[2, 1], server=ENGINE, requests=[
        dict(num_samples=32, seed=4, mel=MEL_FRAMES[0]),
        dict(num_samples=24, seed=9, mel=MEL_FRAMES[1])]),
    "mel_mp": dict(model="mel", layout=[1, 2], server=ENGINE, requests=[
        dict(num_samples=24, seed=5, mel=MEL_FRAMES[1]),
        dict(num_samples=32, seed=1, mel=MEL_FRAMES[0])]),
    "speaker_mp": dict(model="speaker", layout=[1, 2], server=ENGINE,
                       requests=[dict(num_samples=32, seed=3, speaker=4),
                                 dict(num_samples=32, seed=3, speaker=1),
                                 dict(num_samples=24, seed=6)]),
    # the long primed request first, then short batchable ones: on the
    # collective loop each layer's all-reduce has the lane's batch in its
    # shape, so two lanes sharing one group would mix or stall
    "lanes": dict(model="plain", layout=[2, 1], stagger_s=0.05,
                  server=dict(ENGINE, max_wait_ms=1.0),
                  requests=[dict(num_samples=LONG, seed=2, prime=PRIME),
                            dict(num_samples=32, seed=2)]),
    "lanes_mp": dict(model="plain", layout=[1, 2], stagger_s=0.05,
                     server=dict(ENGINE, max_wait_ms=1.0),
                     requests=[dict(num_samples=LONG, seed=3, prime=PRIME),
                               dict(num_samples=32, seed=5),
                               dict(num_samples=32, seed=6)]),
}


def _model(name):
    kw = dict(MODELS[name])
    if "mel" in kw:
        kw["mel"] = tconfig.MelConfig(**kw["mel"])
    cfg = tconfig.WaveNetConfig(**kw)
    params = twn.init_params(cfg, torch.Generator().manual_seed(
        list(MODELS).index(name)), "cpu")
    return WaveNet(cfg, params)


@pytest.fixture(scope="module")
def served(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_serve"))
    models = {}
    for name in MODELS:
        m = models[name] = _model(name)
        with open(os.path.join(d, f"{name}.json"), "w") as f:
            json.dump({"cfg": m.cfg.to_json()}, f)
        np.savez(os.path.join(d, f"{name}_params.npz"),
                 **flatten_tree(params_to_numpy(m.params)))
        np.savez(os.path.join(d, f"{name}_in.npz"))
    with open(os.path.join(d, "serve.json"), "w") as f:
        json.dump(CASES, f)
    dpw.run_ranks(worker.serve_ranks, d, timeout=120, store_dir=d)
    with np.load(os.path.join(d, "serve_out.npz")) as z:
        return models, dict(z)


def _replay(model, req) -> np.ndarray:
    """The request decoded alone on one device."""
    kw = {}
    if "mel" in req:
        kw["mel"] = np.asarray(req["mel"], np.float32)[None]
    if "prime" in req:
        kw["prime_tokens"] = mulaw.encode_np(
            np.asarray(req["prime"], np.float32),
            model.cfg.quantization_channels)[None]
    if "speaker" in req or model.cfg.global_classes is not None:
        kw["speaker"] = [req.get("speaker", 0)]
    toks = model.generate(num_samples=req["num_samples"],
                          seeds=[req["seed"]], **kw)
    return mulaw.decode(toks, model.cfg.quantization_channels
                        ).numpy()[0].astype(np.float32)


@pytest.mark.parametrize("case", list(CASES))
def test_mesh_responses_equal_singleton_replays(served, case):
    models, out = served
    spec = CASES[case]
    for i, req in enumerate(spec["requests"]):
        got = out[f"{case}/wave{i}"]
        assert got.shape == (req["num_samples"],)
        np.testing.assert_array_equal(got, _replay(models[spec["model"]],
                                                   req), err_msg=f"req {i}")


@pytest.mark.parametrize("case", ["pad_dp", "pad_mp"])
def test_mesh_bucket_pads_to_the_data_axis(served, case):
    """Three requests pad to the 4-row bucket (a multiple of dp = 2 on the
    fan-out; of dp = 1 on the collective loop): one batch, one pad row."""
    _, out = served
    assert int(out[f"{case}/batches"]) == 1
    assert int(out[f"{case}/padded_rows"]) == 1
    assert int(out[f"{case}/requests"]) == 3


def test_mesh_mel_rows_share_a_batch(served):
    _, out = served
    for case in ("mel_dp", "mel_mp"):
        assert int(out[f"{case}/batches"]) == 1, case


@pytest.mark.parametrize("case", ["lanes", "lanes_mp"])
def test_conditioned_lane_does_not_block_batchable(served, case):
    """The short batchable requests, submitted after the long primed one,
    finish first: the lanes decode concurrently over the mesh (on the
    kernel fan-out and on the collective loop)."""
    _, out = served
    done = out[f"{case}/done"]
    assert max(done[1:]) < done[0]
    assert int(out[f"{case}/batches"]) >= 2


# ---------------------------------------------------------------------------
# the CLIs under torchrun (two gloo ranks on the CPU)
# ---------------------------------------------------------------------------

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CLI_TIMEOUT_S = 120


def _torchrun(args, **kw):
    import subprocess
    import sys
    return subprocess.Popen(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", *args], cwd=ROOT, text=True,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, **kw)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("mesh_cli") / "ck")
    _model("plain").save(d)
    return d


@pytest.mark.parametrize("axis", ["--data-parallel", "--model-parallel"])
def test_generate_cli_over_the_mesh(ckpt, tmp_path, axis):
    """`torchrun ... -m wavenet_tpu_torch.generate` over two ranks writes
    (on rank 0 only) the single-process CLI's wavs, byte for byte."""
    from wavenet_tpu_torch.generate import __main__ as generate
    common = ["--ckpt", ckpt, "--seconds", "0.004", "--batch", "4",
              "--seed", "7", "--device", "cpu"]
    generate.main(common + ["--out", str(tmp_path / "one.wav")])
    p = _torchrun(["-m", "wavenet_tpu_torch.generate", *common, "--out",
                   str(tmp_path / "mesh.wav"), axis, "2"])
    out, _ = p.communicate(timeout=CLI_TIMEOUT_S)
    assert p.returncode == 0, out[-3000:]
    route = "decode" if axis == "--data-parallel" else "collective loop"
    assert out.count(f"route {route})") == 2, out[-3000:]
    for i in range(4):
        with open(tmp_path / f"one_{i}.wav", "rb") as a, \
                open(tmp_path / f"mesh_{i}.wav", "rb") as b:
            assert a.read() == b.read(), i
    assert out.count("wrote ") == 1, out[-3000:]        # rank 0 only


def test_serve_cli_over_the_mesh(ckpt):
    """`torchrun ... -m wavenet_tpu_torch.serve --data-parallel 2`: rank 0
    answers over HTTP with the single process's audio, rank 1 follows, and
    an interrupt of rank 0 ends both ranks cleanly."""
    import signal
    import urllib.request
    import wave
    p = _torchrun(["-m", "wavenet_tpu_torch.serve", "--ckpt", ckpt,
                   "--device", "cpu", "--data-parallel", "2", "--port",
                   "0", "--chunk-seconds", str(Q32),
                   "--length-quantum-seconds", str(Q32)])
    try:
        lines = []
        for line in p.stdout:
            lines.append(line)
            if line.startswith("serving "):
                break
        head = lines[-1]
        assert head.startswith("serving "), "".join(lines)[-3000:]
        url = head.split(" on ", 1)[1].split(" ", 1)[0]
        req = urllib.request.Request(
            url + "/synthesize", data=json.dumps(
                {"num_samples": 40, "seed": 7}).encode())
        with urllib.request.urlopen(req, timeout=CLI_TIMEOUT_S) as r:
            import io
            with wave.open(io.BytesIO(r.read())) as w:
                pcm = np.frombuffer(w.readframes(w.getnframes()), "<i2")
        os.kill(int(head.rsplit("pid ", 1)[1].split(",")[0]), signal.SIGINT)
        out, _ = p.communicate(timeout=CLI_TIMEOUT_S)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
    assert p.returncode == 0, out[-3000:]
    model = WaveNet.from_checkpoint(ckpt, device="cpu")
    want = (np.clip(_replay(model, dict(num_samples=40, seed=7)), -1, 1)
            * 32767.0).astype("<i2")
    np.testing.assert_array_equal(pcm, want)
