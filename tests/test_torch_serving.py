"""Port serving vs the JAX package's serving, on the CPU.

Both servers load one JAX export_npz file and serve the same requests with
the same seeds; the JAX server decodes through its wide kernel in interpret
mode, the port's through the plain PyTorch version of its CUDA kernel.
The engines bucket lengths and chunk at 64 samples here (the 0.5 s
defaults would bucket every request to 8000 interpreted steps).  Per
request, the mu-law token agreement must be >= 99% (the port and XLA round
the last bit of a dot product differently, which may flip a near-tie);
inside the port, a co-batched reply equals its singleton replay bit for bit.
"""

import io
import json
import threading
import urllib.error
import urllib.request
import wave

import jax
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models.api import WaveNet as JWaveNet
from wavenet_tpu.ops.pallas import decode as jpdec
from wavenet_tpu.serving.server import WaveNetServer as JWaveNetServer
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.serving import WaveNetServer
from wavenet_tpu_torch.serving.http import make_server

torch.set_num_threads(1)

RATE = 16000
Q64 = 64 / RATE                       # 64-sample chunks and length buckets
ENGINE = dict(max_batch=4, max_wait_ms=300.0, chunk_seconds=Q64,
              length_quantum_seconds=Q64)


@pytest.fixture(scope="module")
def npz(tmp_path_factory):
    cfg = jconfig.WaveNetConfig(num_blocks=1, max_dilation=8,
                                residual_channels=128, skip_channels=128)
    path = str(tmp_path_factory.mktemp("serve") / "wide.npz")
    JWaveNet(cfg).init(jax.random.PRNGKey(0)).export_npz(path)
    return path


def _serve(server, reqs):
    handles = [server.submit(**r) for r in reqs]
    return [h.waveform() for h in handles]


def test_port_server_matches_jax_server(npz, monkeypatch):
    # the JAX server routes this small R=128 model to its narrow kernel;
    # make it take the wide kernel, the one the port replaces
    monkeypatch.setattr(jpdec, "fits_vmem", lambda *a, **k: False)
    prime = (0.4 * np.sin(np.arange(20) * 0.3)).astype(np.float32)
    reqs = [dict(num_samples=100, seed=5), dict(num_samples=90, seed=6),
            dict(num_samples=128, seed=7, temperature=1.0),
            dict(num_samples=70, seed=8, prime=prime)]
    with JWaveNetServer(JWaveNet.from_npz(npz), **ENGINE) as js:
        want = _serve(js, reqs)
    with WaveNetServer(WaveNet.from_npz(npz, device="cpu"), **ENGINE) as ts:
        got = _serve(ts, reqs)
        assert ts.stats["requests"] == 4 and ts.stats["samples_out"] == 388
    for r, a, b in zip(reqs, want, got):
        assert a.shape == b.shape == (r["num_samples"],)
        assert b.dtype == np.float32 and np.abs(b).max() <= 1.0
        # equal bin centers <=> equal mu-law tokens (one shared table)
        assert (a == b).mean() >= 0.99, r


def test_port_cobatched_reply_equals_singleton_replay(npz):
    model = WaveNet.from_npz(npz, device="cpu")
    reqs = [dict(num_samples=100, seed=1), dict(num_samples=80, seed=2),
            dict(num_samples=120, seed=3)]
    with WaveNetServer(model, **ENGINE) as s:
        got = _serve(s, reqs)
        assert s.stats["batches"] == 1 and s.stats["padded_rows"] == 1
        alone = s.submit(num_samples=80, seed=2).waveform()
    np.testing.assert_array_equal(alone, got[1])
    for r, g in zip(reqs, got):
        replay = np.concatenate(list(model.stream(
            num_samples=r["num_samples"], chunk_samples=37,
            seeds=[r["seed"]])), axis=1)[0]
        np.testing.assert_array_equal(replay, g)
    assert not np.array_equal(got[0][:80], got[1])


def _get(url):
    with urllib.request.urlopen(url, timeout=120) as r:
        return r.status, json.loads(r.read())


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, dict(r.headers), r.read()


def test_port_http_endpoints(npz):
    model = WaveNet.from_npz(npz, device="cpu")
    engine = WaveNetServer(model, **ENGINE)
    server = make_server(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        assert _get(url + "/healthz") == (200, {"ok": True})
        code, info = _get(url + "/info")
        assert code == 200 and info["sample_rate"] == RATE
        assert info["receptive_field"] == model.cfg.receptive_field
        assert info["mel"] is False

        code, headers, data = _post(url + "/synthesize",
                                    {"num_samples": 96, "seed": 4})
        assert code == 200 and headers["Content-Type"] == "audio/wav"
        with wave.open(io.BytesIO(data)) as w:
            assert (w.getnchannels(), w.getsampwidth(), w.getframerate(),
                    w.getnframes()) == (1, 2, RATE, 96)
            pcm = np.frombuffer(w.readframes(96), "<i2")

        code, headers, data = _post(url + "/synthesize", {
            "num_samples": 96, "seed": 4, "stream": True})
        assert code == 200 and headers["Content-Type"] == "audio/L16"
        assert headers["X-Num-Samples"] == "96"
        np.testing.assert_array_equal(np.frombuffer(data, "<i2"), pcm)

        for bad in ({"seconds": 0.01, "speaker": 1},
                    {"seconds": 0.01, "mel": [[0.0] * 80]},
                    {"num_samples": -3}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/synthesize", bad)
            assert e.value.code == 400
        with pytest.raises(urllib.error.HTTPError) as e:
            _post(url + "/nope", {})
        assert e.value.code == 404
        assert engine.stats["samples_out"] == 192
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    thread.join(timeout=30)
    assert not thread.is_alive()
