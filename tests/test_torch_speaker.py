"""Speaker (global) conditioning in the port, against the JAX package on the
CPU: the gate offsets, the params, the weights carried across, the wide
decode with a speaker, the facade, the server's speaker rows and HTTP; and
the training half's entry points taking speaker ids (their numbers against
JAX are in tests/test_torch_speaker_train.py).

Tolerances: the offsets g = g_embed[speaker] @ v_global[l] are K = G sums
that the port takes exactly (f64, one rounding) and JAX in f32: rtol 1e-6.
The wide decode (R = 128) is held as tests/test_torch_decode.py holds it
(teacher-forced token agreement >= 99%, rings rtol = atol = 2e-2): its
K = 128 sums round differently in f32.  Inside the port batched == singleton
and stream == one-shot bit for bit.
"""

import io
import json
import threading
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.models.api import WaveNet as JWaveNet
from wavenet_tpu.ops import rng as jrng
from wavenet_tpu.ops.pallas import decode_wide as jwide
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.ops.cuda import decode_wide as twide
from wavenet_tpu_torch.serving import WaveNetServer
from wavenet_tpu_torch.serving.http import make_server
from wavenet_tpu_torch.utils.pytree_io import flatten_tree, params_from_numpy

torch.set_num_threads(1)

TOL = 2e-2
NARROW = dict(num_blocks=2, max_dilation=8, residual_channels=16,
              skip_channels=16, global_classes=5, global_channels=8)
WIDE = dict(num_blocks=1, max_dilation=8, residual_channels=128,
            skip_channels=128, global_classes=4)
RATE = 16000


def _setup(kw):
    jc, tc = jconfig.WaveNetConfig(**kw), tconfig.WaveNetConfig(**kw)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("kw", [NARROW, WIDE], ids=["narrow", "wide"])
def test_global_cond_offsets_match_jax(kw):
    jc, tc, jp, tp = _setup(kw)
    sp = np.array([0, 3, 1, 3], np.int32)
    want = np.asarray(jwn.global_cond_offsets(jp, jc, jnp.asarray(sp)))
    got = twn.global_cond_offsets(tp, tc, torch.from_numpy(sp))
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-9)
    # the kernels' layout gives the same offsets
    w = twide.flatten_params(tp, tc)
    assert torch.equal(twn.global_cond_offsets(w, tc, torch.from_numpy(sp)),
                       got)


def test_init_params_have_the_reference_speaker_shapes():
    jc, tc = jconfig.WaveNetConfig(**NARROW), tconfig.WaveNetConfig(**NARROW)
    got = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    want = jwn.init_params(jc, jax.random.PRNGKey(0))
    assert {k: tuple(v.shape) for k, v in got.items()} == \
        {k: tuple(v.shape) for k, v in want.items()}
    assert got["g_embed"].shape == (5, 8)
    assert got["v_global"].shape == (tc.num_layers, 8, 2, 16)
    assert float(got["g_embed"].std()) < 0.1             # N(0, 0.05^2)


def test_npz_carries_speaker_weights_both_ways(tmp_path):
    """A JAX export of a speaker model loads into the port with g_embed
    and v_global and decodes; the port's export loads back into JAX with
    the same arrays."""
    jc = jconfig.WaveNetConfig(**NARROW)
    jm = JWaveNet(jc).init(jax.random.PRNGKey(1))
    path = str(tmp_path / "spk.npz")
    jm.export_npz(path)
    tm = WaveNet.from_npz(path, device="cpu")
    assert tm.cfg == tconfig.WaveNetConfig(**NARROW)
    np.testing.assert_array_equal(tm.params["g_embed"].numpy(),
                                  np.asarray(jm.params["g_embed"]))
    np.testing.assert_array_equal(tm.params["v_global"].numpy(),
                                  np.asarray(jm.params["v_global"]))
    assert tm.generate(num_samples=8, speaker=[4]).shape == (1, 8)
    back = str(tmp_path / "back.npz")
    tm.export_npz(back)
    jb = JWaveNet.from_npz(back)
    assert jb.cfg == jc
    a, b = flatten_tree(jax.tree.map(np.asarray, jm.params)), \
        flatten_tree(jax.tree.map(np.asarray, jb.params))
    assert sorted(a) == sorted(b) and "g_embed" in a and "v_global" in a
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("mode", ["sampled", "primed"])
def test_wide_decode_with_speaker_matches_jax_kernel(mode):
    """decode_chunk_reference with g vs the JAX wide kernel with g
    (interpret mode), the port forced along the JAX trajectory."""
    jc, tc, jp, tp = _setup(WIDE)
    w = twide.flatten_params(tp, tc)
    B, N = 3, 48
    sp = np.array([3, 0, 2], np.int32)
    seeds_np = np.array(jrng.derive_row_seeds(jnp.int32(7), B))
    prime = None
    if mode == "primed":
        prime = np.random.RandomState(3).randint(0, 256, (B, 9)).astype(
            np.int32)
    rings, carry, s, g, P, total = jwide.setup_decode(
        jp, jc, jax.random.PRNGKey(0), B, N,
        prime_tokens=None if prime is None else jnp.asarray(prime),
        speaker=jnp.asarray(sp), seeds=jnp.asarray(seeds_np))
    total_pad = -(-total // 8) * 8
    jt, jr, _ = jwide.decode_chunk(
        jp, jc, rings, carry, jnp.int32(0), s, total_pad, 1.0,
        interpret=True, forced=None if prime is None else jnp.asarray(prime),
        g=g, force_tiles=(B, total_pad))
    jt = np.asarray(jt)
    forced = np.concatenate([np.asarray(carry)[:, :1], jt], axis=1)
    if prime is not None:
        forced[:, :P] = prime
    tr, tcarry, tseeds, tg, _, _ = twide.setup_decode(
        tc, B, N, seeds=torch.from_numpy(seeds_np), device="cpu", w=w,
        speaker=torch.from_numpy(sp))
    np.testing.assert_allclose(tg.numpy(), np.asarray(g).reshape(tg.shape),
                               rtol=1e-6, atol=1e-9)
    pt, pr, _ = twide.decode_chunk(
        w, tc, torch.from_numpy(np.array(jnp.asarray(rings).astype(
            jnp.float32))).to(torch.bfloat16),
        torch.from_numpy(np.array(carry)), 0, tseeds, total_pad, 1.0,
        forced=torch.from_numpy(forced).contiguous(), g=tg)
    assert (pt.numpy() == jt).mean() >= 0.99
    np.testing.assert_allclose(pr.float().numpy(),
                               np.array(jnp.asarray(jr).astype(jnp.float32)),
                               rtol=TOL, atol=TOL)
    # the speaker moves the trajectory
    other = twide.setup_decode(tc, B, N, seeds=0, device="cpu", w=w,
                               speaker=torch.tensor([1, 1, 1]))[3]
    assert not torch.equal(other, tg)


@pytest.fixture(scope="module")
def narrow_model():
    """A narrow speaker model whose speaker embeddings are scaled up (x40),
    so that at these short lengths another speaker changes the samples."""
    cfg = tconfig.WaveNetConfig(**NARROW)
    m = WaveNet(cfg).init(torch.Generator().manual_seed(2), "cpu")
    with torch.no_grad():
        m.g_embed.mul_(40.0)
    return m


def test_facade_generate_and_stream_with_speaker(narrow_model):
    """generate(speaker=) per row; stream == generate; a row depends on its
    own speaker only; a speaker model needs ids in range, and another
    model takes none."""
    m = narrow_model
    a = m.generate(num_samples=40, batch=3, speaker=[4, 0, 2], seeds=[1, 2, 3])
    s = np.concatenate(list(m.stream(num_samples=40, batch=3,
                                     speaker=[4, 0, 2], seeds=[1, 2, 3],
                                     chunk_samples=13)), axis=1)
    np.testing.assert_array_equal(s, mulaw.decode(a).numpy())
    alone = m.generate(num_samples=40, speaker=[0], seeds=[2])
    assert torch.equal(alone[0], a[1])
    other = m.generate(num_samples=40, speaker=[1], seeds=[2])
    assert not torch.equal(other[0], a[1])
    for bad, msg in (([5], "must lie in"), ([-1], "must lie in"),
                     (None, "no speaker ids"), ([0, 1], "ids for a batch")):
        with pytest.raises(ValueError, match=msg):
            m.generate(num_samples=4, speaker=bad)
    plain = WaveNet(tconfig.WaveNetConfig(
        num_blocks=1, max_dilation=2, residual_channels=16,
        skip_channels=16)).init(device="cpu")
    with pytest.raises(ValueError, match="no global conditioning"):
        plain.generate(num_samples=4, speaker=[0])


def test_speaker_training_loss_and_score_are_refused(narrow_model):
    """Training, loss and score of a speaker model are refused only
    without speaker ids (the reference's check): with ids the facade, the
    scan and the fused stack take them, the dataset carries them and the
    trainer trains on them; the fused stack is the training route."""
    from wavenet_tpu_torch.audio import dataset as tds
    from wavenet_tpu_torch.ops.cuda import train_stack as ts
    from wavenet_tpu_torch.training import trainer as ttrainer
    m, cfg = narrow_model, narrow_model.cfg
    toks = torch.randint(0, 256, (2, 33), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(4))
    sp = [4, 1]
    for call in (lambda: m.loss(toks), lambda: m.score(tokens=toks),
                 lambda: m.logits(toks[:, :-1]),
                 lambda: twn.loss_fn(m.params, cfg, toks, use_fused=True),
                 lambda: ts.forward_skip_fused(m.params, cfg,
                                               torch.zeros(2, 32, 16),
                                               tile=32)):
        with pytest.raises(ValueError, match="speaker ids|g is required"):
            call()
    scan = twn.loss_fn(m.params, cfg, toks, speaker=torch.tensor(sp))[0]
    fused = twn.loss_fn(m.params, cfg, toks, use_fused=True,
                        speaker=torch.tensor(sp))[0]
    assert float(m.loss(toks, speaker=sp)[0]) == float(scan)
    np.testing.assert_allclose(float(fused), float(scan), rtol=2e-3)
    assert m.score(tokens=toks, speaker=sp).shape == (2,)
    assert m.logits(toks[:, :-1], speaker=sp).shape == (2, 32, 256)
    small = cfg.replace(train_window=256, batch_size=2)
    ds = tds.AudioDataset([np.zeros(9000, np.float32)] * 3, small)
    assert ds.speakers.tolist() == [0, 1, 2]
    tr = ttrainer.Trainer(small, ds, device="cpu", params=m.params)
    assert tr.use_fused and ts.supported(cfg, 256)
    assert np.isfinite(tr.run(1, log_every=0)["loss"])


ENGINE = dict(max_batch=4, max_wait_ms=300.0, chunk_seconds=32 / RATE,
              length_quantum_seconds=64 / RATE)


def test_server_batches_speakers_and_replays(narrow_model, monkeypatch):
    """Requests of different speakers share one batch; each equals its
    singleton replay (server and facade); a request without a speaker and
    the pad row decode as speaker 0; bad ids are refused at submit."""
    m = narrow_model
    seen = []
    stream = m.stream

    def spy(*a, **k):
        seen.append(None if k.get("speaker") is None
                    else np.asarray(k["speaker"]).tolist())
        return stream(*a, **k)

    monkeypatch.setattr(m, "stream", spy)
    reqs = [dict(num_samples=50, seed=1, speaker=3),
            dict(num_samples=40, seed=1, speaker=1),
            dict(num_samples=60, seed=2)]
    with WaveNetServer(m, **ENGINE) as s:
        for kw, msg in ((dict(speaker=5), "out of range"),
                        (dict(speaker=-1), "out of range")):
            with pytest.raises(ValueError, match=msg):
                s.submit(num_samples=10, **kw)
        hs = [s.submit(**r) for r in reqs]
        got = [h.waveform() for h in hs]
        assert s.stats["requests"] == 3 and s.stats["batches"] == 1
        assert seen == [[3, 1, 0, 0]]
        alone = s.submit(**reqs[1]).waveform()
        s.warmup(seconds=8 / RATE)
        assert seen[-1] == [0, 0, 0, 0]
    np.testing.assert_array_equal(alone, got[1])
    assert not np.array_equal(got[0][:40], got[1])   # same seed, speakers
    for r, g in zip(reqs, got):
        assert g.shape == (r["num_samples"],)
        replay = np.concatenate(list(stream(
            num_samples=r["num_samples"], chunk_samples=23,
            seeds=[r["seed"]], speaker=[r.get("speaker", 0)])), axis=1)[0]
        np.testing.assert_array_equal(replay, g)


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, dict(r.headers), r.read()


def test_http_speaker_field(narrow_model):
    engine = WaveNetServer(narrow_model, **ENGINE)
    server = make_server(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        pcm = {}
        for spk in (2, 4):
            code, headers, data = _post(url + "/synthesize", {
                "num_samples": 48, "seed": 3, "speaker": spk})
            assert code == 200 and headers["Content-Type"] == "audio/wav"
            with wave.open(io.BytesIO(data)) as w:
                assert w.getnframes() == 48
                pcm[spk] = np.frombuffer(w.readframes(48), "<i2")
        assert not np.array_equal(pcm[2], pcm[4])
        code, headers, data = _post(url + "/synthesize", {
            "num_samples": 48, "seed": 3, "speaker": 2, "stream": True})
        assert code == 200
        np.testing.assert_array_equal(np.frombuffer(data, "<i2"), pcm[2])
        for bad in ({"num_samples": 8, "speaker": 5},
                    {"num_samples": 8, "speaker": "x"}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/synthesize", bad)
            assert e.value.code == 400
        with urllib.request.urlopen(url + "/info", timeout=60) as r:
            assert json.loads(r.read())["global_classes"] == 5
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    thread.join(timeout=30)
