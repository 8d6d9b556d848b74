"""The mel-conditioned slice as a whole, against the JAX package on the CPU:
decode with y, streaming, weights carried across, data, training, the
facade's vocode, and the server's mel lane.

Inputs come from numpy seeds; JAX's params carry over with
params_from_numpy or through export_npz.  The JAX wide kernel runs in
interpret mode, as its own tests run it.  Config: the JAX tests' mel config
(num_mels 8, hop 16, win 64, factors (4, 4)); decode on an R = 128 stack
with dilations 1..8 (the wide kernel's), training on R = 16.  Tolerances:
  * decode: teacher-forced token agreement >= 99% against JAX (the port
    sums each dot exactly in f64, XLA in f32, and a last-bit difference
    may flip a near-tie); logits and rings rtol = atol = 2e-2; inside the
    port chunked == one-shot and batched == singleton bit for bit;
  * data batches and resumed training: bit for bit;
  * training losses: rtol 2e-3 (the reference suite's loss band).
"""

import io
import json
import os
import threading
import urllib.error
import urllib.request
import wave

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.audio import dataset as jds
from wavenet_tpu.models import conditioning as jcond
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.models.api import WaveNet as JWaveNet
from wavenet_tpu.ops import rng as jrng
from wavenet_tpu.ops.pallas import decode_wide as jwide
from wavenet_tpu.training import trainer as jtrainer
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.generate.sampler import generate_auto, generate_stream
from wavenet_tpu_torch.models import conditioning as tcond
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.ops import rng as trng
from wavenet_tpu_torch.ops.cuda import decode_wide as twide
from wavenet_tpu_torch.serving import WaveNetServer
from wavenet_tpu_torch.serving.http import make_server
from wavenet_tpu_torch.training import trainer as ttrainer
from wavenet_tpu_torch.utils.pytree_io import flatten_tree, params_from_numpy

torch.set_num_threads(1)

TOL = 2e-2
MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
WIDE = dict(num_blocks=1, max_dilation=8, residual_channels=128,
            skip_channels=128)
MICRO = dict(num_blocks=2, max_dilation=8, residual_channels=16,
             skip_channels=16, batch_size=2, train_window=64,
             learning_rate=3e-3)
RATE = 16000


def _cfgs(base, **kw):
    kw = dict(base, **kw)
    return (jconfig.WaveNetConfig(mel=jconfig.MelConfig(**MEL), **kw),
            tconfig.WaveNetConfig(mel=tconfig.MelConfig(**MEL), **kw))


@pytest.fixture(scope="module")
def wide():
    jc, tc = _cfgs(WIDE)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _y(jp, jc, B, total, seed=2):
    """Upsampled features [B, total, M] (float32 numpy) of random frames,
    through the JAX upsampler."""
    frames = np.random.RandomState(seed).randn(
        B, -(-total // 16), 8).astype(np.float32) * 2.0
    return np.array(jcond.upsample_mel(jp["upsampler"], jc.mel,
                                       jnp.asarray(frames), total))


def _rings_np(r):
    return np.array(jnp.asarray(r).astype(jnp.float32))


def test_decode_step_with_cond_matches_jax(wide):
    """32 teacher-forced steps of decode_step with the per-step cond term
    (bf16 operands, as the reference kernels' tests build it)."""
    jc, tc, jp, tp = wide
    B, N = 2, 32
    y = _y(jp, jc, B, N)
    jcnd = jnp.einsum("btm,lmgr->btlgr", jnp.asarray(y).astype(jnp.bfloat16),
                      jp["v_cond"].astype(jnp.bfloat16),
                      preferred_element_type=jnp.float32)
    tcnd = tcond.project_cond(tp, torch.from_numpy(y))
    toks = np.random.RandomState(0).randint(0, 256, (B, N)).astype(np.int32)
    js, ts = jwn.decode_init(jc, B), twn.decode_init(tc, B, "cpu")
    step = jax.jit(lambda p, s, t, c: jwn.decode_step(p, jc, s, t, cond_t=c))
    for t in range(N):
        js, jl = step(jp, js, jnp.asarray(toks[:, t]), jcnd[:, t])
        ts, tl = twn.decode_step(tp, tc, ts, torch.from_numpy(toks[:, t]),
                                 cond_t=tcnd[:, t])
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=TOL,
                                   atol=TOL, err_msg=f"step {t}")
    np.testing.assert_allclose(ts.queues.float().numpy(),
                               _rings_np(js.queues), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("mode", ["greedy", "sampled", "primed"])
def test_decode_with_mel_matches_jax_kernel(wide, mode):
    """decode_chunk_reference with y vs the JAX wide kernel with y
    (interpret mode): the port is forced along the JAX trajectory and its
    own choices must agree on >= 99% of the steps."""
    jc, tc, jp, tp = wide
    w = twide.flatten_params(tp, tc)
    assert w["v_cond"].shape == (tc.num_layers, 8, 256)
    B, N = 3, 64
    temp = 0.0 if mode == "greedy" else 1.0
    seeds_np = np.array(jrng.derive_row_seeds(jnp.int32(7), B))
    prime = None
    if mode == "primed":
        prime = np.random.RandomState(3).randint(0, 256, (B, 9)).astype(
            np.int32)
    rings, carry, s, _, P, total = jwide.setup_decode(
        jp, jc, jax.random.PRNGKey(0), B, N,
        prime_tokens=None if prime is None else jnp.asarray(prime),
        seeds=jnp.asarray(seeds_np))
    total_pad = -(-total // 8) * 8
    y = _y(jp, jc, B, total_pad)
    jt, jr, _ = jwide.decode_chunk(
        jp, jc, rings, carry, jnp.int32(0), s, total_pad, temp,
        interpret=True, forced=None if prime is None else jnp.asarray(prime),
        y=jnp.asarray(y), force_tiles=(B, total_pad))
    jt = np.asarray(jt)
    forced = np.concatenate([np.asarray(carry)[:, :1], jt], axis=1)
    if prime is not None:
        forced[:, :P] = prime
    pt, pr, _ = twide.decode_chunk(
        w, tc, torch.from_numpy(_rings_np(rings)).to(torch.bfloat16),
        torch.from_numpy(np.array(carry)), 0, torch.from_numpy(seeds_np),
        total_pad, temp, forced=torch.from_numpy(forced).contiguous(),
        y=torch.from_numpy(y))
    agree = (pt.numpy() == jt).mean()
    assert agree >= 0.99, agree
    np.testing.assert_allclose(pr.float().numpy(), _rings_np(jr), rtol=TOL,
                               atol=TOL)
    if temp > 0:
        assert len(np.unique(jt)) > 8            # actually sampling


def test_mel_decode_chunked_equals_one_shot(wide):
    """y sliced per chunk: the stream concatenates to the one-shot
    generate, and the plain per-step loop (models/wavenet.generate with
    the projected cond timeline) gives the same tokens."""
    _, tc, jp, tp = wide
    jc = _cfgs(WIDE)[0]
    w = twide.flatten_params(tp, tc)
    B, N = 2, 40
    prime = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (B, 7)).astype(np.int32))
    y = torch.from_numpy(_y(jp, jc, B, N + 6 + 5))   # longer than needed
    want = generate_auto(w, tc, N, batch=B, prime_tokens=prime, seeds=3,
                         device="cpu", y=y)
    got = torch.cat(list(generate_stream(w, tc, N, chunk_samples=9, batch=B,
                                         prime_tokens=prime, seeds=3,
                                         device="cpu", y=y)), 1)
    assert got.shape == (B, N) and torch.equal(got, want)
    frames = torch.from_numpy(np.random.RandomState(4).randn(
        B, 4, 8).astype(np.float32))
    assert torch.equal(
        tcond.prepare_decode_cond(tp, tc, frames, 50),
        tcond.project_cond(tp, tcond.upsample_mel(tp["upsampler"], tc.mel,
                                                  frames, 50)))
    cond = tcond.project_cond(tp, y)
    assert torch.equal(twn.generate(tp, tc, N, batch=B, prime_tokens=prime,
                                    seeds=trng.as_row_seeds(3, B),
                                    device="cpu", cond=cond), want)
    with pytest.raises(ValueError, match="covers"):
        generate_auto(w, tc, N, batch=B, prime_tokens=prime, device="cpu",
                      y=y[:, :N])
    with pytest.raises(ValueError, match="needs y"):
        generate_auto(w, tc, N, batch=B, device="cpu")


@pytest.mark.parametrize("seed,step", [(0, 0), (3, 11)])
def test_dataset_mel_batches_bit_identical(seed, step):
    jc, tc = _cfgs(MICRO, seed=seed)
    jd = jds.AudioDataset.synthetic(jc, num_clips=3, clip_seconds=0.05)
    td = tds.AudioDataset.synthetic(tc, num_clips=3, clip_seconds=0.05)
    jb, _ = jd.sample_batch(jds.IteratorState(seed=seed, step=step))
    tb, _ = td.sample_batch(tds.IteratorState(seed=seed, step=step))
    assert sorted(tb) == ["mel", "tokens"] == sorted(jb)
    for k in tb:
        assert tb[k].dtype == jb[k].dtype and tb[k].shape == jb[k].shape
        np.testing.assert_array_equal(tb[k], jb[k])
    assert tb["mel"].shape == (2, 64 // 16, 8)


def _port_losses(ttr, n):
    seen = []
    last = ttr.run(n, log_every=1, log_fn=lambda _: None,
                   metrics_fn=lambda s, m: seen.append(m["loss"]))
    return seen + [last["loss"]]


def test_trainer_with_mel_matches_jax_and_resumes_exactly(tmp_path):
    """Three fused training steps on mel batches (upsampler and v_cond
    train) against a JAX loop of the fused loss and the reference's
    optimizer; then a resume from step 2 repeats step 3 bit for bit."""
    jc, tc = _cfgs(MICRO, warmup_steps=1)
    td = tds.AudioDataset.synthetic(tc, num_clips=2, clip_seconds=0.05)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    d = str(tmp_path / "ckpt")
    ttr = ttrainer.Trainer(
        tc, td, device="cpu", checkpoint_dir=d,
        params=params_from_numpy(jax.tree.map(np.asarray, jp), "cpu"))
    assert ttr.use_fused and "upsampler/w1" in ttr.state.params
    tx = jtrainer.make_optimizer(jc)
    st = tx.init(jp)
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, t, m: jwn.loss_fn(p, jc, t, mel=m, use_fused=True,
                                    interpret=True)[0]))
    it, want = tds.IteratorState(jc.seed, 0), []
    for _ in range(3):
        batch, it = td.sample_batch(it)
        loss, g = grad_fn(jp, jnp.asarray(batch["tokens"]),
                          jnp.asarray(batch["mel"]))
        updates, st = tx.update(g, st, jp)
        jp = optax.apply_updates(jp, updates)
        want.append(float(loss))
    seen = []
    two = ttr.run(2, log_every=1, checkpoint_every=2, log_fn=lambda _: None,
                  metrics_fn=lambda s, m: seen.append(m["loss"]))
    three = ttr.run(1, log_every=1, log_fn=lambda _: None)
    np.testing.assert_allclose(seen + [two["loss"], three["loss"]], want,
                               rtol=2e-3)
    again = ttrainer.Trainer(tc, td, device="cpu", checkpoint_dir=d)
    again.restore(step=2)
    again.run(1, log_every=0)
    for k in ttr.state.params:
        assert torch.equal(again.state.params[k], ttr.state.params[k]), k


def test_npz_carries_mel_weights_both_ways(tmp_path):
    """A JAX export_npz of a mel model loads into the port (nested
    upsampler included) and computes the same logits; the port's export
    loads back into JAX unchanged."""
    jc, tc = _cfgs(MICRO)
    jm = JWaveNet(jc).init(jax.random.PRNGKey(1))
    path = str(tmp_path / "mel.npz")
    jm.export_npz(path)
    tm = WaveNet.from_npz(path, device="cpu")
    assert tm.cfg == tc and set(tm.params["upsampler"]) == {
        "w0", "b0", "w1", "b1"}
    toks = np.random.RandomState(4).randint(0, 256, (2, 48)).astype(np.int32)
    mel = np.random.RandomState(5).randn(2, 3, 8).astype(np.float32)
    want = np.asarray(jm.logits(jnp.asarray(toks), mel=jnp.asarray(mel)))
    got = tm.logits(toks, mel=mel).numpy()
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    back = str(tmp_path / "back.npz")
    tm.export_npz(back)
    jb = JWaveNet.from_npz(back)
    assert jb.cfg == jc
    a, b = flatten_tree(jax.tree.map(np.asarray, jm.params)), \
        flatten_tree(jax.tree.map(np.asarray, jb.params))
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])


def test_facade_vocode_and_mel_inputs(wide):
    """generate(mel=) == generate(y=) on the upsampled timeline, stream
    with mel == generate, vocode is generate on the clip's log-mel
    frames, and an unconditional use of a mel model is refused."""
    from wavenet_tpu_torch.audio.mel import log_mel
    _, tc, _, tp = wide
    m = WaveNet(tc, tp)
    mel = np.random.RandomState(6).randn(2, 4, 8).astype(np.float32)
    a = m.generate(num_samples=50, batch=2, mel=mel, seed=4)
    y = tcond.upsample_mel(tp["upsampler"], tc.mel, torch.from_numpy(mel), 50)
    assert torch.equal(m.generate(num_samples=50, batch=2, y=y, seed=4), a)
    s = np.concatenate(list(m.stream(num_samples=50, batch=2, mel=mel,
                                     chunk_samples=16, seed=4)), axis=1)
    np.testing.assert_array_equal(s, mulaw.decode(a).numpy())
    clip = (0.3 * np.sin(np.arange(40) * 0.2)).astype(np.float32)
    v = m.vocode(clip, seed=2)
    frames = log_mel(clip, RATE, tc.mel)
    assert v.shape == (1, frames.shape[0] * 16)
    assert torch.equal(v, m.generate(num_samples=v.shape[1],
                                     mel=frames[None], seed=2))
    with pytest.raises(ValueError, match="needs y"):
        m.generate(num_samples=8)


def _mel_model():
    _, tc = _cfgs(WIDE)
    return WaveNet(tc).init(torch.Generator().manual_seed(2), "cpu")


ENGINE = dict(max_batch=4, max_wait_ms=300.0, chunk_seconds=64 / RATE,
              length_quantum_seconds=64 / RATE)


def test_server_mel_batched_equals_singleton_replay():
    """Mel requests of different lengths batch; each reply equals the
    request replayed alone (server and facade) bit for bit."""
    model = _mel_model()
    rs = np.random.RandomState(7)
    reqs = [dict(num_samples=100, seed=1, mel=rs.randn(7, 8)),
            dict(num_samples=70, seed=2, mel=rs.randn(5, 8)),
            dict(num_samples=120, seed=3, mel=rs.randn(8, 8))]
    with WaveNetServer(model, **ENGINE) as s:
        hs = [s.submit(**r) for r in reqs]
        got = [h.waveform() for h in hs]
        assert s.stats["batches"] == 1 and s.stats["padded_rows"] == 1
        alone = s.submit(**reqs[1]).waveform()
        primed = s.submit(num_samples=40, seed=5, mel=rs.randn(4, 8),
                          prime=np.linspace(-0.5, 0.5, 9)).waveform()
    np.testing.assert_array_equal(alone, got[1])
    assert primed.shape == (40,)
    for r, g in zip(reqs, got):
        assert g.shape == (r["num_samples"],)
        replay = np.concatenate(list(model.stream(
            num_samples=r["num_samples"], chunk_samples=37,
            seeds=[r["seed"]], mel=np.asarray(r["mel"], np.float32)[None])),
            axis=1)[0]
        np.testing.assert_array_equal(replay, g)


def test_server_refuses_bad_mel_at_submit():
    model = _mel_model()
    with WaveNetServer(model, **ENGINE) as s:
        for kw, msg in ((dict(mel=np.zeros((4, 7))), "frames, 8"),
                        (dict(mel=np.zeros((2, 4, 8))), "frames, 8"),
                        (dict(mel=np.zeros((3, 8))), "exceeds"),
                        (dict(mel=np.full((9, 8), np.nan)), "non-finite"),
                        (dict(), "needs mel")):
            with pytest.raises(ValueError, match=msg):
                s.submit(num_samples=60, **kw)
        with pytest.raises(ValueError, match="priming"):
            s.submit(num_samples=60, mel=np.zeros((4, 8)),
                     prime=np.zeros(10))
        assert s.stats["requests"] == 0
        s.warmup(seconds=32 / RATE)               # rows carrying zero mel
        assert s.stats["batches"] == 3


def _post(url, body):
    req = urllib.request.Request(url, data=json.dumps(body).encode())
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, dict(r.headers), r.read()


def test_http_accepts_mel():
    model = _mel_model()
    engine = WaveNetServer(model, **ENGINE)
    server = make_server(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        mel = np.random.RandomState(8).randn(6, 8).astype(np.float32)
        code, headers, data = _post(url + "/synthesize", {
            "num_samples": 80, "seed": 3, "mel": mel.tolist()})
        assert code == 200 and headers["Content-Type"] == "audio/wav"
        with wave.open(io.BytesIO(data)) as w:
            assert w.getnframes() == 80
            pcm = np.frombuffer(w.readframes(80), "<i2")
        import base64
        code, headers, data = _post(url + "/synthesize", {
            "num_samples": 80, "seed": 3, "stream": True,
            "mel_b64": base64.b64encode(mel.astype("<f4").tobytes()).decode()})
        assert code == 200 and headers["X-Num-Samples"] == "80"
        np.testing.assert_array_equal(np.frombuffer(data, "<i2"), pcm)
        for bad in ({"num_samples": 80, "seed": 3},
                    {"num_samples": 200, "mel": mel.tolist()},
                    {"num_samples": 8, "mel": [[0.0] * 7]}):
            with pytest.raises(urllib.error.HTTPError) as e:
                _post(url + "/synthesize", bad)
            assert e.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        engine.close()
    thread.join(timeout=30)


def test_train_cli_full_vocoder_and_checkpoint_vocode(tmp_path):
    """--preset full_vocoder --synthetic (cut to 4 layers and a 512-sample
    window on the CPU) trains on mel batches, checkpoints the nested
    upsampler as flat leaves, and the checkpoint vocodes."""
    from wavenet_tpu_torch import train
    ckpt = str(tmp_path / "ckpt")
    m = train.main(["--preset", "full_vocoder", "--synthetic", "--steps", "2",
                    "--device", "cpu", "--batch-size", "1", "--log-every",
                    "1", "--override", "num_blocks=1", "--override",
                    "max_dilation=8", "--override", "train_window=512",
                    "--ckpt", ckpt, "--ckpt-every", "2"])
    assert np.isfinite(m["loss"])
    raw = torch.load(os.path.join(ckpt, "ckpt_00000002.pt"),
                     weights_only=True)
    assert "upsampler/w2" in raw["params"] and "v_cond" in raw["params"]
    model = WaveNet.from_checkpoint(ckpt, device="cpu")
    assert model.cfg.mel == tconfig.MelConfig()
    toks = model.vocode(np.zeros(200, np.float32))
    assert toks.shape == (1, 256)
    assert int(toks.min()) >= 0 and int(toks.max()) < 256
