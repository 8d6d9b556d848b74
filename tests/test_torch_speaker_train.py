"""Speaker-conditioned training in the port against the JAX package on the
CPU: the scan and fused losses with every gradient (g_embed and v_global
included), the written-out backward's dg, the group plan with the speaker
term, the corpus's speaker ids and batches, the trainer with exact resume,
the facade and the train CLI on a speaker corpus.

Inputs come from numpy seeds; JAX's params carry over with
params_from_numpy.  The reference's fused stack runs in Pallas interpret
mode.  Tolerances are the reference suite's bands
(tests/test_pallas_train.py:96-103): losses rtol 2e-3, the forward
atol 5e-3 / rtol 1e-3, each gradient within 2e-2 of its largest element;
batches and resumed runs bit for bit.  The gradients of g_embed and
v_global agree only to about a bf16 ulp: the port's offsets g are exact
f64 sums of bf16 operands (models/wavenet._dot), whose cotangent is
rounded to bf16 on the way back, as JAX's bf16 einsum rounds it.  Two f32
summation orders of the same bf16-rounded recipe can round a near-tie of
h or x differently and then part ways; the token seed here gives no such
tie at these sizes.
"""

import json
import os
import wave

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.audio import dataset as jds
from wavenet_tpu.audio.io import list_wavs as jlist_wavs
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.models.api import WaveNet as JWaveNet
from wavenet_tpu.ops.pallas import train_stack as jts
from wavenet_tpu.training import trainer as jtrainer
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.audio.io import list_wavs
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.ops.cuda import train_stack as tts
from wavenet_tpu_torch.training import trainer as ttrainer
from wavenet_tpu_torch.utils.pytree_io import flatten_tree, params_from_numpy

torch.set_num_threads(1)

MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
SPK = dict(num_blocks=1, max_dilation=8, residual_channels=16,
           skip_channels=16, global_classes=5, global_channels=8)
T = 64
IDS = np.array([3, 1, 3], np.int32)          # speaker 3 twice in one batch


def _cfgs(mel=False, **kw):
    kw = dict(SPK, **kw)
    if mel:
        return (jconfig.WaveNetConfig(mel=jconfig.MelConfig(**MEL), **kw),
                tconfig.WaveNetConfig(mel=tconfig.MelConfig(**MEL), **kw))
    return jconfig.WaveNetConfig(**kw), tconfig.WaveNetConfig(**kw)


def _params(jc):
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    return jp, jax.tree.map(np.asarray, jp)


def _trainable(npp):
    """Port params whose leaves (nested upsampler included) need grads;
    returns (nested params, flat '/'-joined leaves)."""
    tp = params_from_numpy(npp, "cpu")
    flat = flatten_tree(tp)
    for v in flat.values():
        v.requires_grad_(True)
    return tp, flat


def _assert_grads(jg, flat, grads, band=2e-2):
    jflat = flatten_tree(jax.tree.map(np.asarray, jg))
    assert sorted(jflat) == sorted(flat)
    for k, g in zip(flat, grads):
        a = np.asarray(jflat[k], np.float32)
        scale = max(np.abs(a).max(), 1e-3)
        np.testing.assert_allclose(g.detach().numpy() / scale, a / scale,
                                   atol=band, err_msg=k)


def _tokens(B, n, seed=3):
    return np.random.RandomState(seed).randint(0, 256, (B, n)).astype(
        np.int32)


def _loss_case(mel: bool, fused: bool):
    """loss_fn(speaker=) and every gradient, port against JAX (the fused
    path in interpret mode on the JAX side)."""
    jc, tc = _cfgs(mel)
    jp, npp = _params(jc)
    toks = _tokens(len(IDS), T + 1)
    jkw = {"speaker": jnp.asarray(IDS)}
    tkw = {"speaker": torch.from_numpy(IDS)}
    if mel:
        frames = np.random.RandomState(3).randn(len(IDS), T // 16, 8).astype(
            np.float32)
        jkw["mel"], tkw["mel"] = jnp.asarray(frames), torch.from_numpy(frames)
    (jl, _), jg = jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, jnp.asarray(toks), use_fused=fused,
                              interpret=fused, **jkw), has_aux=True)(jp)
    tp, flat = _trainable(npp)
    tl, _ = twn.loss_fn(tp, tc, torch.from_numpy(toks), use_fused=fused,
                        **tkw)
    tg = torch.autograd.grad(tl, list(flat.values()))
    assert "g_embed" in flat and "v_global" in flat
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=2e-3)
    _assert_grads(jg, flat, tg)


@pytest.mark.parametrize("mel", [False, True], ids=["speaker", "mel_speaker"])
def test_scan_loss_with_speaker_matches_jax(mel):
    _loss_case(mel, fused=False)


@pytest.mark.parametrize("mel", [False, True], ids=["speaker", "mel_speaker"])
def test_fused_loss_with_speaker_matches_jax(mel, monkeypatch):
    """The fused stack's speaker variant (with and without mel) on a plan
    of several groups (a shrunken budget on both sides), so g is sliced
    per group and dg summed back over the groups."""
    jc, tc = _cfgs(mel)
    TT = tts.pick_tile(tc, T)
    budget = max(max(tts._group_sizes(tc, TT, tc.dilations[l:l + 2]))
                 for l in range(0, 3))
    monkeypatch.setattr(tts, "VMEM_BUDGET", budget)
    monkeypatch.setattr(jts, "VMEM_BUDGET", budget)
    plan = tts.group_plan(tc, TT)
    assert len(plan) >= 2 and plan == jts.group_plan(jc, TT), plan
    _loss_case(mel, fused=True)


def _bf_st(x):
    """bf16 rounding with a straight-through (identity) gradient."""
    return x + (x.to(torch.bfloat16).float() - x).detach()


@pytest.mark.parametrize("mel", [False, True], ids=["speaker", "mel_speaker"])
def test_group_bwd_reference_dg_matches_autograd(mel):
    """The written-out backward with g (and y) against autograd of a
    straight-through copy of the plain forward (its products summed
    exactly, `_mm`, so the copy's skip equals the plain forward's bit for
    bit): dg [B, Lg, 2R], each row's sum of dz over time, and the other
    gradients beside it."""
    R, S, M, B = 16, 16, 8, 3
    dils = (1, 2, 4, 8, 1)
    Lg = len(dils)
    rs = np.random.RandomState(6)
    t = lambda *s, sc=1.0: torch.from_numpy(
        (rs.randn(*s) * sc).astype(np.float32))
    raw = [t(Lg, R, 2, R, sc=0.3), t(Lg, R, 2, R, sc=0.3), t(Lg, 2, R, sc=0.1),
           t(Lg, R, R, sc=0.3), t(Lg, R, sc=0.1), t(Lg, R, S, sc=0.3),
           t(Lg, S, sc=0.1)]
    vc = t(Lg, M, 2, R, sc=0.3) if mel else None
    ops = tts.prep_weights(*raw, vc)
    x = t(B, T, R).to(torch.bfloat16).float()
    skip = t(B, T, S, sc=0.1)
    y = t(B, T, M).to(torch.bfloat16) if mel else None
    g = t(B, Lg, 2 * R, sc=0.5)
    dskip, dxout = t(B, T, S), t(B, T, R)
    wz = ops[0].float().requires_grad_(True)
    b = ops[1].clone().requires_grad_(True)
    wrs = ops[2].float().requires_grad_(True)
    bres = ops[3].clone().requires_grad_(True)
    gl = g.clone().requires_grad_(True)
    xin = x.clone().requires_grad_(True)
    carry, sk = xin, skip
    for l, d in enumerate(dils):
        xb = _bf_st(carry)
        z = tts._mm(torch.cat([xb, tts._causal(xb, d)], -1), wz[l]) + b[l]
        if mel:
            z = z + tts._mm(y.float(), ops[5][l])
        z = z + gl[:, l, None]
        h = _bf_st(torch.tanh(z[..., :R]) * torch.sigmoid(z[..., R:]))
        o = tts._mm(h, wrs[l])
        carry = (carry + o[..., :R]) + bres[l]
        sk = (sk + o[..., R:]) + ops[4][l]
    loss = (sk * dskip).sum() + (_bf_st(carry) * dxout).sum()
    want = torch.autograd.grad(loss, [xin, wz, b, wrs, bres, gl])
    fs, _, xs = tts.group_fwd_reference(x, skip, ops, dils, y, g)
    torch.testing.assert_close(fs, sk.detach(), rtol=0, atol=0)
    got = tts.group_bwd_reference(xs, dskip, dxout, ops, dils, y, g)
    assert len(got) == (9 if mel else 7)
    for name, a, w in zip(("dx", "dwz", "db", "dwrs", "dbres", "dg"),
                          got[:5] + got[-1:], want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-4 * float(w.abs().max()),
                                   err_msg=name)


# (preset, overrides, the reference's plan at T = 8192 with 109 speakers)
PLANS = {
    # the widths the kernels take, where the g block moves the boundaries
    "full_vocoder_r64_s512": ("full_vocoder", dict(residual_channels=64,
                                                   skip_channels=512),
                              [(0, 18), (18, 36), (36, 40)]),
    "full_s512": ("full", dict(skip_channels=512),
                  [(0, 7), (7, 13), (13, 19), (19, 25), (25, 31), (31, 38),
                   (38, 40)]),
    **{p: (p, {}, None) for p in sorted(tconfig.PRESETS)},
}


@pytest.mark.parametrize("case", list(PLANS))
def test_group_plan_with_speakers_matches_reference(case):
    """The planner counts the speaker's g block (8 Lg R bytes forward,
    twice backward), as the reference does: the same groups at T = 8192
    for every preset with 109 speakers, and for two configurations whose
    groups the speaker term moves."""
    preset, kw, want = PLANS[case]
    kw = dict(kw, global_classes=109)
    jc = jconfig.get_config(preset).replace(**kw)
    tc = tconfig.get_config(preset).replace(**kw)
    TT = tts.pick_tile(tc, 8192)
    assert TT == jts.pick_tile(jc, 8192)
    assert tts.supported(tc, 8192) == jts.supported(jc, 8192)
    plan = tts.group_plan(tc, TT)
    assert plan == jts.group_plan(jc, TT)
    if want is not None:
        assert plan == want
        assert tts.group_plan(tc.replace(global_classes=None), TT) != want
    # the kernels take every one: R = 128, S = 512 with backward blocks of
    # 32 rows (64 would need 240 KiB of shared memory), the rest at 64
    assert tts.kernel_supported(tc)
    R, S = tc.residual_channels, tc.skip_channels
    nm = 0 if tc.mel is None else tc.mel.num_mels
    assert tts.bwd_rows(R, S, nm) == (32 if case == "full_s512" else 64)


def _write_wav(path, n, seed):
    pcm = (np.random.RandomState(seed).uniform(-0.4, 0.4, n) * 32767
           ).astype("<i2")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with wave.open(str(path), "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(16000)
        w.writeframes(pcm.tobytes())


def _corpus(root):
    """root/<speaker>/*.wav with one clip directly under the root."""
    for i, rel in enumerate(("loose.wav", "p226/a.wav", "p225/b.wav",
                             "p225/c.wav", "p227/d.wav")):
        _write_wav(os.path.join(root, rel), 300 + 40 * i, i)
    return str(root)


def test_speakers_from_dir_and_batches_match_jax(tmp_path):
    """Ids by sorted top-level subdirectory (the loose clip takes 0);
    speaker batches bit-identical to JAX's, from a corpus and from
    synthetic clips (the clip index mod N); the range checks."""
    root = _corpus(tmp_path / "corpus")
    jc, tc = _cfgs(batch_size=6, train_window=128, global_classes=4)
    paths = list_wavs(root)
    assert paths == jlist_wavs(root)
    ids = tds.speakers_from_dir(root, paths, tc)
    assert ids == jds.speakers_from_dir(root, paths, jc)
    want = {"loose.wav": 0, "a.wav": 2, "b.wav": 1, "c.wav": 1, "d.wav": 3}
    assert ids == [want[os.path.basename(p)] for p in paths]
    assert tds.speakers_from_dir(root, paths,
                                 tc.replace(global_classes=None)) is None
    with pytest.raises(ValueError, match="global_classes=3"):
        tds.speakers_from_dir(root, paths, tc.replace(global_classes=3))

    for tdset, jdset in (
            (tds.AudioDataset.from_dir(root, tc),
             jds.AudioDataset.from_dir(root, jc)),
            (tds.AudioDataset.synthetic(tc, num_clips=6, clip_seconds=0.05),
             jds.AudioDataset.synthetic(jc, num_clips=6, clip_seconds=0.05))):
        np.testing.assert_array_equal(tdset.speakers, jdset.speakers)
        for step in (0, 3):
            tb, _ = tdset.sample_batch(tds.IteratorState(7, step))
            jb, _ = jdset.sample_batch(jds.IteratorState(7, step))
            assert sorted(tb) == sorted(jb) == ["speaker", "tokens"]
            for k in tb:
                assert tb[k].dtype == jb[k].dtype == np.int32
                np.testing.assert_array_equal(tb[k], jb[k])
    assert tdset.speakers.tolist() == [0, 1, 2, 3, 0, 1]
    clip = np.zeros(200, np.float32)
    for bad in ([4], [-1]):
        with pytest.raises(ValueError, match="out of range"):
            tds.AudioDataset([clip], tc, speakers=bad)
    with pytest.raises(ValueError, match="align"):
        tds.AudioDataset([clip], tc, speakers=[0, 1])


# three clips of two speakers, batches of four rows: every batch repeats
# a speaker
TRAIN = dict(batch_size=4, train_window=64, learning_rate=3e-3,
             global_classes=2)


def test_trainer_with_speakers_matches_jax_trainer():
    """fused_stack=False: both trainers take the scan path on the CPU."""
    jc, tc = _cfgs(fused_stack=False, grad_clip_norm=1.0, **TRAIN)
    jd = jds.AudioDataset.synthetic(jc, num_clips=3, clip_seconds=0.05)
    td = tds.AudioDataset.synthetic(tc, num_clips=3, clip_seconds=0.05)
    jtr = jtrainer.Trainer(jc, jd)
    p0 = params_from_numpy(jax.tree.map(np.asarray, jtr.state.params), "cpu")
    ttr = ttrainer.Trainer(tc, td, device="cpu", params=p0)
    assert not ttr.use_fused and "g_embed" in ttr.state.params
    want, got = [], []
    jtr.run(3, log_every=1, log_fn=lambda _: None,
            metrics_fn=lambda s, m: want.append(m["loss"]))
    ttr.run(3, log_every=1, log_fn=lambda _: None,
            metrics_fn=lambda s, m: got.append(m["loss"]))
    np.testing.assert_allclose(got, want, rtol=1e-3)
    assert not torch.equal(ttr.state.params["g_embed"], p0["g_embed"])


def test_speaker_training_resumes_bit_for_bit(tmp_path):
    """The fused path (plain versions on the CPU): a run resumed from its
    step-2 checkpoint ends with the uninterrupted run's params bit for
    bit, g_embed and v_global included, and its eval matches."""
    _, tc = _cfgs(ema_decay=0.5, **TRAIN)
    d = str(tmp_path / "ckpt")

    def trainer():
        ds = tds.AudioDataset.synthetic(tc, num_clips=3, clip_seconds=0.05)
        return ttrainer.Trainer(tc, ds, checkpoint_dir=d, device="cpu")

    a = trainer()
    assert a.use_fused
    a.run(4, log_every=0, checkpoint_every=2)
    b = trainer()
    b.restore(step=2)
    b.run(2, log_every=0)
    for k in ("g_embed", "v_global", "w_cur", "head_w2"):
        assert torch.equal(a.state.params[k], b.state.params[k]), k
    for k in a.state.params:
        assert torch.equal(a.state.params[k], b.state.params[k]), k
        assert torch.equal(a.state.ema[k], b.state.ema[k]), k
    assert a.evaluate(num_batches=1) == b.evaluate(num_batches=1)


def test_facade_loss_score_logits_with_speaker(tmp_path):
    """WaveNet.loss/score/logits(speaker=) of a JAX export against the JAX
    facade; ids are required with classes, range-checked, and refused by
    a model without classes."""
    jc = jconfig.WaveNetConfig(**SPK)
    jm = JWaveNet(jc).init(jax.random.PRNGKey(1))
    path = str(tmp_path / "spk.npz")
    jm.export_npz(path)
    tm = WaveNet.from_npz(path, device="cpu")
    toks = _tokens(len(IDS), T + 1)
    jl, _ = jm.loss(jnp.asarray(toks), speaker=jnp.asarray(IDS))
    tl, _ = tm.loss(toks, speaker=IDS)
    np.testing.assert_allclose(float(tl), float(jl), rtol=2e-3)
    js = np.asarray(jm.score(tokens=jnp.asarray(toks), speaker=IDS))
    ts = tm.score(tokens=toks, speaker=IDS.tolist())
    assert ts.shape == (len(IDS),)
    np.testing.assert_allclose(ts.numpy(), js, rtol=2e-3)
    jlog = np.asarray(jm.logits(jnp.asarray(toks[:, :-1]),
                                speaker=jnp.asarray(IDS)))
    tlog = tm.logits(toks[:, :-1], speaker=IDS).numpy()
    np.testing.assert_allclose(tlog, jlog, atol=5e-3, rtol=1e-3)
    other = tm.score(tokens=toks, speaker=[0, 0, 0])
    assert not torch.equal(other, ts)
    for call, msg in ((lambda: tm.loss(toks), "no speaker ids"),
                      (lambda: tm.score(tokens=toks, speaker=[0, 1, 5]),
                       "must lie in"),
                      (lambda: tm.logits(toks, speaker=[-1, 0, 0]),
                       "must lie in")):
        with pytest.raises(ValueError, match=msg):
            call()
    plain = WaveNet(tconfig.WaveNetConfig(
        num_blocks=1, max_dilation=2, residual_channels=16,
        skip_channels=16)).init(device="cpu")
    with pytest.raises(ValueError, match="no global conditioning"):
        plain.loss(toks, speaker=IDS)


def test_train_cli_on_a_speaker_corpus(tmp_path):
    """python -m wavenet_tpu_torch.train --data root/<speaker>/
    --override global_classes=N: trains (cut down, on the CPU), writes
    the classes into params.json, and the checkpoint scores and decodes
    per speaker."""
    from wavenet_tpu_torch import train
    root = _corpus(tmp_path / "corpus")
    ckpt = str(tmp_path / "ckpt")
    m = train.main(["--preset", "tiny", "--data", root, "--steps", "2",
                    "--device", "cpu", "--override", "train_window=128",
                    "--override", "global_classes=4", "--batch-size", "2",
                    "--log-every", "0", "--ckpt", ckpt])
    assert np.isfinite(m["loss"])
    with open(os.path.join(ckpt, "params.json")) as f:
        assert json.load(f)["global_classes"] == 4
    model = WaveNet.from_checkpoint(ckpt, device="cpu")
    assert model.cfg.global_classes == 4
    toks = _tokens(2, 129)
    assert model.score(tokens=toks, speaker=[1, 3]).shape == (2,)
    out = model.generate(num_samples=8, batch=2, speaker=[1, 3])
    assert out.shape == (2, 8)
