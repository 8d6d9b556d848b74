"""The port's command-line entry points against the JAX package's, on the
CPU at micro widths: `python -m wavenet_tpu_torch.generate`,
`python -m wavenet_tpu_torch.score`, the train CLI's --sample-every and
--profile-dir, and the serve CLI's --step / --no-ema.

The JAX params are carried into the port with params_from_numpy and saved
by each package's facade (an orbax directory for JAX, a torch.save one
for the port).  Tolerances:
  * generate: tokens equal the JAX package's generate_wav(...,
    seeds=as_row_seeds(7, 2)) token for token, and the wav files byte for
    byte (the JAX scan sums in f32, the port exactly; at these widths no
    sampled token sits on a tie); --stream and --naive equal the one-shot
    fast path exactly;
  * score: chunked equals one pass of score_fn within 1e-5 bits per
    sample, and the JAX score.main within 1e-3 (the reference's own
    tolerance, tests/test_train.py test_score_cli_exact_chunking);
  * train: losses and params with and without sampling and tracing bit
    for bit.
"""

import json
import os
import wave

import jax
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.generate import sampler as jsampler
from wavenet_tpu.models import api as japi
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.ops import rng as jrng
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch import serve, train
from wavenet_tpu_torch import score as tscore
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.audio.io import read_wav, write_wav
from wavenet_tpu_torch.generate import __main__ as tgenerate
from wavenet_tpu_torch.generate import sampler as tsampler
from wavenet_tpu_torch.models import api as tapi
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

MICRO = dict(num_blocks=2, max_dilation=8, residual_channels=16,
             skip_channels=16, batch_size=2, train_window=64,
             learning_rate=3e-3)
MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))
RATE = 16000
SECONDS = 0.02                          # 320 samples


def _models(tmp, **kw):
    """(JAX config, port config, JAX params, port checkpoint directory)."""
    mel = kw.pop("mel", None)
    jc = jconfig.WaveNetConfig(
        mel=None if mel is None else jconfig.MelConfig(**mel),
        **dict(MICRO, **kw))
    tc = tconfig.WaveNetConfig(
        mel=None if mel is None else tconfig.MelConfig(**mel),
        **dict(MICRO, **kw))
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    d = os.path.join(tmp, "port")
    tapi.WaveNet(tc, tp).save(d)
    return jc, tc, jp, d


@pytest.fixture(scope="module")
def plain(tmp_path_factory):
    return _models(str(tmp_path_factory.mktemp("plain")))


def _clip(n, f, rate=RATE):
    t = np.arange(n) / rate
    return (0.3 * np.sin(2 * np.pi * f * t)).astype(np.float32)


def _gen(d, out, *extra):
    return tgenerate.main(["--ckpt", d, "--seconds", str(SECONDS), "--out",
                           out, "--device", "cpu", *extra])


def test_generate_cli_matches_jax_generate_wav(plain, tmp_path):
    jc, tc, jp, d = plain
    toks = _gen(d, str(tmp_path / "port.wav"), "--seed", "7", "--batch", "2")
    want = np.asarray(jsampler.generate_auto(
        jp, jc, jax.random.PRNGKey(0), int(SECONDS * RATE), batch=2,
        seeds=jrng.as_row_seeds(7, 2)))
    assert toks.shape == want.shape == (2, 320)
    assert len(np.unique(want)) > 8                 # actually sampling
    np.testing.assert_array_equal(toks, want)
    jsampler.generate_wav(jp, jc, str(tmp_path / "jax.wav"), SECONDS,
                          batch=2, seeds=jrng.as_row_seeds(7, 2))
    for i in range(2):
        assert (tmp_path / f"port_{i}.wav").read_bytes() == \
            (tmp_path / f"jax_{i}.wav").read_bytes()


@pytest.mark.parametrize("out,batch", [("o.wav", 1), ("o.wav", 2),
                                       ("sub/o", 3), ("a.b/o.flac", 2)])
def test_batch_paths_match_jax(out, batch):
    assert tsampler.batch_paths(out, batch) == jsampler.batch_paths(out,
                                                                     batch)


def test_generate_stream_and_naive_equal_the_fast_path(plain, tmp_path):
    _, _, _, d = plain
    fast = _gen(d, str(tmp_path / "f.wav"), "--seed", "3", "--batch", "2")
    assert _gen(d, str(tmp_path / "s.wav"), "--seed", "3", "--batch", "2",
                "--stream", "0.003") is None
    for i in range(2):
        assert (tmp_path / f"s_{i}.wav").read_bytes() == \
            (tmp_path / f"f_{i}.wav").read_bytes()
    naive = _gen(d, str(tmp_path / "n.wav"), "--seed", "3", "--batch", "2",
                 "--naive")
    np.testing.assert_array_equal(naive, fast)


def test_generate_facade_and_sampler_write_the_cli_files(plain, tmp_path):
    _, tc, _, d = plain
    toks = _gen(d, str(tmp_path / "c.wav"), "--seed", "5", "--batch", "2")
    m = tapi.WaveNet.from_checkpoint(d, device="cpu")
    m.generate_wav(str(tmp_path / "m.wav"), SECONDS, batch=2, seed=5)
    tsampler.generate_wav(m.params, tc, str(tmp_path / "s"), SECONDS,
                          batch=2, seeds=5, device="cpu")
    for i in range(2):
        want = (tmp_path / f"c_{i}.wav").read_bytes()
        assert (tmp_path / f"m_{i}.wav").read_bytes() == want
        assert (tmp_path / f"s_{i}.wav").read_bytes() == want
    w, rate = read_wav(str(tmp_path / "c_1.wav"))
    assert rate == RATE and w.shape == (320,)
    np.testing.assert_array_equal(
        mulaw.encode_np(w), toks[1])


def test_generate_prime_mel_and_speaker(plain, tmp_path):
    _, _, _, d = plain
    write_wav(str(tmp_path / "p.wav"), _clip(40, 300.0), RATE)
    toks = _gen(d, str(tmp_path / "o.wav"), "--prime",
                str(tmp_path / "p.wav"), "--batch", "2")
    assert toks.shape == (2, 320)

    jc, tc, jp, md = _models(str(tmp_path / "mel"), mel=MEL)
    write_wav(str(tmp_path / "ref.wav"), _clip(200, 440.0), RATE)
    toks = tgenerate.main(["--ckpt", md, "--seconds", "1", "--out",
                           str(tmp_path / "v.wav"), "--device", "cpu",
                           "--mel-from", str(tmp_path / "ref.wav")])
    frames = 1 + (200 - 1) // 16
    assert toks.shape == (1, frames * 16)           # capped at the ref
    # the same as the facade's vocode of the reference clip
    m = tapi.WaveNet.from_checkpoint(md, device="cpu")
    np.testing.assert_array_equal(
        toks, m.vocode(_clip(200, 440.0)).numpy())

    _, _, _, sd = _models(str(tmp_path / "spk"), global_classes=4)
    a = tgenerate.main(["--ckpt", sd, "--seconds", str(SECONDS), "--out",
                        str(tmp_path / "a.wav"), "--device", "cpu",
                        "--speaker", "3"])
    b = tgenerate.main(["--ckpt", sd, "--seconds", str(SECONDS), "--out",
                        str(tmp_path / "b.wav"), "--device", "cpu"])
    want = tapi.WaveNet.from_checkpoint(sd, device="cpu").generate(
        seconds=SECONDS, speaker=[3]).numpy()
    np.testing.assert_array_equal(a, want)
    assert not np.array_equal(a, b)                 # speaker 0 by default


@pytest.mark.parametrize("case", ["mel_on_unconditional", "prime_covers_mel",
                                  "speaker_range", "speaker_without_classes",
                                  "stream_naive"])
def test_generate_refusals_use_the_reference_words(plain, tmp_path, case):
    _, _, _, d = plain
    write_wav(str(tmp_path / "r.wav"), _clip(64, 300.0), RATE)
    ref = str(tmp_path / "r.wav")
    if case == "mel_on_unconditional":
        args, msg = [d, "--mel-from", ref], \
            "--mel-from requires a conditional (mel) checkpoint"
    elif case == "prime_covers_mel":
        _, _, _, md = _models(str(tmp_path / "mel"), mel=MEL)
        write_wav(str(tmp_path / "long.wav"), _clip(100, 200.0), RATE)
        args = [md, "--mel-from", ref, "--prime", str(tmp_path / "long.wav")]
        msg = ("--prime (100 samples) covers the whole --mel-from reference "
               "(64 samples); nothing left to vocode")
    elif case == "speaker_range":
        _, _, _, sd = _models(str(tmp_path / "spk"), global_classes=4)
        args, msg = [sd, "--speaker", "4"], "--speaker must be in [0, 4)"
    elif case == "speaker_without_classes":
        args, msg = [d, "--speaker", "1"], \
            "--speaker requires a global_classes checkpoint"
    else:
        args, msg = [d, "--stream", "0.01", "--naive"], \
            "--stream uses the fast decoder; drop --naive"
    with pytest.raises(SystemExit) as e:
        tgenerate.main(["--ckpt", *args, "--out", str(tmp_path / "o.wav"),
                        "--device", "cpu"])
    assert str(e.value) == msg


def test_score_cli_exact_chunking_and_jax(plain, tmp_path, capsys):
    """--chunk 150 over clips of 900 and 431 samples equals one score_fn
    pass within 1e-5 bits per sample and the JAX score.main within 1e-3;
    a directory and --json work."""
    import score as jscore
    jc, tc, jp, d = plain
    wavdir = tmp_path / "eval"
    clips = [_clip(900, 220.0), _clip(431, 440.0)]
    for i, c in enumerate(clips):
        write_wav(str(wavdir / f"c{i}.wav"), c, RATE)
    agg = tscore.main(["--ckpt", d, str(wavdir), "--chunk", "150",
                       "--device", "cpu"])
    m = tapi.WaveNet.from_checkpoint(d, device="cpu")
    bits, n = [], []
    for i in range(2):
        w, _ = read_wav(str(wavdir / f"c{i}.wav"), RATE)
        toks = torch.from_numpy(mulaw.encode_np(w))[None]
        bits.append(float(twn.score_fn(m.params, tc, toks)[0]))
        n.append(toks.shape[1] - 1)
    assert abs(agg - np.average(bits, weights=n)) < 1e-5
    jd = str(tmp_path / "jax")
    japi.WaveNet(jc, jp).save(jd)
    assert abs(agg - jscore.main(["--ckpt", jd, str(wavdir), "--chunk",
                                  "150"])) < 1e-3
    capsys.readouterr()
    one = tscore.main(["--ckpt", d, str(wavdir / "c1.wav"), "--json",
                       "--device", "cpu", "--chunk", "150"])
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["files"][0]["samples"] == 430
    assert out["bits_per_sample"] == one
    assert abs(one - bits[1]) < 1e-5


def test_score_clip_under_mel_and_speaker(tmp_path):
    """Chunked == one pass for a mel model (--mel self) and a speaker
    model, through score_clip."""
    for name, kw in (("mel", dict(mel=MEL)), ("spk", dict(global_classes=4))):
        _, tc, _, d = _models(str(tmp_path / name), **kw)
        m = tapi.WaveNet.from_checkpoint(d, device="cpu")
        clip = _clip(500, 330.0)
        toks = mulaw.encode_np(clip)
        mel = spk = None
        if "mel" in kw:
            from wavenet_tpu_torch.audio.mel import log_mel
            mel = log_mel(clip, RATE, tc.mel)[None]
        else:
            spk = 2
        got, n = tscore.score_clip(m, toks, 120, mel, spk)
        want = float(m.score(tokens=toks[None], mel=mel,
                             speaker=None if spk is None else [spk])[0])
        assert n == 499 and abs(got - want) < 1e-5


def _train(tmp, name, *extra, steps=6):
    """Train tiny (window 128, B = 2, EMA) through the CLI, a checkpoint
    every 2 steps; returns (the checkpoint directory, {step: loss})."""
    d = os.path.join(tmp, name)
    mfile = os.path.join(tmp, name + ".jsonl")
    train.main(["--preset", "tiny", "--synthetic", "--steps", str(steps),
                "--device", "cpu", "--override", "train_window=128",
                "--override", "ema_decay=0.9", "--batch-size", "2",
                "--log-every", "1", "--ckpt", d, "--ckpt-every", "2",
                "--metrics-file", mfile, *extra])
    with open(mfile) as f:
        return d, {r["step"]: r["loss"] for r in map(json.loads, f)}


def test_train_cli_sampling_and_tracing_leave_training_alone(tmp_path):
    """12 steps with and without --sample-every 4 and --profile-dir: the
    same losses, params and EMA bit for bit; three samples of 160 samples;
    the trace holds steps 10 and 11 of [10, 15)."""
    tmp = str(tmp_path)
    a, la = _train(tmp, "a", steps=12)
    b, lb = _train(tmp, "b", "--sample-every", "4", "--sample-seconds",
                   "0.01", "--profile-dir", os.path.join(tmp, "prof"),
                   steps=12)
    assert la == lb and sorted(la) == list(range(1, 13))
    pa = torch.load(os.path.join(a, "ckpt_00000012.pt"), weights_only=True)
    pb = torch.load(os.path.join(b, "ckpt_00000012.pt"), weights_only=True)
    for tree in ("params", "ema"):
        for k in pa[tree]:
            assert torch.equal(pa[tree][k], pb[tree][k]), (tree, k)
    for step in (4, 8, 12):
        with wave.open(os.path.join(b, f"sample_step{step}.wav")) as w:
            assert w.getnframes() == 160 and w.getframerate() == RATE
    assert not any(n.startswith("sample") for n in os.listdir(a))
    with open(os.path.join(tmp, "prof", "trace_steps10-15.json")) as f:
        names = {e.get("name") for e in json.load(f)["traceEvents"]}
    assert {n for n in names if n and n.startswith("train_step_")} == {
        "train_step_10", "train_step_11"}


def test_train_cli_sample_step_is_the_current_params(tmp_path):
    """The sample written at step N decodes the trainer's raw params at N
    (the checkpoint of that step, use_ema=False), with row seeds of 0."""
    tmp = str(tmp_path)
    d, _ = _train(tmp, "a", "--sample-every", "2", "--sample-seconds",
                  "0.01")
    m = tapi.WaveNet.from_checkpoint(d, step=4, use_ema=False, device="cpu")
    m.generate_wav(os.path.join(tmp, "want.wav"), 0.01, seed=0)
    with open(os.path.join(tmp, "want.wav"), "rb") as f:
        want = f.read()
    with open(os.path.join(d, "sample_step4.wav"), "rb") as f:
        assert f.read() == want


def test_serve_cli_step_and_no_ema_pick_the_weights(tmp_path):
    d, _ = _train(str(tmp_path), "a")
    raw = {s: torch.load(os.path.join(d, f"ckpt_{s:08d}.pt"),
                         weights_only=True) for s in (2, 4, 6)}
    cases = [([], 6, "ema"), (["--step", "2"], 2, "ema"),
             (["--no-ema"], 6, "params"),
             (["--step", "4", "--no-ema"], 4, "params")]
    for extra, step, tree in cases:
        m = serve.load_model(serve.parse_args(
            ["--ckpt", d, "--device", "cpu", *extra]))
        for k, v in m.params.items():
            assert torch.equal(v, raw[step][tree][k]), (extra, k)
    with pytest.raises(SystemExit):
        serve.parse_args(["--npz", "m.npz", "--step", "2"])
    with pytest.raises(SystemExit):
        serve.parse_args(["--npz", "m.npz", "--no-ema"])
