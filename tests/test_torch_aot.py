"""The port's AOT decode artifacts (wavenet_tpu_torch/serving/aot.py) and
the decode op they call (ops/cuda/decode_op.py), against the JAX package
on the CPU, mirroring tests/test_serving.py's AOT tests.

The JAX params (wn.init_params at the reference tests' size: one block,
max_dilation 8, R = S = 16, bf16, 8 kHz) are carried into the port with
params_from_numpy.  The port's artifact has no JAX key: generate(seed=s)
samples with the counter-RNG row seeds as_row_seeds(s, batch), so the
JAX side is wn.generate(..., seeds=as_row_seeds(s, batch)) (and, for a mel
model, cond=prepare_decode_cond(...)).  Tolerance: tokens equal bit for
bit, against the port's live generate and against JAX (the JAX scan sums
in f32, the port exactly; at these widths no sampled token sits on a
tie); the waveform equals the mu-law expansion exactly.  Each artifact is
exported once, behind a module fixture.
"""

import io
import json
import os
import subprocess
import sys
import zipfile

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.models.conditioning import prepare_decode_cond
from wavenet_tpu.ops import rng as jrng
from wavenet_tpu.utils import pytree_io as jpytree
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import mulaw
from wavenet_tpu_torch.generate import __main__ as tgenerate
from wavenet_tpu_torch.generate import sampler as tsampler
from wavenet_tpu_torch.models import api as tapi
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops.cuda import build, decode_common, decode_op
from wavenet_tpu_torch.serving import export_decoder, load_decoder
from wavenet_tpu_torch.utils.pytree_io import flatten_tree, params_from_numpy

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MEL = dict(num_mels=8, hop_length=16, win_length=64, fmax=4000.0,
           upsample_factors=(4, 4))


def cfgs_(**kw):
    """(JAX config, port config) of the reference tests' cfg_."""
    mel = kw.pop("mel", None)
    base = dict(num_blocks=1, max_dilation=8, residual_channels=16,
                skip_channels=16, compute_dtype="bfloat16", sample_rate=8000)
    base.update(kw)
    return (jconfig.WaveNetConfig(
                mel=None if mel is None else jconfig.MelConfig(**mel),
                **base),
            tconfig.WaveNetConfig(
                mel=None if mel is None else tconfig.MelConfig(**mel),
                **base))


def _case(tmp, name, key, num_samples, batch, **kw):
    """(JAX cfg, port cfg, JAX params, port params, artifact path, the
    loaded decoder) of one exported model."""
    jc, tc = cfgs_(**kw)
    jp = jwn.init_params(jc, jax.random.PRNGKey(key))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    path = str(tmp / f"{name}.wnx")
    export_decoder(tp, tc, path, num_samples=num_samples, batch=batch)
    return jc, tc, jp, tp, path, load_decoder(path, device="cpu")


@pytest.fixture(scope="module")
def uncond(tmp_path_factory):
    return _case(tmp_path_factory.mktemp("aot"), "uncond", 0, 32, 2)


@pytest.fixture(scope="module")
def speaker(tmp_path_factory):
    return _case(tmp_path_factory.mktemp("aot"), "spk", 1, 24, 2,
                 global_classes=3, global_channels=8)


@pytest.fixture(scope="module")
def vocoder(tmp_path_factory):
    return _case(tmp_path_factory.mktemp("aot"), "voc", 0, 48, 2, mel=MEL)


def _jax(jp, jc, n, batch, seed, **kw):
    return np.asarray(jwn.generate(jp, jc, jax.random.PRNGKey(0), n,
                                   batch=batch,
                                   seeds=jrng.as_row_seeds(seed, batch),
                                   **kw))


# ---------------------------------------------------------------- round trips

def test_aot_roundtrip_unconditional(uncond):
    jc, tc, jp, tp, _, dec = uncond
    assert dec.num_samples == 32 and dec.batch == 2
    assert not dec.with_mel and not dec.with_speaker
    got = dec.generate(seed=5)
    assert got.dtype == torch.int32 and got.shape == (2, 32)
    live = tapi.WaveNet(tc, tp).generate(num_samples=32, batch=2, seed=5)
    want = _jax(jp, jc, 32, 2, 5)
    assert len(np.unique(want)) > 4                  # actually sampling
    np.testing.assert_array_equal(got.numpy(), live.numpy())
    np.testing.assert_array_equal(got.numpy(), want)
    # per-row seeds: each row's audio depends only on its own seed
    rows = dec.generate(seeds=[11, 5])
    np.testing.assert_array_equal(
        rows.numpy(), tapi.WaveNet(tc, tp).generate(
            num_samples=32, batch=2, seeds=[11, 5]).numpy())

    wav = dec.waveform(seed=5)
    np.testing.assert_array_equal(
        wav, mulaw.decode_np(want, tc.quantization_channels))
    with pytest.raises(ValueError, match="speaker"):
        dec.generate(speaker=np.zeros((2,), np.int32))
    with pytest.raises(ValueError, match="mel"):
        dec.generate(mel=np.zeros((2, 2, 8), np.float32))


def test_aot_multi_platform_export(uncond, tmp_path):
    """platforms=("cpu", "cuda") records both and runs on the CPU; a TPU
    target is refused with a message that says whose it is."""
    _, tc, _, tp, _, _ = uncond
    jc = cfgs_()[0]
    path = str(tmp_path / "multi.wnx")
    export_decoder(tp, tc, path, num_samples=16, batch=1,
                   platforms=("cpu", "cuda"))
    dec = load_decoder(path, device="cpu")
    assert dec.platforms == ("cpu", "cuda")
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    np.testing.assert_array_equal(dec.generate(seed=0).numpy(),
                                  _jax(jp, jc, 16, 1, 0))
    for bad in (("cpu", "tpu"), ("tpu",), ()):
        with pytest.raises(ValueError, match="TPU lowering is the JAX"):
            export_decoder(tp, tc, str(tmp_path / "bad.wnx"),
                           num_samples=16, platforms=bad)
    assert not (tmp_path / "bad.wnx").exists()


def test_aot_roundtrip_speaker(speaker):
    jc, tc, jp, tp, _, dec = speaker
    assert dec.with_speaker
    sp = np.asarray([0, 2], np.int32)
    got = dec.generate(seed=3, speaker=sp).numpy()
    want = _jax(jp, jc, 24, 2, 3, speaker=jnp.asarray(sp))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tapi.WaveNet(tc, tp).generate(
        num_samples=24, batch=2, seed=3, speaker=sp).numpy())
    # default speaker is id 0
    np.testing.assert_array_equal(
        dec.generate(seed=3).numpy(),
        _jax(jp, jc, 24, 2, 3, speaker=jnp.zeros((2,), jnp.int32)))
    with pytest.raises(ValueError, match="mel"):
        dec.generate(mel=np.zeros((2, 2, 8), np.float32))


def test_aot_roundtrip_mel(vocoder):
    """Mel models export with a STATIC [batch, frames, M] conditioning
    input; exported decode == live generate on the same features, and ==
    JAX's wn.generate on prepare_decode_cond of them."""
    jc, tc, jp, tp, _, dec = vocoder
    N, B = 48, 2
    assert dec.with_mel and dec.mel_frames == 3
    mel = np.random.default_rng(4).normal(size=(B, 3, 8)).astype(np.float32)
    got = dec.generate(seed=5, mel=mel).numpy()
    cond = prepare_decode_cond(jp, jc, jnp.asarray(mel), N)
    np.testing.assert_array_equal(got, _jax(jp, jc, N, B, 5, cond=cond))
    np.testing.assert_array_equal(got, tapi.WaveNet(tc, tp).generate(
        num_samples=N, batch=B, seed=5, mel=mel).numpy())
    # 2-D mel broadcasts over the batch; wrong frame count is rejected
    got2 = dec.generate(seed=5, mel=mel[0]).numpy()
    assert got2.shape == (B, N)
    np.testing.assert_array_equal(got2, dec.generate(
        seed=5, mel=np.stack([mel[0], mel[0]])).numpy())
    with pytest.raises(ValueError, match="static export shape"):
        dec.generate(mel=np.zeros((B, 5, 8), np.float32))
    with pytest.raises(ValueError, match="pass mel="):
        dec.generate(seed=1)
    with pytest.raises(ValueError, match="speaker"):
        dec.generate(mel=mel, speaker=[0, 1])


# ---------------------------------------------------------------- loading

def test_artifact_members_and_meta(vocoder):
    """The reference's four members; meta holds its keys plus the kernel
    sources' hash."""
    *_, path, _ = vocoder
    with zipfile.ZipFile(path) as z:
        assert sorted(z.namelist()) == sorted(
            ["exported.pt2", "weights.npz", "config.json", "meta.json"])
        meta = json.loads(z.read("meta.json"))
        cfg = tconfig.WaveNetConfig.from_json(z.read("config.json").decode())
    assert meta == {"num_samples": 48, "batch": 2, "temperature": 1.0,
                    "with_speaker": False, "with_mel": True,
                    "mel_frames": 3, "platforms": ["cpu"],
                    "kernel_sources": build.sources_hash()}
    assert cfg.mel.num_mels == 8


@pytest.mark.parametrize("case", ["uncond", "vocoder"])
def test_weights_npz_reads_with_the_jax_unflatten(case, request):
    jc, _, jp, _, path, _ = request.getfixturevalue(case)
    with zipfile.ZipFile(path) as z:
        with np.load(io.BytesIO(z.read("weights.npz"))) as w:
            tree = jpytree.unflatten_tree({k: w[k] for k in w.files})
    want = jpytree.flatten_tree(jax.tree.map(np.asarray, jp))
    got = jpytree.flatten_tree(tree)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_load_decoder_cuda_raises_without_a_card(uncond, tmp_path,
                                                 monkeypatch):
    """A cuda load raises here, before any decode; a device type the
    artifact was not exported for is refused."""
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA")
    _, tc, _, tp, path, _ = uncond
    calls = []
    monkeypatch.setattr(decode_op, "generate_auto",
                        lambda *a, **k: calls.append(1))
    multi = str(tmp_path / "multi.wnx")
    export_decoder(tp, tc, multi, num_samples=8, platforms=("cpu", "cuda"))
    with pytest.raises(RuntimeError, match="CUDA"):
        load_decoder(multi, device="cuda")
    with pytest.raises(RuntimeError, match="CUDA"):
        load_decoder(multi)                      # the default is cuda
    with pytest.raises(ValueError, match="platforms"):
        load_decoder(path, device="cuda")        # exported for cpu only
    assert not calls


def test_loading_constructs_no_model(uncond, monkeypatch):
    """load_decoder + generate with WaveNet(), init_params and
    from_checkpoint all raising."""
    _, tc, _, tp, path, _ = uncond

    def refuse(*a, **k):
        raise AssertionError("model construction at load")
    monkeypatch.setattr(tapi.WaveNet, "__init__", refuse)
    monkeypatch.setattr(tapi.WaveNet, "from_checkpoint", refuse)
    monkeypatch.setattr(twn, "init_params", refuse)
    dec = load_decoder(path, device="cpu")
    got = dec.generate(seed=5)
    want = tsampler.generate_auto(tp, tc, 32, batch=2, seeds=5,
                                  device="cpu")
    assert torch.equal(got, want)


def test_load_imports_no_facade(uncond):
    """A fresh process that loads an artifact and decodes never imports
    models/api.py (nor JAX)."""
    *_, path, _ = uncond
    code = (
        "import sys, torch\n"
        "torch.set_num_threads(1)\n"
        "from wavenet_tpu_torch.serving import load_decoder\n"
        "t = load_decoder(sys.argv[1], device='cpu').generate(seed=5)\n"
        "bad = [m for m in sys.modules if m == 'wavenet_tpu_torch.models.api'"
        " or m.split('.')[0] in ('jax', 'wavenet_tpu')]\n"
        "assert not bad, bad\n"
        "print(tuple(t.shape))\n")
    r = subprocess.run([sys.executable, "-c", code, path], cwd=ROOT,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "(2, 32)"


# ---------------------------------------------------------------- the op

def _op_args(tp, tc, seeds, n):
    flat = flatten_tree(tp)
    return ([flat[k] for k in sorted(flat)], seeds, None, None, n, 1.0,
            tc.to_json())


def test_generate_op_equals_generate_auto(uncond):
    _, tc, _, tp, _, _ = uncond
    seeds = torch.tensor([7, -3], dtype=torch.int32)
    got = torch.ops.wavenet_tpu_torch.generate(*_op_args(tp, tc, seeds, 20))
    want = tsampler.generate_auto(tp, tc, 20, batch=2, seeds=seeds,
                                  device="cpu")
    assert torch.equal(got, want)
    torch.library.opcheck(torch.ops.wavenet_tpu_torch.generate.default,
                          _op_args(tp, tc, seeds, 4))


def test_generate_op_fake_impl(uncond):
    from torch._subclasses.fake_tensor import FakeTensorMode
    _, tc, _, tp, _, _ = uncond
    weights, seeds, *rest = _op_args(tp, tc, torch.zeros(3, dtype=torch.int32),
                                     17)
    with FakeTensorMode() as mode:
        out = torch.ops.wavenet_tpu_torch.generate(
            [mode.from_tensor(w) for w in weights], mode.from_tensor(seeds),
            *rest)
    assert out.shape == (3, 17) and out.dtype == torch.int32
    assert out.device == seeds.device


@pytest.mark.parametrize("kw", [{}, {"mel": MEL},
                                {"global_classes": 3, "global_channels": 8},
                                {"kernel_size": 3}, {"causal_channels": 8}])
def test_param_keys_name_init_params(kw):
    """The op's weight order names exactly the leaves init_params makes."""
    tc = cfgs_(**kw)[1]
    params = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert decode_op.param_keys(tc) == sorted(flatten_tree(params))


def test_generate_op_reuses_the_kernel_layout(uncond, monkeypatch):
    """flatten_params runs once per set of weight tensors, again after one
    is modified in place, and the op hands generate_auto the seeds'
    device."""
    _, tc, _, tp, _, _ = uncond
    tp = {k: v.clone() for k, v in tp.items()}
    built, devices = [], []
    real_flatten, real_auto = decode_common.flatten_params, \
        decode_op.generate_auto

    def flatten(params, cfg):
        if not isinstance(params, decode_common.DecodeWeights):
            built.append(1)
        return real_flatten(params, cfg)

    def auto(*a, **k):
        devices.append(k["device"])
        return real_auto(*a, **k)
    monkeypatch.setattr(decode_common, "flatten_params", flatten)
    monkeypatch.setattr(decode_op, "generate_auto", auto)
    args = _op_args(tp, tc, torch.tensor([1, 2], dtype=torch.int32), 6)
    a = torch.ops.wavenet_tpu_torch.generate(*args)
    b = torch.ops.wavenet_tpu_torch.generate(*args)
    assert torch.equal(a, b) and len(built) == 1
    with torch.no_grad():
        tp["w_res"].mul_(0.5)
    c = torch.ops.wavenet_tpu_torch.generate(*args)
    assert len(built) == 2
    assert torch.equal(c, tsampler.generate_auto(
        tp, tc, 6, batch=2, seeds=args[1], device="cpu"))
    assert devices == [torch.device("cpu")] * 3
    with pytest.raises(ValueError, match="weight tensors"):
        torch.ops.wavenet_tpu_torch.generate(args[0][:-1], *args[1:])


# ---------------------------------------------------------------- CLI

@pytest.fixture(scope="module")
def ckpt(tmp_path_factory, uncond):
    _, tc, _, tp, _, _ = uncond
    d = str(tmp_path_factory.mktemp("ckpt") / "port")
    tapi.WaveNet(tc, tp).save(d)
    return d


def test_generate_cli_export_aot(ckpt, uncond, tmp_path, capsys):
    """--export-aot writes an artifact equal to the facade at the same
    seeds; the reference's four refusals hold."""
    _, tc, _, tp, _, _ = uncond
    out = str(tmp_path / "cli.wnx")
    assert tgenerate.main(["--ckpt", ckpt, "--seconds", "0.004", "--batch",
                           "2", "--export-aot", out, "--device",
                           "cpu"]) is None
    assert f"wrote {out} (0.004s x batch 2, platforms cpu,cuda)" in \
        capsys.readouterr().out
    dec = load_decoder(out, device="cpu")
    assert (dec.num_samples, dec.batch, dec.platforms) == (32, 2,
                                                           ("cpu", "cuda"))
    want = tapi.WaveNet.from_checkpoint(ckpt, device="cpu").generate(
        num_samples=32, batch=2, seed=9)
    assert torch.equal(dec.generate(seed=9), want)
    for extra in (["--prime", out], ["--mel-from", out], ["--stream", "0.1"],
                  ["--naive"]):
        with pytest.raises(SystemExit,
                           match="drop --prime/--mel-from/--stream/--naive"):
            tgenerate.main(["--ckpt", ckpt, "--export-aot", out, "--device",
                            "cpu", *extra])
    with pytest.raises(ValueError, match="TPU lowering"):
        tgenerate.main(["--ckpt", ckpt, "--export-aot", out, "--device",
                        "cpu", "--export-platforms", "cpu,tpu"])
