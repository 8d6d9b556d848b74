"""The port's narrow decode (ops/cuda/decode.py, R < 128) vs the JAX
package's narrow whole-loop kernel (wavenet_tpu/ops/pallas/decode.py, run
in interpret mode as its own tests run it on the CPU), on the same weights.

On the CPU the port's decode_chunk is its plain version (exact f64 sums,
rounded once); the reference kernel sums in f32.  At these widths (R = 16
and 32, K <= 32 per dot product) the two give the same f32 values, so the
tokens, the rings (the reference's [sum_d, R, B] transposed to the port's
[sum_d, B, R]) and the carry are compared for equality, in every variant:
greedy and sampled, primed, chunked, mel, speaker, mel + speaker, and
batch-tiled.  Configs: the reference's decode test config (R = S = 16,
2 blocks of dilations 1..8) and `tiny`'s widths (R = 32, S = 16) at a
short depth.  Inputs come from numpy seeds; weights carry over with
params_from_numpy.

Routing: generate_auto and generate_stream send R < 128 to ops/cuda/decode
and R = 128 to ops/cuda/decode_wide; on a CUDA device a width neither
kernel takes goes to the plain route, as the reference's scan.

On the card (`gpu`, skipped without one): the kernel against the plain
version, bit for bit, where its staging meets the rings (every layer at
d = 1, one layer only), at ragged batch tiles and every rows per block.
The card's machine has no JAX, so these run there with

    python -m pytest tests/test_torch_decode_narrow.py --noconftest -m gpu
"""

import numpy as np
import pytest
import torch

try:                     # the reference side (absent on the card's machine)
    import jax
    import jax.numpy as jnp
    from wavenet_tpu import config as jconfig
    from wavenet_tpu.models import conditioning as jcond
    from wavenet_tpu.models import wavenet as jwn
    from wavenet_tpu.ops import rng as jrng
    from wavenet_tpu.ops.pallas import decode as jdec
except ImportError:
    jax = None
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.generate import sampler
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops.cuda import decode as tdec
from wavenet_tpu_torch.ops.cuda import decode_wide as twide
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

REF = dict(num_blocks=2, max_dilation=8, residual_channels=16,
           skip_channels=16)
TINY = dict(num_blocks=1, max_dilation=16, residual_channels=32,
            skip_channels=16)
MEL = dict(num_mels=8, hop_length=16, win_length=64, upsample_factors=(4, 4))
SPEAKER = dict(global_classes=3, global_channels=8)


def _setup(base, mel=False, speaker=False):
    kw = dict(base, **(SPEAKER if speaker else {}))
    jc = jconfig.WaveNetConfig(
        mel=jconfig.MelConfig(**MEL) if mel else None, **kw)
    tc = tconfig.WaveNetConfig(
        mel=tconfig.MelConfig(**MEL) if mel else None, **kw)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _port_rings(jax_rings) -> torch.Tensor:
    """[sum_d, R, B] (the reference's layout) -> [sum_d, B, R] bf16."""
    r = np.array(jnp.asarray(jax_rings).astype(jnp.float32))
    return torch.from_numpy(r.transpose(0, 2, 1).copy()).to(torch.bfloat16)


def _both(jc, tc, jp, tp, B, N, temp=1.0, prime=None, mel=False,
          speaker=None, t0=0, rings=None, carry=None, tiles=None):
    """One launch of each side on the same inputs: returns the JAX
    (tokens, rings, carry) and the port's, as numpy in the port's
    layout."""
    seeds = np.array(jrng.derive_row_seeds(jnp.int32(7), B))
    if rings is None:
        _, sum_d = jdec._ring_offsets(jc)
        rings = jnp.zeros((sum_d, jc.residual_channels, B), jnp.bfloat16)
        first = (np.full((B,), 128, np.int32) if prime is None
                 else prime[:, 0])
        carry = np.stack([first, np.zeros(B, np.int32)], 1)
    y = g = ty = tg = None
    if mel:
        frames = np.random.RandomState(2).randn(
            B, -(-N // 16), 8).astype(np.float32) * 2.0
        y = np.array(jcond.upsample_mel(jp["upsampler"], jc.mel,
                                        jnp.asarray(frames), N))
        ty = torch.from_numpy(y)
        y = jnp.asarray(y)
    if speaker is not None:
        g = jwn.global_cond_offsets(jp, jc, jnp.asarray(speaker))
        w = tdec.flatten_params(tp, tc)
        tg = tdec.setup_decode(tc, B, N, seeds=0, device="cpu", w=w,
                               speaker=torch.from_numpy(speaker))[3]
    jt, jr, jcr = jdec.decode_chunk(
        jp, jc, rings, jnp.asarray(carry), jnp.int32(t0),
        jnp.asarray(seeds), N, temp, interpret=True,
        forced=None if prime is None else jnp.asarray(prime), y=y, g=g,
        force_tiles=tiles or (B, N))
    pt, pr, pc = tdec.decode_chunk(
        tdec.flatten_params(tp, tc), tc, _port_rings(rings),
        torch.from_numpy(np.array(carry, np.int32)), t0,
        torch.from_numpy(seeds), N, temp,
        forced=None if prime is None else torch.from_numpy(prime),
        y=ty, g=tg)
    return ((np.asarray(jt), _port_rings(jr).float().numpy(), np.asarray(jcr)),
            (pt.numpy(), pr.float().numpy(), pc.numpy()), (jr, jcr))


def _assert_equal(jax_out, port_out):
    for name, a, b in zip(("tokens", "rings", "carry"), jax_out, port_out):
        np.testing.assert_array_equal(b, a, err_msg=name)


@pytest.fixture(scope="module")
def ref():
    return _setup(REF)


@pytest.mark.parametrize("base", ["ref", "tiny"])
@pytest.mark.parametrize("mode", ["greedy", "sampled", "primed"])
def test_narrow_decode_matches_jax_kernel(base, mode):
    """Free-running greedy and sampled decode, and a primed one: tokens,
    rings and carry equal to the JAX narrow kernel's."""
    jc, tc, jp, tp = _setup(REF if base == "ref" else TINY)
    B, N = 3, 40
    prime = None
    if mode == "primed":
        prime = np.random.RandomState(3).randint(0, 256, (B, 9)).astype(
            np.int32)
    j, p, _ = _both(jc, tc, jp, tp, B, N, 0.0 if mode == "greedy" else 1.0,
                    prime=prime)
    _assert_equal(j, p)
    if mode == "sampled":
        assert len(np.unique(j[0])) > 8             # actually sampling


def test_narrow_decode_chunked_continuation_matches_jax(ref):
    """A second launch continuing from the reference's rings and carry at
    t0 = 24 equals the reference's continuation, and the port's own
    chunked launches equal its one-shot launch."""
    jc, tc, jp, tp = ref
    B = 2
    _, _, (jr, jcr) = _both(jc, tc, jp, tp, B, 24)
    j, p, _ = _both(jc, tc, jp, tp, B, 16, t0=24, rings=jr,
                    carry=np.asarray(jcr))
    _assert_equal(j, p)
    w = tdec.flatten_params(tp, tc)
    rings, carry, s, _, _, _ = tdec.setup_decode(tc, B, 40, seeds=5,
                                                 device="cpu")
    one = tdec.decode_chunk(w, tc, rings, carry, 0, s, 40, 1.0)
    r, c, toks, t0 = rings, carry, [], 0
    for n in (7, 24, 9):
        tk, r, c = tdec.decode_chunk(w, tc, r, c, t0, s, n, 1.0)
        toks.append(tk)
        t0 += n
    assert torch.equal(torch.cat(toks, 1), one[0])
    assert torch.equal(r, one[1]) and torch.equal(c, one[2])


@pytest.mark.parametrize("variant", ["mel", "speaker", "mel_speaker"])
def test_narrow_decode_conditioned_matches_jax(variant):
    """The mel and speaker variants and both together (the reference's
    test_generate_stream_mel_plus_speaker_interpret case), sampled and
    primed: tokens, rings and carry equal to the JAX kernel's."""
    mel, spk = "mel" in variant, "speaker" in variant
    jc, tc, jp, tp = _setup(REF, mel=mel, speaker=spk)
    B, N = 2, 32
    prime = np.random.RandomState(4).randint(0, 256, (B, 5)).astype(np.int32)
    j, p, _ = _both(jc, tc, jp, tp, B, N, prime=prime, mel=mel,
                    speaker=np.array([0, 2], np.int32) if spk else None)
    _assert_equal(j, p)


def test_narrow_decode_batch_tiled_equals_untiled(ref):
    """The reference run in two batch tiles of 2 rows (separate launches)
    equals the untiled port run: a row does not depend on the tiling."""
    jc, tc, jp, tp = ref
    j, p, _ = _both(jc, tc, jp, tp, 4, 24, tiles=(2, 8))
    _assert_equal(j, p)


def test_generate_stream_narrow_speaker_equals_one_shot():
    """Streaming a narrow speaker + mel model concatenates to the one-shot
    decode; the one-shot equals the plain per-step generator."""
    jc, tc, jp, tp = _setup(REF, mel=True, speaker=True)
    B, N = 2, 30
    frames = torch.from_numpy(np.random.RandomState(6).randn(
        B, 3, 8).astype(np.float32))
    from wavenet_tpu_torch.models import conditioning as tcond
    y = tcond.upsample_mel(tp["upsampler"], tc.mel, frames, N)
    sp = torch.tensor([2, 1])
    one = sampler.generate_auto(tp, tc, N, batch=B, seeds=4, device="cpu",
                                y=y, speaker=sp)
    got = torch.cat(list(sampler.generate_stream(
        tp, tc, N, chunk_samples=11, batch=B, seeds=4, device="cpu", y=y,
        speaker=sp)), 1)
    assert torch.equal(got, one)
    from wavenet_tpu_torch.ops import rng as trng
    assert torch.equal(twn.generate(
        tp, tc, N, batch=B, seeds=trng.as_row_seeds(4, B), device="cpu",
        cond=tcond.project_cond(tp, y), speaker=sp), one)
    assert torch.equal(tdec.generate_narrow(tp, tc, N, batch=B, seeds=4,
                                            device="cpu", y=y, speaker=sp),
                       one)


class _Spy:
    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    def __call__(self, *a, **k):
        self.calls += 1
        return self.fn(*a, **k)


@pytest.mark.parametrize("R", [32, 128])
def test_generate_routes_on_width(monkeypatch, R):
    """R < 128 decodes through ops/cuda/decode, R = 128 through
    ops/cuda/decode_wide, one-shot and streaming alike."""
    tc = tconfig.WaveNetConfig(num_blocks=1, max_dilation=4,
                               residual_channels=R, skip_channels=32)
    params = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    narrow, wide = _Spy(tdec.decode_chunk), _Spy(twide.decode_chunk)
    monkeypatch.setattr(tdec, "decode_chunk", narrow)
    monkeypatch.setattr(twide, "decode_chunk", wide)
    sampler.generate_auto(params, tc, 6, device="cpu")
    list(sampler.generate_stream(params, tc, 6, chunk_samples=4,
                                 device="cpu"))
    assert (narrow.calls, wide.calls) == ((3, 0) if R < 128 else (0, 3))


def test_width_no_kernel_takes_raises_on_cuda(monkeypatch):
    """Widths neither kernel takes decode through the plain route on a
    CUDA device, as the reference falls back to its scan (formerly they
    raised): R = 192 and R = 128 with S = 48 (widths the wide kernel
    refuses) at Q = 60000, where the narrow block exceeds 227 KiB.  The
    route is decided for device "cuda" and the decode then runs on the
    CPU (kernel_module is wrapped, so nothing is allocated on a card):
    neither kernel module's decode_chunk nor plain version is called, the
    plain route's decode_chunk is, and its tokens equal the CPU decode's.
    Widths a kernel takes stay on it."""
    spies = [_Spy(tdec.decode_chunk), _Spy(twide.decode_chunk),
             _Spy(tdec.decode_chunk_reference),
             _Spy(twide.decode_chunk_reference)]
    for mod, name, spy in ((tdec, "decode_chunk", spies[0]),
                           (twide, "decode_chunk", spies[1]),
                           (tdec, "decode_chunk_reference", spies[2]),
                           (twide, "decode_chunk_reference", spies[3])):
        monkeypatch.setattr(mod, name, spy)
    plain = _Spy(sampler.PLAIN.decode_chunk)
    monkeypatch.setattr(sampler.PLAIN, "decode_chunk", plain)
    decide = sampler.kernel_module
    routes = []

    def on_cuda(cfg, device):          # the decision a CUDA device gets
        routes.append(decide(cfg, "cuda"))
        return routes[-1]

    for R, S in ((192, 32), (128, 48)):
        tc = tconfig.WaveNetConfig(num_blocks=1, max_dilation=2,
                                   residual_channels=R, skip_channels=S,
                                   quantization_channels=60000)
        params = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
        assert not tdec.supported(tc) and not twide.supported(tc)
        want = sampler.generate_auto(params, tc, 4, device="cpu")
        assert (spies[0].calls, plain.calls) == (1, 0)  # CPU: narrow plain
        spies[0].calls = spies[2].calls = 0
        monkeypatch.setattr(sampler, "kernel_module", on_cuda)
        got = sampler.generate_auto(params, tc, 4, device="cpu")
        streamed = next(sampler.generate_stream(params, tc, 4,
                                                device="cpu"))
        monkeypatch.setattr(sampler, "kernel_module", decide)
        assert routes == [sampler.PLAIN] * 2
        assert not any(s.calls for s in spies) and plain.calls == 2
        assert torch.equal(got, want) and torch.equal(streamed, want)
        routes.clear()
        plain.calls = 0
    # widths a kernel takes keep it on the card (the wide one up to the
    # widest it took before, R = 5760)
    for R, S, mod in ((128, 32, twide), (256, 96, twide), (3200, 256, twide),
                      (4096, 32, twide), (5760, 32, twide), (64, 128, tdec),
                      (192, 32, tdec), (128, 48, tdec)):
        tc = tconfig.WaveNetConfig(num_blocks=1, max_dilation=2,
                                   residual_channels=R, skip_channels=S)
        assert decide(tc, "cuda") is mod and decide(tc, "cpu") is mod


# ---------------------------------------------------------------------------
# On the card.

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


# configs whose ring slots the kernel's staging could read too early: every
# layer at d = 1 (a slot is read one step after its write), one layer at
# d = 1 (the next layer is the same layer, one step on), and `tiny`
CARD = {"d1": dict(num_blocks=4, max_dilation=1, residual_channels=64,
                   skip_channels=128),
        "d1_one_layer": dict(num_blocks=1, max_dilation=1,
                             residual_channels=64, skip_channels=128),
        "tiny": dict(num_blocks=1, max_dilation=128, residual_channels=32,
                     skip_channels=16)}


def _card_cfg(name, variant):
    kw = dict(CARD[name])
    if "mel" in variant:
        kw["mel"] = tconfig.MelConfig(num_mels=80, hop_length=16,
                                      win_length=64, fmax=4000.0,
                                      upsample_factors=(4, 4))
    if "speaker" in variant:
        kw.update(global_classes=5, global_channels=8)
    return tconfig.WaveNetConfig(**kw)


@pytest.mark.gpu
@pytest.mark.parametrize("variant", ["plain", "mel", "speaker",
                                     "mel_speaker"])
@pytest.mark.parametrize("name", sorted(CARD))
def test_narrow_kernel_equals_plain_on_the_card(dev, name, variant):
    """Tokens, rings and carry equal to the plain version's, greedy and
    sampled, free-running and primed, at B = 1, 4 and 65 (a ragged last
    tile), at every rows per block (1-16); chunked == one-shot."""
    cfg = _card_cfg(name, variant)
    gen = torch.Generator().manual_seed(len(name) + len(variant))
    w = tdec.flatten_params(twn.init_params(cfg, gen, dev), cfg)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    N = 24
    for batch in (1, 4, 65):
        prime = torch.randint(0, 256, (batch, 5), dtype=torch.int32,
                              generator=gen).to(dev)
        y = (torch.randn(batch, N, M, generator=gen) * 3).to(dev) if M \
            else None
        sp = (torch.randint(0, 5, (batch,), generator=gen)
              if cfg.global_classes else None)
        for temp, forced in ((0.0, None), (1.0, None), (1.0, prime)):
            rings, carry, s, g, _, _ = tdec.setup_decode(
                cfg, batch, N, forced, seeds=3, device=dev, w=w,
                speaker=sp)
            want = tdec.decode_chunk_reference(w, cfg, rings, carry, 0, s,
                                               N, temp, forced, y=y, g=g)
            for bt in (None, 1, 2, 4, 8, 16):
                got = tdec.decode_chunk(w, cfg, rings, carry, 0, s, N, temp,
                                        forced, y=y, g=g, rows_per_block=bt)
                for what, a, b in zip(("tokens", "rings", "carry"), got,
                                      want):
                    assert torch.equal(a, b), (batch, temp, bt, what)
        r, c, toks, t0 = rings, carry, [], 0
        for n in (1, 10, 13):
            tk, r, c = tdec.decode_chunk(
                w, cfg, r, c, t0, s, n, 1.0,
                y=None if y is None else y[:, t0:t0 + n], g=g)
            toks.append(tk)
            t0 += n
        one = tdec.decode_chunk(w, cfg, rings, carry, 0, s, N, 1.0, y=y,
                                g=g)
        assert torch.equal(torch.cat(toks, 1), one[0])
        assert torch.equal(r, one[1]) and torch.equal(c, one[2])
