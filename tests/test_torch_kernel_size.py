"""kernel_size > 2 and causal_channels != residual_channels in the port,
against the JAX package on the CPU: the configs the reference runs only on
its XLA scan, and the port only on its plain route.

Params carry over from JAX with params_from_numpy; inputs come from numpy
seeds.  Tolerances: f32 compute (the reference's check-8 config: K = 3,
R = 16, S = 8, Q = 64) holds the logits within 1e-5 of the largest and the
ring decoder within 1e-4 of the full forward, as the reference's own
tests/test_kernel_size.py does; at bf16 the port's exact sums and JAX's f32
sums may round a residual differently, so argmax agreement >= 99%, the
gate every port-vs-JAX test uses.  Inside the port, fast == naive and
chunked == one-shot token for token.
"""

import jax
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.generate import sampler as jsampler
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.audio import dataset as tds
from wavenet_tpu_torch.generate import sampler
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.models.api import WaveNet
from wavenet_tpu_torch.ops.cuda import decode as tdec
from wavenet_tpu_torch.ops.cuda import decode_wide as twide
from wavenet_tpu_torch.ops.cuda import train_stack as tts
from wavenet_tpu_torch.serving import WaveNetServer
from wavenet_tpu_torch.training import trainer as ttrainer
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

K3 = dict(num_blocks=2, max_dilation=8, residual_channels=16,
          skip_channels=8, quantization_channels=64)
MEL = dict(num_mels=8, hop_length=16, win_length=64, upsample_factors=(4, 4))


def _setup(K=3, dtype="float32", mel=False, speaker=False, **kw):
    kw = dict(K3, kernel_size=K, compute_dtype=dtype, **kw)
    if speaker:
        kw.update(global_classes=3, global_channels=8)
    jc = jconfig.WaveNetConfig(
        mel=jconfig.MelConfig(**MEL) if mel else None, **kw)
    tc = tconfig.WaveNetConfig(
        mel=tconfig.MelConfig(**MEL) if mel else None, **kw)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


def _tokens(B, T, Q=64, seed=0):
    return np.random.RandomState(seed).randint(0, Q, (B, T)).astype(np.int32)


@pytest.mark.parametrize("K,E", [(3, None), (4, None), (2, 24), (3, 24)])
def test_params_have_the_reference_shapes(K, E):
    """init_params draws w_prevk [L, K-2, R, 2, R], embed_prevk [K-2, Q, E]
    and w_embed_proj [E, R] with the reference's shapes and bounds (Glorot
    fan-in of the 5-D taps from the input axis); the leaves a K = 2 model
    also has keep the values they had before the taps existed."""
    jc, tc, jp, _ = _setup(K, causal_channels=E)
    got = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    assert {k: tuple(v.shape) for k, v in got.items()} == {
        k: tuple(v.shape) for k, v in jp.items()}
    if K > 2:
        R = tc.residual_channels
        limit = (6.0 / (R + R)) ** 0.5
        assert float(got["w_prevk"].abs().max()) <= limit
        assert float(got["w_prevk"].abs().max()) > 0.9 * limit
    if E is None:
        base = tc.replace(kernel_size=2)
        want = twn.init_params(base, torch.Generator().manual_seed(0), "cpu")
        for k, v in want.items():
            assert torch.equal(got[k], v), k


@pytest.mark.parametrize("K", [3, 4])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_forward_matches_jax(K, dtype):
    jc, tc, jp, tp = _setup(K, dtype)
    toks = _tokens(2, 96)
    want = np.asarray(jwn.forward_logits(jp, jc, toks))
    got = twn.forward_logits(tp, tc, torch.from_numpy(toks)).numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99


@pytest.mark.parametrize("K", [3, 4])
def test_ring_decoder_equals_forward(K):
    """decode_step teacher-forced over RF + 13 tokens against the full
    forward at f32 (the reference's check 8): within 1e-4; its rings are
    d (K-1) rows per layer."""
    _, tc, _, tp = _setup(K)
    offs, total = twn.ring_offsets(tc)
    assert total == (K - 1) * sum(tc.dilations)
    assert offs[1] == (K - 1) * tc.dilations[0]
    T = tc.receptive_field + 13
    toks = torch.from_numpy(_tokens(2, T, seed=1))
    full = twn.forward_logits(tp, tc, toks)
    st = twn.decode_init(tc, 2, "cpu")
    assert st.queues.dtype == torch.float32 and st.prev_token.shape == (2,
                                                                       K - 1)
    steps = []
    for t in range(T):
        st, lg = twn.decode_step(tp, tc, st, toks[:, t])
        steps.append(lg)
    assert float((torch.stack(steps, 1) - full).abs().max()) < 1e-4


@pytest.mark.parametrize("variant", ["greedy", "sampled", "primed", "mel",
                                     "speaker"])
@pytest.mark.parametrize("K", [3, 4])
def test_fast_equals_naive(K, variant):
    """The plain route's fast decoder and the naive oracle give the same
    tokens, greedy and sampled (both draw the counter RNG keyed by the
    absolute step), primed, with mel features and with speakers."""
    dtype = "bfloat16" if variant == "sampled" else "float32"
    _, tc, _, tp = _setup(K, dtype, mel=variant == "mel",
                          speaker=variant == "speaker")
    B, N = 2, 40
    temp = 0.0 if variant == "greedy" else 1.0
    kw = dict(batch=B, temperature=temp, seeds=[3, 9], device="cpu")
    if variant == "primed":
        kw["prime_tokens"] = torch.from_numpy(_tokens(B, 9, seed=2))
    if variant == "mel":
        kw["y"] = torch.from_numpy(
            np.random.RandomState(3).randn(B, N, 8).astype(np.float32))
    if variant == "speaker":
        kw["speaker"] = torch.tensor([2, 0])
    fast = sampler.generate_auto(tp, tc, N, **kw)
    naive = sampler.generate_naive(tp, tc, N, **kw)
    assert fast.shape == (B, N)
    assert torch.equal(fast, naive)


@pytest.mark.parametrize("K", [3, 4])
def test_fast_and_naive_greedy_match_jax(K):
    """Greedy tokens of the port's fast decoder and naive oracle equal the
    reference's fast decoder and naive oracle at f32."""
    jc, tc, jp, tp = _setup(K)
    N = 48
    jf = np.asarray(jwn.generate(jp, jc, jax.random.PRNGKey(5), N, batch=2,
                                 temperature=0.0))
    jn = np.asarray(jsampler.generate_naive(jp, jc, jax.random.PRNGKey(9),
                                            N, batch=2, temperature=0.0))
    fast = sampler.generate_auto(tp, tc, N, batch=2, temperature=0.0,
                                 device="cpu").numpy()
    naive = sampler.generate_naive(tp, tc, N, batch=2, temperature=0.0,
                                   device="cpu").numpy()
    np.testing.assert_array_equal(jf, jn)
    np.testing.assert_array_equal(fast, jf)
    np.testing.assert_array_equal(naive, jf)


@pytest.mark.parametrize("K", [3, 4])
def test_chunked_equals_one_shot(K):
    """generate_stream on the plain route: rings and the [B, K] carry pass
    from chunk to chunk, so the chunks concatenate to the one-shot tokens,
    primed and sampled."""
    _, tc, _, tp = _setup(K, "bfloat16")
    prime = torch.from_numpy(_tokens(3, 7, seed=4))
    kw = dict(batch=3, prime_tokens=prime, temperature=1.0, seeds=11,
              device="cpu")
    one = sampler.generate_auto(tp, tc, 37, **kw)
    for chunk in (1, 5, 16):
        parts = list(sampler.generate_stream(tp, tc, 37, chunk_samples=chunk,
                                             **kw))
        assert torch.equal(torch.cat(parts, 1), one), chunk


@pytest.mark.parametrize("K,E", [(3, None), (2, 24), (3, 24)])
def test_loss_and_gradients_match_jax(K, E):
    """loss_fn (the scan) and every gradient at f32: the loss within 1e-5
    relative, each gradient within 1e-4 of its largest element."""
    jc, tc, jp, tp = _setup(K, causal_channels=E)
    toks = _tokens(2, 65, seed=5)
    jl, jg = jax.value_and_grad(
        lambda p: jwn.loss_fn(p, jc, toks)[0])(jp)
    leaves = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    loss, _ = twn.loss_fn(leaves, tc, torch.from_numpy(toks))
    loss.backward()
    assert abs(loss.item() - float(jl)) <= 1e-5 * abs(float(jl))
    for k, v in leaves.items():
        want = np.asarray(jg[k])
        got = v.grad.numpy()
        assert np.abs(got - want).max() <= 1e-4 * max(np.abs(want).max(),
                                                      1e-12), k


def test_trainer_takes_the_scan():
    """A K = 3 model and an E != R model train through the scan on any
    device (the stack's kernels take neither); a step runs on the CPU."""
    for kw in ({"kernel_size": 3}, {"causal_channels": 24},
               {"compute_dtype": "float32"}):
        tc = tconfig.WaveNetConfig(**dict(K3, batch_size=2, train_window=64,
                                          **kw))
        assert not ttrainer.use_fused_stack(tc, tc.train_window)
        ds = tds.AudioDataset.synthetic(tc, num_clips=2, clip_seconds=0.05)
        tr = ttrainer.Trainer(tc, ds, device="cpu")
        assert not tr.use_fused
        out = tr.run(2, log_every=1, log_fn=lambda _: None)
        assert np.isfinite(out["loss"])


def test_embed_projection_decodes_and_matches_jax():
    """causal_channels E != R: the embedding projects through w_embed_proj
    [E, R]; the forward matches JAX and the fast decoder equals the naive
    oracle."""
    jc, tc, jp, tp = _setup(2, "float32", causal_channels=24)
    assert tuple(tp["w_embed_proj"].shape) == (24, 16)
    toks = _tokens(2, 64, seed=6)
    want = np.asarray(jwn.forward_logits(jp, jc, toks))
    got = twn.forward_logits(tp, tc, torch.from_numpy(toks)).numpy()
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    kw = dict(batch=2, temperature=1.0, seeds=5, device="cpu")
    assert torch.equal(sampler.generate_auto(tp, tc, 30, **kw),
                       sampler.generate_naive(tp, tc, 30, **kw))


def test_server_serves_kernel_size_3():
    """The port's server decodes a K = 3 model (as the reference's serves
    one, tests/test_kernel_size.py): two co-batched requests, each equal
    to the facade's singleton decode at its seed, through the plain route
    with no kernel launched."""
    from wavenet_tpu_torch.audio import mulaw
    tc = tconfig.WaveNetConfig(**dict(K3, kernel_size=3))
    model = WaveNet(tc).init(torch.Generator().manual_seed(0), "cpu")
    assert sampler.kernel_module(tc, "cuda") is sampler.PLAIN
    counts = [c.value for c in (tdec.launches, twide.launches)]
    with WaveNetServer(model, max_batch=2, max_wait_ms=300.0,
                       chunk_seconds=16 / 16000,
                       length_quantum_seconds=16 / 16000) as srv:
        hs = [srv.submit(num_samples=40, seed=s) for s in (4, 8)]
        got = [h.waveform() for h in hs]
        assert srv.stats["batches"] == 1
    for seed, wav in zip((4, 8), got):
        toks = model.generate(num_samples=40, seeds=[seed])
        np.testing.assert_array_equal(
            wav, mulaw.decode(toks[0], 64).numpy())
    assert [c.value for c in (tdec.launches, twide.launches)] == counts


@pytest.mark.parametrize("kw", [{"kernel_size": 3}, {"causal_channels": 24},
                                {"compute_dtype": "float32"}])
def test_width2_only_paths_refuse(kw):
    """The counterpart of the reference's test_width2_only_paths_refuse:
    both decode kernels and the training stack refuse K > 2, E != R and
    f32 compute, so the sampler routes them to the plain route on the card
    too, and the fused loss raises instead of rounding them to bf16."""
    tc = tconfig.WaveNetConfig(**dict(K3, residual_channels=128,
                                      skip_channels=128, **kw))
    assert not tdec.supported(tc) and not twide.supported(tc)
    assert not tts.config_taken(tc) and not tts.supported(tc, 1024)
    assert sampler.kernel_module(tc, "cuda") is sampler.PLAIN
    p = twn.init_params(tc, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(ValueError, match="trains on the scan"):
        twn.loss_fn(p, tc, torch.zeros(1, 65, dtype=torch.int32),
                    use_fused=True)
