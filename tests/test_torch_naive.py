"""The port's naive oracle and the validity mask it rests on, against the
JAX package on the CPU.

forward_logits(valid_mask=) zeroes the carry at masked positions before
every layer, so logits at valid positions equal those of the valid suffix
alone; generate_naive reruns that forward over a sliding RF + K - 1 window
per sample.  Both are held against the reference's (models/wavenet.py
forward_logits, generate/sampler.py generate_naive) on params carried over
with params_from_numpy, at f32 compute: logits within 1e-5 of the largest,
greedy tokens equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.generate import sampler as jsampler
from wavenet_tpu.models import conditioning as jcond
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.generate import sampler
from wavenet_tpu_torch.models import conditioning as tcond
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

BASE = dict(num_blocks=2, max_dilation=8, residual_channels=16,
            skip_channels=8, quantization_channels=64,
            compute_dtype="float32")
MEL = dict(num_mels=8, hop_length=16, win_length=64, upsample_factors=(4, 4))


def _setup(K=2, mel=False, speaker=False, dtype="float32"):
    kw = dict(BASE, kernel_size=K, compute_dtype=dtype)
    if speaker:
        kw.update(global_classes=3, global_channels=8)
    jc = jconfig.WaveNetConfig(
        mel=jconfig.MelConfig(**MEL) if mel else None, **kw)
    tc = tconfig.WaveNetConfig(
        mel=tconfig.MelConfig(**MEL) if mel else None, **kw)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.mark.parametrize("K", [2, 3])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_valid_mask_forward_matches_jax(K, dtype):
    """A ragged mask (row 0 keeps its last 20 positions, row 1 all 50):
    the port's masked logits match JAX's, and at the valid positions they
    equal the forward of the valid suffix alone."""
    jc, tc, jp, tp = _setup(K, dtype=dtype)
    rs = np.random.RandomState(1)
    toks = rs.randint(0, 64, (2, 50)).astype(np.int32)
    mask = np.ones((2, 50), np.float32)
    mask[0, :30] = 0
    want = np.asarray(jwn.forward_logits(jp, jc, toks,
                                         valid_mask=jnp.asarray(mask)))
    got = twn.forward_logits(tp, tc, torch.from_numpy(toks),
                             valid_mask=torch.from_numpy(mask)).numpy()
    if dtype == "float32":
        assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert (got.argmax(-1) == want.argmax(-1)).mean() >= 0.99
    # the suffix alone, with the zero-token history a sequence start has
    suffix = torch.from_numpy(toks[:1, 30:])
    alone = twn.forward_logits(tp, tc, suffix).numpy()
    prev = torch.from_numpy(np.concatenate(
        [np.zeros((1, 1), np.int32), toks[:1, 30:-1]], 1))
    masked_tok = toks[:1].copy()
    masked_tok[:, :30] = 0
    extra = None
    if K > 2:
        extra = torch.stack([torch.nn.functional.pad(
            torch.from_numpy(masked_tok), (j, 0))[:, :50]
            for j in range(2, K)])
    got0 = twn.forward_logits(
        tp, tc, torch.from_numpy(masked_tok),
        prev_tokens=torch.cat([torch.zeros(1, 30, dtype=torch.int32), prev],
                              1),
        prev_tokens_extra=extra, valid_mask=torch.from_numpy(mask[:1]))
    np.testing.assert_array_equal(got0[0, 30:].numpy(), alone[0])


@pytest.mark.parametrize("variant", ["plain", "K3", "primed", "mel",
                                     "speaker"])
def test_naive_greedy_matches_jax(variant):
    """generate_naive at temperature 0 equals the reference's
    generate_naive token for token (and both equal the fast decoders)."""
    jc, tc, jp, tp = _setup(3 if variant == "K3" else 2,
                            mel=variant == "mel",
                            speaker=variant == "speaker")
    B, N = 2, 40
    jkw, tkw = {}, {}
    if variant == "primed":
        prime = np.random.RandomState(2).randint(0, 64, (B, 11)).astype(
            np.int32)
        jkw["prime_tokens"] = jnp.asarray(prime)
        tkw["prime_tokens"] = torch.from_numpy(prime)
    if variant == "mel":
        mel = np.random.RandomState(3).randn(B, 4, 8).astype(np.float32)
        jkw["y"] = jcond.upsample_mel(jp["upsampler"], jc.mel,
                                      jnp.asarray(mel), N)
        tkw["y"] = tcond.upsample_mel(tp["upsampler"], tc.mel,
                                      torch.from_numpy(mel), N)
    if variant == "speaker":
        jkw["speaker"] = jnp.asarray([2, 1], jnp.int32)
        tkw["speaker"] = torch.tensor([2, 1])
    want = np.asarray(jsampler.generate_naive(
        jp, jc, jax.random.PRNGKey(0), N, batch=B, temperature=0.0, **jkw))
    got = sampler.generate_naive(tp, tc, N, batch=B, temperature=0.0,
                                 device="cpu", **tkw)
    np.testing.assert_array_equal(got.numpy(), want)
    fast = sampler.generate_auto(tp, tc, N, batch=B, temperature=0.0,
                                 device="cpu", **tkw)
    assert torch.equal(fast, got)


def test_naive_equals_fast_sampled_with_long_prime():
    """A prime longer than the window (the window starts full) and
    sampling at temperature 0.8: naive == fast, token for token."""
    _, tc, _, tp = _setup(dtype="bfloat16")
    W = tc.receptive_field + 1
    prime = torch.randint(0, 64, (3, W + 5), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(4))
    kw = dict(batch=3, prime_tokens=prime, temperature=0.8, seeds=[1, 2, 3],
              device="cpu")
    assert torch.equal(sampler.generate_naive(tp, tc, 30, **kw),
                       sampler.generate_auto(tp, tc, 30, **kw))
