"""Port decode vs the JAX package on the CPU, on the same weights.

JAX params are carried into the port through params_from_numpy; token
inputs come from numpy.  The JAX wide kernel runs in interpret mode, as its
own tests run it on the CPU.  Tolerances:

  * logits and rings: rtol = atol = 2e-2.  The port sums each dot product
    exactly (f64) and rounds once, XLA sums in f32 in its own order; a
    last-bit difference can flip a bf16 residual rounding (one bf16 ulp is
    2^-8 relative) which then carries through the later layers.
  * tokens: the teacher-forced agreement (the JAX trajectory forced into
    the port, the port's own argmax counted) is >= 99%: near-ties may flip
    at single steps.
  * chunked == one-shot inside the port: bit for bit.

The CUDA kernel itself runs only on a card: tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from wavenet_tpu import config as jconfig
from wavenet_tpu.models import wavenet as jwn
from wavenet_tpu.ops import rng as jrng
from wavenet_tpu.ops.pallas import decode_wide as jwide
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops import rng as trng
from wavenet_tpu_torch.ops.cuda import decode_wide as twide
from wavenet_tpu_torch.utils.pytree_io import params_from_numpy

torch.set_num_threads(1)

TOL = 2e-2
WIDE = dict(num_blocks=1, max_dilation=8, residual_channels=128,
            skip_channels=128)


def _setup(kw):
    jc = jconfig.WaveNetConfig(**kw)
    tc = tconfig.WaveNetConfig(**kw)
    jp = jwn.init_params(jc, jax.random.PRNGKey(0))
    tp = params_from_numpy(jax.tree.map(np.asarray, jp), "cpu")
    return jc, tc, jp, tp


@pytest.fixture(scope="module")
def wide():
    return _setup(WIDE)


def _rings_np(r):
    return np.array(jnp.asarray(r).astype(jnp.float32))


@pytest.mark.parametrize("preset", ["wide", "tiny"])
def test_decode_step_logits_match_jax(preset):
    """64 teacher-forced steps of decode_step: logits and rings."""
    kw = WIDE if preset == "wide" else dict(
        num_blocks=1, max_dilation=128, residual_channels=32,
        skip_channels=16)
    jc, tc, jp, tp = _setup(kw)
    B, N = 3, 64
    toks = np.random.RandomState(0).randint(0, 256, (B, N)).astype(np.int32)
    js, ts = jwn.decode_init(jc, B), twn.decode_init(tc, B, "cpu")
    step = jax.jit(lambda p, s, t: jwn.decode_step(p, jc, s, t))
    for t in range(N):
        js, jl = step(jp, js, jnp.asarray(toks[:, t]))
        ts, tl = twn.decode_step(tp, tc, ts, torch.from_numpy(toks[:, t]))
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=TOL, atol=TOL, err_msg=f"step {t}")
    assert ts.t == N
    np.testing.assert_array_equal(ts.prev_token.numpy(), toks[:, -1])
    np.testing.assert_allclose(ts.queues.float().numpy(),
                               _rings_np(js.queues), rtol=TOL, atol=TOL)


def _jax_chunk(jp, jc, rings, carry, t0, seeds, n, temp, forced=None):
    return jwide.decode_chunk(jp, jc, rings, carry, jnp.int32(t0), seeds, n,
                              temp, interpret=True, forced=forced,
                              force_tiles=(carry.shape[0], n))


def _port_forced(jax_tokens, t0, head):
    """The forced-token array that makes the port consume the JAX
    trajectory: global step g consumes forced[:, g]; `head` holds the
    tokens consumed at steps 0..t0 (the carry's first column at t0)."""
    return torch.from_numpy(np.concatenate(
        [np.asarray(head, np.int32), np.asarray(jax_tokens, np.int32)],
        axis=1)).contiguous()


@pytest.mark.parametrize("mode", ["greedy", "sampled", "primed", "chunked"])
def test_decode_chunk_reference_matches_jax_kernel(wide, mode):
    """decode_chunk_reference vs the JAX wide kernel (interpret mode):
    teacher-forced token agreement >= 99%, rings and carry allclose."""
    jc, tc, jp, tp = wide
    w = twide.flatten_params(tp, tc)
    B, N = 3, 96
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
    t0 = 0
    if mode == "chunked":                   # continue from a JAX chunk
        _, rings, carry = _jax_chunk(jp, jc, rings, carry, 0, s, 40, temp)
        t0 = 40
    jt, jr, jcarry = _jax_chunk(jp, jc, rings, carry, t0, s, total, temp,
                                forced=None if prime is None
                                else jnp.asarray(prime))
    jt = np.asarray(jt)

    # the port, forced along the JAX trajectory (a prime keeps priority)
    head = np.zeros((B, t0 + 1), np.int32)
    head[:, t0] = np.asarray(carry)[:, 0]
    forced = _port_forced(jt, t0, head)
    if prime is not None:
        forced[:, :P] = torch.from_numpy(prime)
    pt, pr, pc = twide.decode_chunk(
        w, tc, torch.from_numpy(_rings_np(rings)).to(torch.bfloat16),
        torch.from_numpy(np.array(carry)), t0, torch.from_numpy(seeds_np),
        total, temp, forced=forced)
    agree = (pt.numpy() == jt).mean()
    assert agree >= 0.99, agree
    np.testing.assert_allclose(pr.float().numpy(), _rings_np(jr),
                               rtol=TOL, atol=TOL)
    np.testing.assert_array_equal(pc.numpy()[:, 1], np.asarray(jcarry)[:, 1])
    if temp > 0:
        assert len(np.unique(jt)) > 8        # actually sampling


def test_port_chunked_equals_one_shot(wide):
    """Carried rings + carry + global-step RNG: three uneven launches of
    the plain decode (and the streaming generator) equal one launch."""
    from wavenet_tpu_torch.generate.sampler import (generate_auto,
                                                    generate_stream)
    _, tc, _, tp = wide
    w = twide.flatten_params(tp, tc)
    B, N = 2, 90
    rings, carry, s, _, _, _ = twide.setup_decode(tc, B, N, seeds=11,
                                              device="cpu")
    one, r1, c1 = twide.decode_chunk(w, tc, rings, carry, 0, s, N, 1.0)
    r, c, parts, t0 = rings, carry, [], 0
    for n in (17, 50, 23):
        tk, r, c = twide.decode_chunk(w, tc, r, c, t0, s, n, 1.0)
        parts.append(tk)
        t0 += n
    assert torch.equal(torch.cat(parts, 1), one)
    assert torch.equal(r, r1) and torch.equal(c, c1)
    assert not torch.equal(rings, r1)        # the input rings are untouched
    assert not rings.float().abs().sum()

    prime = torch.from_numpy(np.random.RandomState(5).randint(
        0, 256, (B, 7)).astype(np.int32))
    want = generate_auto(w, tc, 40, batch=B, prime_tokens=prime, seeds=3,
                         device="cpu")
    got = torch.cat(list(generate_stream(w, tc, 40, chunk_samples=9,
                                         batch=B, prime_tokens=prime,
                                         seeds=3, device="cpu")), 1)
    assert got.shape == (B, 40) and torch.equal(got, want)
    # the facade-free plain generator agrees with the whole-loop one
    assert torch.equal(twn.generate(tp, tc, 40, batch=B, prime_tokens=prime,
                                    seeds=trng.as_row_seeds(3, B),
                                    device="cpu"), want)
