"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and nvcc; they skip without one (the kernels
have no CPU mode).  They import no JAX, so on a GPU machine without JAX
they run with:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Decode: both sides sum every dot product exactly (f64) and round once, so
the kernel must equal the plain version bit for bit.  Training stack: both
sides sum bf16-valued products in f32 in different orders, so they agree
within the reference suite's bands (test_pallas_train.py:96-103), and two
kernel runs agree bit for bit.  chip_smoke.py repeats these checks at the
`full` preset's widths.
"""

import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import decode_wide as pwide
from wavenet_tpu_torch.ops.cuda import train_stack as ts

pytestmark = pytest.mark.gpu


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small(dev):
    cfg = tconfig.WaveNetConfig(num_blocks=2, max_dilation=16,
                                residual_channels=128, skip_channels=256)
    params = wn.init_params(cfg, torch.Generator().manual_seed(1), dev)
    return cfg, pwide.flatten_params(params, cfg)


def test_counter_bits_match_plain(dev):
    seeds = rng.derive_row_seeds(9, 5).to(dev)
    for t in (0, 3, 2 ** 31 - 1):
        assert torch.equal(pwide.counter_bits(seeds, t, 256).cpu(),
                           pwide.counter_bits(seeds.cpu(), t, 256))


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("batch", [1, 3, 9])
def test_decode_kernel_equals_plain(dev, small, temp, batch):
    """Free-running and primed: tokens, rings and carry bit for bit, for
    batches that give 1-row and multi-row blocks."""
    cfg, w = small
    prime = torch.randint(0, 256, (batch, 6), dtype=torch.int32,
                          generator=torch.Generator().manual_seed(2)).to(dev)
    for forced in (None, prime):
        rings, carry, s, _, _ = pwide.setup_decode(cfg, batch, 70, forced,
                                                   seeds=5, device=dev)
        k = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 70, temp, forced)
        p = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s, 70,
                                         temp, forced)
        for a, b in zip(k, p):
            assert torch.equal(a, b)


def test_decode_kernel_chunked_equals_one_shot(dev, small):
    cfg, w = small
    rings, carry, s, _, _ = pwide.setup_decode(cfg, 4, 90, seeds=8,
                                               device=dev)
    one = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 90, 1.0)
    r, c, toks, t0 = rings, carry, [], 0
    for n in (1, 44, 45):
        tk, r, c = pwide.decode_chunk(w, cfg, r, c, t0, s, n, 1.0)
        toks.append(tk)
        t0 += n
    assert torch.equal(torch.cat(toks, 1), one[0])
    assert torch.equal(r, one[1]) and torch.equal(c, one[2])
    before = pwide.launches.value
    pwide.decode_chunk(w, cfg, rings, carry, 0, s, 3, 1.0)
    assert pwide.launches.value == before + 1


@pytest.mark.parametrize("R,S,B,T,dmax", [(128, 256, 2, 256, 16),
                                          (64, 96, 3, 200, 64),
                                          (32, 16, 2, 128, 8),
                                          (16, 16, 2, 64, 8)])
def test_train_stack_kernels_match_plain(dev, R, S, B, T, dmax):
    """One layer group forward and backward: kernel vs plain, and two
    kernel runs bit for bit (ragged row tiles in the second case, the
    `tiny` preset's widths in the third, a contraction shorter than one
    staged slice of W in the last)."""
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=dmax,
                                residual_channels=R, skip_channels=S)
    g = torch.Generator().manual_seed(3)
    p = wn.init_params(cfg, g, dev)
    dils = cfg.dilations
    Lg = len(dils)
    ops = ts.prep_weights(*(p[k] for k in ts.GROUP_KEYS))
    rnd = lambda *shape, sc: (torch.randn(*shape, generator=g) * sc).to(dev)
    x = rnd(B, T, R, sc=0.5).to(torch.bfloat16).float()
    skip, dskip, dxo = rnd(B, T, S, sc=0.1), rnd(B, T, S, sc=0.01), \
        rnd(B, T, R, sc=0.01)
    before = (ts.fwd_launches.value, ts.bwd_launches.value)
    kf = ts.group_fwd(x, skip, ops, dils)
    pf = ts.group_fwd_reference(x, skip, ops, dils)
    kb = ts.group_bwd(kf[2], dskip, dxo, ops, dils)
    pb = ts.group_bwd_reference(pf[2], dskip, dxo, ops, dils)
    # device kernels: the carry init and one per layer; per layer the row
    # pass, the shift pass, two weight gradients and three column sums at
    # two launches each, plus the skip-bias sum
    assert (ts.fwd_launches.value, ts.bwd_launches.value) == (
        before[0] + Lg + 1, before[1] + 10 * Lg + 2)
    torch.testing.assert_close(kf[0], pf[0], atol=5e-3, rtol=1e-3)
    for a, b in zip(kb, pb):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-2 * scale
    kf2 = ts.group_fwd(x, skip, ops, dils)
    kb2 = ts.group_bwd(kf2[2], dskip, dxo, ops, dils)
    assert all(torch.equal(a, b) for a, b in zip(kf + kb, kf2 + kb2))


def _rel(a, b):
    """(max |a - b| / max |b|, |a - b| / |b|) of two gradients."""
    d = (a - b).float()
    return (float(d.abs().max()) / max(float(b.abs().max()), 1e-30),
            float(d.norm()) / max(float(b.norm()), 1e-30))


def test_fused_loss_gradients_on_the_card(dev, monkeypatch):
    """The autograd path through the kernels (embed -> fused stack over
    three layer groups -> head -> cross-entropy) on the card.

    1. Under a fixed random cotangent on the skip sum (a linear objective),
       the gradients of every stack parameter and both embedding tables
       against the CPU, where the stack runs its plain versions.
    2. The training loss itself: every gradient with the backward kernels
       against the same forward kernels followed by the plain backward on
       the card (group_bwd swapped for group_bwd_reference).
    Case 2 shares the forward, because two forwards that sum in another
    order differ in a few bf16 roundings of h, and the head's ReLUs turn
    those into whole flipped entries of the cross-entropy's skip
    cotangent: between the plain versions on the CPU and on the card that
    moves the cross-entropy gradients by several per cent (printed here as
    `plain card vs plain cpu`; run with -s)."""
    cfg = tconfig.WaveNetConfig(num_blocks=2, max_dilation=32,
                                residual_channels=128, skip_channels=128,
                                train_window=256)
    budget = max(ts._group_sizes(cfg, 256, cfg.dilations[l:l + 4])[1]
                 for l in range(len(cfg.dilations) - 3))
    monkeypatch.setattr(ts, "VMEM_BUDGET", budget)
    assert len(ts.group_plan(cfg, ts.pick_tile(cfg, 256))) == 3
    p0 = wn.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    g = torch.Generator().manual_seed(5)
    toks = torch.randint(0, 256, (2, 257), generator=g)
    ct = torch.randn(2, 256, cfg.skip_channels, generator=g)
    keys = sorted(p0)
    stack_keys = list(ts.GROUP_KEYS) + ["embed_cur", "embed_prev"]

    def run(d):
        p = {k: v.detach().to(d).requires_grad_(True)
             for k, v in p0.items()}
        loss, _ = wn.loss_fn(p, cfg, toks.to(d), use_fused=True)
        ce = torch.autograd.grad(loss, [p[k] for k in keys])
        inputs = toks[:, :-1].to(d)
        x = wn.embed_tokens(p, cfg, inputs, wn._shifted_tokens(inputs))
        skip = ts.forward_skip_fused(p, cfg, x)
        lin = torch.autograd.grad((skip * ct.to(d)).mean(),
                                  [p[k] for k in stack_keys])
        return (float(loss.detach()), [g.cpu() for g in ce],
                [g.cpu() for g in lin])

    lk, cek, link = run(dev)
    lc, cec, linc = run(torch.device("cpu"))
    assert abs(lk - lc) <= 2e-3 * abs(lc)
    for k, a, b in zip(stack_keys, link, linc):
        assert _rel(a, b)[0] <= 2e-2, k

    with monkeypatch.context() as m:
        m.setattr(ts, "group_bwd", ts.group_bwd_reference)
        lp, cep, _ = run(dev)                 # kernel forward, plain backward
        m.setattr(ts, "group_fwd", ts.group_fwd_reference)
        _, ceq, _ = run(dev)                  # the plain versions on the card
    assert lp == lk
    for k, a, b in zip(keys, cek, cep):
        assert _rel(a, b)[0] <= 2e-2, k
    for name, a, b in (("kernel bwd vs plain bwd, card", cek, cep),
                       ("kernel vs plain, card", cek, ceq),
                       ("plain card vs plain cpu", ceq, cec)):
        rel = {k: _rel(x, y) for k, x, y in zip(keys, a, b)}
        kmax = max(rel, key=lambda k: rel[k][0])
        kl2 = max(rel, key=lambda k: rel[k][1])
        print(f"cross-entropy gradients, {name}: worst max-rel "
              f"{rel[kmax][0]} ({kmax}), worst l2-rel {rel[kl2][1]} ({kl2})")


def _mel_cfg(num_mels):
    mel = (tconfig.MelConfig() if num_mels == 80 else
           tconfig.MelConfig(num_mels=num_mels, hop_length=16, win_length=64,
                             fmax=4000.0, upsample_factors=(4, 4)))
    return tconfig.WaveNetConfig(num_blocks=2, max_dilation=16,
                                 residual_channels=128, skip_channels=256,
                                 mel=mel)


@pytest.mark.parametrize("num_mels", [80, 8])
@pytest.mark.parametrize("temp", [0.0, 1.0])
def test_decode_kernel_mel_equals_plain(dev, num_mels, temp):
    """The mel variant: tokens, rings and carry bit for bit against the
    plain version (exact sums of bf16(y) @ bf16(V_cond) on both sides),
    for 1-row and multi-row blocks, primed and free-running; y sliced per
    chunk gives the one-shot result."""
    cfg = _mel_cfg(num_mels)
    g = torch.Generator().manual_seed(6)
    w = pwide.flatten_params(wn.init_params(cfg, g, dev), cfg)
    for batch in (1, 3):
        prime = torch.randint(0, 256, (batch, 5), dtype=torch.int32,
                              generator=g).to(dev)
        y = (torch.randn(batch, 64, num_mels, generator=g) * 3).to(dev)
        for forced in (None, prime):
            rings, carry, s, _, _ = pwide.setup_decode(cfg, batch, 64,
                                                       forced, seeds=4,
                                                       device=dev)
            k = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 64, temp,
                                   forced, y=y)
            p = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s, 64,
                                             temp, forced, y=y)
            for a, b in zip(k, p):
                assert torch.equal(a, b)
        before = (pwide.mel_launches.value, pwide.launches.value)
        r, c, toks, t0 = rings, carry, [], 0
        for n in (7, 57):
            tk, r, c = pwide.decode_chunk(w, cfg, r, c, t0, s, n, temp,
                                          y=y[:, t0:t0 + n])
            toks.append(tk)
            t0 += n
        one = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 64, temp, y=y)
        assert (pwide.mel_launches.value, pwide.launches.value) == (
            before[0] + 3, before[1])
        assert torch.equal(torch.cat(toks, 1), one[0])
        assert torch.equal(r, one[1]) and torch.equal(c, one[2])


@pytest.mark.parametrize("R,S,nm,B,T,dmax", [(128, 256, 80, 2, 256, 16),
                                             (64, 96, 8, 3, 200, 64),
                                             (32, 16, 16, 2, 64, 8)])
def test_train_stack_mel_kernels_match_plain(dev, R, S, nm, B, T, dmax):
    """The mel variants of one layer group's forward and backward: kernel
    vs plain within the reference suite's bands (dv_cond and dy
    included), two kernel runs bit for bit, and 12 backward launches per
    layer."""
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=dmax,
                                residual_channels=R, skip_channels=S)
    g = torch.Generator().manual_seed(7)
    p = wn.init_params(cfg, g, dev)
    dils = cfg.dilations
    Lg = len(dils)
    rnd = lambda *shape, sc: (torch.randn(*shape, generator=g) * sc).to(dev)
    vc = rnd(Lg, nm, 2, R, sc=0.1)
    ops = ts.prep_weights(*(p[k] for k in ts.GROUP_KEYS), vc)
    x = rnd(B, T, R, sc=0.5).to(torch.bfloat16).float()
    y = rnd(B, T, nm, sc=2.0).to(torch.bfloat16)
    skip, dskip, dxo = rnd(B, T, S, sc=0.1), rnd(B, T, S, sc=0.01), \
        rnd(B, T, R, sc=0.01)
    counts = lambda: (ts.fwd_mel_launches.value, ts.bwd_mel_launches.value,
                      ts.fwd_launches.value, ts.bwd_launches.value)
    before = counts()
    kf = ts.group_fwd(x, skip, ops, dils, y)
    pf = ts.group_fwd_reference(x, skip, ops, dils, y)
    kb = ts.group_bwd(kf[2], dskip, dxo, ops, dils, y)
    pb = ts.group_bwd_reference(pf[2], dskip, dxo, ops, dils, y)
    assert counts() == (before[0] + Lg + 1, before[1] + 12 * Lg + 2,
                        before[2], before[3])
    assert len(kb) == len(pb) == 8
    torch.testing.assert_close(kf[0], pf[0], atol=5e-3, rtol=1e-3)
    for a, b in zip(kb, pb):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-2 * scale
    kf2 = ts.group_fwd(x, skip, ops, dils, y)
    kb2 = ts.group_bwd(kf2[2], dskip, dxo, ops, dils, y)
    assert all(torch.equal(a, b) for a, b in zip(kf + kb, kf2 + kb2))
