"""The port's CUDA kernels against their plain PyTorch versions, on a card.

These tests need a CUDA device and nvcc; they skip without one (the kernels
have no CPU mode).  They import no JAX, so on a GPU machine without JAX
they run with:

    python -m pytest tests/test_torch_kernels.py --noconftest -q

Decode (the narrow kernel, R < 128, and the wide one): both sides sum
every dot product exactly (f64) and round once, so each kernel must equal
the plain version bit for bit, in every variant (unconditional, mel,
speaker, mel + speaker), whatever the rows per block (narrow) and the
cluster size and rows per cluster (wide).  Training stack
(unconditional, mel, speaker, mel + speaker): the forward sums its bf16
products exactly on both sides, so kernel and plain forwards are equal bit
for bit; the backward's f32-cotangent products sum in f32 in different
orders, so gradients agree within the reference suite's bands
(test_pallas_train.py:96-103); two kernel runs agree bit for bit.
chip_smoke.py repeats these checks at the `full` preset's widths.
"""

import itertools

import pytest
import torch

import _colsum_order as order
from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as wn
from wavenet_tpu_torch.ops import rng
from wavenet_tpu_torch.ops.cuda import decode as pnarrow
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
        rings, carry, s, _, _, _ = pwide.setup_decode(cfg, batch, 70, forced,
                                                   seeds=5, device=dev)
        k = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 70, temp, forced)
        p = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s, 70,
                                         temp, forced)
        for a, b in zip(k, p):
            assert torch.equal(a, b)


def test_decode_kernel_chunked_equals_one_shot(dev, small):
    cfg, w = small
    rings, carry, s, _, _, _ = pwide.setup_decode(cfg, 4, 90, seeds=8,
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


@pytest.mark.parametrize("temp", [0.0, 1.0])
@pytest.mark.parametrize("R", [128, 256])
@pytest.mark.parametrize("batch", [1, 3, 4, 9])
def test_wide_decode_cluster_plans_equal_plain(dev, batch, R, temp):
    """The cluster split (ops/cuda/decode_wide.py plan_clusters) changes no
    row: every cluster size, rows-per-cluster and exchange (all-reduce,
    scatter) plan forced through the keywords gives the plain version's
    tokens, rings and carry, primed and free-running (ragged last tiles at
    B = 3, 9)."""
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=16,
                                residual_channels=R, skip_channels=96)
    g = torch.Generator().manual_seed(21)
    w = pwide.flatten_params(wn.init_params(cfg, g, dev), cfg)
    prime = torch.randint(0, 256, (batch, 5), dtype=torch.int32,
                          generator=g).to(dev)
    for forced in (None, prime):
        rings, carry, s, _, _, _ = pwide.setup_decode(cfg, batch, 40, forced,
                                                   seeds=3, device=dev)
        p = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s, 40,
                                         temp, forced)
        ran = 0
        for C, rows, scatter in ((None, None, None), (16, 1, False),
                                 (16, 1, True), (16, 4, False),
                                 (16, 4, True), (16, 8, True), (8, 2, False),
                                 (8, 2, True), (4, 8, True), (2, 1, False),
                                 (2, 1, True)):
            if C is not None and pwide.smem_bytes(
                    rows, C, pwide.THREADS, False, scatter,
                    cfg) > 227 * 1024:
                continue          # R = 256: 16 CTAs x 4 rows all-reduced
            k = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 40, temp,
                                   forced, cluster=C, rows_per_cluster=rows,
                                   scatter=scatter)
            for a, b in zip(k, p):
                assert torch.equal(a, b), (C, rows, scatter)
            ran += 1
        assert ran >= 10


def test_wide_decode_shares_in_place_equal_plain(dev, monkeypatch):
    """With the shares read in place (the plan for widths whose stage
    buffers do not fit, forced here by a smaller budget), the kernel
    equals the plain version too, with a speaker."""
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=8,
                                residual_channels=128, skip_channels=64,
                                global_classes=5)
    g = torch.Generator().manual_seed(22)
    w = pwide.flatten_params(wn.init_params(cfg, g, dev), cfg)
    monkeypatch.setattr(pwide, "_MAX_SMEM", 20_000)
    assert not pwide.plan_clusters(
        3, cfg, lambda plan: pwide.max_clusters(cfg, plan)).stage
    rings, carry, s, gc, _, _ = pwide.setup_decode(
        cfg, 3, 30, seeds=4, device=dev, w=w, speaker=[0, 4, 2])
    k = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 30, 1.0, g=gc)
    p = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s, 30, 1.0,
                                     g=gc)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


def test_wide_decode_layout_mirrors(dev):
    """plan_clusters' byte count (smem_bytes) and pack_shares' block
    length (share_elems) equal the library's own."""
    lib = pwide.library()
    for base in (tconfig.full(), tconfig.full_vocoder(),
                 tconfig.WaveNetConfig(residual_channels=384,
                                       skip_channels=96,
                                       quantization_channels=255)):
        for cfg in (base, base.replace(global_classes=7)):
            M = 0 if cfg.mel is None else cfg.mel.num_mels
            for C in (2, 8, 16):
                assert lib.wn_decode_wide_share(
                    C, cfg.residual_channels, cfg.skip_channels,
                    M) == pwide.share_elems(C, cfg)
                for rows, stage, scatter in itertools.product(
                        (1, 4), (0, 1), (0, 1)):
                    assert lib.wn_decode_wide_smem(
                        rows, C, pwide.THREADS, stage, scatter,
                        int(cfg.global_classes is not None),
                        cfg.num_layers, cfg.residual_channels,
                        cfg.skip_channels, cfg.quantization_channels,
                        M) == pwide.smem_bytes(rows, C, pwide.THREADS,
                                               bool(stage), bool(scatter),
                                               cfg)


@pytest.mark.parametrize("R,S,M", [(5760, 32, 0), (4096, 256, 0),
                                   (3072, 64, 80)])
def test_wide_decode_widest_widths_equal_plain(dev, R, S, M):
    """The widest widths the one-block kernel took before the cluster
    design plan the scatter exchange (its buffers do not grow with C x R)
    and equal the plain version bit for bit, sampled, with a speaker."""
    cfg = tconfig.WaveNetConfig(
        num_blocks=1, max_dilation=2, residual_channels=R, skip_channels=S,
        quantization_channels=256, global_classes=3,
        mel=tconfig.MelConfig(num_mels=M) if M else None)
    assert pwide.plan_clusters(
        2, cfg, lambda p: pwide.max_clusters(cfg, p)).scatter
    g = torch.Generator().manual_seed(23)
    w = pwide.flatten_params(wn.init_params(cfg, g, dev), cfg)
    rings, carry, s, gc, _, _ = pwide.setup_decode(
        cfg, 2, 6, seeds=5, device=dev, w=w, speaker=[1, 2])
    y = (torch.randn(2, 6, M, generator=g).to(dev) if M else None)
    k = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 6, 1.0, y=y, g=gc)
    p = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s, 6, 1.0,
                                     y=y, g=gc)
    for a, b in zip(k, p):
        assert torch.equal(a, b)


@pytest.mark.parametrize("R,S,B,T,dmax", [(128, 256, 2, 256, 16),
                                          (64, 96, 3, 200, 64),
                                          (32, 16, 2, 128, 8),
                                          (16, 16, 2, 64, 8),
                                          (20, 12, 2, 200, 8),
                                          (128, 256, 2, 1024, 128)])
def test_train_stack_kernels_match_plain(dev, R, S, B, T, dmax):
    """One layer group forward and backward: kernel vs plain, and two
    kernel runs bit for bit (ragged row tiles in the second case, the
    `tiny` preset's widths in the third, a contraction shorter than one
    staged slice of W in the fourth; in the fifth, widths that end in a
    partial k16 slice and a partial n8 tile of the MMAs, with ragged row
    tiles and 8-byte copies of xcat; in the last, a `full` group of 8
    layers, dilations up to 128)."""
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
    # pass, the shift pass, two weight gradients at two launches each and
    # one launch of the column sums (db and db_res), plus the skip-bias sum
    assert (ts.fwd_launches.value, ts.bwd_launches.value) == (
        before[0] + Lg + 1, before[1] + 7 * Lg + 1)
    torch.testing.assert_close(kf[0], pf[0], atol=5e-3, rtol=1e-3)
    # the forward's products are summed exactly on both sides
    assert all(torch.equal(a, b) for a, b in zip(kf, pf))
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
            rings, carry, s, _, _, _ = pwide.setup_decode(cfg, batch, 64,
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
                                             (32, 16, 16, 2, 64, 8),
                                             (20, 12, 8, 2, 200, 8)])
def test_train_stack_mel_kernels_match_plain(dev, R, S, nm, B, T, dmax):
    """The mel variants of one layer group's forward and backward: kernel
    vs plain within the reference suite's bands (dv_cond and dy
    included), two kernel runs bit for bit, and 9 backward launches per
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
    assert counts() == (before[0] + Lg + 1, before[1] + 9 * Lg + 1,
                        before[2], before[3])
    assert len(kb) == len(pb) == 8
    torch.testing.assert_close(kf[0], pf[0], atol=5e-3, rtol=1e-3)
    # the forward's products are summed exactly on both sides
    assert all(torch.equal(a, b) for a, b in zip(kf, pf))
    for a, b in zip(kb, pb):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-2 * scale
    kf2 = ts.group_fwd(x, skip, ops, dils, y)
    kb2 = ts.group_bwd(kf2[2], dskip, dxo, ops, dils, y)
    assert all(torch.equal(a, b) for a, b in zip(kf + kb, kf2 + kb2))


@pytest.mark.parametrize("R,S,nm,B,T,dmax", [(128, 256, 0, 2, 256, 16),
                                             (64, 96, 8, 3, 200, 64),
                                             (32, 16, 0, 3, 1100, 8),
                                             (20, 12, 0, 2, 200, 8),
                                             (128, 256, 24, 2, 200, 16),
                                             (64, 96, 20, 3, 200, 64)])
def test_train_stack_speaker_kernels_match_plain(dev, R, S, nm, B, T, dmax):
    """The speaker variants (g [B, Lg, 2R]; with mel where nm > 0) of one
    layer group's forward and backward: kernel vs plain within the
    reference suite's bands, dg included, two kernel runs bit for bit, and
    (8 + 2 mel) Lg + 1 backward launches counted as speaker launches
    only.  T = 200 and 1100 are not multiples of the 64-row tile (a tile
    spans two batch rows), and T = 1100 gives each batch row two splits
    of ROWS_PER_SPLIT rows in dg's segmented sum.  nm = 24 and 20 end in
    a partial k16 step of the mel product, and nm = 20 takes 8-byte
    copies of y."""
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=dmax,
                                residual_channels=R, skip_channels=S)
    g = torch.Generator().manual_seed(8)
    p = wn.init_params(cfg, g, dev)
    dils = cfg.dilations
    Lg = len(dils)
    rnd = lambda *shape, sc: (torch.randn(*shape, generator=g) * sc).to(dev)
    vc = rnd(Lg, nm, 2, R, sc=0.1) if nm else None
    ops = ts.prep_weights(*(p[k] for k in ts.GROUP_KEYS), vc)
    x = rnd(B, T, R, sc=0.5).to(torch.bfloat16).float()
    y = rnd(B, T, nm, sc=2.0).to(torch.bfloat16) if nm else None
    gc = rnd(B, Lg, 2 * R, sc=0.5)
    skip, dskip, dxo = rnd(B, T, S, sc=0.1), rnd(B, T, S, sc=0.01), \
        rnd(B, T, R, sc=0.01)
    counters = (ts.fwd_gc_launches, ts.bwd_gc_launches, ts.fwd_mel_launches,
                ts.bwd_mel_launches, ts.fwd_launches, ts.bwd_launches)
    counts = lambda: tuple(c.value for c in counters)
    before = counts()
    kf = ts.group_fwd(x, skip, ops, dils, y, gc)
    pf = ts.group_fwd_reference(x, skip, ops, dils, y, gc)
    kb = ts.group_bwd(kf[2], dskip, dxo, ops, dils, y, gc)
    pb = ts.group_bwd_reference(pf[2], dskip, dxo, ops, dils, y, gc)
    assert counts() == (before[0] + Lg + 1,
                        before[1] + (8 + (2 if nm else 0)) * Lg + 1,
                        *before[2:])
    assert len(kb) == len(pb) == (9 if nm else 7)
    assert kb[-1].shape == (B, Lg, 2 * R)
    torch.testing.assert_close(kf[0], pf[0], atol=5e-3, rtol=1e-3)
    # the forward's products are summed exactly on both sides
    assert all(torch.equal(a, b) for a, b in zip(kf, pf))
    for a, b in zip(kb, pb):
        scale = float(b.abs().max())
        assert float((a - b).abs().max()) <= 2e-2 * scale
    kf2 = ts.group_fwd(x, skip, ops, dils, y, gc)
    kb2 = ts.group_bwd(kf2[2], dskip, dxo, ops, dils, y, gc)
    assert all(torch.equal(a, b) for a, b in zip(kf + kb, kf2 + kb2))


@pytest.mark.parametrize("B,T,N", [(8, 8192, 256), (8, 8192, 128),
                                     (64, 8192, 128), (64, 8192, 64),
                                     (3, 1100, 64), (2, 200, 40),
                                     (3, 200, 12)])
def test_column_sums_are_the_fixed_order(dev, B, T, N):
    """The backward's bias-gradient sums through their kernel alone
    (column_sums), over all M = B T rows (db's, db_res's and db_skip's
    form) and per batch row (dg's), one tensor a launch or two (x beside a
    tensor of the half width, as db and db_res), bit for bit the fixed
    order of tests/_colsum_order.py, two runs alike: `full`'s widths at
    M = 65,536 (2R = S = 256, R = 128), `fastgen_bench`'s at M = 524,288
    (2R = S = 128, R = 64), two splits a batch row of 1,100 rows, M below
    1,024, and last strips of 8, 12, 20 and 4 columns."""
    gen = torch.Generator().manual_seed(N)
    x = (torch.randn(B * T, N, generator=gen) * 0.01).to(dev)
    x[::5] *= -300.0                    # terms of very different sizes
    half = x[:, : N // 2 // 4 * 4 or 4].contiguous() * 3.0
    for rows in (B * T, T):
        want = [order.column_sums(t, rows, ts.ROWS_PER_SPLIT)
                for t in (x, half)]
        before = ts.colsum_launches.value
        one = ts.column_sums(x, T=rows)
        two = ts.column_sums(x, half, T=rows)
        again = ts.column_sums(x, half, T=rows)
        assert ts.colsum_launches.value == before + 3
        assert torch.equal(one[0], want[0])
        assert all(torch.equal(a, w) for a, w in zip(two, want))
        assert all(torch.equal(a, b) for a, b in zip(again, two))


@pytest.mark.parametrize("R,S,nm,speaker,B,T,dmax", [
    (128, 256, 0, False, 8, 8192, 16),     # `full`'s first group
    (64, 128, 0, False, 64, 8192, 8),      # `fastgen_bench`'s widths
    (128, 256, 0, True, 2, 256, 16),       # the speaker test's cases
    (64, 96, 8, True, 3, 200, 64),
    (32, 16, 0, True, 3, 1100, 8),
    (20, 12, 0, True, 2, 200, 8),
    (128, 256, 24, True, 2, 200, 16),
    (64, 96, 20, True, 3, 200, 64),
    (128, 256, 80, False, 2, 256, 16)])    # the mel test's first
def test_group_bias_gradients_are_the_fixed_order(dev, R, S, nm, speaker,
                                                 B, T, dmax):
    """group_bwd's db_skip and its last layer's db_res (the column sums of
    its inputs dskip and dx_out) bit for bit the fixed order, and every
    gradient the same bits in two runs; db and dg sum the layer's dz,
    which only the kernel holds, through the same launcher
    (test_column_sums_are_the_fixed_order)."""
    dils, ops, x, skip, y, gc, dskip, dxo = _group_case(
        R, S, nm, speaker, B, T, dmax, seed=11)
    kf = ts.group_fwd(x, skip, ops, dils, y, gc)
    kb = ts.group_bwd(kf[2], dskip, dxo, ops, dils, y, gc)
    kb2 = ts.group_bwd(kf[2], dskip, dxo, ops, dils, y, gc)
    assert all(torch.equal(a, b) for a, b in zip(kb, kb2))
    sums = lambda t: order.column_sums(t.reshape(B * T, -1), None,
                                       ts.ROWS_PER_SPLIT)[0]
    assert torch.equal(kb[5], sums(dskip))
    assert torch.equal(kb[4][-1], sums(dxo))


def _group_case(R, S, nm, speaker, B, T, dmax, seed):
    """One layer group's inputs at widths (R, S, nm), with a speaker's
    offsets g when `speaker`: (dils, ops, x, skip, y, g, dskip, dx_out)."""
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=dmax,
                                residual_channels=R, skip_channels=S)
    g = torch.Generator().manual_seed(seed)
    dev = torch.device("cuda")
    p = wn.init_params(cfg, g, dev)
    dils = cfg.dilations
    Lg = len(dils)
    rnd = lambda *shape, sc: (torch.randn(*shape, generator=g) * sc).to(dev)
    vc = rnd(Lg, nm, 2, R, sc=0.1) if nm else None
    ops = ts.prep_weights(*(p[k] for k in ts.GROUP_KEYS), vc)
    x = rnd(B, T, R, sc=0.5).to(torch.bfloat16).float()
    y = rnd(B, T, nm, sc=2.0).to(torch.bfloat16) if nm else None
    gc = rnd(B, Lg, 2 * R, sc=0.5) if speaker else None
    return (dils, ops, x, rnd(B, T, S, sc=0.1), y, gc, rnd(B, T, S, sc=0.01),
            rnd(B, T, R, sc=0.01))


@pytest.mark.parametrize("R,S,nm,speaker,B,T,dmax,rows", [
    (256, 256, 0, False, 2, 256, 16, (64, 32)),      # `full`, R = 256
    (128, 1024, 0, False, 2, 200, 16, (64, 32)),     # `full`, S = 1,024
    (128, 512, 0, True, 2, 200, 16, (64, 32)),       # S = 512, speakers
    (192, 1024, 80, False, 2, 128, 8, (64, 32)),     # wide, with mel
    (128, 1392, 0, False, 2, 128, 8, (64, 16)),      # 16 rows
    (32, 16, 80, False, 2, 256, 16, (64, 64)),       # `tiny`, 80 mels
    (8, 16, 24, True, 2, 200, 8, (64, 64)),          # nm > 2R, speakers
    (30, 18, 0, True, 3, 200, 16, (64, 64)),         # padded to 32, 20
    (18, 10, 6, False, 2, 200, 8, (64, 64))])        # padded to 20, 12, 8
def test_train_stack_new_widths_match_plain(dev, R, S, nm, speaker, B, T,
                                            dmax, rows):
    """Widths the kernels refused before: their planned row tiles (the
    forward's, the backward's), nm > 2R, and widths that are not multiples
    of 4, run padded.  Kernel vs plain as at every other width: the
    forward bit for bit, the gradients within the bands, two kernel runs
    bit for bit, and the variant's launch count."""
    dils, ops, x, skip, y, gc, dskip, dxo = _group_case(
        R, S, nm, speaker, B, T, dmax, seed=9)
    Rp, Sp, nmp = ts.padded_widths(R, S, nm)
    assert (ts.fwd_rows(Rp, nmp), ts.bwd_rows(Rp, Sp, nmp)) == rows
    Lg = len(dils)
    c = ts._counters(nm, gc, True), ts._counters(nm, gc, False)
    before = (c[0].value, c[1].value)
    ts.tile_calls.clear()
    kf = ts.group_fwd(x, skip, ops, dils, y, gc)
    kb = ts.group_bwd(kf[2], dskip, dxo, ops, dils, y, gc)
    assert ts.tile_calls == {f"fwd{rows[0]}": 1, f"bwd{rows[1]}": 1}
    assert (c[0].value, c[1].value) == (
        before[0] + Lg + 1,
        before[1] + (7 + 2 * bool(nm) + speaker) * Lg + 1)
    pf = ts.group_fwd_reference(x, skip, ops, dils, y, gc)
    pb = ts.group_bwd_reference(pf[2], dskip, dxo, ops, dils, y, gc)
    assert all(torch.equal(a, b) for a, b in zip(kf, pf))
    assert len(kb) == len(pb)
    for a, b in zip(kb, pb):
        assert a.shape == b.shape
        assert float((a - b).abs().max()) <= 2e-2 * float(b.abs().max())
    kf2 = ts.group_fwd(x, skip, ops, dils, y, gc)
    kb2 = ts.group_bwd(kf2[2], dskip, dxo, ops, dils, y, gc)
    assert all(torch.equal(a, b) for a, b in zip(kf + kb, kf2 + kb2))


@pytest.mark.parametrize("R,S,nm,speaker", [(128, 256, 0, False),
                                            (64, 96, 20, True),
                                            (20, 12, 0, False)])
def test_train_stack_row_tiles_give_the_same_bits(dev, R, S, nm, speaker):
    """Every row tile computes each element's sum the same way, so a
    layer group forced to 32 and 16 rows gives the 64-row result bit for
    bit, forward and backward (T = 200: tiles that straddle batch rows)."""
    dils, ops, x, skip, y, gc, dskip, dxo = _group_case(
        R, S, nm, speaker, 2, 200, 16, seed=10)
    runs = []
    for rows in ts.ROW_TILES:
        kf = ts.group_fwd(x, skip, ops, dils, y, gc, rows=rows)
        runs.append(kf + ts.group_bwd(kf[2], dskip, dxo, ops, dils, y, gc,
                                      rows=rows))
    for other in runs[1:]:
        assert all(torch.equal(a, b) for a, b in zip(runs[0], other))


def _narrow_cfg(R, variant):
    """The widths of the reference's decode tests (R = S = 16), `tiny`
    (R = 32, S = 16) and `fastgen_bench` (R = 64, S = 128), 8 layers, with
    the variant's conditioning (mel: 8 bins; speaker: 5 classes)."""
    S = {16: 16, 32: 16, 64: 128}[R]
    kw = dict(num_blocks=2, max_dilation=8, residual_channels=R,
              skip_channels=S)
    if "mel" in variant:
        kw["mel"] = tconfig.MelConfig(num_mels=8, hop_length=16,
                                      win_length=64, fmax=4000.0,
                                      upsample_factors=(4, 4))
    if "speaker" in variant:
        kw.update(global_classes=5, global_channels=8)
    return tconfig.WaveNetConfig(**kw)


def _counts(mod):
    return (mod.launches.value, mod.mel_launches.value, mod.gc_launches.value)


@pytest.mark.parametrize("variant", ["plain", "mel", "speaker",
                                     "mel_speaker"])
@pytest.mark.parametrize("R", [16, 32, 64])
def test_narrow_decode_kernel_equals_plain(dev, R, variant):
    """The narrow kernel vs the plain version, bit for bit (tokens, rings,
    carry): greedy and sampled, free-running and primed, B = 1, 3 and 64,
    then a chunked run (y sliced per chunk) equal to the one-shot run; each
    launch bumps its variant's counter and no other."""
    cfg = _narrow_cfg(R, variant)
    g = torch.Generator().manual_seed(R)
    w = pnarrow.flatten_params(wn.init_params(cfg, g, dev), cfg)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    which = 2 if cfg.global_classes else 1 if M else 0
    N = 40
    for batch in (1, 3, 64):
        prime = torch.randint(0, 256, (batch, 6), dtype=torch.int32,
                              generator=g).to(dev)
        y = (torch.randn(batch, N, M, generator=g) * 3).to(dev) if M else None
        sp = (torch.randint(0, 5, (batch,), generator=g)
              if cfg.global_classes else None)
        for temp in (0.0, 1.0):
            for forced in (None, prime):
                rings, carry, s, gc, _, _ = pnarrow.setup_decode(
                    cfg, batch, N, forced, seeds=3, device=dev, w=w,
                    speaker=sp)
                before = _counts(pnarrow)
                k = pnarrow.decode_chunk(w, cfg, rings, carry, 0, s, N, temp,
                                         forced, y=y, g=gc)
                want = list(before)
                want[which] += 1
                assert list(_counts(pnarrow)) == want
                p = pnarrow.decode_chunk_reference(w, cfg, rings, carry, 0, s,
                                                   N, temp, forced, y=y, g=gc)
                for a, b in zip(k, p):
                    assert torch.equal(a, b), (batch, temp, forced is None)
        r, c, toks, t0 = rings, carry, [], 0
        for n in (1, 17, 22):
            tk, r, c = pnarrow.decode_chunk(
                w, cfg, r, c, t0, s, n, 1.0,
                y=None if y is None else y[:, t0:t0 + n], g=gc)
            toks.append(tk)
            t0 += n
        one = pnarrow.decode_chunk(w, cfg, rings, carry, 0, s, N, 1.0, y=y,
                                   g=gc)
        assert torch.equal(torch.cat(toks, 1), one[0])
        assert torch.equal(r, one[1]) and torch.equal(c, one[2])


def test_narrow_decode_rows_per_block_do_not_change_a_row(dev):
    """Every tile size (1 to 16 rows per block, ragged last tiles at
    B = 21) gives the same tokens, rings and carry: the replay contract."""
    cfg = _narrow_cfg(64, "mel_speaker")
    g = torch.Generator().manual_seed(9)
    w = pnarrow.flatten_params(wn.init_params(cfg, g, dev), cfg)
    B, N = 21, 30
    y = (torch.randn(B, N, 8, generator=g) * 3).to(dev)
    rings, carry, s, gc, _, _ = pnarrow.setup_decode(
        cfg, B, N, seeds=7, device=dev, w=w,
        speaker=torch.arange(B) % 5)
    outs = [pnarrow.decode_chunk(w, cfg, rings, carry, 0, s, N, 1.0, y=y,
                                 g=gc, rows_per_block=bt)
            for bt in (1, 2, 4, 8, 16)]
    for o in outs[1:]:
        for a, b in zip(o, outs[0]):
            assert torch.equal(a, b)


@pytest.mark.parametrize("mel", [False, True])
def test_wide_decode_kernel_speaker_equals_plain(dev, mel):
    """The wide kernel's speaker variant (with and without mel) vs the
    plain version, bit for bit, for 1-row and multi-row blocks; it counts
    as a speaker launch only."""
    base = _mel_cfg(8) if mel else tconfig.WaveNetConfig(
        num_blocks=2, max_dilation=16, residual_channels=128,
        skip_channels=256)
    cfg = base.replace(global_classes=7)
    g = torch.Generator().manual_seed(11)
    w = pwide.flatten_params(wn.init_params(cfg, g, dev), cfg)
    for batch in (1, 3, 9):
        y = (torch.randn(batch, 50, 8, generator=g) * 3).to(dev) if mel \
            else None
        prime = torch.randint(0, 256, (batch, 5), dtype=torch.int32,
                              generator=g).to(dev)
        for forced in (None, prime):
            rings, carry, s, gc, _, _ = pwide.setup_decode(
                cfg, batch, 50, forced, seeds=2, device=dev, w=w,
                speaker=torch.arange(batch) % 7)
            before = _counts(pwide)
            k = pwide.decode_chunk(w, cfg, rings, carry, 0, s, 50, 1.0,
                                   forced, y=y, g=gc)
            assert _counts(pwide) == (before[0], before[1], before[2] + 1)
            p = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s, 50,
                                             1.0, forced, y=y, g=gc)
            for a, b in zip(k, p):
                assert torch.equal(a, b)


@pytest.mark.parametrize("preset", ["tiny", "small", "fastgen_bench",
                                    "conditional"])
def test_narrow_decode_shared_memory_per_preset(dev, preset):
    """The narrow kernel's shared memory per block (smem_bytes, the size it
    is launched with) fits one block at every tile size for every narrow
    preset; printed (run with -s)."""
    cfg = tconfig.get_config(preset)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    sizes = {bt: pnarrow.smem_bytes(
        bt, cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
        cfg.quantization_channels, M) for bt in (1, 2, 4, 8, 16)}
    print(f"narrow decode shared memory, {preset}: {sizes}")
    assert all(v <= 227 * 1024 for v in sizes.values())
    assert sizes[1] < sizes[16]


@pytest.mark.parametrize("R,S", [(128, 80), (192, 64)])
def test_narrow_decode_widened_widths_equal_plain(dev, R, S):
    """The widths the narrow kernel took over (R = 128 with S = 80, which
    the wide kernel refuses for S, and R = 192): the sampler routes them
    to it, and it equals the plain version bit for bit, greedy and
    sampled, free-running and primed, at 1-row and multi-row blocks."""
    from wavenet_tpu_torch.generate import sampler
    cfg = tconfig.WaveNetConfig(num_blocks=2, max_dilation=8,
                                residual_channels=R, skip_channels=S)
    assert sampler.kernel_module(cfg, dev) is pnarrow
    g = torch.Generator().manual_seed(R + S)
    w = pnarrow.flatten_params(wn.init_params(cfg, g, dev), cfg)
    for batch in (1, 5):
        prime = torch.randint(0, 256, (batch, 4), dtype=torch.int32,
                              generator=g).to(dev)
        for temp in (0.0, 1.0):
            for forced in (None, prime):
                rings, carry, s, _, _, _ = pnarrow.setup_decode(
                    cfg, batch, 30, forced, seeds=5, device=dev, w=w)
                for bt in (None, 4):
                    k = pnarrow.decode_chunk(w, cfg, rings, carry, 0, s, 30,
                                             temp, forced, rows_per_block=bt)
                    p = pnarrow.decode_chunk_reference(
                        w, cfg, rings, carry, 0, s, 30, temp, forced)
                    for a, b in zip(k, p):
                        assert torch.equal(a, b), (batch, temp, bt)


@pytest.mark.parametrize("R,S,Q,M", [(16, 16, 256, 0), (64, 128, 256, 80),
                                     (128, 80, 256, 0), (192, 64, 64, 8)])
def test_narrow_decode_plans_equal_plain(dev, R, S, Q, M):
    """The kernel launched with decode.py's plan (staged or in-place
    blobs, the head resident or not, the shared-memory offsets, from plan
    and smem_bytes, at widths whose plans differ, with and without mel)
    equals the plain version bit for bit at every tile size whose block
    fits 227 KiB; a larger one is refused before launch."""
    mel = None if not M else _mel_cfg(M).mel
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=4,
                                residual_channels=R, skip_channels=S,
                                quantization_channels=Q, mel=mel)
    g = torch.Generator().manual_seed(R + S + Q + M)
    w = pnarrow.flatten_params(wn.init_params(cfg, g, dev), cfg)
    batch, steps = 16, 12
    y = (None if not M else
         (torch.randn(batch, steps, M, generator=g) * 3).to(dev))
    rings, carry, s, _, _, _ = pnarrow.setup_decode(cfg, batch, steps,
                                                    None, seeds=3,
                                                    device=dev, w=w)
    p = pnarrow.decode_chunk_reference(w, cfg, rings, carry, 0, s, steps,
                                       1.0, y=y)
    for bt in (1, 2, 4, 8, 16):
        if pnarrow.smem_bytes(bt, cfg.num_layers, R, S, Q, M) > 227 * 1024:
            assert bt > 1
            with pytest.raises(ValueError, match="shared"):
                pnarrow.decode_chunk(w, cfg, rings, carry, 0, s, steps, 1.0,
                                     y=y, rows_per_block=bt)
            continue
        k = pnarrow.decode_chunk(w, cfg, rings, carry, 0, s, steps, 1.0,
                                 y=y, rows_per_block=bt)
        for a, b in zip(k, p):
            assert torch.equal(a, b), (bt, pnarrow.plan(bt, 1, R, S, Q, M))


def test_probe_kernels_equal_their_plain_versions(dev):
    """P1-P4 (csrc/probes.cu) against their plain versions, each launch
    counted: P1 every mode exact and equal to the probes' printed
    expectations; P2 elementwise within 4 ulps of torch's CPU tanh and
    sigmoid (the card's tanhf and expf against the CPU's; the count is
    measured by the verify tool); P3 a and b exact, c within 1e-6 of its
    largest element, also at T = 17 and 300 (ragged row tiles), and a
    misaligned operand refused; P4 exact, 4 launches for its 4 cases, also
    at TT = 300, R = 63 and on an x one element into its buffer.  P2 also
    on a view one element into its buffer, n = 8,190 and 5 (one element at
    a time), and at n = 8,191 from its start (pairs and an odd last
    element).  P1's "ring_launches" also twice with nothing between the
    calls (the second's ring is the memory the first just freed; its
    launches run under PDL)."""
    from wavenet_tpu_torch.ops.cuda import probes
    before = probes.scratch_launches.value
    for mode, (_, rows, tiles, expect) in probes.SCRATCH_MODES.items():
        got = probes.probe_scratch(mode, dev).cpu()
        assert torch.equal(got, probes.probe_scratch_reference(mode))
        want = torch.tensor(expect, dtype=torch.float32)
        assert torch.equal(got[:, :, 0, 0], want)
    assert probes.scratch_launches.value == before + 4 + 4
    calls = [probes.probe_scratch("ring_launches", dev) for _ in range(2)]
    assert probes.scratch_launches.value == before + 8 + 8
    for got in calls:
        assert torch.equal(got.cpu(),
                           probes.probe_scratch_reference("ring_launches"))
    inp, cpu = probes.probe_inputs(dev), probes.probe_inputs("cpu")
    for got, want in zip(probes.probe_gate(inp["gate_x"]),
                         probes.probe_gate_reference(cpu["gate_x"])):
        assert probes.ulps(got, want) <= probes.GATE_ULPS == 4
    for off, n in ((1, 8190), (1, 5), (0, 8191)):
        buf = torch.linspace(-30.0, 30.0, n + off)
        gate = probes.gate_launches.value
        got = probes.probe_gate(buf.to(dev)[off:])
        assert probes.gate_launches.value == gate + 1
        for a, b in zip(got, probes.probe_gate_reference(buf[off:])):
            assert a.shape == (n,) and probes.ulps(a, b) <= 4
    for T in (256, 17, 300):
        lin, lcpu = ((inp, cpu) if T == 256 else
                     (probes.lane_inputs(T, dev),
                      probes.lane_inputs(T, "cpu")))
        for case in probes.LANE_CASES:
            ops = probes.LANE_OPS[case]
            lane = probes.lane_launches.value
            got = probes.probe_lane_ops(case, *(lin[k] for k in ops))
            assert probes.lane_launches.value == lane + 1
            want = probes.probe_lane_ops_reference(case,
                                                   *(lcpu[k] for k in ops))
            for a, b in zip(got, want):
                if case == "c":
                    assert float((a.cpu() - b).abs().max()) <= 1e-6 * float(
                        b.abs().max())
                else:
                    assert torch.equal(a.cpu(), b), (case, T)
    x = torch.empty(300 * 64 + 1, device=dev)[1:].view(300, 64)
    with pytest.raises(ValueError, match="aligned"):
        probes.probe_lane_ops("c", x, lin["yf"], lin["wf"])
    for T, R, off in ((probes.TT, probes.R, 0), (300, 63, 0),
                      (probes.TT, probes.R, 1)):
        sin, scpu = ((inp, cpu) if (T, R, off) == (probes.TT, probes.R, 0)
                     else (probes.shift_inputs(T, R, dev, offset=off),
                           probes.shift_inputs(T, R, "cpu", offset=off)))
        assert sin["shift_x"].data_ptr() % 16 == 4 * off
        shift = probes.shift_launches.value
        for case in probes.SHIFT_CASES:
            ring = "snaps" if case == "B" else "ring"
            assert torch.equal(
                probes.probe_shift_concat(case, sin[ring],
                                          sin["shift_x"]).cpu(),
                probes.probe_shift_concat_reference(case, scpu[ring],
                                                    scpu["shift_x"])), (
                case, T, R, off)
        assert probes.shift_launches.value == shift + 4


@pytest.mark.parametrize("variant", ["plain", "mel", "speaker"])
@pytest.mark.parametrize("R", [32, 128])
def test_decode_op_equals_the_kernel(dev, monkeypatch, R, variant):
    """torch.ops.wavenet_tpu_torch.generate (the op an AOT artifact calls)
    on CUDA tensors: one launch of the kernel the widths select (narrow at
    R = 32, wide at R = 128), of the variant's counter, tokens equal to
    that kernel's direct call at the same seeds, and never the plain
    version; a second call reuses the kernel layout."""
    from wavenet_tpu_torch.ops.cuda import decode_common, decode_op
    from wavenet_tpu_torch.utils.pytree_io import flatten_tree
    mod = pwide if R == 128 else pnarrow
    cfg = _narrow_cfg(32, variant).replace(residual_channels=R,
                                           skip_channels=128)
    params = wn.init_params(cfg, torch.Generator().manual_seed(R), dev)
    flat = flatten_tree(params)
    B, N = 3, 50
    seeds = rng.derive_row_seeds(11, B).to(dev)
    y = (torch.randn(B, N, 8, generator=torch.Generator().manual_seed(2))
         .to(dev) if cfg.mel else None)
    sp = (torch.tensor([0, 4, 2], dtype=torch.int32, device=dev)
          if cfg.global_classes else None)

    def refuse(*a, **k):
        raise AssertionError("a CUDA tensor reached the plain decode")
    monkeypatch.setattr(mod, "decode_chunk_reference", refuse)
    which = 2 if cfg.global_classes else 1 if cfg.mel else 0
    for _ in range(2):
        before = list(_counts(mod))
        got = torch.ops.wavenet_tpu_torch.generate(
            [flat[k] for k in sorted(flat)], seeds, y, sp, N, 1.0,
            cfg.to_json())
        before[which] += 1
        assert list(_counts(mod)) == before
    w = decode_op.decode_weights([flat[k] for k in sorted(flat)],
                                 cfg.to_json())
    want = decode_common.generate_one_shot(mod.decode_chunk, w, cfg, N, B,
                                           None, 1.0, seeds, dev, y, sp)
    assert torch.equal(got, want)
