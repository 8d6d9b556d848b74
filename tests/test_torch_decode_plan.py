"""The wide decode kernel's launch plan (ops/cuda/decode_wide.py
plan_clusters), its shared-memory mirror and its packed weight shares, on
the CPU.

The kernel (csrc/decode_wide.cu) runs one batch tile's layer chain over a
thread-block cluster of C CTAs, each owning R / C gate channels and S / C
skip columns; it needs R / C a multiple of 8 and S / C even, and at most
227 KiB of shared memory per CTA.  These tests hold the plan to that for
the presets and a grid of widths (R in {128, 256, 384}, S in {32, 96,
256}, with and without mel features (M = 80, 8) and speakers), plan every
width the one-block kernel before the cluster design launched (up to
R = 5,760), and pin `supported` to the widths it took before.  The kernel
against its plain version is in tests/test_torch_kernels.py (on the
card).
"""

import pytest
import torch

from wavenet_tpu_torch import config as tconfig
from wavenet_tpu_torch.models import wavenet as twn
from wavenet_tpu_torch.ops.cuda import decode_common
from wavenet_tpu_torch.ops.cuda import decode_wide as pw

torch.set_num_threads(1)

BATCHES = (1, 3, 4, 9, 64, 300)
SMEM = 227 * 1024


def held(plan) -> int:
    """Clusters of a plan's shape a card holds at once, as max_clusters
    reports it on the card: here one CTA per SM of 132."""
    return 132 // plan.cluster


def smem_before(cfg, rows=1) -> int:
    """The shared memory of the one-block kernel before the cluster design
    (one block of `rows` rows per tile, f64 x, old, h, skip and s1, with
    mel y and its partial sums, and f32 z, scores and tokens); it launched
    every supported width where this was at most 227 KiB."""
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    return (8 * rows * (3 * R + 2 * S + (M + 4 * R if M else 0))
            + 4 * (rows * (4 * R + S + Q) + 3 * rows + 2 * L))


def taken_before(cfg) -> bool:
    """supported() as it stood before the cluster design."""
    R, S = cfg.residual_channels, cfg.skip_channels
    return (R >= 128 and R % 128 == 0 and S % 32 == 0 and cfg.kernel_size == 2
            and cfg.compute_dtype == "bfloat16" and cfg.embed_channels == R)


def variants(cfg):
    """cfg with and without mel features (M = 80, 8) and speakers."""
    for mel in (None, tconfig.MelConfig(num_mels=80),
                tconfig.MelConfig(num_mels=8)):
        for speakers in (None, 109):
            yield cfg.replace(mel=mel, global_classes=speakers)


def check_plan(cfg, batch, plan):
    R, S, Q = (cfg.residual_channels, cfg.skip_channels,
               cfg.quantization_channels)
    C = plan.cluster
    assert 2 <= C <= pw.MAX_CLUSTER
    assert R % C == 0 and (R // C) % 8 == 0       # whole 16-byte copies
    assert S % C == 0 and (S // C) % 2 == 0
    assert Q >= C                                 # ragged, non-empty shares
    assert plan.rows in pw.ROWS
    assert plan.threads % 32 == 0 and plan.threads >= 32 * plan.rows
    assert pw.smem_bytes(plan.rows, C, plan.threads, plan.stage,
                         plan.scatter, cfg) <= SMEM
    if plan.rows > 1:                             # the all-reduce: one row
        assert plan.scatter


@pytest.mark.parametrize("R", [128, 256, 384])
@pytest.mark.parametrize("S", [32, 96, 256])
def test_plan_fits_every_width(R, S):
    """Every grid width is supported, as before, and plans a cluster that
    splits it into whole shares within 227 KiB, at every batch."""
    base = tconfig.WaveNetConfig(num_blocks=2, max_dilation=512,
                                 residual_channels=R, skip_channels=S)
    for cfg in variants(base):
        assert pw.supported(cfg) and taken_before(cfg)
        for batch in BATCHES:
            check_plan(cfg, batch, pw.plan_clusters(batch, cfg, held))


@pytest.mark.parametrize("preset", sorted(tconfig.PRESETS))
def test_plan_per_preset(preset):
    """The wide presets plan 16 CTAs per cluster and stage their layer
    shares, by the all-reduce at one row per cluster; every preset keeps
    the route it had (supported unchanged)."""
    for cfg in variants(tconfig.get_config(preset)):
        assert pw.supported(cfg) == taken_before(cfg)
        if not pw.supported(cfg):
            continue
        for batch in BATCHES:
            plan = pw.plan_clusters(batch, cfg, held)
            check_plan(cfg, batch, plan)
            assert plan.cluster == 16 and plan.stage
            assert plan.scatter == (plan.rows > 1)


def test_supported_takes_what_it_took():
    """supported() is pinned to the widths taken before, refusals
    included (those go to the narrow kernel or the plain route)."""
    for R in (64, 96, 128, 192, 256, 320, 384, 512, 1024):
        for S in (16, 32, 48, 64, 96, 128, 256, 512):
            for extra in ({}, {"kernel_size": 3},
                          {"compute_dtype": "float32"},
                          {"causal_channels": 64}):
                cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=2,
                                            residual_channels=R,
                                            skip_channels=S, **extra)
                assert pw.supported(cfg) == taken_before(cfg), (R, S, extra)


def test_default_rows_spread_then_grow():
    """One row per cluster while every tile's cluster runs at once (as many
    as the card holds, 14 clusters of 16 on an H100); rows double past
    that, up to 8 as far as shared memory allows, and a batch far past the
    card still plans (the clusters run in turns).  A shape the card cannot
    hold (0) is not planned."""
    cfg = tconfig.full()
    fourteen = lambda plan: 14
    rows = {b: pw.plan_clusters(b, cfg, fourteen).rows
            for b in (1, 4, 9, 14, 15, 28, 29, 56, 57)}
    assert rows == {1: 1, 4: 1, 9: 1, 14: 1, 15: 2, 28: 2, 29: 4, 56: 4,
                    57: 8}
    big = pw.plan_clusters(10_000, cfg, fourteen)
    check_plan(cfg, 10_000, big)
    assert big.rows == 8 and big.stage
    # the rows follow the card's count, not its SMs: fewer held, more rows
    assert pw.plan_clusters(9, cfg, lambda plan: 4).rows == 4
    # no 16-CTA cluster fits the card: 8 CTAs
    eight = pw.plan_clusters(4, cfg, lambda p: 0 if p.cluster == 16 else 28)
    assert (eight.cluster, eight.rows) == (8, 1)
    with pytest.raises(ValueError):
        pw.plan_clusters(4, cfg, lambda plan: 0)


def test_forced_plans_and_refusals():
    """A forced cluster size, rows per cluster and exchange are taken as
    given when they split the widths and fit; others raise ValueError."""
    cfg = tconfig.full()
    for C in (2, 4, 8, 16):
        for rows in (1, 2, 4, 8):
            plan = pw.plan_clusters(4, cfg, held, C, rows)
            assert (plan.cluster, plan.rows) == (C, rows)
            check_plan(cfg, 4, plan)
            for scatter in (False, True):
                if not scatter and rows == 8:
                    continue          # all-reduce buffers of 8 rows
                plan = pw.plan_clusters(4, cfg, held, C, rows, scatter)
                assert (plan.cluster, plan.rows, plan.scatter) == (
                    C, rows, scatter)
    for bad in ({"cluster": 32}, {"cluster": 3}, {"cluster": 0},
                {"cluster": 1}, {"rows": 3}, {"rows": 16}):
        with pytest.raises(ValueError):
            pw.plan_clusters(4, cfg, held, bad.get("cluster"),
                             bad.get("rows"))
    # S = 32 with C = 32 would leave one skip column per CTA
    with pytest.raises(ValueError):
        pw.plan_clusters(4, cfg.replace(skip_channels=32), held, 32)
    # R = 4096: the all-reduce's buffers do not fit, the scatter's do;
    # R = 10240: x, old and the scatter's partial sums need 240 KiB a row
    wide = tconfig.WaveNetConfig(num_blocks=1, max_dilation=2,
                                 residual_channels=4096, skip_channels=32)
    with pytest.raises(ValueError):
        pw.plan_clusters(1, wide, held, scatter=False)
    assert pw.plan_clusters(1, wide, held).scatter
    wider = wide.replace(residual_channels=10240)
    assert pw.supported(wider)
    with pytest.raises(ValueError):
        pw.plan_clusters(1, wider, held)


def test_small_quantization_takes_smaller_cluster():
    """Q below 16 leaves a CTA no logits at C = 16: the default halves C
    until every share is non-empty."""
    cfg = tconfig.full().replace(quantization_channels=10)
    plan = pw.plan_clusters(4, cfg, held)
    assert plan.cluster == 8
    check_plan(cfg, 4, plan)


def test_wide_share_in_place_when_staging_does_not_fit():
    """A width whose two stage buffers do not fit reads its shares in
    place (R = 2048: 2 x ~1.3 MB of shares per CTA), still within 227
    KiB."""
    cfg = tconfig.WaveNetConfig(num_blocks=1, max_dilation=2,
                                residual_channels=2048, skip_channels=256)
    plan = pw.plan_clusters(1, cfg, held)
    assert not plan.stage
    check_plan(cfg, 1, plan)


@pytest.mark.parametrize("mel", [False, True])
def test_pack_shares_layout(mel):
    """Each [l, c] block of the pack holds CTA c's share of layer l:
    W_cur and W_prev columns of its gate channels (z_f, then z_g), V_cond
    the same with mel, the W_skip and W_res rows of its h slice, then its
    biases' f32 bits; and the pack is made anew when a weight changes."""
    base = tconfig.WaveNetConfig(num_blocks=1, max_dilation=4,
                                 residual_channels=128, skip_channels=64)
    cfg = base.replace(mel=tconfig.MelConfig(num_mels=8)) if mel else base
    params = twn.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    w = decode_common.flatten_params(params, cfg)
    R, S, L = 128, 64, cfg.num_layers
    M = 8 if mel else 0
    for C in (2, 16):
        pack = pw.packed_shares(w, cfg, C)
        assert pack.shape == (L, C, pw.share_elems(C, cfg))
        assert pack.dtype == torch.bfloat16
        hc, sc = R // C, S // C
        for l in range(L):
            for c in (0, C - 1):
                blk, lo = pack[l, c], c * hc
                gate = lambda x: torch.cat([x[:, lo:lo + hc],
                                            x[:, R + lo:R + lo + hc]], 1)
                want = [gate(w["w_cur"][l]), gate(w["w_prev"][l])]
                if mel:
                    want.append(gate(w["v_cond"][l]))
                want += [w["w_skip"][l][lo:lo + hc], w["w_res"][l][lo:lo + hc]]
                o = 0
                for x in want:
                    n = x.numel()
                    assert torch.equal(blk[o:o + n].view(x.shape), x)
                    o += n
                bias = torch.cat([w["b"][l][lo:lo + hc],
                                  w["b"][l][R + lo:R + lo + hc], w["b_res"][l],
                                  w["b_skip"][l][c * sc:(c + 1) * sc]])
                got = blk[o:o + 2 * bias.numel()].contiguous()
                assert torch.equal(got.view(torch.float32), bias)
                assert o + 2 * bias.numel() == (2 * R * 2 * hc + M * 2 * hc
                                                + hc * S + hc * R
                                                + 2 * (2 * hc + R + sc))
    assert pw.packed_shares(w, cfg, 16) is pw.packed_shares(w, cfg, 16)
    before = pw.packed_shares(w, cfg, 16)
    w["w_res"].add_(1.0)                       # an in-place update
    after = pw.packed_shares(w, cfg, 16)
    assert after is not before and not torch.equal(after, before)


@pytest.mark.parametrize("M", [0, 80])
@pytest.mark.parametrize("S", [32, 256, 1024, 4096, 8192])
def test_plan_takes_every_width_taken_before(S, M):
    """Every width the one-block kernel launched before the cluster design
    (R up to 5,760, S up to 8,192, Q 16 to 30,000, with and without
    speakers) plans one row per cluster within 227 KiB: the all-reduce
    where its buffers fit, else the scatter (always past R = 3,328)."""
    taken = 0
    for R in range(128, 6145, 128):
        for Q in (16, 256, 30000):
            for speakers in (None, 109):
                cfg = tconfig.WaveNetConfig(
                    num_blocks=1, max_dilation=2, residual_channels=R,
                    skip_channels=S, quantization_channels=Q,
                    mel=tconfig.MelConfig(num_mels=M) if M else None,
                    global_classes=speakers)
                assert pw.supported(cfg)
                if smem_before(cfg) > SMEM:
                    continue
                plan = pw.plan_clusters(1, cfg, held)
                check_plan(cfg, 1, plan)
                taken += 1
                assert plan.scatter == (pw.smem_bytes(
                    1, plan.cluster, plan.threads, plan.stage, False,
                    cfg) > SMEM)
                assert plan.scatter or R <= 3328
    assert taken > 0


def test_decode_phases_variants():
    """utils/decode_phases.py's variants are built with macros the kernel
    reads (a change to the kernel that drops one fails here), and the tool
    refuses without a card."""
    from wavenet_tpu_torch.ops.cuda import build
    from wavenet_tpu_torch.utils import decode_phases
    source = (build.CSRC / "decode_wide.cu").read_text()
    flags = decode_phases.variants()
    assert set(flags) == {"kernel", "skeleton", *decode_phases.PARTS}
    assert flags["kernel"] == []
    assert sorted(flags["skeleton"]) == sorted(
        "-D" + m for m in decode_phases.PARTS.values())
    for macro in decode_phases.PARTS.values():
        assert f"#ifdef {macro}\n" in source
        assert flags[next(n for n, m in decode_phases.PARTS.items()
                          if m == macro)] == ["-D" + macro]
    if not torch.cuda.is_available():
        assert decode_phases.main([]) == 1


def test_decode_times_refuses_without_a_card():
    """utils/decode_times.py (the wide kernel's step times by shape) needs
    the card; its cases are the presets' widths."""
    from wavenet_tpu_torch.utils import decode_times
    names = [c[0] for c in decode_times.CASES]
    assert len(set(names)) == len(names)
    for _, make, batch, plan in decode_times.CASES:
        cfg = make()
        assert pw.supported(cfg) and batch >= 1
        pw.plan_clusters(batch, cfg, held, plan.get("cluster"),
                         plan.get("rows_per_cluster"))
    if not torch.cuda.is_available():
        assert decode_times.main([]) == 1

