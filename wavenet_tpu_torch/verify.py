"""The port's kernel-verification tool: every CUDA kernel against its plain
PyTorch version on the card, the probes, the scan-only configs and the
golden fixtures.  Counterpart of tools/tpu_verify.py; run it after any
kernel change or toolchain update:

    python -m wavenet_tpu_torch.verify [--quick] [--device cuda|cpu]
                                       [--golden DIR]

Exit 0: every comparison BIT-EXACT or inside its band; 2: the only
findings are DRIFTs (which only the train_stack kernels can give: they sum
f32 in another order than their plain versions); 1: any FAIL.  Without a
card it refuses to run (exit 1), as the reference refuses the CPU;
--device cpu runs every check with the plain version on both sides (what
the CPU tests drive), at reduced sizes.

Families, each in a fresh subprocess (never reuse a process's warm state
across families):
  stack          the train_stack kernels (forward skip sum, every
                 gradient): `small`'s widths at T = 1024, unconditional,
                 mel and speaker; a multi-group plan (small dims, budget
                 squeezed to 3+ groups); `full`'s widths at one group.
  decode_narrow  csrc/decode.cu: greedy, batch-tiled (2 rows per block),
                 sampled at temperature 1, primed, mel, speaker, `full`'s
                 widths, and the two widths it took over from the wide
                 kernel's refusals (R = 128 with S = 80, R = 192); then
                 the scan_route_divergence counterpart (measured).
  decode_wide    csrc/decode_wide.cu: the same variants, batch-tiled at
                 B = 264 (4 rows per cluster, 66 clusters in turns),
                 plus the `full` and `full_vocoder` presets (the
                 reference's check 7).
  scan_k3        check 8: a K = 3, f32 model on the plain route on the
                 card; the ring decoder teacher-forced equals
                 forward_logits within 1e-4, fast == naive greedy.
  probes         P1-P4 (ops/cuda/probes.py) against their plain versions
                 and the probes' expectations (P3's f32 case within 1e-6
                 of its largest element, P2 within probes.GATE_ULPS of
                 torch's CPU values); P2's ulp counts against torch's and
                 JAX's (probes.npz) CPU values.
  golden         the kernels against the JAX package's CPU outputs
                 (tests/golden_torch/): the fused loss within 2e-3,
                 teacher-forced argmax of the fused stack >= 99% where
                 JAX's top-2 margin exceeds bf16 noise (utils/golden.py
                 argmax_agreement), and the decode kernel
                 teacher-forced on JAX's greedy and sampled trajectories,
                 flips <= 1% of the steps whose JAX margin exceeds bf16
                 noise (P2 decides: the card's tanhf and expf are not
                 JAX's to the bit, so logits are not held exactly).
--quick runs the multi-group stack check and the batch-tiled narrow decode.

Every decode comparison is exact-only: the decode kernels sum each dot
product exactly, so any difference from the plain version is a FAIL.
The last line of a run is `VERIFY_COUNTS {json}`: every kernel wrapper's
launch count summed over the families, each family's counts set to 0 at
its start.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from typing import Dict, List

import numpy as np
import torch

BF16_ULP = 2.0 ** -7          # elementwise rel step at the bf16 mantissa
FAMILIES = ("stack", "decode_narrow", "decode_wide", "scan_k3", "probes",
            "golden")
QUICK = ("stack", "decode_narrow")

FAILURES: List[str] = []
DRIFTS: List[str] = []


# ---------------------------------------------------------------------------
# classification (tools/tpu_verify.py:65-126)
# ---------------------------------------------------------------------------

def _np(a) -> np.ndarray:
    if isinstance(a, torch.Tensor):
        a = a.detach().float().cpu().numpy()
    return np.asarray(a)


def report(name: str, ok: bool, detail: str = "") -> None:
    print(f"{name}: {'BIT-EXACT' if ok else 'FAIL ' + detail}", flush=True)
    if not ok:
        FAILURES.append(name)


def drift_stats(a, b):
    """(global rel, median nonzero elementwise rel) of a vs b in f64."""
    a, b = _np(a).astype(np.float64), _np(b).astype(np.float64)
    diff = np.abs(a - b)
    gscale = max(np.abs(b).max(), 1e-6)
    nz = diff > 0
    if not nz.any():
        return 0.0, 0.0
    elem_rel = diff[nz] / np.maximum(np.abs(b[nz]), 1e-6)
    return float(diff.max() / gscale), float(np.median(elem_rel))


def classify_cmp(a, b, drift_band: float = 0.02) -> str:
    """BIT-EXACT when equal; DRIFT when the median nonzero elementwise
    difference is within one bf16 ulp and the largest within drift_band of
    the largest value; else FAIL."""
    if np.array_equal(_np(a), _np(b)):
        return "BIT-EXACT"
    grel, med = drift_stats(a, b)
    return "DRIFT" if med <= BF16_ULP and grel <= drift_band else "FAIL"


def classify_grad(a, b, band: float) -> str:
    """BIT-EXACT (inside the band) when the largest difference is below
    band of the largest value; DRIFT up to 0.15 with a bf16-ulp median;
    else FAIL."""
    grel, med = drift_stats(a, b)
    if grel < band:
        return "BIT-EXACT"
    return "DRIFT" if med <= BF16_ULP and grel <= 0.15 else "FAIL"


def _record(name: str, verdict: str, detail: str) -> None:
    print(f"{name}: {verdict} {detail}".rstrip(), flush=True)
    if verdict == "DRIFT":
        DRIFTS.append(name)
    elif verdict == "FAIL":
        FAILURES.append(name)


def report_cmp(name: str, a, b, drift_band: float = 0.02) -> None:
    verdict = classify_cmp(a, b, drift_band)
    grel, med = drift_stats(a, b)
    _record(name, verdict, "" if verdict == "BIT-EXACT" else
            f"(global rel {grel:.3e}, median elem rel {med:.3e})")


def report_grad(name: str, a, b, band: float) -> None:
    verdict = classify_grad(a, b, band)
    grel, med = drift_stats(a, b)
    _record(name, verdict, f"(max rel diff {grel:.3e}, median elem rel "
            f"{med:.3e}, band {band:g})")


def report_grads(tag: str, pairs, band: float) -> None:
    """report_grad for every (name, got, want), printed as one line when
    all are inside the band (the worst named), else a line each."""
    verdicts = [(n, classify_grad(a, b, band), drift_stats(a, b))
                for n, a, b in pairs]
    if all(v == "BIT-EXACT" for _, v, _ in verdicts):
        worst = max(verdicts, key=lambda t: t[2][0])
        print(f"{tag}: {len(verdicts)} gradients BIT-EXACT (max rel diff "
              f"{worst[2][0]:.3e} in {worst[0]}, band {band:g})", flush=True)
        return
    for n, a, b in pairs:
        report_grad(f"{tag} {n}", a, b, band)


def report_exact(name: str, pairs) -> None:
    """Exact-only: every (got, want) pair equal, else FAIL."""
    bad = [i for i, (a, b) in enumerate(pairs)
           if not torch.equal(a.cpu(), b.cpu())]
    detail = ""
    if bad:
        a, b = pairs[bad[0]]
        detail = (f"(output {bad[0]}: {int((a.cpu() != b.cpu()).sum())} "
                  f"elements differ)")
    report(name, not bad, detail)


# ---------------------------------------------------------------------------
# the families
# ---------------------------------------------------------------------------

def _modules():
    from wavenet_tpu_torch.ops.cuda import decode, decode_wide, probes
    from wavenet_tpu_torch.ops.cuda import train_stack
    return decode, decode_wide, train_stack, probes


def counts() -> Dict[str, int]:
    """Every kernel wrapper's launch count, as "<module>.<counter>"."""
    from wavenet_tpu_torch.ops.cuda.build import LaunchCounter
    out = {}
    for mod in _modules():
        short = mod.__name__.rsplit(".", 1)[-1]
        for k, v in vars(mod).items():
            if isinstance(v, LaunchCounter):
                out[f"{short}.{k}"] = v.value
    return out


def _cfg(**kw):
    from wavenet_tpu_torch.config import WaveNetConfig
    return WaveNetConfig(**kw)


def _mel(**kw):
    from wavenet_tpu_torch.config import MelConfig
    return MelConfig(**kw)


def _params(cfg, dev, seed: int = 0):
    from wavenet_tpu_torch.models import wavenet as wn
    return wn.init_params(cfg, torch.Generator().manual_seed(seed), dev)


def _check_stack(tag, cfg, dev, T, B=2, budget=None, min_groups=1):
    from wavenet_tpu_torch.models import conditioning
    from wavenet_tpu_torch.models import wavenet as wn
    from wavenet_tpu_torch.ops.cuda import train_stack as ts
    saved_budget = ts.VMEM_BUDGET
    try:
        if budget is not None:
            ts.VMEM_BUDGET = budget
        groups = ts.group_plan(cfg, ts.pick_tile(cfg, T))
    finally:
        ts.VMEM_BUDGET = saved_budget
    if len(groups) < min_groups:
        report(f"train {tag} plan", False, f"{groups}: < {min_groups} groups")
        return
    params = _params(cfg, dev)
    rs = np.random.RandomState(2)
    toks = torch.from_numpy(rs.randint(0, cfg.quantization_channels,
                                       (B, T)).astype(np.int32)).to(dev)
    ct = torch.from_numpy(rs.randn(B, T, cfg.skip_channels).astype(
        np.float32)).to(dev)
    y = g = None
    with torch.no_grad():
        x = wn.embed_tokens(params, cfg, toks, wn._shifted_tokens(toks))
        if cfg.mel is not None:
            frames = torch.from_numpy(rs.randn(
                B, -(-T // cfg.mel.hop_length), cfg.mel.num_mels).astype(
                    np.float32)).to(dev)
            y = conditioning.upsample_mel(params["upsampler"], cfg.mel,
                                          frames, T).to(torch.bfloat16)
        if cfg.global_classes is not None:
            g = wn.global_cond_offsets(params, cfg, torch.arange(
                B, device=dev) % cfg.global_classes)
        out = []
        for fwd, bwd in ((ts.group_fwd, ts.group_bwd),
                         (ts.group_fwd_reference, ts.group_bwd_reference)):
            skip, saved = ts.stack_forward(params, cfg, groups,
                                           x.contiguous(), fwd, y, g)
            out.append((skip, ts.stack_backward(saved, ct / ct.numel(), bwd,
                                                y)))
    (ks, kg), (ps, pg) = out
    report_cmp(f"train fwd {tag} ({len(groups)} groups)", ks, ps)
    report_grads(f"train {tag} grad", [(n, a, b) for (n, a), (_, b)
                                       in zip(kg, pg)], 1e-4)


def family_stack(dev, quick: bool) -> None:
    cpu = dev.type == "cpu"
    T = 256 if cpu else 1024
    maxd = 64 if cpu else 512
    small = dict(num_blocks=2, max_dilation=maxd, residual_channels=64,
                 skip_channels=64)
    multi = _cfg(**small)
    from wavenet_tpu_torch.ops.cuda import train_stack as ts
    TT = ts.pick_tile(multi, T)
    budget = max(max(ts._group_sizes(multi, TT, multi.dilations[l:l + 4]))
                 for l in range(0, multi.num_layers, 4))
    _check_stack("small-dims multigrp", multi, dev, T, budget=budget,
                 min_groups=3)
    if quick:
        return
    mel = _mel(num_mels=80, hop_length=256, win_length=1024, fmax=8000.0,
               upsample_factors=(16, 16))
    _check_stack("small", _cfg(**small), dev, T)
    _check_stack("small mel", _cfg(mel=mel, **small), dev, T)
    _check_stack("small gc", _cfg(global_classes=4, global_channels=16,
                                  **small), dev, T)
    _check_stack("small mel+gc", _cfg(mel=mel, global_classes=4,
                                      global_channels=16, **small), dev, T)
    _check_stack("full-dims 1grp", _cfg(
        num_blocks=1, max_dilation=32 if cpu else 256, residual_channels=128,
        skip_channels=256), dev, T)


def _decode_case(name, mod, cfg, dev, batch, steps, temperature=0.0,
                 prime=None, speaker=None, mel_frames=None, **kw) -> None:
    """mod.decode_chunk (the kernel on the card) vs decode_chunk_reference
    on the same inputs: tokens, rings and carry equal."""
    from wavenet_tpu_torch.models import conditioning
    params = _params(cfg, dev)
    w = mod.flatten_params(params, cfg)
    rings, carry, seeds, g, _, total = mod.setup_decode(
        cfg, batch, steps, prime, seeds=7, device=dev, w=w, speaker=speaker)
    y = None
    if cfg.mel is not None:
        with torch.no_grad():
            y = conditioning.upsample_mel(params["upsampler"], cfg.mel,
                                          mel_frames, total)
    forced = None if prime is None else prime.to(dev).contiguous()
    k = mod.decode_chunk(w, cfg, rings, carry, 0, seeds, total, temperature,
                         forced, y=y, g=g, **kw)
    p = mod.decode_chunk_reference(w, cfg, rings, carry, 0, seeds, total,
                                   temperature, forced, y=y, g=g)
    report_exact(name, list(zip(k, p)))


def _decode_family(mod, dev, quick: bool, wide: bool) -> None:
    from wavenet_tpu_torch.config import full, full_vocoder
    cpu = dev.type == "cpu"
    N = 16 if cpu else 256
    tag = "wide-decode" if wide else "decode"
    R, S = (128, 256) if wide else (32, 32)
    base = dict(num_blocks=2, max_dilation=64, residual_channels=R,
                skip_channels=S)
    cfg = _cfg(**base)
    g = torch.Generator().manual_seed(5)
    if wide:
        _decode_case(f"{tag} batch-tiled", mod, cfg, dev, 264,
                     8 if cpu else 64, 1.0)
    else:
        _decode_case(f"{tag} batch-tiled", mod, cfg, dev, 8, N,
                     rows_per_block=2)
    if quick:
        return
    _decode_case(f"{tag} greedy", mod, cfg, dev, 8, N)
    _decode_case(f"{tag} sampled t=1", mod, cfg, dev, 4, N, 1.0)
    prime = torch.randint(0, 256, (4, 33), dtype=torch.int32, generator=g)
    _decode_case(f"{tag} primed", mod, cfg, dev, 4, N // 2, prime=prime)
    mel = _mel(num_mels=80, hop_length=64, win_length=256,
               upsample_factors=(8, 8))
    frames = torch.randn(4, -(-N // 64), 80, generator=g).to(dev)
    _decode_case(f"{tag} mel", mod, _cfg(mel=mel, **base), dev, 4, N, 1.0,
                 mel_frames=frames)
    _decode_case(f"{tag} global-cond", mod, _cfg(global_classes=4,
                                                 global_channels=16, **base),
                 dev, 4, N, speaker=torch.arange(4))
    if wide:
        _decode_case(f"{tag} FULL preset sampled", mod, full(), dev, 8,
                     N, 1.0)
        vcfg = full_vocoder()
        frames = torch.randn(8, -(-N // 256), 80, generator=g).to(dev)
        _decode_case(f"{tag} FULL_VOCODER preset mel", mod, vcfg, dev, 8, N,
                     1.0, mel_frames=frames)
        return
    _decode_case(f"{tag} full-dims", mod, _cfg(
        num_blocks=2, max_dilation=64, residual_channels=128,
        skip_channels=256), dev, 8, N, 1.0)
    for R2, S2 in ((128, 80), (192, 64)):
        _decode_case(f"{tag} R={R2} S={S2}", mod, _cfg(
            num_blocks=2, max_dilation=64, residual_channels=R2,
            skip_channels=S2), dev, 4, N, 1.0)
    scan_route_divergence(mod, cfg, dev, 64 if cpu else 512)


def scan_route_divergence(mod, cfg, dev, num_steps: int, batch: int = 4):
    """MEASURED, not pass/fail (tools/tpu_verify.py:467): the kernel decodes
    a greedy trajectory, then the plain decode is teacher-forced on it and
    its per-step argmax compared with the kernel's choice; the count of
    independent near-tie flips."""
    w = mod.flatten_params(_params(cfg, dev), cfg)
    rings, carry, seeds, g, _, _ = mod.setup_decode(cfg, batch, num_steps,
                                                    device=dev, w=w)
    kern, _, _ = mod.decode_chunk(w, cfg, rings, carry, 0, seeds, num_steps,
                                  0.0)
    forced = torch.cat([carry[:, :1], kern], 1).contiguous()
    preds, _, _ = mod.decode_chunk_reference(w, cfg, rings, carry, 0, seeds,
                                             num_steps, 0.0, forced)
    flips = (preds != kern).cpu()
    cols = flips.any(0).nonzero()
    out = {"tokens": int(kern.numel()), "near_tie_flips": int(flips.sum()),
           "first_flip_step": int(cols[0]) if len(cols) else -1,
           "config": f"R={cfg.residual_channels},L={cfg.num_layers}",
           "num_steps": num_steps}
    print(f"scan_route_divergence (measured): {json.dumps(out)}", flush=True)


def family_decode_narrow(dev, quick: bool) -> None:
    from wavenet_tpu_torch.ops.cuda import decode
    _decode_family(decode, dev, quick, wide=False)


def family_decode_wide(dev, quick: bool) -> None:
    from wavenet_tpu_torch.ops.cuda import decode_wide
    _decode_family(decode_wide, dev, quick, wide=True)


def family_scan_k3(dev, quick: bool) -> None:
    """Check 8 (tools/tpu_verify.py:515): a K = 3, f32 model, no kernel
    route, on the device."""
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.models import wavenet as wn
    cfg = _cfg(num_blocks=2, max_dilation=8, kernel_size=3,
               residual_channels=16, skip_channels=8,
               quantization_channels=64, compute_dtype="float32")
    before = counts()
    p = _params(cfg, dev)
    T = cfg.receptive_field + 13
    toks = torch.from_numpy(np.random.RandomState(1).randint(
        0, 64, (2, T)).astype(np.int32)).to(dev)
    with torch.no_grad():
        full = wn.forward_logits(p, cfg, toks)
        st, steps = wn.decode_init(cfg, 2, dev), []
        for t in range(T):
            st, lg = wn.decode_step(p, cfg, st, toks[:, t])
            steps.append(lg)
    d = float((torch.stack(steps, 1) - full).abs().max())
    report("k3 scan ring==forward (f32 allclose)", d < 1e-4,
           f"max abs diff {d:.2e}")
    t = time.monotonic()
    fast = sampler.generate_auto(p, cfg, 64, batch=2, temperature=0.0,
                                 device=dev)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    ms = (time.monotonic() - t) * 1e3 / 64
    print(f"k3 plain route (measured): {ms:.4f} ms per decode step, B = 2, "
          f"{cfg.num_layers} layers, on {dev.type}", flush=True)
    naive = sampler.generate_naive(p, cfg, 64, batch=2, temperature=0.0,
                                   device=dev)
    eq = int((fast == naive).sum())
    report("k3 scan fast==naive greedy", eq == fast.numel(),
           f"{eq}/{fast.numel()} tokens")
    report("k3 scan took no kernel", counts() == before,
           f"{before} -> {counts()}")


def _ulp_report(name, got, want, x, limit=None) -> None:
    """Print the differences of f32 arrays got vs want over inputs x:
    count, largest distance in ulps, the input range where they differ;
    a FAIL when that distance exceeds `limit` (None: measured only)."""
    from wavenet_tpu_torch.ops.cuda import probes
    g, w = _np(got).reshape(-1), _np(want).reshape(-1)
    xs = _np(x).reshape(-1)
    ne = g != w
    out = {"differ": int(ne.sum()), "of": int(g.size),
           "max_ulps": probes.ulps(g, w),
           "x_range": ([float(xs[ne].min()), float(xs[ne].max())]
                       if ne.any() else None)}
    bad = limit is not None and out["max_ulps"] > limit
    print(f"{name}: {'FAIL ' if bad else ''}{json.dumps(out)}", flush=True)
    if bad:
        FAILURES.append(name)


def family_probes(dev, quick: bool, golden_dir) -> None:
    from wavenet_tpu_torch.ops.cuda import probes
    for mode, (_, rows, tiles, expect) in probes.SCRATCH_MODES.items():
        got = probes.probe_scratch(mode, dev)
        want = probes.probe_scratch_reference(mode)
        exp = torch.tensor(expect, dtype=torch.float32)[:, :, None, None]
        report_exact(f"P1 scratch {mode}",
                     [(got, want), (got, exp.expand(rows, tiles, 8, 128))])
    inp = probes.probe_inputs(dev)
    cpu_in = probes.probe_inputs("cpu")
    gate = probes.probe_gate(inp["gate_x"])
    torch_cpu = probes.probe_gate_reference(cpu_in["gate_x"])
    stored = _load(golden_dir, "probes")
    for i, name in enumerate(("tanh", "sigmoid", "gate")):
        _ulp_report(f"P2 {name} vs torch cpu (<= {probes.GATE_ULPS} ulps)",
                    gate[i], torch_cpu[i], cpu_in["gate_x"],
                    probes.GATE_ULPS)
        if stored is not None:
            _ulp_report(f"P2 {name} vs JAX cpu (measured)", gate[i],
                        stored["gate_" + "tsg"[i]], cpu_in["gate_x"])
    for case, ops in probes.LANE_OPS.items():
        got = probes.probe_lane_ops(case, *(inp[k] for k in ops))
        want = probes.probe_lane_ops_reference(case, *(cpu_in[k]
                                                       for k in ops))
        # case c: the kernel's f64 sum rounded once against torch's f32
        # product, inside 1e-6 or FAIL
        if case == "c":
            grel, _ = drift_stats(got[0], want[0])
            _record("P3 lane c (f32)", "BIT-EXACT" if grel <= 1e-6
                    else "FAIL", f"(max rel diff {grel:.3e}, band 1e-06)")
        else:
            report_exact(f"P3 lane {case}", list(zip(got, want)))
    for case in probes.SHIFT_CASES:
        ring = "snaps" if case == "B" else "ring"
        got = probes.probe_shift_concat(case, inp[ring], inp["shift_x"])
        want = probes.probe_shift_concat_reference(case, cpu_in[ring],
                                                   cpu_in["shift_x"])
        pairs = [(got, want)]
        if stored is not None:
            pairs.append((got, torch.from_numpy(stored[f"shift_{case}"])))
        report_exact(f"P4 shift {case}", pairs)
    if stored is None:
        report("P2/P4 goldens", False, f"no probes.npz in {golden_dir}")


def _load(golden_dir, name):
    path = os.path.join(golden_dir, f"{name}.npz")
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def family_golden(dev, quick: bool, golden_dir) -> None:
    """The kernels (plain versions with --device cpu) against the JAX
    package's CPU outputs."""
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.models import wavenet as wn
    from wavenet_tpu_torch.utils import golden
    from wavenet_tpu_torch.utils.pytree_io import params_from_numpy
    for name, (_, seed, B, T, N) in golden.MODELS.items():
        stored = _load(golden_dir, name)
        if stored is None:
            report(f"golden {name}", False, f"no {name}.npz in {golden_dir}")
            continue
        cfg = golden.model_config(name)
        p = params_from_numpy(golden.draw_params(cfg, seed), dev)
        toks = torch.from_numpy(golden.tokens(name)).to(dev)
        with torch.no_grad():
            loss, _ = wn.loss_fn(p, cfg, toks, use_fused=True)
            logits = wn.forward_logits_fused(p, cfg, toks[:, :-1])
        rel = abs(float(loss) - float(stored["loss"])) / abs(
            float(stored["loss"]))
        report(f"golden {name} fused loss vs JAX (rel {rel:.2e}, band 2e-3)",
               rel <= 2e-3, f"port {float(loss)} JAX {float(stored['loss'])}")
        scale = float(np.abs(stored["tf_logits"]).max())
        overall, kept, share = golden.argmax_agreement(
            logits.cpu().numpy(), stored["tf_argmax_fused"],
            stored["tf_margin_fused"], scale)
        report(f"golden {name} teacher-forced argmax agreement {kept:.4f} "
               f"where JAX's margin > 2^-7 of the scale ({share:.3f} of "
               f"positions; {overall:.4f} overall) (>= 0.99)", kept >= 0.99,
               "")
        mod = sampler.kernel_module(cfg, dev)
        w = mod.flatten_params(p, cfg)
        for kind, temp in (("greedy", 0.0), ("sampled", golden.TEMPERATURE)):
            want = torch.from_numpy(stored[kind].astype(np.int32)).to(dev)
            rings, carry, seeds, _, _, _ = mod.setup_decode(
                cfg, B, N, seeds=list(golden.SAMPLE_SEEDS), device=dev, w=w)
            forced = torch.cat([carry[:, :1], want], 1).contiguous()
            got, _, _ = mod.decode_chunk(w, cfg, rings, carry, 0, seeds, N,
                                         temp, forced)
            flips = (got != want).cpu().numpy()
            tie = golden.near_tie(stored[f"{kind}_margin"], scale)
            hard = int((flips & ~tie).sum())
            report(f"golden {name} {kind} teacher-forced flips "
                   f"{int(flips.sum())}/{flips.size}, {hard} where JAX's "
                   f"margin > 2^-7 of the scale (<= 1% of "
                   f"{int((~tie).sum())})", hard <= 0.01 * (~tie).sum(), "")


def run_family(name: str, dev, quick: bool, golden_dir) -> dict:
    FAILURES.clear()
    DRIFTS.clear()
    fn = globals()[f"family_{name}"]
    t = time.monotonic()
    if name in ("probes", "golden"):
        fn(dev, quick, golden_dir)
    else:
        fn(dev, quick)
    if dev.type == "cuda":
        torch.cuda.synchronize()
    return {"family": name, "failures": list(FAILURES),
            "drifts": list(DRIFTS),
            "counts": counts(), "seconds": time.monotonic() - t}


def _child(args) -> int:
    dev = torch.device(args.device)
    if dev.type == "cpu":
        torch.set_num_threads(2)
    out = run_family(args.family, dev, args.quick, args.golden)
    print("VERIFY_FAMILY " + json.dumps(out), flush=True)
    return 0


def main(argv=None) -> int:
    from wavenet_tpu_torch.utils import golden
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--device", choices=("cuda", "cpu"), default=None)
    ap.add_argument("--golden", default=str(golden.golden_dir()))
    ap.add_argument("--family", choices=FAMILIES, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.device is None:
        if not torch.cuda.is_available():
            print("verify: needs a CUDA device (--device cpu runs the plain "
                  "versions on both sides)", file=sys.stderr)
            return 1
        args.device = "cuda"
    if args.family:
        return _child(args)
    if args.device == "cuda":                 # every nvcc at once, up front
        from wavenet_tpu_torch.ops.cuda import build
        build.load_all(["decode", "decode_wide", "train_stack", "probes"])
    failures, drifts, total = [], [], {}
    for fam in (QUICK if args.quick else FAMILIES):
        cmd = [sys.executable, "-m", "wavenet_tpu_torch.verify", "--family",
               fam, "--device", args.device, "--golden", args.golden]
        if args.quick:
            cmd.append("--quick")
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              cwd=os.path.dirname(os.path.dirname(
                                  os.path.abspath(__file__))))
        result = None
        for line in proc.stdout.splitlines():
            if line.startswith("VERIFY_FAMILY "):
                result = json.loads(line[len("VERIFY_FAMILY "):])
            else:
                print(line, flush=True)
        if proc.returncode != 0 or result is None:
            print(proc.stderr[-4000:], file=sys.stderr, flush=True)
            failures.append(f"{fam} (exit {proc.returncode})")
            continue
        print(f"[{fam}: {result['seconds']:.1f} s]", flush=True)
        failures += result["failures"]
        drifts += result["drifts"]
        for k, v in result["counts"].items():
            total[k] = total.get(k, 0) + v
    code = 1 if failures else (2 if drifts else 0)
    if failures:
        print(f"\n{len(failures)} FAILURES: {failures}")
    if drifts:
        print(f"{len(drifts)} drift warnings (train_stack summation order): "
              f"{drifts}")
    if not failures and not drifts:
        print("\nALL KERNELS BIT-EXACT OR WITHIN THEIR BANDS")
    print("VERIFY_COUNTS " + json.dumps(total), flush=True)
    return code


if __name__ == "__main__":
    sys.exit(main())
