#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wavenet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper,
sm_90a) and nvcc.  It builds the port's kernels from the checkout's
sources, checks each against its plain PyTorch version on the card at the
`full` preset's widths, then serves the `full` preset end to end (export_npz
-> WaveNet.from_npz -> WaveNetServer -> HTTP on localhost) and shows that
the served requests went through the kernel, then trains `full` and serves
the trained checkpoint; phases 6-9 do the same for the mel-conditioned
`full_vocoder` preset through the mel variants of the kernels.  Any failed
check raises and the exit code is non-zero; without a CUDA device it exits
2 and prints no result.  The last three lines of stdout are the kernel
table (JSON), the card's name and power limit, and the device summary
(JSON).

Phases (one line of numbers each):
  0. device (nvidia-smi name, power limit) and kernel build time (one nvcc
     per source, all started together);
  1. RNG: the device counter-hash bits equal the plain version's exactly;
  2. decode kernel vs plain at full widths, B=4, 512 steps, T=0 and T=1:
     teacher-forced token flips <= 0.5% of steps, rings allclose
     (atol=rtol=3e-2), first free-running divergence, chunked == one-shot
     bit for bit, kernel and plain time per step;
  3. served slice: 4 concurrent 0.25 s requests (one streamed) plus one
     primed request over HTTP; valid 16-bit PCM of the asked length; a
     replayed seed gives bit-identical audio; the served audio's first
     samples equal the plain version's; the kernel's launch count grew;
  4. train_stack kernels vs plain at `full` widths and depth, T=8192
     (5 layer groups), at B=2 and at the training shape B=8: embedded
     tokens in, a fixed random cotangent ct on the skip sum, loss
     mean(skip * ct); skip max|d|/max|skip| <= 1e-2, loss |d| <= 2e-3 of
     mean(|skip * ct|) (the loss itself is a cancelling sum near zero),
     every gradient max|d|/max|g| <= 2e-2 (the reference suite's bands),
     two kernel runs bit-identical; kernel and plain ms of the whole
     stack's forward and backward at both shapes (the table reports B=8);
  5. trained and served: python -m wavenet_tpu_torch.train's main() on
     `full` (synthetic data, B=8, window 8192) for 6 steps with a
     checkpoint at step 3; the train_stack counters are read right after
     that run (every device kernel the wrappers launched, checked against
     the count the layer groups give); a resume from step 3 whose losses
     at steps 4-6 and final params equal the uninterrupted run's bit for
     bit; WaveNet.from_checkpoint then decodes 0.05 s through the decode
     kernel, whose counter grows too;
  6. the decode kernel's mel variant vs plain at `full_vocoder` widths
     (M = 80), B=4, 512 steps, T=0 and T=1, y upsampled from random mel
     frames: as phase 2, with y sliced per chunk;
  7. served vocoder: over HTTP, three concurrent mel requests of two
     lengths (one streamed), which must share a batch, and one primed mel
     request; valid PCM of the asked length; a batched request replayed
     alone gives the same audio bit for bit; the first samples equal the
     plain version's on the same upsampled features; only the mel
     variant's counter grew;
  8. the train_stack kernels' mel variants vs plain at `full_vocoder`
     widths and depth, T=8192 (6 layer groups), B=2 and B=8, y upsampled
     from random frames: the bands of phase 4, dv_cond and dy included;
  9. train.main on `full_vocoder` (synthetic clips and their log-mel
     frames, B=8, window 8192) for 6 steps with a checkpoint at step 3,
     the mel counters read right after that run; a resume from step 3 bit
     for bit (losses, params, upsampler included);
     WaveNet.from_checkpoint(...).vocode() of 0.05 s of a synthetic clip
     through the decode kernel's mel variant.
The phases that drive a main path (3, 5, 7, 9) set the counts of its
kernels to 0 right before and read them right after.
"""

from __future__ import annotations

import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
import wave

B, STEPS = 4, 512                # phase 2 shape
FLIP_LIMIT = 0.005               # teacher-forced flips per step
RING_TOL = 3e-2                  # atol = rtol on the bf16 rings
SERVE_SECONDS, PRIME_SECONDS = 0.25, 0.05
REF_SAMPLES = 128                # served audio checked against plain
VOC_SECONDS = (0.25, 0.2)        # phase 7 request lengths (one bucket)
TS_B, TS_T, TS_TRAIN_B = 2, 8192, 8   # phase 4 shapes
SKIP_TOL, LOSS_TOL, GRAD_TOL = 1e-2, 2e-3, 2e-2
TRAIN_STEPS, RESUME_AT, DECODE_SECONDS = 6, 3, 0.05
# published H100 SXM peaks (dense): bf16 tensor cores, f32 CUDA cores, HBM
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0]


def check(cond: bool, what: str) -> None:
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, repeats: int = 1) -> float:
    """Milliseconds of device time for fn() (median of `repeats`)."""
    import torch
    times = []
    for _ in range(repeats):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return sorted(times)[len(times) // 2]


def phase_rng(pwide, rng, dev) -> None:
    import torch
    seeds = rng.derive_row_seeds(2024, 8).to(dev)
    for t in (0, 1, 4093):
        got = pwide.counter_bits(seeds, t, 256).cpu()
        want = pwide.counter_bits(seeds.cpu(), t, 256)
        check(torch.equal(got, want), f"device RNG bits differ at step {t}")
    print("phase 1 rng: [8, 256] hash bits equal at steps 0, 1, 4093",
          flush=True)


def phase_kernel(pwide, cfg, w, dev, card: str, y=None, phase=2) -> dict:
    """Kernel vs plain at full widths (with the upsampled mel features y
    [B, STEPS, M] for a mel model); returns the numbers for the table."""
    import torch
    worst_err, ms, plain_ms = 0.0, None, None
    ys = (lambda t0, n: None) if y is None else \
        (lambda t0, n: y[:, t0:t0 + n])
    for temp in (0.0, 1.0):
        rings, carry, seeds, _, _ = pwide.setup_decode(
            cfg, B, STEPS, seeds=[11 * (i + 1) for i in range(B)], device=dev)
        out = {}

        def plain():
            out["p"] = pwide.decode_chunk_reference(
                w, cfg, rings, carry, 0, seeds, STEPS, temp, y=y)
        t_plain = cuda_ms(plain) / STEPS
        rt, rr, rc = out["p"]
        kt, kr, kc = pwide.decode_chunk(w, cfg, rings, carry, 0, seeds,
                                        STEPS, temp, y=y)
        diverge = (kt != rt).any(0).nonzero()
        first_div = int(diverge[0]) if len(diverge) else None
        forced = torch.cat([carry[:, :1], rt], 1).contiguous()
        ft, fr, fc = pwide.decode_chunk(w, cfg, rings, carry, 0, seeds,
                                        STEPS, temp, forced=forced, y=y)
        flips = int((ft != rt).sum())
        err = float((fr.float() - rr.float()).abs().max())
        worst_err = max(worst_err, err)
        check(flips <= FLIP_LIMIT * B * STEPS,
              f"T={temp}: {flips} teacher-forced flips in {B * STEPS} steps")
        check(torch.allclose(fr.float(), rr.float(), atol=RING_TOL,
                             rtol=RING_TOL), f"T={temp}: rings differ")
        check(torch.equal(fc, rc), f"T={temp}: carry differs")

        # chunked (3 uneven launches) == one-shot, bit for bit
        r, c, toks, t0 = rings, carry, [], 0
        for n in (STEPS // 5, STEPS * 3 // 5,
                  STEPS - STEPS // 5 - STEPS * 3 // 5):
            tk, r, c = pwide.decode_chunk(w, cfg, r, c, t0, seeds, n, temp,
                                          y=ys(t0, n))
            toks.append(tk)
            t0 += n
        check(torch.equal(torch.cat(toks, 1), kt) and torch.equal(r, kr)
              and torch.equal(c, kc), f"T={temp}: chunked != one-shot")

        t_kernel = cuda_ms(lambda: pwide.decode_chunk(
            w, cfg, rings, carry, 0, seeds, STEPS, temp, y=y),
            repeats=3) / STEPS
        if temp > 0:
            ms, plain_ms = t_kernel, t_plain
        print(f"phase {phase} kernel T={temp}: B={B} steps={STEPS} "
              f"teacher_forced_flips={flips} first_free_divergence="
              f"{first_div} rings_max_abs_err={err} chunked_equal=True "
              f"kernel_ms_per_step={t_kernel} plain_ms_per_step={t_plain} "
              f"card={card!r}", flush=True)
    return {"max_abs_err": worst_err, "ms": ms, "plain_ms": plain_ms,
            **decode_bound(cfg, w)}


def decode_bound(cfg, w) -> dict:
    """Least time per decode step of the phase-2 (or 6) launch (B rows,
    STEPS steps): its MACs (per row-step: L layers of 4R^2 + R(R+S), with
    mel 2RM more, plus the S^2 + SQ head) at the bf16 peak, or its bytes
    (weights once, rings in and out, y in as bf16, tokens out) at the
    memory rate, whichever is larger."""
    L, R, S, Q = (cfg.num_layers, cfg.residual_channels, cfg.skip_channels,
                  cfg.quantization_channels)
    M = 0 if cfg.mel is None else cfg.mel.num_mels
    flops = (2 * (L * (4 * R * R + R * (R + S) + 2 * R * M) + S * S + S * Q)
             * B * STEPS)
    rings = sum(cfg.dilations) * B * R * 2
    nbytes = (sum(v.numel() * v.element_size() for v in w.values())
              + 2 * rings + B * STEPS * (4 + 2 * M))
    t_ops, t_bytes = flops / PEAK_BF16, nbytes / PEAK_BYTES
    return {"bound_ms": max(t_ops, t_bytes) * 1e3 / STEPS,
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def _post(url: str, body: dict):
    req = urllib.request.Request(url, data=json.dumps(body).encode(),
                                 headers={"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=600) as r:
        return r.status, dict(r.headers), r.read()


def _wav_samples(data: bytes, rate: int):
    import numpy as np
    with wave.open(io.BytesIO(data)) as w:
        check(w.getnchannels() == 1 and w.getsampwidth() == 2
              and w.getframerate() == rate, "not 16-bit mono PCM WAV")
        return np.frombuffer(w.readframes(w.getnframes()), "<i2")


def phase_serve(pwide, cfg, dev, card: str) -> int:
    """Serve `full` through the normal entry points; returns the kernel's
    launch count over the served requests."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.audio import mulaw
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.serving import WaveNetServer
    from wavenet_tpu_torch.serving.http import make_server

    rate = cfg.sample_rate
    n = int(SERVE_SECONDS * rate)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "full.npz")
        WaveNet(cfg).init(torch.Generator().manual_seed(0),
                          device=dev).export_npz(path)
        model = WaveNet.from_npz(path, device=dev)
    engine = WaveNetServer(model, max_batch=4, max_wait_ms=200.0,
                           chunk_seconds=0.125,
                           length_quantum_seconds=SERVE_SECONDS)
    server = make_server(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        seeds = [101, 202, 303, 404]
        prime = (0.5 * np.sin(np.arange(int(PRIME_SECONDS * rate)) * 0.05)
                 ).astype(np.float32)
        bodies = [{"seconds": SERVE_SECONDS, "seed": s,
                   "stream": i == 3} for i, s in enumerate(seeds)]
        bodies.append({"seconds": SERVE_SECONDS, "seed": 505,
                       "prime": prime.tolist()})
        replies = [None] * len(bodies)

        def call(i):
            replies[i] = _post(url + "/synthesize", bodies[i])

        pwide.launches.reset()                   # the main path starts here
        wall = time.monotonic()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
            check(not t.is_alive(), "a request did not finish")
        wall = time.monotonic() - wall
        launches = pwide.launches.value
        check(launches > 0, "served requests did not launch the kernel")

        pcm = []
        for body, (status, headers, data) in zip(bodies, replies):
            check(status == 200, f"HTTP {status}")
            if body.get("stream"):
                check(headers.get("Content-Type") == "audio/L16"
                      and int(headers["X-Num-Samples"]) == n,
                      "bad stream headers")
                s = np.frombuffer(data, "<i2")
            else:
                s = _wav_samples(data, rate)
            check(s.shape == (n,), f"got {s.shape[0]} samples, asked {n}")
            pcm.append(s)
        check(len({p.tobytes() for p in pcm}) == len(pcm),
              "distinct seeds gave identical audio")

        # replay one co-batched seed alone: bit-identical audio
        _, _, again = _post(url + "/synthesize",
                            {"seconds": SERVE_SECONDS, "seed": seeds[1]})
        check(np.array_equal(_wav_samples(again, rate), pcm[1]),
              "replayed seed gave different audio")

        # served audio vs the plain PyTorch decode of the same request
        w = model.decode_weights()
        rings, carry, s, _, _ = pwide.setup_decode(
            cfg, 1, REF_SAMPLES, seeds=[seeds[0]], device=dev)
        ref, _, _ = pwide.decode_chunk_reference(w, cfg, rings, carry, 0, s,
                                                 REF_SAMPLES, 1.0)
        ref_pcm = (np.clip(mulaw.decode(ref[0]).cpu().numpy(), -1, 1)
                   * 32767.0).astype("<i2")
        check(np.array_equal(pcm[0][:REF_SAMPLES], ref_pcm),
              "served audio differs from the plain decode")

        st = dict(engine.stats)
        print(f"phase 3 served: requests={st['requests']} "
              f"batches={st['batches']} samples_out={st['samples_out']} "
              f"decode_seconds={st['decode_seconds']} "
              f"realtime_factor={engine.realtime_factor} "
              f"decode_samples_per_s={st['samples_out'] / st['decode_seconds']}"
              f" wall_s_5_requests={wall} kernel_launches={launches} "
              f"card={card!r}", flush=True)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        engine.close()


def phase_serve_vocoder(pwide, cfg, dev, card: str) -> int:
    """Serve the mel model `cfg` (full_vocoder) over HTTP; returns the mel
    decode variant's launch count over the served requests."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.audio import mulaw
    from wavenet_tpu_torch.models import conditioning
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.serving import WaveNetServer
    from wavenet_tpu_torch.serving.http import make_server

    rate, hop, M = cfg.sample_rate, cfg.mel.hop_length, cfg.mel.num_mels
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "full_vocoder.npz")
        WaveNet(cfg).init(torch.Generator().manual_seed(0),
                          device=dev).export_npz(path)
        model = WaveNet.from_npz(path, device=dev)
    engine = WaveNetServer(model, max_batch=4, max_wait_ms=300.0,
                           chunk_seconds=0.125,
                           length_quantum_seconds=max(VOC_SECONDS))
    server = make_server(engine, port=0)
    url = f"http://127.0.0.1:{server.server_address[1]}"
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        rs = np.random.RandomState(9)
        lens = [int(VOC_SECONDS[0] * rate), int(VOC_SECONDS[1] * rate),
                int(VOC_SECONDS[0] * rate), int(PRIME_SECONDS * rate)]
        prime = (0.5 * np.sin(np.arange(int(PRIME_SECONDS * rate)) * 0.05)
                 ).astype(np.float32)
        span = [0, 0, 0, prime.size - 1]
        mels = [(rs.randn(-(-(s + n) // hop), M) * 2.0 - 4.0)
                .astype(np.float32) for s, n in zip(span, lens)]
        bodies = [{"num_samples": n, "seed": 11 + i, "mel": m.tolist(),
                   "stream": i == 2} for i, (n, m) in enumerate(zip(lens,
                                                                    mels))]
        bodies[3]["prime"] = prime.tolist()
        replies = [None] * len(bodies)

        def call(i):
            replies[i] = _post(url + "/synthesize", bodies[i])

        pwide.launches.reset()                   # the main path starts here
        pwide.mel_launches.reset()
        wall = time.monotonic()
        threads = [threading.Thread(target=call, args=(i,))
                   for i in range(len(bodies))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=900)
            check(not t.is_alive(), "a request did not finish")
        wall = time.monotonic() - wall
        launches = pwide.mel_launches.value
        check(launches > 0, "served mel requests did not launch the kernel")
        check(pwide.launches.value == 0,
              "a mel request launched the unconditional decode")
        st = dict(engine.stats)
        check(st["batches"] < st["requests"],
              f"the mel requests did not batch: {st}")

        pcm = []
        for body, n, (status, headers, data) in zip(bodies, lens, replies):
            check(status == 200, f"HTTP {status}")
            if body.get("stream"):
                check(headers.get("Content-Type") == "audio/L16"
                      and int(headers["X-Num-Samples"]) == n,
                      "bad stream headers")
                got = np.frombuffer(data, "<i2")
            else:
                got = _wav_samples(data, rate)
            check(got.shape == (n,), f"got {got.shape[0]} samples, asked {n}")
            pcm.append(got)
        check(len({p.tobytes() for p in pcm}) == len(pcm),
              "distinct requests gave identical audio")

        # a batched request replayed alone: bit-identical audio
        _, _, again = _post(url + "/synthesize", dict(bodies[1], stream=False))
        check(np.array_equal(_wav_samples(again, rate), pcm[1]),
              "a batched mel request differs from its singleton replay")

        # served audio vs the plain decode on the same upsampled features
        w = model.decode_weights()
        with torch.no_grad():
            y = conditioning.upsample_mel(
                model.params["upsampler"], cfg.mel,
                torch.from_numpy(mels[0][None]).to(dev), lens[0])
        rings, carry, s, _, _ = pwide.setup_decode(
            cfg, 1, REF_SAMPLES, seeds=[bodies[0]["seed"]], device=dev)
        ref, _, _ = pwide.decode_chunk_reference(
            w, cfg, rings, carry, 0, s, REF_SAMPLES, 1.0,
            y=y[:, :REF_SAMPLES])
        ref_pcm = (np.clip(mulaw.decode(ref[0]).cpu().numpy(), -1, 1)
                   * 32767.0).astype("<i2")
        check(np.array_equal(pcm[0][:REF_SAMPLES], ref_pcm),
              "served vocoder audio differs from the plain decode")

        print(f"phase 7 served vocoder: requests={st['requests']} "
              f"batches={st['batches']} padded_rows={st['padded_rows']} "
              f"samples_out={st['samples_out']} "
              f"decode_seconds={st['decode_seconds']} "
              f"realtime_factor={engine.realtime_factor} "
              f"wall_s_4_requests={wall} mel_kernel_launches={launches} "
              f"replay_bit_identical=True card={card!r}", flush=True)
        return launches
    finally:
        server.shutdown()
        server.server_close()
        engine.close()


def _stack_fwd(ts, params, cfg, groups, x, fwd, y=None):
    """The fused stack's forward, group by group, through `fwd` (the
    kernel wrapper or the plain version), with the bf16 mel features y of
    a mel model: (skip, [(dils, ops, xs)])."""
    import torch
    skip = torch.zeros(*x.shape[:2], cfg.skip_channels, device=x.device)
    saved = []
    for lo, hi in groups:
        dils = tuple(cfg.dilations[lo:hi])
        ops = ts.prep_weights(*(params[k][lo:hi] for k in ts.GROUP_KEYS),
                              None if y is None else params["v_cond"][lo:hi])
        skip, x, xs = fwd(x, skip, ops, dils, y)
        saved.append((dils, ops, xs))
    return skip, saved


def _stack_bwd(saved, dskip, bwd, y=None):
    """The backward through `bwd`: [(name, gradient)], dx last, after it
    the mel features' dy summed over the groups (a mel model)."""
    import torch
    dx = torch.zeros(*dskip.shape[:2], saved[0][2].shape[-1],
                     device=dskip.device)
    grads, dy = [], None
    names = ("dwz", "db", "dwrs", "dbres", "dbskip", "dv_cond")
    for gi, (dils, ops, xs) in reversed(list(enumerate(saved))):
        dx, *gw = bwd(xs, dskip, dx, ops, dils, y)
        if y is not None:
            dy = gw[-1] if dy is None else dy + gw[-1]
            gw = gw[:-1]
        grads += [(f"g{gi}.{n}", g) for n, g in zip(names, gw)]
    return grads + [("dx", dx)] + ([] if y is None else [("dy", dy)])


def _stack(ts, params, cfg, groups, x, ct, fwd, bwd, y=None):
    """(skip, loss = mean(skip * ct), grads, saved) through fwd and bwd."""
    skip, saved = _stack_fwd(ts, params, cfg, groups, x, fwd, y)
    return (skip, (skip * ct).mean(),
            _stack_bwd(saved, ct / ct.numel(), bwd, y), saved)


def loss_rel(loss_k: float, loss_p: float, skip_p, ct) -> float:
    """|loss_k - loss_p| against mean(|skip * ct|): the loss mean(skip * ct)
    of a zero-mean ct is a cancelling sum near zero, so a band relative to
    itself would hold two correct sums in different orders to far more
    than their rounding; mean(|skip * ct|) is the size of what is summed."""
    return abs(loss_k - loss_p) / float((skip_p * ct).abs().mean())


def stack_bound(cfg, groups, B: int, T: int) -> dict:
    """Least time of the whole stack's forward and backward at [B, T]: the
    forward's products (bf16 operands) at the bf16 peak; the backward's
    recompute of z at the bf16 peak plus its four f32 products (dh, dz
    @ Wz^T, dWz, dWrs) at the f32 peak; with mel, y @ V_cond in the
    forward and the recompute (bf16 peak) and dV_cond and dy in the
    backward (f32 peak); against the bytes each must move (input and
    output activations, y, the bf16 layer-input stash, weights)."""
    L, R, S = cfg.num_layers, cfg.residual_channels, cfg.skip_channels
    nm = 0 if cfg.mel is None else cfg.mel.num_mels
    M = B * T
    wbytes = L * (4 * R * R + R * (R + S) + 2 * R * nm) * 2
    stash = (L + len(groups)) * M * R * 2
    fwd_ops = 2 * M * L * (4 * R * R + R * (R + S) + 2 * R * nm) / PEAK_BF16
    fwd_bytes = (4 * M * R + 4 * M * S + 2 * M * nm + stash + wbytes
                 ) / PEAK_BYTES
    bwd_ops = (2 * M * L * (4 * R * R + 2 * R * nm) / PEAK_BF16
               + 2 * M * L * (2 * R * (R + S) + 8 * R * R + 4 * R * nm)
               / PEAK_F32)
    bwd_bytes = (stash + 4 * M * S + 4 * M * R + 6 * M * nm + 3 * wbytes
                 ) / PEAK_BYTES
    out = {}
    for name, t_ops, t_bytes in (("fwd", fwd_ops, fwd_bytes),
                                 ("bwd", bwd_ops, bwd_bytes)):
        out[name] = {"bound_ms": max(t_ops, t_bytes) * 1e3,
                     "bound_by": "operations" if t_ops >= t_bytes
                     else "bytes", "library_ms": None}
    return out


def _mel_features(params, cfg, B: int, T: int, rs, dev):
    """Upsampled features [B, T, M] f32 of random log-mel-like frames,
    through the model's upsampler."""
    import numpy as np
    import torch
    from wavenet_tpu_torch.models import conditioning
    F = -(-T // cfg.mel.hop_length)
    frames = torch.from_numpy((rs.randn(B, F, cfg.mel.num_mels) * 2.0 - 4.0)
                              .astype(np.float32)).to(dev)
    with torch.no_grad():
        return conditioning.upsample_mel(params["upsampler"], cfg.mel,
                                         frames, T).contiguous()


def phase_train_stack(ts, wn, cfg, params, dev, card: str, phase: int = 4,
                      num_groups: int = 5) -> dict:
    """Kernels vs plain over the whole stack of `cfg` (`full`, or the mel
    model `full_vocoder` with y); returns the table's numbers for the
    forward and backward kernels."""
    import numpy as np
    import torch
    TT = ts.pick_tile(cfg, TS_T)
    groups = ts.group_plan(cfg, TT)
    check(len(groups) == num_groups,
          f"expected {num_groups} layer groups, got {groups}")
    rs = np.random.RandomState(4)

    def inputs(B):
        toks = torch.from_numpy(rs.randint(
            0, cfg.quantization_channels, (B, TS_T)).astype(np.int32)).to(dev)
        x = wn.embed_tokens(params, cfg, toks, wn._shifted_tokens(toks))
        ct = torch.from_numpy(rs.randn(B, TS_T, cfg.skip_channels).astype(
            np.float32)).to(dev)
        y = None
        if cfg.mel is not None:
            y = _mel_features(params, cfg, B, TS_T, rs, dev).to(
                torch.bfloat16)
        return x.contiguous(), ct, y

    def compare(B):
        """Kernel vs plain at [B, TS_T] (and two kernel runs), checked
        against the bands; returns the inputs, both runs and the errors."""
        x, ct, y = inputs(B)
        k = _stack(ts, params, cfg, groups, x, ct, ts.group_fwd, ts.group_bwd,
                   y)
        k2 = _stack(ts, params, cfg, groups, x, ct, ts.group_fwd,
                    ts.group_bwd, y)
        p = _stack(ts, params, cfg, groups, x, ct, ts.group_fwd_reference,
                   ts.group_bwd_reference, y)
        torch.cuda.synchronize()
        skip_err = float((k[0] - p[0]).abs().max())
        skip_rel = skip_err / float(p[0].abs().max())
        lrel = loss_rel(float(k[1]), float(p[1]), p[0], ct)
        grad_rel, grad_err = {}, 0.0
        for (name, gk), (_, gp) in zip(k[2], p[2]):
            e = float((gk - gp).abs().max())
            grad_err = max(grad_err, e)
            grad_rel[name] = e / max(float(gp.abs().max()), 1e-30)
        same = (torch.equal(k[0], k2[0]) and torch.equal(k[1], k2[1])
                and all(torch.equal(a, b) for (_, a), (_, b)
                        in zip(k[2], k2[2])))
        del k2
        print(f"phase {phase} train_stack: B={B} T={TS_T} groups={groups} "
              f"skip_rel={skip_rel} skip_max_abs_err={skip_err} "
              f"loss_kernel={float(k[1])} loss_plain={float(p[1])} "
              f"loss_rel_to_mean_abs={lrel} worst_grad="
              f"{max(grad_rel.values())} "
              f"({max(grad_rel, key=grad_rel.get)}) grad_max_abs_err="
              f"{grad_err} kernel_runs_bit_identical={same}", flush=True)
        check(skip_rel <= SKIP_TOL, f"B={B}: skip differs: {skip_rel}")
        check(lrel <= LOSS_TOL, f"B={B}: loss differs: {lrel}")
        for name, r in grad_rel.items():
            check(r <= GRAD_TOL, f"B={B}: gradient {name} differs: {r}")
        check(same, f"B={B}: two kernel runs differ")
        return x, ct, y, k, p, skip_err, grad_err

    with torch.no_grad():
        times = {}
        for B in (TS_B, TS_TRAIN_B):
            x, ct, y, k, p, skip_err, grad_err = compare(B)
            dsk = ct / ct.numel()
            fwd_k = cuda_ms(lambda: _stack_fwd(ts, params, cfg, groups, x,
                                               ts.group_fwd, y), 3)
            fwd_p = cuda_ms(lambda: _stack_fwd(ts, params, cfg, groups, x,
                                               ts.group_fwd_reference, y), 3)
            bwd_k = cuda_ms(lambda: _stack_bwd(k[3], dsk, ts.group_bwd, y), 3)
            bwd_p = cuda_ms(lambda: _stack_bwd(p[3], dsk,
                                               ts.group_bwd_reference, y), 3)
            times[B] = (fwd_k, fwd_p, bwd_k, bwd_p, skip_err, grad_err)
            del k, p
            print(f"phase {phase} train_stack times B={B} T={TS_T}: "
                  f"fwd_kernel_ms={fwd_k} fwd_plain_ms={fwd_p} "
                  f"bwd_kernel_ms={bwd_k} bwd_plain_ms={bwd_p} "
                  f"card={card!r}", flush=True)
    bound = stack_bound(cfg, groups, TS_TRAIN_B, TS_T)
    fk, fp, bk, bp, skip_err, grad_err = times[TS_TRAIN_B]
    return {"fwd": {"max_abs_err": skip_err, "ms": fk, "plain_ms": fp,
                    **bound["fwd"]},
            "bwd": {"max_abs_err": grad_err, "ms": bk, "plain_ms": bp,
                    **bound["bwd"]}}


def _losses(path: str) -> dict:
    with open(path) as f:
        return {r["step"]: r["loss"] for r in map(json.loads, f)}


def phase_train(ts, pwide, dev, card: str, preset: str = "full",
                phase: int = 5) -> dict:
    """Train `preset` through the CLI's main(), resume, and decode the
    checkpoint (a mel model vocodes a clip); returns the launch counts of
    the three kernels (of their mel variants for a mel model)."""
    import math
    import numpy as np
    import torch
    from wavenet_tpu_torch import train
    from wavenet_tpu_torch.config import get_config
    from wavenet_tpu_torch.models.api import WaveNet
    cfg = get_config(preset)
    mel = cfg.mel is not None
    fwd_c, bwd_c = ((ts.fwd_mel_launches, ts.bwd_mel_launches) if mel
                    else (ts.fwd_launches, ts.bwd_launches))
    dec_c = pwide.mel_launches if mel else pwide.launches
    others = ([ts.fwd_launches, ts.bwd_launches, pwide.launches] if mel
              else [ts.fwd_mel_launches, ts.bwd_mel_launches,
                    pwide.mel_launches])
    common = ["--preset", preset, "--synthetic", "--device", "cuda",
              "--batch-size", str(TS_TRAIN_B), "--override",
              f"train_window={TS_T}", "--log-every", "1"]
    with tempfile.TemporaryDirectory() as tmp:
        a, b = os.path.join(tmp, "a"), os.path.join(tmp, "b")
        torch.cuda.reset_peak_memory_stats(dev)
        for c in (fwd_c, bwd_c, *others):
            c.reset()                            # the training path starts here
        ma = train.main(common + [
            "--steps", str(TRAIN_STEPS), "--ckpt", a, "--ckpt-every",
            str(RESUME_AT), "--metrics-file", os.path.join(tmp, "a.jsonl")])
        torch.cuda.synchronize()
        fwd_n, bwd_n = fwd_c.value, bwd_c.value
        # per step and layer group: Lg + 1 forward kernels, 10 Lg + 2
        # backward kernels (12 Lg + 2 with mel; train_stack.cu)
        ng = len(ts.group_plan(cfg, ts.pick_tile(cfg, TS_T)))
        L = cfg.num_layers
        want = (TRAIN_STEPS * (L + ng),
                TRAIN_STEPS * ((12 if mel else 10) * L + 2 * ng))
        check((fwd_n, bwd_n) == want, "training launched (fwd, bwd) = "
              f"{(fwd_n, bwd_n)} train_stack kernels, expected {want}")
        check(not any(c.value for c in others),
              "training launched another variant of the kernels")
        os.makedirs(b)
        for f in ("params.json", f"ckpt_{RESUME_AT:08d}.pt"):
            shutil.copy(os.path.join(a, f), b)
        peak_gb = torch.cuda.max_memory_allocated(dev) / 1e9
        train.main(common + [
            "--steps", str(TRAIN_STEPS - RESUME_AT), "--ckpt", b, "--resume",
            "--metrics-file", os.path.join(tmp, "b.jsonl")])
        la = _losses(os.path.join(tmp, "a.jsonl"))
        lb = _losses(os.path.join(tmp, "b.jsonl"))
        check(sorted(la) == list(range(1, TRAIN_STEPS + 1))
              and all(math.isfinite(v) for v in la.values()),
              f"losses of the uninterrupted run: {la}")
        check(sorted(lb) == list(range(RESUME_AT + 1, TRAIN_STEPS + 1))
              and all(lb[s] == la[s] for s in lb),
              f"resumed losses {lb} differ from {la}")
        last = f"ckpt_{TRAIN_STEPS:08d}.pt"
        pa = torch.load(os.path.join(a, last), weights_only=True)["params"]
        pb = torch.load(os.path.join(b, last), weights_only=True)["params"]
        check(sorted(pa) == sorted(pb)
              and (not mel or "upsampler/w0" in pa)
              and all(torch.equal(pa[k], pb[k]) for k in pa),
              "resumed params differ from the uninterrupted run's")
        check(fwd_c.value > fwd_n and bwd_c.value > bwd_n,
              "the resumed run did not launch the train_stack kernels")

        dec_c.reset()                            # the serving path starts here
        model = WaveNet.from_checkpoint(a, device=dev)
        n = int(DECODE_SECONDS * model.cfg.sample_rate)
        if mel:
            t = np.arange(n) / cfg.sample_rate        # a synthetic clip
            clip = (0.3 * np.sin(2 * np.pi * 220.0 * t)
                    + 0.1 * np.sin(2 * np.pi * 1300.0 * t)).astype(np.float32)
            toks = model.vocode(clip, seed=1)
            hop = cfg.mel.hop_length
            n = (1 + (n - 1) // hop) * hop
        else:
            toks = model.generate(seconds=DECODE_SECONDS, seed=1)
        torch.cuda.synchronize()
        dec_n = dec_c.value
        check(tuple(toks.shape) == (1, n) and int(toks.min()) >= 0
              and int(toks.max()) < model.cfg.quantization_channels,
              "bad decode of the trained model")
        check(dec_n > 0, "the trained model's decode did not launch the "
              "kernel")
    print(f"phase {phase} trained and served: preset={preset} "
          f"steps={TRAIN_STEPS} "
          f"losses={[la[s] for s in sorted(la)]} resumed_from={RESUME_AT} "
          f"resume_bit_exact=True ms_per_step={1e3 / ma['steps_per_sec']} "
          f"audio_seconds_per_sec={ma['audio_seconds_per_sec']} "
          f"peak_device_memory_gb={peak_gb} "
          f"train_stack_fwd_launches={fwd_n} train_stack_bwd_launches="
          f"{bwd_n} decode_launches={dec_n} decoded_samples={n} "
          f"card={card!r}", flush=True)
    return {"train_stack_fwd": fwd_n, "train_stack_bwd": bwd_n,
            "decode_wide": dec_n}


def main() -> int:
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from wavenet_tpu_torch.config import full, full_vocoder
        from wavenet_tpu_torch.models import wavenet as wn
        from wavenet_tpu_torch.ops import rng
        from wavenet_tpu_torch.ops.cuda import build
        from wavenet_tpu_torch.ops.cuda import decode_wide as pwide
        from wavenet_tpu_torch.ops.cuda import train_stack as ts
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    card = nvidia_smi()
    dev = torch.device("cuda", 0)
    t = time.monotonic()
    build.load_all(["decode_wide", "train_stack"])
    pwide.library()
    ts.library()
    print(f"phase 0 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernel build_s={time.monotonic() - t}",
          flush=True)

    phase_rng(pwide, rng, dev)
    cfg = full()
    params = wn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    w = pwide.flatten_params(params, cfg)
    numbers = phase_kernel(pwide, cfg, w, dev, card)
    launches = phase_serve(pwide, cfg, dev, card)
    stack = phase_train_stack(ts, wn, cfg, params, dev, card)
    trained = phase_train(ts, pwide, dev, card)
    del params, w

    vcfg = full_vocoder()
    vparams = wn.init_params(vcfg, torch.Generator().manual_seed(0), dev)
    vw = pwide.flatten_params(vparams, vcfg)
    y = _mel_features(vparams, vcfg, B, STEPS, np.random.RandomState(6), dev)
    mel_numbers = phase_kernel(pwide, vcfg, vw, dev, card, y=y, phase=6)
    mel_launches = phase_serve_vocoder(pwide, vcfg, dev, card)
    mel_stack = phase_train_stack(ts, wn, vcfg, vparams, dev, card, phase=8,
                                  num_groups=6)
    mel_trained = phase_train(ts, pwide, dev, card, "full_vocoder", phase=9)

    src = "wavenet_tpu_torch/csrc/"
    pallas = "wavenet_tpu/ops/pallas/"

    def row(name, source, replaces, launched, numbers):
        return {"name": name, "route": "cuda", "source": src + source,
                "replaces": pallas + replaces, "launches": launched,
                **numbers}
    print(json.dumps({"kernels": [
        row("decode_wide", "decode_wide.cu", "decode_wide.py:170", launches,
            numbers),
        row("train_stack_fwd", "train_stack.cu", "train_stack.py:324",
            trained["train_stack_fwd"], stack["fwd"]),
        row("train_stack_bwd", "train_stack.cu", "train_stack.py:426",
            trained["train_stack_bwd"], stack["bwd"]),
        row("decode_wide_mel", "decode_wide.cu", "decode_wide.py:170",
            mel_launches, mel_numbers),
        row("train_stack_fwd_mel", "train_stack.cu", "train_stack.py:324",
            mel_trained["train_stack_fwd"], mel_stack["fwd"]),
        row("train_stack_bwd_mel", "train_stack.cu", "train_stack.py:426",
            mel_trained["train_stack_bwd"], mel_stack["bwd"])]}))
    print(card)
    # the run used one card, device 0
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": 1}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
