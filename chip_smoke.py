#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port (wavenet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with a CUDA card (Hopper,
sm_90a) and nvcc.  It builds the port's kernels from the checkout's
sources, checks each against its plain PyTorch version on the card at the
`full` preset's widths, then serves the `full` preset end to end (export_npz
-> WaveNet.from_npz -> WaveNetServer -> HTTP on localhost) and shows that
the served requests went through the kernel.  Any failed check raises and
the exit code is non-zero; without a CUDA device it exits 2 and prints no
result.  The last two lines of stdout are the kernel table and the device
summary, both JSON.

Phases (one line of numbers each):
  0. device (nvidia-smi name, power limit) and kernel build time;
  1. RNG: the device counter-hash bits equal the plain version's exactly;
  2. decode kernel vs plain at full widths, B=4, 512 steps, T=0 and T=1:
     teacher-forced token flips <= 0.5% of steps, rings allclose
     (atol=rtol=3e-2), first free-running divergence, chunked == one-shot
     bit for bit, kernel and plain time per step;
  3. served slice: 4 concurrent 0.25 s requests (one streamed) plus one
     primed request over HTTP; valid 16-bit PCM of the asked length; a
     replayed seed gives bit-identical audio; the served audio's first
     samples equal the plain version's; the kernel's launch count grew.
"""

from __future__ import annotations

import io
import json
import os
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


def phase_kernel(pwide, wn, cfg, w, dev, card: str) -> dict:
    """Kernel vs plain at full widths; returns the numbers for the table."""
    import torch
    worst_err, ms, plain_ms = 0.0, None, None
    for temp in (0.0, 1.0):
        rings, carry, seeds, _, _ = pwide.setup_decode(
            cfg, B, STEPS, seeds=[11 * (i + 1) for i in range(B)], device=dev)
        out = {}

        def plain():
            out["p"] = pwide.decode_chunk_reference(
                w, cfg, rings, carry, 0, seeds, STEPS, temp)
        t_plain = cuda_ms(plain) / STEPS
        rt, rr, rc = out["p"]
        kt, kr, kc = pwide.decode_chunk(w, cfg, rings, carry, 0, seeds,
                                        STEPS, temp)
        diverge = (kt != rt).any(0).nonzero()
        first_div = int(diverge[0]) if len(diverge) else None
        forced = torch.cat([carry[:, :1], rt], 1).contiguous()
        ft, fr, fc = pwide.decode_chunk(w, cfg, rings, carry, 0, seeds,
                                        STEPS, temp, forced=forced)
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
        for n in (100, 317, STEPS - 417):
            tk, r, c = pwide.decode_chunk(w, cfg, r, c, t0, seeds, n, temp)
            toks.append(tk)
            t0 += n
        check(torch.equal(torch.cat(toks, 1), kt) and torch.equal(r, kr)
              and torch.equal(c, kc), f"T={temp}: chunked != one-shot")

        t_kernel = cuda_ms(lambda: pwide.decode_chunk(
            w, cfg, rings, carry, 0, seeds, STEPS, temp), repeats=3) / STEPS
        if temp > 0:
            ms, plain_ms = t_kernel, t_plain
        print(f"phase 2 kernel T={temp}: B={B} steps={STEPS} "
              f"teacher_forced_flips={flips} first_free_divergence="
              f"{first_div} rings_max_abs_err={err} chunked_equal=True "
              f"kernel_ms_per_step={t_kernel} plain_ms_per_step={t_plain} "
              f"card={card!r}", flush=True)
    return {"max_abs_err": worst_err, "ms": ms, "plain_ms": plain_ms}


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
        WaveNet(cfg).init(torch.Generator().manual_seed(0)).export_npz(path)
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


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    try:
        from wavenet_tpu_torch.config import full
        from wavenet_tpu_torch.models import wavenet as wn
        from wavenet_tpu_torch.ops import rng
        from wavenet_tpu_torch.ops.cuda import decode_wide as pwide
    except ImportError as e:
        print(f"chip_smoke: the port is not beside this script ({e})",
              file=sys.stderr)
        return 2

    card = nvidia_smi()
    dev = torch.device("cuda", 0)
    t = time.monotonic()
    pwide.library()
    print(f"phase 0 device: {card} | torch {torch.__version__} cuda "
          f"{torch.version.cuda} | kernel build_s={time.monotonic() - t}",
          flush=True)

    phase_rng(pwide, rng, dev)
    cfg = full()
    params = wn.init_params(cfg, torch.Generator().manual_seed(0), dev)
    w = pwide.flatten_params(params, cfg)
    numbers = phase_kernel(pwide, wn, cfg, w, dev, card)
    launches = phase_serve(pwide, cfg, dev, card)

    print(json.dumps({"kernels": [{
        "name": "decode_wide", "route": "cuda",
        "source": "wavenet_tpu_torch/csrc/decode_wide.cu",
        "replaces": "wavenet_tpu/ops/pallas/decode_wide.py:170",
        "launches": launches, **numbers}]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
