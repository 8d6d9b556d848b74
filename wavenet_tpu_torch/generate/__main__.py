"""Generation CLI of the port (counterpart of the repository's generate.py):
sample audio from a checkpoint of the port's trainer and write wav files.

  python -m wavenet_tpu_torch.generate --ckpt runs/full --seconds 2 \
      --out out.wav --device cuda
  python -m wavenet_tpu_torch.generate --ckpt runs/full --seconds 1 \
      --batch 4 --seed 7                       # out_0.wav ... out_3.wav
  python -m wavenet_tpu_torch.generate --ckpt runs/full --prime some.wav
  python -m wavenet_tpu_torch.generate --ckpt runs/voc --mel-from ref.wav
  python -m wavenet_tpu_torch.generate --ckpt runs/full --stream 0.5
  torchrun --nproc_per_node 2 -m wavenet_tpu_torch.generate \
      --ckpt runs/full --batch 8 --data-parallel 2       # 4 rows a rank
  torchrun --nproc_per_node 2 -m wavenet_tpu_torch.generate \
      --ckpt runs/full --batch 4 --model-parallel 2      # channels split
  python -m wavenet_tpu_torch.generate --ckpt runs/full --seconds 1 \
      --batch 4 --export-aot full.wnx                    # an AOT artifact

The fast path decodes through the kernel that takes the model (the narrow
or the wide decode kernel on the card, generate/sampler.py); --naive runs
the full receptive-field forward per sample instead, and --stream writes
the wav chunk by chunk (the same bytes as one shot).  --seed N keys the
port's counter RNG with per-row seeds as_row_seeds(N, batch), as the
facade and the server do: the JAX package's generate.py keys a
jax.random.PRNGKey(N) instead, another random stream, so the same --seed
gives other audio there (the JAX package's generate_wav(...,
seeds=as_row_seeds(N, batch)) gives this one).

Over a mesh of ranks (--data-parallel, --model-parallel; one process per
rank under torchrun, on cuda:LOCAL_RANK over nccl unless --device and
--dist-backend say otherwise; two ranks on one card need gloo) every rank
decodes its share (sampler.generate_distributed: the decode kernel on each
rank's rows on a data-only mesh, the collective loop on a model-sharded
one) and the wavs equal a single process's at the same --seed; only rank
0 writes them.  --stream and --naive are single-device paths and are
refused there, as the reference refuses them.

--export-aot FILE.wnx writes a deployment artifact instead of sampling
(serving/aot.py: a torch.export program over the decode op, frozen at
--seconds, --batch and --temperature); serving.load_decoder loads it
without model code.  --compile-cache [DIR] builds and reuses the kernels in
DIR (utils/compcache.py).
"""

from __future__ import annotations

import argparse
import sys
import time
import wave


def parse_args(argv=None):
    p = argparse.ArgumentParser(prog="python -m wavenet_tpu_torch.generate",
                                description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument("--ckpt", required=True,
                   help="checkpoint directory of the port's trainer")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step (default: the latest)")
    p.add_argument("--out", default="generated.wav")
    p.add_argument("--seconds", type=float, default=1.0)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--temperature", type=float, default=1.0)
    p.add_argument("--seed", type=int, default=0,
                   help="row seeds as_row_seeds(SEED, batch) of the counter "
                        "RNG (not the JAX package's PRNGKey stream)")
    p.add_argument("--prime", default=None, help="wav file to prime on")
    p.add_argument("--mel-from", default=None,
                   help="wav file to vocode: generate conditioned on its "
                        "log-mel features (a mel checkpoint; caps --seconds "
                        "at the reference's length)")
    p.add_argument("--speaker", type=int, default=None,
                   help="speaker id for every row (a global_classes "
                        "checkpoint; default 0 there)")
    p.add_argument("--naive", action="store_true",
                   help="the O(RF)-per-sample forward instead of the fast "
                        "decoder")
    p.add_argument("--stream", type=float, default=None, metavar="CHUNK_S",
                   help="write the wav progressively in CHUNK_S-second "
                        "chunks (the same audio as one shot)")
    p.add_argument("--no-ema", action="store_true",
                   help="sample from the raw training weights even when the "
                        "checkpoint kept EMA weights")
    p.add_argument("--device", default=None,
                   help="torch device to decode on (cuda runs the kernels; "
                        "default cuda, cuda:LOCAL_RANK under torchrun)")
    p.add_argument("--data-parallel", type=int, default=None, metavar="N",
                   help="decode across N ranks on the data (batch) mesh "
                        "axis (default: the ranks --model-parallel leaves)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="N",
                   help="split the conv stack's channels across N ranks, "
                        "one collective per layer; tokens equal a single "
                        "device's at the same --seed")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend under torchrun (default: "
                        "nccl for a CUDA device, gloo for the CPU)")
    p.add_argument("--export-aot", default=None, metavar="FILE.wnx",
                   help="instead of sampling, freeze the decode for "
                        "(--seconds, --batch, --temperature) via torch.export "
                        "into one deployment artifact "
                        "(wavenet_tpu_torch.serving.load_decoder loads it "
                        "without model code)")
    p.add_argument("--export-platforms", default="cpu,cuda",
                   help="comma-separated devices the --export-aot artifact "
                        "may be loaded on (default cpu,cuda: the decode "
                        "kernels on cuda, their plain versions on cpu; not "
                        "the JAX package's cpu,tpu, since TPU lowering is "
                        "its jax.export's)")
    from wavenet_tpu_torch.utils import compcache
    compcache.add_cli_flag(p)
    args = p.parse_args(argv)
    from wavenet_tpu_torch.parallel import distributed
    if args.device is None:
        args.device = (f"cuda:{distributed.local_rank()}"
                       if distributed.launched() else "cuda")
    return args


def main(argv=None):
    """Returns the [batch, T] int32 tokens as a numpy array (None with
    --stream or --export-aot)."""
    from wavenet_tpu_torch.parallel import distributed
    from wavenet_tpu_torch.utils import compcache
    args = parse_args(argv)
    if args.export_aot and (args.prime or args.mel_from
                            or args.stream is not None or args.naive):
        sys.exit("--export-aot freezes the whole-loop decode; drop "
                 "--prime/--mel-from/--stream/--naive")
    cache_dir = compcache.enable_from_args(args)
    if cache_dir:
        print(f"kernel build cache: {cache_dir}")
    meshed = (distributed.launched() or args.model_parallel > 1
              or (args.data_parallel or 1) > 1)
    if meshed and (args.stream is not None or args.naive):
        sys.exit("--data-parallel/--model-parallel use the distributed fast "
                 "decoder; drop --stream/--naive")
    started = meshed and distributed.initialize(args.dist_backend,
                                                device=args.device)
    if meshed and not started:
        sys.exit("--data-parallel/--model-parallel need one process per rank"
                 ": launch with torchrun --nproc_per_node N")
    try:
        return _generate(args, started)
    finally:
        if started:
            distributed.shutdown()


def _generate(args, meshed: bool):
    import numpy as np
    import torch

    from wavenet_tpu_torch.audio import mulaw
    from wavenet_tpu_torch.audio.io import read_wav
    from wavenet_tpu_torch.generate.sampler import (batch_paths,
                                                    generate_auto,
                                                    generate_naive,
                                                    generate_stream,
                                                    write_wavs)
    from wavenet_tpu_torch.models.api import WaveNet
    from wavenet_tpu_torch.ops import rng

    if meshed and torch.device(args.device).type == "cuda":
        # the mesh would otherwise bind cuda:LOCAL_RANK (two ranks may
        # share one card, each naming cuda:0)
        torch.cuda.set_device(torch.device(args.device))
    model = WaveNet.from_checkpoint(args.ckpt, step=args.step,
                                    use_ema=not args.no_ema,
                                    device=args.device)
    cfg, dev = model.cfg, model.device
    if args.export_aot:
        return _export_aot(args, model)

    prime = None
    if args.prime:
        w, _ = read_wav(args.prime, cfg.sample_rate)
        prime = torch.from_numpy(mulaw.encode_np(
            w, cfg.quantization_channels)).to(dev)[None].repeat(args.batch, 1)

    n = int(args.seconds * cfg.sample_rate)
    y = None
    if args.mel_from:
        if cfg.mel is None:
            sys.exit("--mel-from requires a conditional (mel) checkpoint")
        from wavenet_tpu_torch.audio.mel import log_mel
        from wavenet_tpu_torch.models.conditioning import upsample_mel
        ref, _ = read_wav(args.mel_from, cfg.sample_rate)
        mel = log_mel(ref, cfg.sample_rate, cfg.mel)[None]   # [1, F, M]
        P = 0 if prime is None else prime.shape[1]
        n = min(n, mel.shape[1] * cfg.mel.hop_length - max(P - 1, 0))
        if n <= 0:
            sys.exit(f"--prime ({P} samples) covers the whole --mel-from "
                     f"reference ({mel.shape[1] * cfg.mel.hop_length} "
                     f"samples); nothing left to vocode")
        with torch.no_grad():
            y = upsample_mel(model.params["upsampler"], cfg.mel,
                             torch.from_numpy(mel).to(dev),
                             max(P - 1, 0) + n).repeat(args.batch, 1, 1)

    speaker = None
    if cfg.global_classes is not None:
        sid = args.speaker if args.speaker is not None else 0
        if not 0 <= sid < cfg.global_classes:
            sys.exit(f"--speaker must be in [0, {cfg.global_classes})")
        speaker = torch.full((args.batch,), sid, dtype=torch.int32,
                             device=dev)
    elif args.speaker is not None:
        sys.exit("--speaker requires a global_classes checkpoint")

    if args.stream is not None and args.naive:
        sys.exit("--stream uses the fast decoder; drop --naive")
    if meshed:
        return _generate_mesh(args, model, n, prime, y, speaker)

    seeds = rng.as_row_seeds(args.seed, args.batch, dev)
    kw = dict(batch=args.batch, prime_tokens=prime, y=y, speaker=speaker,
              temperature=args.temperature, seeds=seeds, device=dev)
    t0 = time.perf_counter()
    if args.stream is not None:
        writers = []
        for path in batch_paths(args.out, args.batch):
            w = wave.open(path, "wb")
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(cfg.sample_rate)
            writers.append(w)
        total = 0
        try:
            for toks in generate_stream(
                    model.decode_weights(), cfg, n,
                    chunk_samples=max(1, int(args.stream * cfg.sample_rate)),
                    **kw):
                wav = mulaw.decode(toks, cfg.quantization_channels
                                   ).cpu().numpy()
                pcm = (np.clip(wav, -1.0, 1.0) * 32767.0).astype(np.int16)
                for i, w in enumerate(writers):
                    w.writeframes(pcm[i].tobytes())
                total += toks.shape[1]
                print(f"\rstreamed {total}/{n} samples", end="",
                      file=sys.stderr)
        finally:
            for w in writers:
                w.close()
        dt = time.perf_counter() - t0
        print(f"\n{n} samples x{args.batch} in {dt:.2f}s = "
              f"{n * args.batch / dt:.0f} samples/s (streamed)",
              file=sys.stderr)
        print(f"wrote {args.out}", file=sys.stderr)
        return None
    if args.naive:
        toks = generate_naive(model.params, cfg, n, **kw)
    else:
        toks = generate_auto(model.decode_weights(), cfg, n, **kw)
    toks = toks.cpu()           # timed after the read-back
    dt = time.perf_counter() - t0
    print(f"{n} samples x{args.batch} in {dt:.2f}s = "
          f"{n * args.batch / dt:.0f} samples/s "
          f"({'naive' if args.naive else 'fast'})", file=sys.stderr)
    write_wavs(args.out, toks, cfg)
    print(f"wrote {args.out}", file=sys.stderr)
    return toks.numpy()


def _export_aot(args, model) -> None:
    """Write the --export-aot artifact (rank 0 only under torchrun)."""
    from wavenet_tpu_torch.parallel import distributed
    from wavenet_tpu_torch.serving import export_decoder
    cfg = model.cfg
    platforms = tuple(
        s.strip() for s in args.export_platforms.split(",") if s.strip())
    if not distributed.is_primary():
        return None
    export_decoder(model.params, cfg, args.export_aot,
                   num_samples=int(args.seconds * cfg.sample_rate),
                   batch=args.batch, temperature=args.temperature,
                   platforms=platforms or None)
    print(f"wrote {args.export_aot} "
          f"({args.seconds}s x batch {args.batch}, "
          f"platforms {','.join(platforms) or 'native'}"
          f"{', speaker input' if cfg.global_classes else ''})")
    return None


def _generate_mesh(args, model, n: int, prime, y, speaker):
    """Every rank's decode over the mesh; rank 0 writes the wavs.  Each
    rank prints its route and its ms per decode step."""
    from wavenet_tpu_torch.generate import sampler
    from wavenet_tpu_torch.parallel import distdecode, distributed
    from wavenet_tpu_torch.parallel.mesh import make_mesh
    cfg, dev = model.cfg, model.device
    mesh = make_mesh(cfg.replace(data_parallel=args.data_parallel or 0,
                                 model_parallel=args.model_parallel,
                                 seq_parallel=1), dev.type)
    groups = distdecode.as_groups(mesh)
    fan_out = sampler.kernel_fan_out(cfg, groups, args.batch,
                                      args.temperature, dev)
    route = (sampler.kernel_module(cfg, dev).__name__.rsplit(".", 1)[-1]
             if fan_out else "collective loop")
    t0 = time.perf_counter()
    toks = model.generate(num_samples=n, batch=args.batch,
                          prime_tokens=prime, y=y, speaker=speaker,
                          temperature=args.temperature, seed=args.seed,
                          mesh=groups).cpu()   # timed after the read-back
    dt = time.perf_counter() - t0
    steps = n + max(0 if prime is None else prime.shape[1] - 1, 0)
    # one write, so the ranks' lines do not interleave
    sys.stderr.write(f"rank {distributed.rank()}: {n} samples x{args.batch} "
                     f"in {dt:.2f}s = {1e3 * dt / steps:.4f} ms per step "
                     f"(distributed dp={groups.dp} mp={groups.mp}, route "
                     f"{route})\n")
    sys.stderr.flush()
    if distributed.is_primary():
        sampler.write_wavs(args.out, toks, cfg)
        print(f"wrote {args.out}", file=sys.stderr)
    return toks.numpy()


if __name__ == "__main__":
    main()
