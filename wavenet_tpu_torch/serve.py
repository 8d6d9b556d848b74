"""Serving CLI — run an exported model as an HTTP synthesis service.

The port's counterpart of the repository's serve.py, for `.npz` weights
written by WaveNet.export_npz (either package) or a checkpoint directory
written by the port's trainer (EMA weights when the run kept them):

  python -m wavenet_tpu_torch.serve --npz model.npz --device cuda --port 8000
  python -m wavenet_tpu_torch.serve --ckpt runs/full --device cuda
  python -m wavenet_tpu_torch.serve --ckpt runs/full --step 500 --no-ema
  curl -X POST localhost:8000/synthesize \
       -d '{"seconds": 2.0, "seed": 7}' -o out.wav
  curl -X POST localhost:8000/synthesize \
       -d '{"seconds": 10.0, "stream": true}' --output raw.pcm   # int16 PCM
  curl localhost:8000/info
  # a mel-conditioned model (full_vocoder, conditional): log-mel frames,
  # [frames, M]
  curl -X POST localhost:8000/synthesize \
       -d '{"seconds": 0.5, "seed": 7, "mel": [[...80 floats...], ...]}'
  # a speaker-conditioned model (global_classes set): a speaker id
  curl -X POST localhost:8000/synthesize -d '{"seconds": 0.5, "speaker": 3}'

Narrow models (R < 128: tiny, small, fastgen_bench, conditional) decode
through the narrow kernel, wide ones (full, full_vocoder) through the wide
one.

A directory of the JAX package's orbax checkpoints is refused with a message
that points to export_npz.

Over a mesh of ranks (one process per rank under torchrun):

  torchrun --nproc_per_node 2 -m wavenet_tpu_torch.serve --ckpt runs/full \
      --data-parallel 2                     # rows split over two cards
  torchrun --nproc_per_node 2 -m wavenet_tpu_torch.serve --ckpt runs/full \
      --model-parallel 2                    # channels split over two cards

Each rank loads the model on cuda:LOCAL_RANK (nccl) unless --device and
--dist-backend say otherwise (two ranks on one card need gloo); rank 0
binds HTTP and takes the requests, the other ranks follow its
microbatches (serving/server.py), and every response equals a single
process's.  Interrupting rank 0 closes the server and releases the
followers.
"""

from __future__ import annotations

import argparse


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    src = p.add_mutually_exclusive_group(required=True)
    src.add_argument("--npz", help="export_npz single-file weights")
    src.add_argument("--ckpt", help="checkpoint directory of the port's "
                                    "trainer (latest step, EMA weights when "
                                    "the run kept them)")
    p.add_argument("--step", type=int, default=None,
                   help="checkpoint step to serve (--ckpt; default: the "
                        "latest)")
    p.add_argument("--no-ema", action="store_true",
                   help="serve the raw training weights instead of the EMA "
                        "(--ckpt)")
    p.add_argument("--device", default=None,
                   help="torch device to decode on (cuda runs the kernel; "
                        "default cuda, cuda:LOCAL_RANK under torchrun)")
    p.add_argument("--data-parallel", type=int, default=None, metavar="N",
                   help="serve across N ranks on the data (batch) mesh axis "
                        "(default: the ranks --model-parallel leaves)")
    p.add_argument("--model-parallel", type=int, default=1, metavar="N",
                   help="split the conv stack's channels across N ranks")
    p.add_argument("--dist-backend", choices=("nccl", "gloo"), default=None,
                   help="torch.distributed backend under torchrun (default: "
                        "nccl for a CUDA device, gloo for the CPU)")
    p.add_argument("--host", default="127.0.0.1")
    p.add_argument("--port", type=int, default=8000)
    p.add_argument("--max-batch", type=int, default=8,
                   help="microbatch row cap (requests group up to this)")
    p.add_argument("--max-wait-ms", type=float, default=10.0,
                   help="batching window: how long a request waits for "
                        "company before the batch launches")
    p.add_argument("--chunk-seconds", type=float, default=0.5,
                   help="decode chunk size (streaming time-to-first-byte)")
    p.add_argument("--length-quantum-seconds", type=float, default=0.5,
                   help="requested lengths round up to this quantum")
    p.add_argument("--warmup-seconds", type=float, default=0.0,
                   help="synthesize this much audio through every batch "
                        "bucket at boot (builds the kernel before the "
                        "first request)")
    from wavenet_tpu_torch.utils import compcache
    compcache.add_cli_flag(p)
    args = p.parse_args(argv)
    if args.npz and (args.step is not None or args.no_ema):
        p.error("--step and --no-ema select a checkpoint's weights; an "
                ".npz holds one set (use --ckpt)")
    from wavenet_tpu_torch.parallel import distributed
    if args.device is None:
        args.device = (f"cuda:{distributed.local_rank()}"
                       if distributed.launched() else "cuda")
    return args


def load_model(args):
    """The model the parsed arguments name, on args.device."""
    from wavenet_tpu_torch.models.api import WaveNet
    if args.ckpt:
        return WaveNet.from_checkpoint(args.ckpt, step=args.step,
                                       use_ema=not args.no_ema,
                                       device=args.device)
    return WaveNet.from_npz(args.npz, device=args.device)


def main(argv=None) -> int:
    from wavenet_tpu_torch.parallel import distributed
    from wavenet_tpu_torch.utils import compcache
    args = parse_args(argv)
    cache_dir = compcache.enable_from_args(args)
    if cache_dir:
        print(f"kernel build cache: {cache_dir}")
    meshed = (distributed.launched() or args.model_parallel > 1
              or (args.data_parallel or 1) > 1)
    started = meshed and distributed.initialize(args.dist_backend,
                                                device=args.device)
    if meshed and not started:
        raise SystemExit("--data-parallel/--model-parallel need one process "
                         "per rank: launch with torchrun --nproc_per_node N")
    try:
        return _serve(args, meshed)
    finally:
        if started:
            distributed.shutdown()


def _serve(args, meshed: bool) -> int:
    import os

    import torch

    from wavenet_tpu_torch.serving import WaveNetServer
    from wavenet_tpu_torch.serving.http import make_server
    mesh, where = None, args.device
    if meshed:
        from wavenet_tpu_torch.parallel import distributed
        from wavenet_tpu_torch.parallel.mesh import make_mesh
        if torch.device(args.device).type == "cuda":
            # two ranks may share one card, each naming cuda:0
            torch.cuda.set_device(torch.device(args.device))
    model = load_model(args)
    if meshed:
        mesh = make_mesh(model.cfg.replace(
            data_parallel=args.data_parallel or 0,
            model_parallel=args.model_parallel, seq_parallel=1),
            model.device.type)
        where = (f"{args.device}, mesh data x model = "
                 f"{mesh.shape[0]} x {mesh.shape[2]}, rank "
                 f"{distributed.rank()} of {distributed.world_size()}, "
                 f"pid {os.getpid()}")
    engine = WaveNetServer(model, max_batch=args.max_batch,
                           max_wait_ms=args.max_wait_ms,
                           chunk_seconds=args.chunk_seconds,
                           length_quantum_seconds=args.length_quantum_seconds,
                           mesh=mesh)
    if engine.follower:
        # a follower ends when rank 0 closes (an interrupt of the whole
        # launch reaches rank 0, which then releases the followers)
        import signal
        signal.signal(signal.SIGINT, signal.SIG_IGN)
        print(f"following rank 0 ({where})", flush=True)
        engine.follow()
        return 0
    if args.warmup_seconds > 0:
        engine.warmup(seconds=args.warmup_seconds, verbose=True)
    server = make_server(engine, host=args.host, port=args.port)
    host, port = server.server_address[:2]
    print(f"serving {args.ckpt or args.npz} on http://{host}:{port} "
          f"({where}, "
          f"max_batch={args.max_batch}, chunk={args.chunk_seconds}s)",
          flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
        # on a mesh, drain so that each lane's followers get its close
        engine.close(wait=meshed)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
